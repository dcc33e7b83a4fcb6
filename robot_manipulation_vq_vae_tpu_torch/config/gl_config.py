"""The GL config (copy of the JAX package's ``config/gl_config.py``): the
``gl`` template, whose ``observation.modalities.subgoal`` names the keys the
planner predicts."""

from robot_manipulation_vq_vae_tpu_torch.config.base_config import BaseConfig


class GLConfig(BaseConfig):
    ALGO_NAME = "gl"

    def algo_config(self):
        self.algo.optim_params.goal_network.learning_rate.initial = 1e-4
        self.algo.optim_params.goal_network.learning_rate.decay_factor = 0.1
        self.algo.optim_params.goal_network.learning_rate.epoch_schedule = []
        self.algo.optim_params.goal_network.learning_rate.scheduler_type = (
            "constant"
        )
        self.algo.optim_params.goal_network.regularization.L2 = 0.00

        self.algo.subgoal_horizon = 10

        self.algo.ae.planner_layer_dims = (300, 400)

        self.algo.vae.enabled = True
        self.algo.vae.latent_dim = 16
        self.algo.vae.latent_clip = None
        self.algo.vae.kl_weight = 1.0
        self.algo.vae.decoder.is_conditioned = True
        self.algo.vae.decoder.reconstruction_sum_across_elements = False
        self.algo.vae.prior.learn = False
        self.algo.vae.prior.is_conditioned = False
        self.algo.vae.prior.use_gmm = False
        self.algo.vae.prior.gmm_num_modes = 10
        self.algo.vae.prior.gmm_learn_weights = False
        self.algo.vae.prior.use_categorical = False
        self.algo.vae.prior.categorical_dim = 10
        self.algo.vae.prior.categorical_gumbel_softmax_hard = False
        self.algo.vae.prior.categorical_init_temp = 1.0
        self.algo.vae.prior.categorical_temp_anneal_step = 0.001
        self.algo.vae.prior.categorical_min_temp = 0.3
        self.algo.vae.encoder_layer_dims = (300, 400)
        self.algo.vae.decoder_layer_dims = (300, 400)
        self.algo.vae.prior_layer_dims = (300, 400)

        self.algo.language_conditioned = False

    def observation_config(self):
        super().observation_config()
        # subgoal modalities (reference gl_config.py:64-71)
        self.observation.modalities.subgoal.low_dim = [
            "robot0_eef_pos",
            "robot0_eef_quat",
            "robot0_gripper_qpos",
            "object",
        ]
        self.observation.modalities.subgoal.rgb = []
        self.observation.modalities.subgoal.depth = []
        self.observation.modalities.subgoal.scan = []
        self.observation.modalities.subgoal.do_not_lock_keys()
