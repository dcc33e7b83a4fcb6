"""The IQL config (copy of the JAX package's
``config/iql_config.py``)."""

from robot_manipulation_vq_vae_tpu_torch.config.base_config import BaseConfig


class IQLConfig(BaseConfig):
    ALGO_NAME = "iql"

    def algo_config(self):
        self.algo.optim_params.critic.learning_rate.initial = 1e-4
        self.algo.optim_params.critic.learning_rate.decay_factor = 0.0
        self.algo.optim_params.critic.learning_rate.epoch_schedule = []
        self.algo.optim_params.critic.learning_rate.scheduler_type = "constant"
        self.algo.optim_params.critic.regularization.L2 = 0.00

        self.algo.optim_params.vf.learning_rate.initial = 1e-4
        self.algo.optim_params.vf.learning_rate.decay_factor = 0.0
        self.algo.optim_params.vf.learning_rate.epoch_schedule = []
        self.algo.optim_params.vf.learning_rate.scheduler_type = "constant"
        self.algo.optim_params.vf.regularization.L2 = 0.00

        self.algo.optim_params.actor.learning_rate.initial = 1e-4
        self.algo.optim_params.actor.learning_rate.decay_factor = 0.0
        self.algo.optim_params.actor.learning_rate.epoch_schedule = []
        self.algo.optim_params.actor.learning_rate.scheduler_type = "constant"
        self.algo.optim_params.actor.regularization.L2 = 0.00

        self.algo.discount = 0.99
        self.algo.target_tau = 0.01

        self.algo.actor.net.type = "gaussian"
        self.algo.actor.net.common.std_activation = "softplus"
        self.algo.actor.net.common.low_noise_eval = True
        self.algo.actor.net.common.use_tanh = False
        self.algo.actor.net.gaussian.init_last_fc_weight = 0.001
        self.algo.actor.net.gaussian.init_std = 0.3
        self.algo.actor.net.gaussian.fixed_std = False
        self.algo.actor.net.gmm.num_modes = 5
        self.algo.actor.net.gmm.min_std = 0.0001
        self.algo.actor.layer_dims = (300, 400)
        self.algo.actor.max_gradient_norm = None

        self.algo.critic.ensemble.n = 2
        self.algo.critic.layer_dims = (300, 400)
        self.algo.critic.use_huber = False
        self.algo.critic.max_gradient_norm = None

        self.algo.adv.clip_adv_value = None
        self.algo.adv.beta = 1.0
        self.algo.adv.use_final_clip = True

        self.algo.vf_quantile = 0.9

        self.algo.language_conditioned = False
