"""The diffusion-policy config (copy of the JAX package's
``config/diffusion_policy_config.py``): the ``diffusion_policy`` template."""

from robot_manipulation_vq_vae_tpu_torch.config.base_config import BaseConfig


class DiffusionPolicyConfig(BaseConfig):
    ALGO_NAME = "diffusion_policy"

    def train_config(self):
        super().train_config()
        self.train.hdf5_load_next_obs = False

    def algo_config(self):
        self.algo.optim_params.policy.learning_rate.initial = 1e-4
        self.algo.optim_params.policy.learning_rate.decay_factor = 0.1
        self.algo.optim_params.policy.learning_rate.epoch_schedule = []
        self.algo.optim_params.policy.learning_rate.scheduler_type = "constant"
        self.algo.optim_params.policy.regularization.L2 = 0.00

        self.algo.horizon.observation_horizon = 2
        self.algo.horizon.action_horizon = 8
        self.algo.horizon.prediction_horizon = 16

        self.algo.unet.enabled = True
        self.algo.unet.diffusion_step_embed_dim = 256
        self.algo.unet.down_dims = [256, 512, 1024]
        self.algo.unet.kernel_size = 5
        self.algo.unet.n_groups = 8

        self.algo.ema.enabled = True
        self.algo.ema.power = 0.75

        self.algo.ddpm.enabled = True
        self.algo.ddpm.num_train_timesteps = 100
        self.algo.ddpm.num_inference_timesteps = 100
        self.algo.ddpm.beta_schedule = "squaredcos_cap_v2"
        self.algo.ddpm.clip_sample = True
        self.algo.ddpm.prediction_type = "epsilon"

        self.algo.ddim.enabled = False
        self.algo.ddim.num_train_timesteps = 100
        self.algo.ddim.num_inference_timesteps = 10
        self.algo.ddim.beta_schedule = "squaredcos_cap_v2"
        self.algo.ddim.clip_sample = True
        self.algo.ddim.set_alpha_to_one = True
        self.algo.ddim.steps_offset = 0
        self.algo.ddim.prediction_type = "epsilon"

        self.algo.language_conditioned = False
