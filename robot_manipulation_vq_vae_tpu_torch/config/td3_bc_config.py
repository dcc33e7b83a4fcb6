"""The TD3-BC config (copy of the JAX package's
``config/td3_bc_config.py``)."""

from robot_manipulation_vq_vae_tpu_torch.config.base_config import BaseConfig


class TD3_BCConfig(BaseConfig):
    ALGO_NAME = "td3_bc"

    def train_config(self):
        super().train_config()
        self.train.hdf5_load_next_obs = True

    def algo_config(self):
        self.algo.optim_params.critic.learning_rate.initial = 3e-4
        self.algo.optim_params.critic.learning_rate.decay_factor = 0.1
        self.algo.optim_params.critic.learning_rate.epoch_schedule = []
        self.algo.optim_params.critic.learning_rate.scheduler_type = "constant"
        self.algo.optim_params.critic.regularization.L2 = 0.00
        self.algo.optim_params.critic.start_epoch = -1
        self.algo.optim_params.critic.end_epoch = -1

        self.algo.optim_params.actor.learning_rate.initial = 3e-4
        self.algo.optim_params.actor.learning_rate.decay_factor = 0.1
        self.algo.optim_params.actor.learning_rate.epoch_schedule = []
        self.algo.optim_params.actor.learning_rate.scheduler_type = "constant"
        self.algo.optim_params.actor.regularization.L2 = 0.00
        self.algo.optim_params.actor.start_epoch = -1
        self.algo.optim_params.actor.end_epoch = -1

        self.algo.alpha = 2.5
        self.algo.discount = 0.99
        self.algo.n_step = 1
        self.algo.target_tau = 0.005
        self.algo.infinite_horizon = False

        self.algo.critic.use_huber = False
        self.algo.critic.max_gradient_norm = None
        self.algo.critic.value_bounds = None
        self.algo.critic.ensemble.n = 2
        self.algo.critic.ensemble.weight = 1.0
        self.algo.critic.layer_dims = (256, 256)

        self.algo.actor.update_freq = 2
        self.algo.actor.noise_std = 0.2
        self.algo.actor.noise_clip = 0.5
        self.algo.actor.layer_dims = (256, 256)

        self.algo.language_conditioned = False

    def observation_config(self):
        super().observation_config()
        # reference uses flat D4RL-style observations by default
        self.observation.modalities.obs.low_dim = ["flat"]
