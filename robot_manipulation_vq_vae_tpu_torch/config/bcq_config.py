"""The BCQ config (copy of the JAX package's
``config/bcq_config.py``)."""

from robot_manipulation_vq_vae_tpu_torch.config.base_config import BaseConfig
from robot_manipulation_vq_vae_tpu_torch.config.bc_config import BCConfig


class BCQConfig(BaseConfig):
    ALGO_NAME = "bcq"

    def algo_config(self):
        self.algo.optim_params.critic.learning_rate.initial = 1e-3
        self.algo.optim_params.critic.learning_rate.decay_factor = 0.1
        self.algo.optim_params.critic.learning_rate.epoch_schedule = []
        self.algo.optim_params.critic.learning_rate.scheduler_type = "constant"
        self.algo.optim_params.critic.regularization.L2 = 0.00
        self.algo.optim_params.critic.start_epoch = -1
        self.algo.optim_params.critic.end_epoch = -1

        self.algo.optim_params.action_sampler.learning_rate.initial = 1e-3
        self.algo.optim_params.action_sampler.learning_rate.decay_factor = 0.1
        self.algo.optim_params.action_sampler.learning_rate.epoch_schedule = []
        self.algo.optim_params.action_sampler.learning_rate.scheduler_type = (
            "constant"
        )
        self.algo.optim_params.action_sampler.regularization.L2 = 0.00
        self.algo.optim_params.action_sampler.start_epoch = -1
        self.algo.optim_params.action_sampler.end_epoch = -1

        self.algo.optim_params.actor.learning_rate.initial = 1e-3
        self.algo.optim_params.actor.learning_rate.decay_factor = 0.1
        self.algo.optim_params.actor.learning_rate.epoch_schedule = []
        self.algo.optim_params.actor.learning_rate.scheduler_type = "constant"
        self.algo.optim_params.actor.regularization.L2 = 0.00
        self.algo.optim_params.actor.start_epoch = -1
        self.algo.optim_params.actor.end_epoch = -1

        self.algo.discount = 0.99
        self.algo.n_step = 1
        self.algo.target_tau = 0.005
        self.algo.infinite_horizon = False

        self.algo.critic.use_huber = False
        self.algo.critic.max_gradient_norm = None
        self.algo.critic.value_bounds = None
        self.algo.critic.num_action_samples = 10
        self.algo.critic.num_action_samples_rollout = 100
        self.algo.critic.ensemble.n = 2
        self.algo.critic.ensemble.weight = 0.75
        self.algo.critic.distributional.enabled = False
        self.algo.critic.distributional.num_atoms = 51
        self.algo.critic.layer_dims = (300, 400)

        # action sampler: a BC-VAE config block (reference bcq_config.py:66-78)
        self.algo.action_sampler = BCConfig().algo
        self.algo.action_sampler.vae.enabled = True
        # remove unused parts of the BC algo config; gmm + actor_layer_dims
        # stay (reference bcq_config.py:70-75 keeps them; the paper configs
        # set action_sampler.gmm.enabled)
        for k in ("optim_params", "loss", "gaussian", "rnn", "transformer"):
            if k in self.algo.action_sampler:
                del self.algo.action_sampler[k]
        with self.algo.action_sampler.unlocked():
            self.algo.action_sampler.freeze_encoder_epoch = -1

        self.algo.actor.enabled = False
        self.algo.actor.perturbation_scale = 0.05
        self.algo.actor.layer_dims = (300, 400)

        self.algo.language_conditioned = False
