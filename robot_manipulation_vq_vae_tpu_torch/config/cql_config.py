"""The CQL config (copy of the JAX package's
``config/cql_config.py``)."""

from robot_manipulation_vq_vae_tpu_torch.config.base_config import BaseConfig


class CQLConfig(BaseConfig):
    ALGO_NAME = "cql"

    def algo_config(self):
        self.algo.optim_params.critic.learning_rate.initial = 1e-3
        self.algo.optim_params.critic.learning_rate.decay_factor = 0.0
        self.algo.optim_params.critic.learning_rate.epoch_schedule = []
        self.algo.optim_params.critic.learning_rate.scheduler_type = "constant"
        self.algo.optim_params.critic.regularization.L2 = 0.00

        self.algo.optim_params.actor.learning_rate.initial = 3e-4
        self.algo.optim_params.actor.learning_rate.decay_factor = 0.0
        self.algo.optim_params.actor.learning_rate.epoch_schedule = []
        self.algo.optim_params.actor.learning_rate.scheduler_type = "constant"
        self.algo.optim_params.actor.regularization.L2 = 0.00

        self.algo.discount = 0.99
        self.algo.n_step = 1
        self.algo.target_tau = 0.005
        self.algo.infinite_horizon = False

        self.algo.actor.bc_start_steps = 0
        self.algo.actor.target_entropy = "default"
        self.algo.actor.max_gradient_norm = None
        self.algo.actor.net.type = "gaussian"
        self.algo.actor.net.common.std_activation = "exp"
        self.algo.actor.net.common.use_tanh = True
        self.algo.actor.net.common.low_noise_eval = True
        self.algo.actor.net.gaussian.init_last_fc_weight = 0.001
        self.algo.actor.net.gaussian.init_std = 0.3
        self.algo.actor.net.gaussian.fixed_std = False
        self.algo.actor.layer_dims = (300, 400)

        self.algo.critic.use_huber = False
        self.algo.critic.max_gradient_norm = None
        self.algo.critic.value_bounds = None
        self.algo.critic.num_action_samples = 1
        self.algo.critic.cql_weight = 1.0
        self.algo.critic.deterministic_backup = True
        self.algo.critic.min_q_weight = 1.0
        self.algo.critic.target_q_gap = 5.0
        self.algo.critic.num_random_actions = 10
        self.algo.critic.ensemble.n = 2
        self.algo.critic.layer_dims = (300, 400)

        self.algo.language_conditioned = False
