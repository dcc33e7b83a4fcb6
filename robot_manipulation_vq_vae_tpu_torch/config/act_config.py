"""The ACT config (copy of the JAX package's ``config/act_config.py``): the
``act`` template."""

from robot_manipulation_vq_vae_tpu_torch.config.base_config import BaseConfig


class ACTConfig(BaseConfig):
    ALGO_NAME = "act"

    def train_config(self):
        super().train_config()
        self.train.hdf5_load_next_obs = False
        self.train.seq_length = 10

    def algo_config(self):
        self.algo.optim_params.policy.optimizer_type = "adamw"
        self.algo.optim_params.policy.learning_rate.initial = 5e-5
        self.algo.optim_params.policy.learning_rate.decay_factor = 1
        self.algo.optim_params.policy.learning_rate.epoch_schedule = []
        self.algo.optim_params.policy.learning_rate.scheduler_type = "linear"
        self.algo.optim_params.policy.regularization.L2 = 0.0001

        self.algo.loss.l2_weight = 0.0
        self.algo.loss.l1_weight = 1.0
        self.algo.loss.cos_weight = 0.0

        self.algo.act.hidden_dim = 512
        self.algo.act.dim_feedforward = 3200
        self.algo.act.backbone = "resnet18"
        self.algo.act.enc_layers = 4
        self.algo.act.dec_layers = 7
        self.algo.act.nheads = 8
        self.algo.act.latent_dim = 32
        self.algo.act.kl_weight = 20

        self.algo.language_conditioned = False
