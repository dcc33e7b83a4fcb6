"""The BC config (copy of the JAX package's ``config/bc_config.py``):
the ``bc`` template, which ``exps/templates/bc.json`` dumps."""

from robot_manipulation_vq_vae_tpu_torch.config.base_config import BaseConfig


class BCConfig(BaseConfig):
    ALGO_NAME = "bc"

    def train_config(self):
        super().train_config()
        # BC doesn't need "next_obs"
        self.train.hdf5_load_next_obs = False

    def algo_config(self):
        self.algo.optim_params.policy.optimizer_type = "adam"
        self.algo.optim_params.policy.learning_rate.initial = 1e-4
        self.algo.optim_params.policy.learning_rate.decay_factor = 0.1
        self.algo.optim_params.policy.learning_rate.epoch_schedule = []
        self.algo.optim_params.policy.learning_rate.scheduler_type = (
            "constant_with_warmup"
        )
        self.algo.optim_params.policy.regularization.L2 = 0.00

        self.algo.loss.l2_weight = 1.0
        self.algo.loss.l1_weight = 0.0
        self.algo.loss.cos_weight = 0.0

        self.algo.actor_layer_dims = (1024, 1024)

        self.algo.gaussian.enabled = False
        self.algo.gaussian.fixed_std = False
        self.algo.gaussian.init_std = 0.1
        self.algo.gaussian.min_std = 0.01
        self.algo.gaussian.std_activation = "softplus"
        self.algo.gaussian.low_noise_eval = True

        self.algo.gmm.enabled = False
        self.algo.gmm.num_modes = 5
        self.algo.gmm.min_std = 0.0001
        self.algo.gmm.std_activation = "softplus"
        self.algo.gmm.low_noise_eval = True

        self.algo.vae.enabled = False
        self.algo.vae.latent_dim = 14
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

        self.algo.rnn.enabled = False
        self.algo.rnn.horizon = 10
        self.algo.rnn.hidden_dim = 400
        self.algo.rnn.rnn_type = "LSTM"
        self.algo.rnn.num_layers = 2
        self.algo.rnn.open_loop = False
        self.algo.rnn.kwargs.bidirectional = False
        self.algo.rnn.kwargs.do_not_lock_keys()

        self.algo.transformer.enabled = False
        self.algo.transformer.context_length = 10
        self.algo.transformer.embed_dim = 512
        self.algo.transformer.num_layers = 6
        self.algo.transformer.num_heads = 8
        self.algo.transformer.emb_dropout = 0.1
        self.algo.transformer.attn_dropout = 0.1
        self.algo.transformer.block_output_dropout = 0.1
        self.algo.transformer.sinusoidal_embedding = False
        self.algo.transformer.activation = "gelu"
        self.algo.transformer.supervise_all_steps = False
        self.algo.transformer.nn_parameter_for_timesteps = True
        self.algo.transformer.pred_future_acs = False
        self.algo.transformer.causal = True
        self.algo.transformer.fast_enabled = False
        self.algo.transformer.bin_enabled = False
        self.algo.transformer.vq_vae_enabled = False
        self.algo.transformer.ln_act_enabled = True

        self.algo.language_conditioned = False
