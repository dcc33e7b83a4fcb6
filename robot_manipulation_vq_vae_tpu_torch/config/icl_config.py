"""Config templates for the ICL algorithm family (copy of the JAX package's
``config/icl_config.py``): ``icl``, ``icl_hvqvae`` and ``icl_gmm_paper``.
"""

from robot_manipulation_vq_vae_tpu_torch.config.base_config import BaseConfig
from robot_manipulation_vq_vae_tpu_torch.config.config import Config


class ICLConfig(BaseConfig):
    ALGO_NAME = "icl"

    def train_config(self):
        super().train_config()
        # ICL needs no "next_obs" (reference icl_config.py:13-18)
        self.train.hdf5_load_next_obs = False

    def algo_config(self):
        # optimizer (policy)
        self.algo.optim_params.policy.optimizer_type = "adam"
        self.algo.optim_params.policy.learning_rate.initial = 1e-4
        self.algo.optim_params.policy.learning_rate.decay_factor = 0.1
        self.algo.optim_params.policy.learning_rate.epoch_schedule = []
        self.algo.optim_params.policy.learning_rate.scheduler_type = (
            "constant_with_warmup"
        )
        self.algo.optim_params.policy.regularization.L2 = 0.00

        # optimizer (vqvae) - reference icl_config.py:39-47
        self.algo.optim_params.vqvae = Config()
        self.algo.optim_params.vqvae.optimizer_type = "adamw"
        self.algo.optim_params.vqvae.learning_rate = Config()
        self.algo.optim_params.vqvae.learning_rate.initial = 1e-4
        self.algo.optim_params.vqvae.learning_rate.decay_factor = 1.0
        self.algo.optim_params.vqvae.learning_rate.epoch_schedule = []
        self.algo.optim_params.vqvae.learning_rate.scheduler_type = "constant"
        self.algo.optim_params.vqvae.regularization = Config()
        self.algo.optim_params.vqvae.regularization.L2 = 1e-4

        # loss weights
        self.algo.loss.l2_weight = 1.0
        self.algo.loss.l1_weight = 0.0
        self.algo.loss.cos_weight = 0.0

        # MLP network architecture
        self.algo.actor_layer_dims = (1024, 1024)

        # stochastic Gaussian policy settings
        self.algo.gaussian.enabled = False
        self.algo.gaussian.fixed_std = False
        self.algo.gaussian.init_std = 0.1
        self.algo.gaussian.min_std = 0.01
        self.algo.gaussian.std_activation = "softplus"
        self.algo.gaussian.low_noise_eval = True

        # stochastic GMM policy settings
        self.algo.gmm.enabled = False
        self.algo.gmm.num_modes = 5
        self.algo.gmm.min_std = 0.0001
        self.algo.gmm.std_activation = "softplus"
        self.algo.gmm.low_noise_eval = True

        # stochastic VAE policy settings
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

        # RNN policy settings
        self.algo.rnn.enabled = False
        self.algo.rnn.horizon = 10
        self.algo.rnn.hidden_dim = 400
        self.algo.rnn.rnn_type = "LSTM"
        self.algo.rnn.num_layers = 2
        self.algo.rnn.open_loop = False
        self.algo.rnn.kwargs.bidirectional = False
        self.algo.rnn.kwargs.do_not_lock_keys()

        # Transformer policy settings
        self.algo.transformer.enabled = False
        self.algo.transformer.context_length = 16
        self.algo.transformer.embed_dim = 512
        self.algo.transformer.num_layers = 6
        self.algo.transformer.num_heads = 8
        self.algo.transformer.emb_dropout = 0.1
        self.algo.transformer.attn_dropout = 0.1
        self.algo.transformer.block_output_dropout = 0.1
        self.algo.transformer.sinusoidal_embedding = False
        self.algo.transformer.activation = "gelu"
        self.algo.transformer.fast_enabled = False
        self.algo.transformer.bin_enabled = False
        self.algo.transformer.vq_vae_enabled = True
        self.algo.transformer.ln_act_enabled = True
        self.algo.transformer.supervise_all_steps = False
        self.algo.transformer.nn_parameter_for_timesteps = True
        self.algo.transformer.pred_future_acs = False
        self.algo.transformer.causal = True

        # Hierarchical VQ-VAE settings (reference icl_config.py:129-143)
        self.algo.transformer.vqvae = Config()
        self.algo.transformer.vqvae.num_subclusters = 1024
        self.algo.transformer.vqvae.num_clusters = 512
        self.algo.transformer.vqvae.embed_dim = 512
        self.algo.transformer.vqvae.num_stages = 2
        self.algo.transformer.vqvae.num_layers_per_stage = 4
        self.algo.transformer.vqvae.lambda_rec = 0.002
        self.algo.transformer.vqvae.beta_ema = 0.8
        self.algo.transformer.vqvae.dropout = 0.1
        self.algo.transformer.vqvae.dead_code_threshold_z = 3
        self.algo.transformer.vqvae.dead_code_threshold_q = 1
        self.algo.transformer.vqvae.pretrain_epochs = 0
        self.algo.transformer.vqvae.use_fifa_inference = True
        self.algo.transformer.vqvae.do_not_lock_keys()

        self.algo.language_conditioned = False


class ICLHVQVAEConfig(ICLConfig):
    """Registered under the ``icl_hvqvae`` algo name (reference icl_hvqvae.py)."""

    ALGO_NAME = "icl_hvqvae"


class ICLGMMPaperConfig(ICLConfig):
    """Registered under ``icl_gmm_paper``: the direct route to the paper's
    LipVQ GMM transformer path (ICLTransformer_GMM + LipVQ tokenizer),
    which the reference factory makes unreachable by routing every
    transformer branch to ICLTransformerHVQVAE (reference icl.py:77-103;
    see algo/icl.py routing note). Defaults flip on gmm + transformer +
    vq_vae so ``config_factory("icl_gmm_paper")`` trains the paper model
    out of the box."""

    ALGO_NAME = "icl_gmm_paper"

    def algo_config(self):
        super().algo_config()
        self.algo.gmm.enabled = True
        self.algo.transformer.enabled = True
        self.algo.transformer.vq_vae_enabled = True
        # the base template ships both vq_vae and ln_act on (harmless for
        # the HVQVAE path, which ignores them); the GMM encoder requires
        # exactly one tokenizer modality
        self.algo.transformer.ln_act_enabled = False
