"""The ICL-Mamba config (copy of the JAX package's
``config/icl_mamba_config.py``): the ICL config plus an ``algo.mamba``
section that mirrors ``algo.transformer``."""

from robot_manipulation_vq_vae_tpu_torch.config.config import Config
from robot_manipulation_vq_vae_tpu_torch.config.icl_config import ICLConfig


class ICLMambaConfig(ICLConfig):
    ALGO_NAME = "icl_mamba"

    def algo_config(self):
        super().algo_config()

        self.algo.mamba.enabled = True
        self.algo.mamba.context_length = 10
        self.algo.mamba.embed_dim = 512
        self.algo.mamba.num_layers = 6
        self.algo.mamba.num_heads = 8
        self.algo.mamba.emb_dropout = 0.1
        self.algo.mamba.attn_dropout = 0.1
        self.algo.mamba.block_output_dropout = 0.1
        self.algo.mamba.sinusoidal_embedding = False
        self.algo.mamba.activation = "gelu"
        self.algo.mamba.fast_enabled = False
        self.algo.mamba.bin_enabled = False
        self.algo.mamba.vq_vae_enabled = False
        self.algo.mamba.ln_act_enabled = True
        self.algo.mamba.supervise_all_steps = False
        self.algo.mamba.nn_parameter_for_timesteps = True
        self.algo.mamba.pred_future_acs = False
        self.algo.mamba.causal = True

        self.algo.mamba.vqvae = Config()
        self.algo.mamba.vqvae.num_subclusters = 1024
        self.algo.mamba.vqvae.num_clusters = 512
        self.algo.mamba.vqvae.embed_dim = 512
        self.algo.mamba.vqvae.num_stages = 2
        self.algo.mamba.vqvae.num_layers_per_stage = 4
        self.algo.mamba.vqvae.lambda_rec = 0.002
        self.algo.mamba.vqvae.beta_ema = 0.8
        self.algo.mamba.vqvae.dropout = 0.1
        self.algo.mamba.vqvae.do_not_lock_keys()
