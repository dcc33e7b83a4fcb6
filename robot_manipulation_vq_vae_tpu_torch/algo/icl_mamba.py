"""ICL with a Mamba (selective state-space) backbone (counterpart of the JAX
package's ``algo/icl_mamba.py``), registered as ``icl_mamba`` with its
routing: ``ICLMamba_GMM`` where ``algo.gmm`` and ``algo.mamba`` are both
enabled, else ``ICLMambaHVQVAE``.

The classes are the transformer ICL family's with their hyper-parameters
read from ``algo.mamba`` (``_tx_cfg``). ``ICLMamba_GMM`` is the paper's ICL
GMM path with ``Mamba_Backbone`` as the sequence mixer over the 3T tokens.
``ICLMambaHVQVAE`` keeps the flagship's transformer actor and only reads
``algo.mamba``, as the JAX class does (the reference's HVQVAE path has no
Mamba policy). Both train under ``train.mixed_precision``: the paper's bf16
step and the flagship's.
"""

from robot_manipulation_vq_vae_tpu_torch.algo.algo import register_algo_factory_func
from robot_manipulation_vq_vae_tpu_torch.algo.icl import (
    ICLTransformer_GMM,
    ICLTransformerHVQVAE,
)


@register_algo_factory_func("icl_mamba")
def algo_config_to_class(algo_config):
    """The JAX package's routing (its ``icl_mamba.py:25-31``)."""
    gmm = "gmm" in algo_config and algo_config.gmm.enabled
    if gmm and algo_config.mamba.enabled:
        return ICLMamba_GMM, {}
    return ICLMambaHVQVAE, {}


class _MambaSectionMixin:
    """Reads the sequence model's hyper-parameters from ``algo.mamba``."""

    def _tx_cfg(self):
        return self.algo_config.mamba


class ICLMambaHVQVAE(_MambaSectionMixin, ICLTransformerHVQVAE):
    """HVQVAE co-training with the transformer actor, configured from
    ``algo.mamba`` (see the module docstring)."""


class ICLMamba_GMM(_MambaSectionMixin, ICLTransformer_GMM):
    """The paper's ICL GMM path over a ``Mamba_Backbone``, with the paper
    step's ``train.mixed_precision`` (JAX ``algo/icl.py``:1093-1130, which
    the JAX class inherits).

    Its bf16 layer table, read off ``jax.make_jaxpr`` of the JAX bf16 step
    (each ``dot_general`` and ``conv`` operand's type), low-dimensional
    observations:

    * bf16: the embedding of every token; each Mamba block's in_proj, its
      depthwise causal convolution, x_proj, dt_proj, the selective scan
      (dA = exp(dt A) with A from the bf16 A_log, dBu, the state update
      and C . h as one product) and out_proj; LipVQ's encoder MLP; the GMM
      heads (their outputs cast to fp32);
    * fp32 statistics, one rounding to bf16: the pre-block and output
      LayerNorms (Flax's ``force_float32_reductions``);
    * bf16 operands, fp32 result: LipVQ's latent layer;
    * fp32: the LipVQ codebook search (kernel 1's bf16 instance: fp32 z_e
      against the bf16 codebook), the log-probabilities, the losses and
      both optimizers.

    With image observations the trunks are bf16 up to the keypoints, which
    meet the fp32 keypoint grid, and the sequence model then runs in fp32,
    as ``ICLTransformer_GMM``'s GPT does."""

    BACKBONE = "mamba"
