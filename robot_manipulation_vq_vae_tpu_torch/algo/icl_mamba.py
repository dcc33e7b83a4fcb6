"""ICL with a Mamba (selective state-space) backbone (counterpart of the JAX
package's ``algo/icl_mamba.py``), registered as ``icl_mamba`` with its
routing: ``ICLMamba_GMM`` where ``algo.gmm`` and ``algo.mamba`` are both
enabled, else ``ICLMambaHVQVAE``.

The classes are the transformer ICL family's with their hyper-parameters
read from ``algo.mamba`` (``_tx_cfg``). ``ICLMamba_GMM`` is the paper's ICL
GMM path with ``Mamba_Backbone`` as the sequence mixer over the 3T tokens.
``ICLMambaHVQVAE`` keeps the flagship's transformer actor and only reads
``algo.mamba``, as the JAX class does (the reference's HVQVAE path has no
Mamba policy).
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
    """The paper's ICL GMM path over a ``Mamba_Backbone``. Its
    ``train.mixed_precision`` step is not ported (it raises)."""

    BACKBONE = "mamba"
    MIXED_PRECISION = False
