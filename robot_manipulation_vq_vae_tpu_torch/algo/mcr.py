"""MCR policies (counterpart of the JAX package's ``algo/mcr.py``), registered
as ``mcr``: the ``bc`` classes under the ``bc`` routing (GMM, RNN and
transformer variants; the ``mcr`` template turns the GMM on and puts a
ResNet-50 / SpatialSoftmax core on the cameras), each warm-started from a
pretrained visual trunk where ``RMVQ_MCR_CKPT`` names a file.

The file is the pickle that ``MCRPretrainer.export_trunk`` writes in either
package: the trunk's parameters as a nested dict of numpy arrays under the
Flax names (``stem/conv1/kernel``, ...). At construction every observation
core's ``backbone`` whose parameters have exactly those names takes them
(its BatchNorm statistics stay), as the JAX class grafts the trunk onto
every ``backbone`` subtree of its parameters at its first state init.
"""

import os
import pickle

import torch

from robot_manipulation_vq_vae_tpu_torch.algo.algo import register_algo_factory_func
from robot_manipulation_vq_vae_tpu_torch.algo.bc import (
    BC,
    BC_GMM,
    BC_RNN,
    BC_RNN_GMM,
    BC_Transformer,
    BC_Transformer_GMM,
)
from robot_manipulation_vq_vae_tpu_torch.utils.jax_weights import (
    jax_flat,
    jax_variables,
    load_jax_variables,
)


@register_algo_factory_func("mcr")
def algo_config_to_class(algo_config):
    """The JAX routing (the ``bc`` routing without the Gaussian and VAE
    heads)."""
    gmm = "gmm" in algo_config and algo_config.gmm.enabled
    rnn, transformer = algo_config.rnn.enabled, algo_config.transformer.enabled
    if gmm:
        if rnn:
            return MCR_RNN_GMM, {}
        if transformer:
            return MCR_Transformer_GMM, {}
        return MCR_GMM, {}
    if rnn:
        return MCR_RNN, {}
    if transformer:
        return MCR_Transformer, {}
    return MCR, {}


def graft_trunk(module, trunk):
    """Load @trunk (a nested dict of Flax-named parameters) into every
    ``backbone`` under @module whose parameters have the same names; its
    other variables (BatchNorm statistics) stay. Returns how many took it."""
    params = jax_flat(trunk)
    grafted = 0
    for backbone in [m.backbone for m in module.modules()
                     if isinstance(getattr(m, "backbone", None), torch.nn.Module)]:
        flat = jax_variables(backbone)
        if {k for k in flat if k.startswith("params/")} != set(params):
            continue
        load_jax_variables(backbone, {**flat, **params})
        grafted += 1
    return grafted


class _MCRWarmStartMixin:
    """Grafts the trunk of ``RMVQ_MCR_CKPT`` (see the module docstring) once
    the networks are built."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        ckpt = os.environ.get("RMVQ_MCR_CKPT")
        if ckpt and os.path.isfile(ckpt):
            with open(ckpt, "rb") as f:
                trunk = pickle.load(f)
            n = graft_trunk(self.nets, trunk)
            print(f"[MCR] warm-started {n} visual trunks from {ckpt}")


class MCR(_MCRWarmStartMixin, BC):
    pass


class MCR_GMM(_MCRWarmStartMixin, BC_GMM):
    pass


class MCR_RNN(_MCRWarmStartMixin, BC_RNN):
    pass


class MCR_RNN_GMM(_MCRWarmStartMixin, BC_RNN_GMM):
    pass


class MCR_Transformer(_MCRWarmStartMixin, BC_Transformer):
    pass


class MCR_Transformer_GMM(_MCRWarmStartMixin, BC_Transformer_GMM):
    pass
