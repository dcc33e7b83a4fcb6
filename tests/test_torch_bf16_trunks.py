"""The vision trunks under ``train.mixed_precision``: each port trunk through
``half_call`` against the JAX trunk applied to bf16 casts of the same
(perturbed) variables and of the same seeded images (40 x 40, B = 2), the
trunks inside a ``VisualCore`` with no pool (the features flattened
channels-last, as both packages flatten them).

* With BatchNorm on its running statistics (eval; the JAX step's bf16
  copies of them, rounded on the port's side as well): ResNet-34, ResNet-34
  FiLM, ResNet-18 FiLM with the language cross-attention, and ShallowConv
  (ResNet-50 and ResNet-50 FiLM in tests/test_torch_bf16_trunks_r50.py);
  and in training ResNet-18 with GroupNorm and coord-conv (the coordinates
  cast to the image's bf16, as JAX's ``astype(x.dtype)`` casts them): the
  output's type and every value within 2e-2 of its largest |value|, or
  within twice JAX's own bf16-from-fp32 gap where that is larger (16 FiLM
  layers of ResNet-50 FiLM carry activations of several hundred, where a
  bf16 step is 2 to 4; measured 4e-3 to 2.0e-2).
* With BatchNorm in training: ResNet-34 FiLM (ResNet-50 FiLM in the other
  file). Over a
  batch of 2 x 2 x 2 values a channel's statistics amplify each bf16
  rounding of the layers before (a near-constant channel is divided by
  its tiny standard deviation), so JAX's own bf16 output lies 7-11 % of
  the largest value from its fp32 output at this size. The port is held to
  JAX's bf16 output by that measure: its largest error at most twice JAX's
  own bf16-from-fp32 gap (measured 1.4-1.6 times), and at least 90 % of the
  values within 5e-2 of the largest (measured 95-96 %).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robot_manipulation_vq_vae_tpu.models import obs_core as JaxObsCore

from robot_manipulation_vq_vae_tpu_torch.models import obs_core as PortObsCore
from torch_bf16_helpers import assert_half_close, init_pair, jax_half_apply, \
    port_half_apply
from torch_bf16_helpers import one_torch_thread  # noqa: F401 (autouse)
from torch_port_helpers import assert_mostly_close

B, IMG, LANG = 2, 40, 8
NO_POOL = dict(pool_class=None, feature_dimension=None)

# name -> (backbone class, backbone kwargs, FiLM, training)
TRUNKS = {
    "resnet34": ("ResNet34Conv", {}, False, False),
    "resnet34_film": ("ResNet34ConvFiLM", {}, True, False),
    "resnet18_film_cross_attn": ("ResNet18ConvFiLMCrossAttn", {}, True, False),
    "shallow_conv": ("ShallowConv", {}, False, False),
    "resnet18_group_coord": ("ResNet18Conv", {"norm": "group", "input_coord_conv": True},
                             False, True),
}


def _pair(backbone, backbone_kwargs, film):
    kwargs = dict(backbone_class=backbone, backbone_kwargs=backbone_kwargs, **NO_POOL)
    if film:
        return (JaxObsCore.VisualCoreLanguageConditioned(input_shape=(IMG, IMG, 3), **kwargs),
                PortObsCore.VisualCoreLanguageConditioned((IMG, IMG, 3), lang_emb_dim=LANG,
                                                          **kwargs))
    return (JaxObsCore.VisualCore(input_shape=(IMG, IMG, 3), **kwargs),
            PortObsCore.VisualCore((IMG, IMG, 3), **kwargs))


def _inputs(film, seed=1):
    rng = np.random.RandomState(seed)
    x = rng.rand(B, IMG, IMG, 3)
    return [x, rng.randn(B, LANG)] if film else [x]


def _jax_fp32(jax_core, nested, args, train):
    def apply(v, *a):
        out = jax_core.apply(v, *a, train=train, mutable=["batch_stats"] if train else False)
        return out[0] if train else out

    return np.asarray(jax.jit(apply)(nested, *(jnp.asarray(a, jnp.float32) for a in args)))


def check_trunk(name, trunks):
    backbone, backbone_kwargs, film, train = trunks[name]
    jax_core, port = _pair(backbone, backbone_kwargs, film)
    args = _inputs(film)
    nested = init_pair(jax_core, port, args)
    port.train(train)
    if train:
        want, _ = jax_half_apply(jax_core, nested, args, mutable=["batch_stats"], train=True)
    else:
        want = jax_half_apply(jax_core, nested, args)
    got = port_half_apply(port, args)
    assert got.dtype == torch.bfloat16
    assert_half_close(got, want, msg=name, fp32=_jax_fp32(jax_core, nested, args, train))


@pytest.mark.parametrize("name", list(TRUNKS))
def test_trunk_bf16_matches_jax(name):
    check_trunk(name, TRUNKS)


def check_training_trunk(backbone):
    jax_core, port = _pair(backbone, {}, True)
    args = _inputs(True, seed=2)
    nested = init_pair(jax_core, port, args)
    port.train()
    want, _ = jax_half_apply(jax_core, nested, args, mutable=["batch_stats"], train=True)
    fp32 = _jax_fp32(jax_core, nested, args, True)
    got = port_half_apply(port, args)
    assert got.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16"
    want, fp32 = np.asarray(want, np.float32), np.asarray(fp32)
    top = float(np.abs(want).max())
    own_gap = float(np.abs(want - fp32).max())
    got = got.detach().float().numpy()
    assert float(np.abs(got - want).max()) <= 2 * own_gap
    assert_mostly_close(got, want, atol=5e-2 * top, frac=0.9, max_abs=2 * own_gap,
                        msg=backbone)


def test_batch_norm_trunk_in_training_bf16_matches_jax():
    check_training_trunk("ResNet34ConvFiLM")
