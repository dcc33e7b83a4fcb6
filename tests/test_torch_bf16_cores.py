"""The other cores, pools, options and randomizers under
``train.mixed_precision``: each port module through ``half_call`` against
the JAX module applied to bf16 casts of the same (perturbed) variables and
of the same seeded inputs; the output's type and every value within 2e-2 of
its largest |value|, unless stated.

* ``SpatialSoftmax`` on bf16 features with a learnable temperature (a bf16
  parameter: the logits stay bf16), with its variance output (within 3e-2:
  E[x^2] - E[x]^2 cancels, and XLA's CPU build keeps JAX's bf16 attention
  in fp32 where it meets the fp32 grid, where the port rounds it to bf16
  as the step's types say, as a TPU does; measured 0.9e-2 to 2.3e-2 over
  three seeds) and with
  keypoint noise in training (JAX's fp32 draw, recorded, injected into the
  port); the keypoints meet the fp32 grid, so both sides return fp32.
  ``SpatialMeanPool`` (the mean taken in fp32, rounded once).
* ``VisualCore`` on ShallowConv with no pool (flattened channels-last, or
  not flattened) and with the mean pool (JAX's ``VisualCore`` raises with
  a SpatialMeanPool; its pieces are composed as tests/test_torch_vision_cores.py
  composes them); ``ScanCore``.
* The randomizers on a bf16 image with JAX's draws pinned
  (``PinnedJaxRandom``; the draws are fp32 on both sides, so the image
  comes out fp32): the colour jitter in two of its orders, held with
  ``assert_mostly_close`` (99 % of the pixels within 1e-2, all within 0.35:
  the HSV arithmetic of a bf16 pixel near a sextant's edge can take the
  other branch where the two sides round h * 6 differently; measured
  99.9 % and 0.0 to 0.2), and the Gaussian noise within 1e-6.
* The frozen pretrained cores: R3M (ResNet-18 on a 40 x 40 image, resized to
  224 in fp32 and rounded once, as torch's CPU build has no bf16
  antialiased resize) and MVP's ViT-S (its attention softmax bf16 on both
  sides), each in a ``VisualCore`` with a projection.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robot_manipulation_vq_vae_tpu.models import base_nets as JaxBaseNets
from robot_manipulation_vq_vae_tpu.models import obs_core as JaxObsCore

from robot_manipulation_vq_vae_tpu_torch.models import base_nets as PortBaseNets
from robot_manipulation_vq_vae_tpu_torch.models import obs_core as PortObsCore
from robot_manipulation_vq_vae_tpu_torch.utils.mixed_precision import half_call
from test_torch_vision_cores import _JaxMeanPoolCore
from torch_bf16_helpers import assert_half_close, half_tree, init_pair, jax_half_apply, \
    port_half_apply
from torch_bf16_helpers import one_torch_thread  # noqa: F401 (autouse)
from torch_port_helpers import PinnedJaxRandom, assert_mostly_close, port_draws

B, IMG = 2, 40


def _features(seed=8, c=6, h=5, w=7):
    return np.random.RandomState(seed).randn(B, h, w, c) * 2.0


def _nchw(a):
    return np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 1))


@pytest.mark.parametrize("option", ["learnable_temperature", "output_variance"])
def test_spatial_softmax_options_bf16_match_jax(option):
    feat = _features()
    kw = dict(num_kp=4, temperature=0.8, **{option: True})
    jax_pool = JaxBaseNets.SpatialSoftmax(input_shape=feat.shape[1:], **kw)
    port = PortBaseNets.SpatialSoftmax(feat.shape[1:], **kw)
    nested = init_pair(jax_pool, port, [feat])
    want = jax_half_apply(jax_pool, nested, [feat])
    got = port_half_apply(port, [_nchw(feat)])
    if option == "output_variance":
        assert_half_close(got[0], want[0], msg="keypoints")
        assert_half_close(got[1], want[1], rel=3e-2, msg="variance")
    else:
        assert_half_close(got, want, msg="keypoints")
        assert port.temperature.dtype == torch.float32


def test_spatial_softmax_noise_bf16_matches_jax(monkeypatch):
    feat = _features(9)
    kw = dict(num_kp=4, noise_std=0.1)
    jax_pool = JaxBaseNets.SpatialSoftmax(input_shape=feat.shape[1:], **kw)
    port = PortBaseNets.SpatialSoftmax(feat.shape[1:], **kw).train()
    nested = init_pair(jax_pool, port, [feat])
    draws, real_normal = [], jax.random.normal

    def recorded_normal(key, shape, *args, **kwargs):
        draws.append(real_normal(key, shape, *args, **kwargs))
        return draws[-1]

    monkeypatch.setattr(jax.random, "normal", recorded_normal)
    want = jax_pool.apply(half_tree(nested), half_tree(jnp.asarray(feat, jnp.float32)),
                          train=True, rngs={"dropout": jax.random.PRNGKey(4)})
    assert len(draws) == 1 and str(draws[0].dtype) == "float32"
    noise = torch.from_numpy(np.array(draws[0]))
    got = port_half_apply(port, [_nchw(feat)], noise=noise)
    assert_half_close(got, want, msg="noisy keypoints")


def test_spatial_mean_pool_bf16_matches_jax():
    feat = _features(10) + 3.0
    got = port_half_apply(PortBaseNets.SpatialMeanPool(), [_nchw(feat)])
    want = JaxBaseNets.SpatialMeanPool().apply({}, half_tree(jnp.asarray(feat, jnp.float32)))
    assert_half_close(got, want, msg="mean pool")


CORES = {
    "no_pool_flat": dict(pool_class=None, feature_dimension=None),
    "no_pool_unflattened": dict(pool_class=None, flatten=False, feature_dimension=None),
    "mean_pool": dict(pool_class="SpatialMeanPool", feature_dimension=16),
}


@pytest.mark.parametrize("name", list(CORES))
def test_visual_core_pools_bf16_match_jax(name):
    kwargs = dict(backbone_class="ShallowConv", **CORES[name])
    x = np.random.RandomState(4).rand(B, IMG, IMG, 3)
    jax_core = (_JaxMeanPoolCore() if name == "mean_pool"
                else JaxObsCore.VisualCore(input_shape=(IMG, IMG, 3), **kwargs))
    port = PortObsCore.VisualCore((IMG, IMG, 3), **kwargs).train()
    nested = init_pair(jax_core, port, [x])
    want = jax_half_apply(jax_core, nested, [x], train=True)
    got = port_half_apply(port, [x])
    assert tuple(got.shape) == tuple(want.shape)
    assert_half_close(got, want, msg=name)


def test_scan_core_bf16_matches_jax():
    x = np.random.RandomState(9).randn(3, 64)
    jax_core = JaxObsCore.ScanCore(input_shape=(64,), feature_dimension=10)
    port = PortObsCore.ScanCore((64,), feature_dimension=10)
    nested = init_pair(jax_core, port, [x])
    assert_half_close(port_half_apply(port, [x]), jax_half_apply(jax_core, nested, [x]),
                      msg="scan core")


def _jax_randomize(rand, x, shim, monkeypatch):
    """JAX's randomizer applied eagerly to bf16 @x with its draws pinned."""
    monkeypatch.setattr(JaxObsCore, "jax", shim)
    out = rand.forward_in(jnp.asarray(x, jnp.float32).astype(jnp.bfloat16),
                          rng=jax.random.PRNGKey(0), train=True)
    monkeypatch.setattr(JaxObsCore, "jax", jax)
    return out


@pytest.mark.parametrize("order", [0, 17])
def test_color_randomizer_bf16_matches_jax(order, monkeypatch):
    x = np.random.RandomState(1).rand(4, 12, 10, 3).astype(np.float32)
    shim = PinnedJaxRandom(order, fixed={"randint": order})
    want = _jax_randomize(JaxObsCore.ColorRandomizer(x.shape[1:], num_samples=2), x, shim,
                          monkeypatch)
    port_draws(monkeypatch, shim.log, PortObsCore)
    rand = PortObsCore.ColorRandomizer(x.shape[1:], num_samples=2)
    got = rand.forward_in(torch.from_numpy(x).bfloat16(), torch.Generator(), train=True)
    assert got.dtype == torch.float32 and str(want.dtype) == "float32"
    assert_mostly_close(got.numpy(), np.asarray(want), atol=1e-2, frac=0.99, max_abs=0.35,
                        msg=f"order {order}")


def test_gaussian_noise_randomizer_bf16_matches_jax(monkeypatch):
    x = np.random.RandomState(4).rand(5, 9).astype(np.float32)
    kw = dict(noise_mean=0.1, noise_std=0.5, limits=(0.0, 0.9), num_samples=3)
    shim = PinnedJaxRandom(5)
    want = _jax_randomize(JaxObsCore.GaussianNoiseRandomizer(x.shape[1:], **kw), x, shim,
                          monkeypatch)
    port_draws(monkeypatch, shim.log, PortObsCore)
    rand = PortObsCore.GaussianNoiseRandomizer(x.shape[1:], **kw)
    got = rand.forward_in(torch.from_numpy(x).bfloat16(), torch.Generator(), train=True)
    assert got.dtype == torch.float32 and str(want.dtype) == "float32"
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


@pytest.mark.parametrize("backbone,backbone_kwargs", [
    ("R3MConv", {"r3m_model_class": "resnet18"}),
    ("MVPConv", {"mvp_model_class": "vits-mae-in"}),
], ids=["r3m", "mvp"])
def test_pretrained_cores_bf16_match_jax(backbone, backbone_kwargs):
    kwargs = dict(backbone_class=backbone, backbone_kwargs=backbone_kwargs, pool_class=None,
                  feature_dimension=16)
    x = np.random.RandomState(6).rand(1 if backbone == "MVPConv" else B, IMG, IMG, 3)
    jax_core = JaxObsCore.VisualCore(input_shape=(IMG, IMG, 3), **kwargs)
    port = PortObsCore.VisualCore((IMG, IMG, 3), **kwargs).train()
    nested = init_pair(jax_core, port, [x])
    want = jax_half_apply(jax_core, nested, [x], train=True,
                          mutable=["batch_stats"] if "batch_stats" in nested else False)
    if isinstance(want, tuple):
        want = want[0]
    got = half_call(port, (torch.from_numpy(x).float(),))
    assert_half_close(got, want, msg=backbone)
