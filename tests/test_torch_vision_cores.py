"""The port's vision trunks, pools and cores against the JAX package's, in
float64 (``jax.enable_x64``; ``.double()``) at small images (40 x 40, B = 2:
ResNet features of 2 x 2), the JAX weights carried across by
``load_jax_variables`` and JAX applied under ``jit``.

* ResNet-34, ShallowConv (the other trunks JAX registers are in
  tests/test_torch_film_trunks.py) and
  ResNet-18 with group norm and coord-conv, in training: outputs, the
  gradients of a fixed projection of the output (each within 1e-9 of its
  tensor's largest) and the BatchNorm statistics after the forward within
  1e-9. (Flax takes the GroupNorm variance as E[x^2] - E[x]^2: in float64
  that is a rounding from torch's.)
* ``VisualCore`` with no pool (flattened channels-last, or not flattened),
  SpatialMeanPool, and SpatialSoftmax with a learnable temperature: outputs
  and gradients within 1e-9, output shapes as JAX's ``_core_output_shape``
  gives them. JAX's ``VisualCore`` raises with a SpatialMeanPool (it hands
  the pool an ``input_shape`` it does not take); the port's core is held
  against JAX's ShallowConv, SpatialMeanPool and Dense composed as that
  core composes them.
* SpatialSoftmax's variance output, and its keypoint noise in training
  (fault: the port used to drop ``noise_std``) with JAX's own draw injected
  into the port; a core refuses to flatten the variance pair, as JAX's
  fails to.
* Every backbone, pool and randomizer JAX registers builds in the port, and
  the model-level switches reach the new trunks' stems."""

import copy

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from robot_manipulation_vq_vae_tpu.models import base_nets as JaxBaseNets
from robot_manipulation_vq_vae_tpu.models import obs_core as JaxObsCore
from robot_manipulation_vq_vae_tpu.models import obs_nets as JaxObsNets
from robot_manipulation_vq_vae_tpu.utils import obs_utils as JaxObsUtils
from robot_manipulation_vq_vae_tpu.utils.ckpt_conversion import flatten_variables

from robot_manipulation_vq_vae_tpu_torch.models import base_nets as PortBaseNets
from robot_manipulation_vq_vae_tpu_torch.models import obs_core as PortObsCore
from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils as PortObsUtils
from robot_manipulation_vq_vae_tpu_torch.utils.jax_weights import load_jax_variables
from torch_port_helpers import perturbed_variables
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

B, IMG, LANG, TOL = 2, 40, 8, 1e-9


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 1)))


def _inputs(seed, shape=(B, IMG, IMG, 3)):
    rng = np.random.RandomState(seed)
    return rng.rand(*shape), rng.randn(B, LANG)


def _jax_step(module, variables, args, ct, train):
    """(output, updated batch_stats, parameter gradients) of
    sum(module(*args) * ct), float64, under jit."""
    stats = variables.get("batch_stats", {})

    def loss(params):
        out, upd = module.apply({"params": params, "batch_stats": stats}, *args,
                                train=train, mutable=["batch_stats"])
        return jnp.sum(out * ct), (out, upd)

    (_, (out, upd)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])
    return out, upd.get("batch_stats", {}), grads


def _holder(module, params, stats):
    """A copy of @module filled from a JAX tree (the gradients or the
    updated statistics arrive in the parameters' layout)."""
    holder = copy.deepcopy(module)
    load_jax_variables(holder, flatten_variables(
        {"params": params, **({"batch_stats": stats} if stats else {})}))
    return holder


def _assert_grads(module, holder):
    """Each gradient within TOL of its tensor's largest (or of the largest of
    all where a tensor's is 0 in exact arithmetic)."""
    want = {n: p.detach().numpy() for n, p in holder.named_parameters()}
    top = max(np.abs(w).max() for w in want.values())
    for name, p in module.named_parameters():
        scale = max(np.abs(want[name]).max(), 1e-6 * top)
        got = np.zeros_like(want[name]) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(got, want[name], atol=TOL * scale, rtol=0, err_msg=name)


def _assert_stats(module, holder):
    want = dict(holder.named_buffers())
    n = 0
    for name, buf in module.named_buffers():
        if "running" in name:
            np.testing.assert_allclose(buf.numpy(), want[name].numpy(), atol=TOL, rtol=0,
                                       err_msg=name)
            n += 1
    return n


def check_trunk(make_jax, make_port, film):
    """The trunk in training: output, BatchNorm statistics and gradients
    against JAX's (see the module docstring). Returns the port trunk."""
    x, lang = _inputs(1)
    jax_mod = make_jax()
    args = (x, lang) if film else (x,)
    with jax.enable_x64():
        variables = jax_mod.init(jax.random.PRNGKey(0),
                                 *(jnp.asarray(a, jnp.float32) for a in args))
        nested, flat = perturbed_variables(variables, 2)
        nested = _f64(nested)
        out_shape = jax.eval_shape(lambda: jax_mod.apply(nested, *args)).shape
        ct = np.random.RandomState(3).randn(*out_shape)
        out_j, stats, grads = _jax_step(jax_mod, nested, [jnp.asarray(a) for a in args],
                                        ct, train=True)
    port = make_port().double().train()
    load_jax_variables(port, flat)
    out = port(*([_nchw(x)] + ([torch.from_numpy(lang)] if film else [])))
    assert list(out.shape[1:]) == [out_shape[-1], *out_shape[1:3]]
    np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(), np.asarray(out_j),
                               atol=TOL * float(np.abs(out_j).max()), rtol=0)
    (out * _nchw(ct)).sum().backward()
    n_stats = _assert_stats(port, _holder(port, nested["params"], stats))
    assert n_stats == 2 * sum(isinstance(m, PortBaseNets.BatchNorm2d) for m in port.modules())
    _assert_grads(port, _holder(port, grads, stats))
    assert list(port.output_shape((IMG, IMG, 3))) == list(out_shape[1:])
    return port, grads


# (JAX module, port module, takes the language embedding); the FiLM and
# Bottleneck trunks are in tests/test_torch_film_trunks.py
TRUNKS = {
    "resnet18_group_coord": (
        lambda: JaxBaseNets.ResNet18Conv(norm="group", input_coord_conv=True),
        lambda: PortBaseNets.ResNet18Conv(norm="group", input_coord_conv=True), False),
    "resnet34": (JaxBaseNets.ResNet34Conv, PortBaseNets.ResNet34Conv, False),
    "shallow_conv": (JaxBaseNets.ShallowConv, PortBaseNets.ShallowConv, False),
}


@pytest.mark.parametrize("name", list(TRUNKS))
def test_trunk_training_forward_matches_jax(name):
    port, _ = check_trunk(*TRUNKS[name])
    if name == "resnet18_group_coord":
        assert not any(isinstance(m, PortBaseNets.BatchNorm2d) for m in port.modules())
        assert port.nets[0].weight.shape[1] == 5


# core kwargs: no pool, flattened (channels-last) and not; the mean pool on
# ShallowConv; SpatialSoftmax with a learnable temperature on a group-norm
# coord-conv trunk
CORES = {
    "no_pool_flat": dict(backbone_class="ResNet18Conv", pool_class=None,
                         feature_dimension=None),
    "no_pool_unflattened": dict(backbone_class="ResNet18Conv", pool_class=None,
                                flatten=False, feature_dimension=None),
    "shallow_mean_pool": dict(backbone_class="ShallowConv", pool_class="SpatialMeanPool",
                              feature_dimension=16),
    "softmax_learnable_temperature": dict(
        backbone_class="ResNet18Conv",
        backbone_kwargs={"norm": "group", "input_coord_conv": True, "pretrained": False},
        pool_kwargs={"num_kp": 8, "learnable_temperature": True, "temperature": 0.7},
        feature_dimension=16),
}


class _JaxMeanPoolCore(fnn.Module):
    """JAX's VisualCore on ShallowConv with a SpatialMeanPool, composed as
    ``VisualCore._backbone_and_pool`` composes it: JAX's own core passes
    ``input_shape`` to SpatialMeanPool, which takes none, and raises."""

    @fnn.compact
    def __call__(self, x, train=False):
        x = JaxBaseNets.ShallowConv(name="backbone")(x, train=train)
        x = JaxBaseNets.SpatialMeanPool(name="pool")(x, train=train)
        return fnn.Dense(16, name="proj")(x.reshape(x.shape[0], -1))


@pytest.mark.parametrize("name", list(CORES))
def test_visual_core_matches_jax(name):
    kwargs = CORES[name]
    jax_core = JaxObsCore.VisualCore(input_shape=(IMG, IMG, 3), **kwargs)
    x, _ = _inputs(4)
    if name == "shallow_mean_pool":
        with pytest.raises(TypeError, match="input_shape"):
            jax_core.init(jax.random.PRNGKey(1), jnp.asarray(x, jnp.float32))
        jax_core = _JaxMeanPoolCore()
    with jax.enable_x64():
        variables = jax_core.init(jax.random.PRNGKey(1), jnp.asarray(x, jnp.float32))
        nested, flat = perturbed_variables(variables, 5)
        nested = _f64(nested)
        out_shape = jax.eval_shape(lambda: jax_core.apply(nested, x)).shape
        ct = np.random.RandomState(6).randn(*out_shape)
        out_j, stats, grads = _jax_step(jax_core, nested, [jnp.asarray(x)], ct, train=True)
    port = PortObsCore.VisualCore((IMG, IMG, 3), **kwargs).double().train()
    load_jax_variables(port, flat)
    out = port(torch.from_numpy(x))
    assert tuple(out.shape) == tuple(out_shape)
    assert port.output_shape() == list(
        JaxObsNets._core_output_shape("VisualCore", kwargs, (IMG, IMG, 3)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               atol=TOL * float(np.abs(out_j).max()), rtol=0)
    (out * torch.from_numpy(ct)).sum().backward()
    _assert_stats(port, _holder(port, nested["params"], stats))
    _assert_grads(port, _holder(port, grads, stats))
    if name == "softmax_learnable_temperature":
        assert port.pool.temperature.grad is not None


def _keypoints(seed=8, c=6, h=5, w=7):
    return np.random.RandomState(seed).randn(B, h, w, c) * 2.0


def test_spatial_softmax_variance_matches_jax():
    feat = _keypoints()
    kw = dict(num_kp=4, temperature=0.8, output_variance=True)
    jax_pool = JaxBaseNets.SpatialSoftmax(input_shape=feat.shape[1:], **kw)
    with jax.enable_x64():
        variables = jax_pool.init(jax.random.PRNGKey(2), jnp.asarray(feat, jnp.float32))
        nested, flat = perturbed_variables(variables, 6)
        kp_j, cov_j = jax.jit(lambda v, f: jax_pool.apply(v, f))(_f64(nested), feat)
    port = PortBaseNets.SpatialSoftmax(feat.shape[1:], **kw).double()
    load_jax_variables(port, flat)
    kp, cov = port(_nchw(feat))
    assert cov.shape == (B, 4, 2, 2)
    np.testing.assert_allclose(kp.detach().numpy(), np.asarray(kp_j), atol=TOL, rtol=0)
    np.testing.assert_allclose(cov.detach().numpy(), np.asarray(cov_j), atol=TOL, rtol=0)


def test_spatial_softmax_noise_matches_jax(monkeypatch):
    """With noise_std > 0 a training forward adds noise_std x N(0, 1) to the
    keypoints: JAX's draw (from its dropout stream, recorded) injected into
    the port gives JAX's keypoints; the port's own draw comes from the
    caller's generator; eval adds none."""
    feat = _keypoints(9)
    kw = dict(num_kp=4, noise_std=0.1)
    jax_pool = JaxBaseNets.SpatialSoftmax(input_shape=feat.shape[1:], **kw)
    draws = []
    real_normal = jax.random.normal

    def recorded_normal(key, shape, *args, **kwargs):
        draws.append(real_normal(key, shape, *args, **kwargs))
        return draws[-1]

    with jax.enable_x64():
        variables = jax_pool.init(jax.random.PRNGKey(3), jnp.asarray(feat, jnp.float32))
        nested, flat = perturbed_variables(variables, 7)
        monkeypatch.setattr(jax.random, "normal", recorded_normal)
        want = jax_pool.apply(_f64(nested), feat, train=True,
                              rngs={"dropout": jax.random.PRNGKey(4)})
        clean = jax_pool.apply(_f64(nested), feat, train=False)
    assert len(draws) == 1 and draws[0].shape == (B, 4, 2)
    port = PortBaseNets.SpatialSoftmax(feat.shape[1:], **kw).double()
    load_jax_variables(port, flat)
    noise = torch.from_numpy(np.array(draws[0]))
    got = port.train()(_nchw(feat), noise=noise)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=TOL, rtol=0)
    assert float(np.abs(np.asarray(want) - np.asarray(clean)).max()) > 1e-3
    with pytest.raises(ValueError, match="generator"):
        port(_nchw(feat))
    gen = torch.Generator().manual_seed(5)
    own = port(_nchw(feat), torch.Generator().manual_seed(5))
    ref = port(_nchw(feat), noise=torch.randn((B, 4, 2), generator=gen, dtype=torch.float64))
    assert torch.equal(own, ref)
    np.testing.assert_allclose(port.eval()(_nchw(feat)).detach().numpy(), np.asarray(clean),
                               atol=TOL, rtol=0)


def test_a_core_refuses_to_flatten_the_variance_pair():
    kwargs = dict(backbone_class="ShallowConv", feature_dimension=None,
                  pool_kwargs={"num_kp": 4, "output_variance": True})
    jax_core = JaxObsCore.VisualCore(input_shape=(16, 16, 3), **kwargs)
    with pytest.raises(AttributeError):   # JAX reshapes the tuple
        jax_core.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))
    with pytest.raises(ValueError, match="variance"):
        PortObsCore.VisualCore((16, 16, 3), **kwargs)
    core = PortObsCore.VisualCore((16, 16, 3), **kwargs, flatten=False)
    kp, cov = core(torch.rand(1, 16, 16, 3))
    assert kp.shape == (1, 4, 2) and cov.shape == (1, 4, 2, 2)


def test_every_jax_core_pool_and_randomizer_is_registered():
    assert set(PortObsCore._BACKBONE_CLASSES) == set(JaxObsCore._BACKBONE_CLASSES)
    assert set(PortObsCore._POOL_CLASSES) == set(JaxObsCore._POOL_CLASSES)
    assert PortObsCore._FILM_BACKBONES == JaxObsCore._FILM_BACKBONES
    assert set(JaxObsUtils.OBS_RANDOMIZERS) <= set(PortObsUtils.OBS_RANDOMIZERS)
    assert set(JaxObsUtils.OBS_ENCODER_CORES) <= set(PortObsUtils.OBS_ENCODER_CORES)
    assert "ScanCore" in PortObsUtils.OBS_ENCODER_CORES


def test_the_model_switches_reach_every_new_trunk():
    """set_stem_pool / set_pool_free_stem / set_frozen_batch_norm reach the
    stems and BatchNorms of every trunk (the JAX switches are process-wide);
    frozen BatchNorm leaves GroupNorm alone."""
    trunks = [PortBaseNets.ResNet50ConvFiLM(lang_emb_dim=LANG),
              PortBaseNets.ResNet34Conv(norm="group"),
              PortBaseNets.ResNet18ConvFiLMCrossAttn(lang_emb_dim=LANG)]
    model = torch.nn.ModuleList(trunks)
    PortBaseNets.set_stem_pool(model, True, use_kernel=False)
    PortBaseNets.set_frozen_batch_norm(model, True)
    pools = [m for m in model.modules() if isinstance(m, PortBaseNets.StemMaxPool)]
    assert len(pools) == 3 and all(p.recorded_argmax and not p.use_kernel for p in pools)
    bns = [m for m in model.modules() if isinstance(m, PortBaseNets.BatchNorm2d)]
    assert bns and all(m.frozen for m in bns)
    assert len([m for m in trunks[1].modules() if isinstance(m, PortBaseNets.GroupNorm)]) == 36
    x = torch.rand(1, 3, 40, 40)
    with torch.no_grad():
        pooled = trunks[1](x)
        PortBaseNets.set_pool_free_stem(model, True)
        assert trunks[1](x).shape == pooled.shape
