"""The port's other action tokenizers against the JAX package's, module by
module, from the same seeded numpy inputs with the JAX weights carried
across by ``load_jax_variables``: the adaptive-bin embedding (running
statistics, the ``num_step_stop`` cut-off, values on the bin boundaries, a
constant action dimension, the never-trained model), the spectral-norm
``SNDense`` (eval and train outputs, the stored ``u``, gradients through the
power iteration), the default encoder (at D = 976 and at a D that is not a
multiple of 8; its dropout), the Mamba block and the LN-act encoder (also
against the float64 recurrence, and causal), and FAST (``resample_latents``,
the host encoder on ``chip_smoke.py``'s deterministic stand-ins,
``FastProjection``).

Outputs agree within 1e-5 of each output's largest magnitude in float32 and
within 1e-10 in float64 (``jax.enable_x64`` / ``module.double()``); bin
indices and statistics agree to the bit."""

import contextlib
import functools
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robot_manipulation_vq_vae_tpu.models.tokenizers import bin_action as JaxBin
from robot_manipulation_vq_vae_tpu.models.tokenizers import default_encoder as JaxDefault
from robot_manipulation_vq_vae_tpu.models.tokenizers import fast as JaxFast
from robot_manipulation_vq_vae_tpu.models.tokenizers import ln_act as JaxLnAct
from robot_manipulation_vq_vae_tpu.utils.ckpt_conversion import unflatten_npz

from robot_manipulation_vq_vae_tpu_torch.models.tokenizers import bin_action as PortBin
from robot_manipulation_vq_vae_tpu_torch.models.tokenizers import default_encoder as PortDefault
from robot_manipulation_vq_vae_tpu_torch.models.tokenizers import fast as PortFast
from robot_manipulation_vq_vae_tpu_torch.models.tokenizers import ln_act as PortLnAct
from robot_manipulation_vq_vae_tpu_torch.utils.jax_weights import (
    load_jax_variables,
)
from chip_smoke import SmokeFastProcessor, smoke_clip_encode
from torch_port_helpers import perturbed_variables
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

A, OUT, N, NB = 12, 20, 32, 20
DTYPES = [np.float32, np.float64]
REL = {np.float32: 1e-5, np.float64: 1e-10}


@contextlib.contextmanager
def precision(dtype):
    """JAX in float64 for a float64 case."""
    if dtype == np.float64:
        with jax.enable_x64():
            yield
    else:
        yield


def jax_tree(flat, dtype):
    """The nested JAX variables of @flat in @dtype (integer leaves, the bin
    step counter, as int32). Call inside ``precision(dtype)``."""
    def cast(key, a):
        if key.endswith("num_step"):
            return jnp.asarray(a, jnp.int32)
        return jnp.asarray(a, dtype)
    return unflatten_npz({k: cast(k, v) for k, v in flat.items()})


def port_of(module, flat, dtype):
    load_jax_variables(module, flat)
    return module.double() if dtype == np.float64 else module


def assert_close(got, want, dtype, msg=""):
    """max |got - want| within REL of want's largest magnitude."""
    got = got.detach().numpy() if hasattr(got, "detach") else np.asarray(got)
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, f"{msg}: shape {got.shape} vs {want.shape}"
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= REL[dtype] * scale, f"{msg}: max|diff| {err:.3g} > {REL[dtype]} x {scale:.3g}"


def jit_init(model, *shapes, seed=0):
    """The module's variables (one compile instead of one per eager op)."""
    return jax.jit(model.init)(jax.random.PRNGKey(seed),
                               *(jnp.zeros(sh) for sh in shapes))


def jit_apply(model, variables, *args, **kwargs):
    return jax.jit(functools.partial(model.apply, **kwargs))(variables, *args)


def t(x, dtype):
    return torch.from_numpy(np.asarray(x, dtype))


def with_noise(flat, names, seed):
    """@flat with N(0, 0.2^2) added to the leaves named in @names (constants
    at init, such as Mamba's A_log and D)."""
    rng = np.random.RandomState(seed)
    return {k: (v + rng.normal(0.0, 0.2, np.shape(v)).astype(np.float32)
                if k.rsplit("/", 1)[-1] in names else v)
            for k, v in flat.items()}


# ---------------------------------------------------------------------------
# adaptive bins
# ---------------------------------------------------------------------------

def bin_pair(dtype, num_step_stop=10000, seed=0):
    model = JaxBin.AdaptiveBinActionEmbedding(A, OUT, num_bins=NB,
                                              num_step_stop=num_step_stop)
    variables = model.init(jax.random.PRNGKey(seed), jnp.zeros((N, A)))
    _, flat = perturbed_variables(variables, seed)
    port = PortBin.AdaptiveBinActionEmbedding(A, OUT, num_step_stop=num_step_stop)
    assert port.num_bins == NB
    return model, flat, port_of(port, flat, dtype)


def bin_train(model, variables, port, x, dtype):
    """One training forward on both sides; the outputs agree and the
    statistics are equal to the bit. Returns JAX's new variables."""
    y_j, upd = model.apply(variables, jnp.asarray(x), update_stats=True,
                           mutable=["bin_stats"])
    y_t = port.train()(t(x, dtype))
    assert_close(y_t, y_j, dtype, "output")
    stats = upd["bin_stats"]
    for name in ("running_min", "running_max", "num_step"):
        np.testing.assert_array_equal(getattr(port, name).numpy(),
                                      np.asarray(stats[name]), err_msg=name)
    return {**variables, **upd}


@pytest.mark.parametrize("dtype", DTYPES)
def test_bin_training_statistics_match_jax(dtype):
    model, flat, port = bin_pair(dtype)
    rng = np.random.RandomState(1)
    with precision(dtype):
        variables = jax_tree(flat, dtype)
        for scale in (0.5, 1.0, 2.0):
            variables = bin_train(model, variables, port,
                                  rng.uniform(-scale, scale, (N, A)).astype(dtype), dtype)
    assert int(port.num_step) == 3


@pytest.mark.parametrize("dtype", DTYPES)
def test_bin_statistics_stop_at_num_step_stop(dtype):
    model, flat, port = bin_pair(dtype, num_step_stop=2)
    rng = np.random.RandomState(2)
    xs = [rng.uniform(-s, s, (N, A)).astype(dtype) for s in (0.5, 1.0, 3.0)]
    with precision(dtype):
        variables = jax_tree(flat, dtype)
        for x in xs:
            variables = bin_train(model, variables, port, x, dtype)
    # the third, widest batch came after the cut-off
    assert int(port.num_step) == 2
    np.testing.assert_array_equal(port.running_min.numpy(), np.minimum(*[x.min(0) for x in xs[:2]]))
    np.testing.assert_array_equal(port.running_max.numpy(), np.maximum(*[x.max(0) for x in xs[:2]]))


@pytest.mark.parametrize("dtype", DTYPES)
def test_bin_values_on_the_boundaries_take_jax_bins(dtype):
    """Every value sits exactly on one of JAX's boundaries (the outputs of
    two bins differ by far more than the tolerance, so agreeing outputs are
    agreeing bins); the port's indices equal searchsorted(side="left") on
    JAX's boundaries."""
    model, flat, port = bin_pair(dtype, seed=3)
    rng = np.random.RandomState(3)
    with precision(dtype):
        variables = bin_train(model, jax_tree(flat, dtype), port,
                              rng.uniform(-1, 1, (N, A)).astype(dtype), dtype)
        lo = variables["bin_stats"]["running_min"]
        hi = variables["bin_stats"]["running_max"]
        bounds = np.asarray(lo[:, None] + (hi - lo)[:, None]
                            * jnp.linspace(0.0, 1.0, NB + 1)[None, :])
        n = np.arange(2 * (NB + 1))
        x = np.stack([bounds[a, (n + a) % (NB + 1)] for a in range(A)], axis=1)
        y_j = model.apply(variables, jnp.asarray(x), update_stats=False)
        want = np.stack([np.asarray(jnp.searchsorted(jnp.asarray(bounds[a]),
                                                     jnp.asarray(x[:, a]), side="left"))
                         for a in range(A)], axis=1)
    port.eval()
    assert_close(port(t(x, dtype)), y_j, dtype, "output")
    idx = PortBin.bin_index(t(x, dtype), port.running_min, port.running_max, NB)
    np.testing.assert_array_equal(idx.numpy(), np.clip(want - 1, 0, NB - 1))


@pytest.mark.parametrize("dtype", DTYPES)
def test_bin_constant_action_dimension(dtype):
    """lo == hi in dimension 0: the value itself and anything below take
    bin 0, anything above the last bin, as in JAX."""
    model, flat, port = bin_pair(dtype, seed=4)
    rng = np.random.RandomState(4)
    x = rng.uniform(-1, 1, (N, A)).astype(dtype)
    x[:, 0] = 0.3
    with precision(dtype):
        variables = bin_train(model, jax_tree(flat, dtype), port, x, dtype)
        probe = rng.uniform(-1, 1, (3, A)).astype(dtype)
        probe[:, 0] = [0.3, 0.2, 0.4]
        probe = probe.astype(dtype)
        y_j = model.apply(variables, jnp.asarray(probe), update_stats=False)
    assert float(port.running_min[0]) == float(port.running_max[0])
    assert_close(port.eval()(t(probe, dtype)), y_j, dtype, "output")
    idx = PortBin.bin_index(t(probe, dtype), port.running_min, port.running_max, NB)
    assert idx[:, 0].tolist() == [0, 0, NB - 1]


@pytest.mark.parametrize("dtype", DTYPES)
def test_bin_never_trained_model_serves_bin_0(dtype):
    """lo = +inf and hi = -inf make every boundary NaN: JAX's searchsorted
    lands every value in bin 0 (torch.searchsorted would give the last
    bin), and so does the port."""
    model, flat, port = bin_pair(dtype, seed=5)
    x = np.random.RandomState(5).uniform(-1, 1, (4, A)).astype(dtype)
    with precision(dtype):
        y_j = model.apply(jax_tree(flat, dtype), jnp.asarray(x), update_stats=False)
    assert_close(port.eval()(t(x, dtype)), y_j, dtype, "output")
    idx = PortBin.bin_index(t(x, dtype), port.running_min, port.running_max, NB)
    assert not idx.any()
    nan_bounds = torch.full((NB + 1,), float("nan"))
    assert int(torch.searchsorted(nan_bounds, torch.tensor([0.0]))) == NB + 1
    assert int(port.num_step) == 0


# ---------------------------------------------------------------------------
# spectral norm and the default encoder
# ---------------------------------------------------------------------------

def sn_pair(dtype, in_dim=24, features=16, seed=0):
    model = JaxDefault.SNDense(features)
    variables = jit_init(model, (N, in_dim), seed=seed)
    _, flat = perturbed_variables(variables, seed)
    return model, flat, port_of(PortDefault.SNDense(in_dim, features), flat, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("train", [False, True])
def test_sn_dense_output_and_u_match_jax(dtype, train):
    model, flat, port = sn_pair(dtype, seed=1)
    x = np.random.RandomState(1).randn(N, 24).astype(dtype)
    u0 = port.u.clone()
    with precision(dtype):
        y_j, upd = jit_apply(model, jax_tree(flat, dtype), jnp.asarray(x),
                             update_stats=train, mutable=["spectral"])
    y_t = port.train(train)(t(x, dtype))
    assert_close(y_t, y_j, dtype, "output")
    u_j = np.asarray(upd["spectral"]["u"])
    if train:   # the new u is stored
        assert not torch.equal(port.u, u0)
        assert_close(port.u, u_j, dtype, "u")
    else:       # eval stores nothing
        assert torch.equal(port.u, u0)
        np.testing.assert_array_equal(port.u.numpy(), u_j)


@pytest.mark.parametrize("dtype", DTYPES)
def test_sn_dense_gradients_match_jax_grad(dtype):
    """Gradients of sum(y * w) by the kernel, the bias and the input, with
    the power iteration differentiated, within 1e-6 of each gradient's
    largest magnitude. Detaching sigma (as torch's spectral_norm detaches
    u and v) would miss the kernel's gradient by far more."""
    model, flat, port = sn_pair(dtype, seed=2)
    rng = np.random.RandomState(2)
    x = rng.randn(N, 24).astype(dtype)
    w = rng.randn(N, 16).astype(dtype)
    with precision(dtype):
        tree = jax_tree(flat, dtype)
        spectral = tree["spectral"]

        def loss(params, xj):
            y = model.apply({"params": params, "spectral": spectral}, xj)
            return jnp.sum(y * jnp.asarray(w))

        g_params, g_x = jax.jit(jax.grad(loss, argnums=(0, 1)))(tree["params"],
                                                                jnp.asarray(x))
    xt = t(x, dtype).requires_grad_(True)
    (port(xt) * t(w, dtype)).sum().backward()
    for got, want, name in ((port.weight.grad, np.asarray(g_params["kernel"]).T, "kernel"),
                            (port.bias.grad, g_params["bias"], "bias"), (xt.grad, g_x, "x")):
        got, want = got.numpy(), np.asarray(want)
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= 1e-6, f"{name}: {err:.3g} of the largest gradient"

    weight = port.weight.detach().clone().requires_grad_(True)
    with torch.no_grad():
        u = PortDefault._normalize(port.u)
        v = PortDefault._normalize(u @ weight)
        u_new = PortDefault._normalize(weight @ v)
    sigma = torch.dot(u_new @ weight, v).detach()
    (torch.nn.functional.linear(t(x, dtype), weight / sigma, port.bias) * t(w, dtype)).sum().backward()
    off = np.abs(weight.grad.numpy() - port.weight.grad.numpy()).max()
    assert off > 1e-3 * np.abs(port.weight.grad.numpy()).max()


def default_pair(dtype, d, seed):
    model = JaxDefault.DefaultActionEncoder(A, d)
    variables = jit_init(model, (N, A), seed=seed)
    _, flat = perturbed_variables(variables, seed)
    port = port_of(PortDefault.DefaultActionEncoder(A, d), flat, dtype)
    return model, flat, port


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [976, 12])
@pytest.mark.parametrize("train", [False, True])
def test_default_encoder_matches_jax(dtype, d, train):
    """At the full width, 976 (8 heads of 122), and at 12 (one head).
    In training the spectral vectors move; dropout is off on both sides
    here (JAX deterministic, the port's p set to 0) and is tested below."""
    model, flat, port = default_pair(dtype, d, seed=d)
    assert port.layers[0].nh == (8 if d == 976 else 1)
    x = np.random.RandomState(d).uniform(-1, 1, (N, A)).astype(dtype)
    with precision(dtype):
        y_j, upd = jit_apply(model, jax_tree(flat, dtype), jnp.asarray(x),
                             deterministic=True, update_stats=train, mutable=["spectral"])
    port.train(train)
    for m in port.modules():
        if isinstance(m, PortDefault.Dropout):
            m.p = 0.0
    assert_close(port(t(x, dtype)), y_j, dtype, "output")
    for i in (1, 2, 3):
        assert_close(getattr(port, f"sn{i}").u, upd["spectral"][f"sn{i}"]["u"], dtype, f"sn{i}.u")


def test_default_encoder_attention_spans_the_flattened_batch():
    """A change to one token moves every other token's output, on both
    sides: the [B*T, A] input is one sequence."""
    model, flat, port = default_pair(np.float32, 16, seed=7)
    x = np.random.RandomState(7).uniform(-1, 1, (N, A)).astype(np.float32)
    x2 = x.copy()
    x2[0] += 1.0
    tree = jax_tree(flat, np.float32)
    y1, y2 = (np.asarray(jit_apply(model, tree, jnp.asarray(v))) for v in (x, x2))
    port.eval()
    p1, p2 = (port(t(v, np.float32)).detach().numpy() for v in (x, x2))
    assert (np.abs(y1[1:] - y2[1:]).max(-1) > 1e-4).all()
    assert (np.abs(p1[1:] - p2[1:]).max(-1) > 1e-4).all()


def test_default_encoder_applies_dropout_0_1_in_training():
    """Each of the 12 dropouts (3 a layer) zeroes about 10 % of its input in
    training and scales the rest by 1 / 0.9; in eval it passes its input."""
    torch.manual_seed(0)
    port = PortDefault.DefaultActionEncoder(A, 64)
    seen = []
    drops = [m for m in port.modules() if isinstance(m, PortDefault.Dropout)]
    assert len(drops) == 12 and all(m.p == 0.1 for m in drops)
    for m in drops:
        m.register_forward_hook(lambda mod, inp, out: seen.append((inp[0], out)))
    x = torch.from_numpy(np.random.RandomState(8).uniform(-1, 1, (512, A)).astype(np.float32))
    port.train()(x)
    for inp, out in seen:
        live = inp != 0
        dropped = float(((out == 0) & live).sum() / live.sum())
        assert 0.08 < dropped < 0.12, dropped
        kept = (out != 0)
        torch.testing.assert_close(out[kept], inp[kept] / 0.9)
    seen.clear()
    port.eval()(x)
    assert all(torch.equal(inp, out) for inp, out in seen)


# ---------------------------------------------------------------------------
# LN-act: the Mamba block
# ---------------------------------------------------------------------------

def mamba_flat(variables, seed):
    _, flat = perturbed_variables(variables, seed)
    return with_noise(flat, ("A_log", "D"), seed)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d_state", [8, 16])
def test_mamba_block_matches_jax(dtype, d_state):
    model = JaxLnAct.MambaBlock(d_model=A, d_state=d_state)
    x = np.random.RandomState(d_state).randn(3, 16, A).astype(dtype)
    flat = mamba_flat(jit_init(model, (3, 16, A), seed=d_state), d_state)
    port = port_of(PortLnAct.MambaBlock(A, d_state=d_state), flat, dtype)
    assert port.A_log.shape == (2 * A, d_state)
    with precision(dtype):
        y_j = jit_apply(model, jax_tree(flat, dtype), jnp.asarray(x))
    assert_close(port(t(x, dtype)), y_j, dtype, "output")


@pytest.mark.parametrize("dtype", DTYPES)
def test_ln_act_encoder_matches_jax(dtype):
    model = JaxLnAct.LNActEncoder(action_dim=A, output_dim=OUT)
    x = np.random.RandomState(3).uniform(-1, 1, (4, 16, A)).astype(dtype)
    flat = mamba_flat(jit_init(model, (4, 16, A), seed=3), 3)
    port = port_of(PortLnAct.LNActEncoder(A, OUT), flat, dtype)
    with precision(dtype):
        y_j = jit_apply(model, jax_tree(flat, dtype), jnp.asarray(x))
    y_t = port(t(x, dtype))
    assert y_t.shape == (4 * 16, OUT)
    assert_close(y_t, y_j, dtype, "output")


def test_selective_scan_matches_the_float64_recurrence():
    rng = np.random.RandomState(0)
    b, steps, di, n = 2, 9, 5, 4
    u = rng.randn(b, steps, di)
    dt = np.abs(rng.randn(b, steps, di)) * 0.3
    a = -np.abs(rng.randn(di, n))
    bm, cm = rng.randn(b, steps, n), rng.randn(b, steps, n)
    d = rng.randn(di)
    h = np.zeros((b, di, n))
    want = np.zeros((b, steps, di))
    for s in range(steps):
        h = np.exp(dt[:, s, :, None] * a[None]) * h + (
            dt[:, s, :, None] * bm[:, s, None, :] * u[:, s, :, None])
        want[:, s] = np.einsum("bdn,bn->bd", h, cm[:, s]) + u[:, s] * d
    got = PortLnAct.selective_scan(*(torch.from_numpy(v) for v in (u, dt, a, bm, cm, d)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


def test_mamba_block_is_causal():
    torch.manual_seed(1)
    block = PortLnAct.MambaBlock(A, d_state=4).double()
    x = torch.from_numpy(np.random.RandomState(1).randn(1, 10, A))
    x2 = x.clone()
    x2[0, -1] += 10.0
    y1, y2 = block(x), block(x2)
    torch.testing.assert_close(y1[0, :-1], y2[0, :-1], rtol=0, atol=1e-12)
    assert not torch.allclose(y1[0, -1], y2[0, -1])


# ---------------------------------------------------------------------------
# FAST
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [1, 3, 9, 10, 11, 25, 64])
def test_resample_latents_equals_jax(d):
    latents = np.random.RandomState(d).randn(d, 8).astype(np.float32)
    got = PortFast.resample_latents(latents, 10)
    np.testing.assert_array_equal(got, JaxFast.resample_latents(latents, 10))
    assert got.shape == (10, 8)


def test_fast_host_encoder_equals_jax_on_the_stand_ins():
    acts = np.random.RandomState(0).randn(12, 4, A).astype(np.float32)
    got, want = (cls.from_components(SmokeFastProcessor(), smoke_clip_encode).encode_batch(
        acts, seq_len=8) for cls in (PortFast.FastHostEncoder, JaxFast.FastHostEncoder))
    assert got.shape == (12, 8, PortFast.CLIP_TEXT_DIM) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # both of resample_latents' branches ran
    counts = [len(SmokeFastProcessor()(a[None])[0]) for a in acts]
    assert min(counts) < 8 <= max(counts), counts


@pytest.mark.parametrize("dtype", DTYPES)
def test_fast_projection_matches_jax(dtype):
    model = JaxFast.FastProjection(output_dim=OUT)
    x = np.random.RandomState(1).randn(N, 512).astype(dtype)
    _, flat = perturbed_variables(jit_init(model, (N, 512), seed=1), 1)
    port = port_of(PortFast.FastProjection(OUT), flat, dtype)
    with precision(dtype):
        y_j = jit_apply(model, jax_tree(flat, dtype), jnp.asarray(x))
    assert_close(port(t(x, dtype)), y_j, dtype, "output")


def test_fast_host_encoder_from_directories_needs_transformers(monkeypatch):
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="transformers"):
        PortFast.FastHostEncoder("no-such-processor-dir")
