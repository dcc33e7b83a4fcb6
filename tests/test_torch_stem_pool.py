"""Parity of the port's stem-pool pair (``ops/stem_pool.py``) with the JAX
package: the plain versions of kernels 3 and 4 against the Pallas kernels in
interpret mode and the ``ops/pool_argmax`` formulation, ties included, on the
same seeded numpy inputs (NHWC for JAX, permuted to the port's NCHW); the
autograd pair against ``F.max_pool2d``'s gradient; and the LipVQ assign's
backward (``L2Nearest``) against ``jax.grad`` through the Pallas kernel's
custom VJP. The CUDA kernels are held against these plain versions on the
card by tests/test_torch_kernels_cuda.py."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from robot_manipulation_vq_vae_tpu.ops import pool_argmax as oracle
from robot_manipulation_vq_vae_tpu.ops.pallas import stem_pool as pallas
from robot_manipulation_vq_vae_tpu.ops.pallas.lipvq_kernel import l2_nearest_pallas

from robot_manipulation_vq_vae_tpu_torch.ops import stem_pool as S
from robot_manipulation_vq_vae_tpu_torch.ops.cuda_build import LAUNCHES
from robot_manipulation_vq_vae_tpu_torch.ops.lipvq_kernel import l2_nearest
from torch_port_helpers import assert_margin


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _assert_forward_equal(y, out_t, idx_t, out_j, idx_j):
    np.testing.assert_array_equal(_nhwc(out_t), np.asarray(out_j))
    np.testing.assert_array_equal(_nhwc(idx_t).astype(np.int32),
                                  np.asarray(idx_j, np.int32))


@pytest.mark.parametrize("shape", [(4, 58, 58, 64), (2, 8, 8, 64)])
def test_forward_plain_matches_pallas_interpret(shape):
    y = _rand(shape, 0)
    out_j, idx_j = pallas.pool_fwd_pallas(jnp.asarray(y), interpret=True)
    out_t, idx_t = S.pool_fwd_plain(_nchw(y))
    assert idx_t.dtype == torch.int8
    _assert_forward_equal(y, out_t, idx_t, out_j, idx_j)


@pytest.mark.parametrize("shape", [(2, 57, 59, 64), (3, 5, 2, 8), (1, 1, 1, 4)])
def test_forward_plain_matches_pool_argmax_at_odd_shapes(shape):
    y = _rand(shape, 1)
    out_j, idx_j = oracle.pool_argmax_forward(jnp.asarray(y))
    out_t, idx_t = S.pool_fwd_plain(_nchw(y))
    _assert_forward_equal(y, out_t, idx_t, out_j, idx_j)
    np.testing.assert_array_equal(out_t.numpy(), F.max_pool2d(_nchw(y), 3, 2, 1).numpy())


@pytest.mark.parametrize("fill", ["ones", "zeros", "relu"])
def test_forward_ties_record_the_first_maximum(fill):
    """Constant planes tie every window; after a ReLU about half the cells
    are 0 and whole windows tie at 0. The first maximum in row-major window
    order wins, as in the Pallas kernel and torch."""
    if fill == "relu":
        y = np.maximum(_rand((2, 16, 16, 64), 2) - 0.3, 0.0).astype(np.float32)
    else:
        y = np.full((1, 8, 8, 64), 1.0 if fill == "ones" else 0.0, np.float32)
    out_j, idx_j = pallas.pool_fwd_pallas(jnp.asarray(y), interpret=True)
    out_t, idx_t = S.pool_fwd_plain(_nchw(y))
    _assert_forward_equal(y, out_t, idx_t, out_j, idx_j)
    _, idx_o = oracle.pool_argmax_forward(jnp.asarray(y))
    np.testing.assert_array_equal(_nhwc(idx_t).astype(np.int32), np.asarray(idx_o))
    if fill != "relu":
        # window (0, 0): offsets 0, 1 and 3 fall on the padding
        assert int(idx_t[0, 0, 0, 0]) == 4


@pytest.mark.parametrize("shape", [(4, 58, 58, 64), (2, 8, 8, 64)])
def test_backward_plain_matches_pallas_interpret(shape):
    y = _rand(shape, 3)
    ho, wo = S.pooled_hw(shape[1], shape[2])
    g = _rand((shape[0], ho, wo, shape[3]), 4)
    _, idx_j = pallas.pool_fwd_pallas(jnp.asarray(y), interpret=True)
    dx_j = pallas.pool_bwd_pallas(idx_j, jnp.asarray(g), interpret=True)
    _, idx_t = S.pool_fwd_plain(_nchw(y))
    dx_t = S.pool_bwd_plain(idx_t, _nchw(g), shape[1:3])
    np.testing.assert_allclose(_nhwc(dx_t), np.asarray(dx_j), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", [(2, 57, 59, 16), (3, 6, 7, 8)])
def test_backward_plain_matches_pool_argmax_at_odd_shapes(shape):
    y = np.maximum(_rand(shape, 5), 0.0).astype(np.float32)   # ties at 0
    ho, wo = S.pooled_hw(shape[1], shape[2])
    g = _rand((shape[0], ho, wo, shape[3]), 6)
    _, idx_o = oracle.pool_argmax_forward(jnp.asarray(y))
    dx_o = oracle.pool_argmax_backward(idx_o, jnp.asarray(g), shape[1:3])
    _, idx_t = S.pool_fwd_plain(_nchw(y))
    dx_t = S.pool_bwd_plain(idx_t, _nchw(g), shape[1:3])
    np.testing.assert_allclose(_nhwc(dx_t), np.asarray(dx_o), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", [(2, 4, 58, 58), (2, 3, 9, 12)])
def test_autograd_pair_matches_max_pool2d_gradient(shape):
    """Without ties, and with integer cotangents so that every sum is exact
    in any order, the gradient equals F.max_pool2d's bit for bit."""
    x = torch.from_numpy(_rand(shape, 7)).requires_grad_(True)
    ho, wo = S.pooled_hw(*shape[2:])
    g = torch.from_numpy(np.random.RandomState(8).randint(-8, 9, (*shape[:2], ho, wo))
                         .astype(np.float32))
    before = dict(LAUNCHES)
    out = S.max_pool_3x3_s2(x)
    (dx,) = torch.autograd.grad(out, x, g)
    (dx_ref,) = torch.autograd.grad(F.max_pool2d(x, 3, 2, 1), x, g)
    assert LAUNCHES == before   # CPU tensors take the plain versions
    np.testing.assert_array_equal(out.detach().numpy(),
                                  F.max_pool2d(x, 3, 2, 1).detach().numpy())
    np.testing.assert_array_equal(dx.numpy(), dx_ref.numpy())


def test_lipvq_backward_matches_jax_grad_through_pallas():
    """d codebook = segment_sum of the z_q cotangent by code; z gets none."""
    rng = np.random.RandomState(9)
    cb = rng.randn(64, 24).astype(np.float32)
    z = (cb[rng.randint(0, 64, 70)] + 0.1 * rng.randn(70, 24)).astype(np.float32)
    w = rng.randn(70, 24).astype(np.float32)
    assert_margin(z, cb, 1e-4)

    def loss(zz, c):
        _, z_q = l2_nearest_pallas(zz, c, 64, True)
        return jnp.sum(z_q * w) + jnp.sum(z_q ** 2)

    g_z, g_cb = jax.grad(loss, argnums=(0, 1))(jnp.asarray(z), jnp.asarray(cb))
    zt = torch.from_numpy(z).requires_grad_(True)
    cbt = torch.from_numpy(cb).requires_grad_(True)
    idx, z_q = l2_nearest(zt, cbt)
    ((z_q * torch.from_numpy(w)).sum() + (z_q ** 2).sum()).backward()
    assert zt.grad is None
    assert not np.asarray(g_z).any()
    assert not idx.requires_grad
    np.testing.assert_allclose(cbt.grad.numpy(), np.asarray(g_cb), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# bf16: the flagship's mixed-precision stem pools bf16 activations
# ---------------------------------------------------------------------------

def _bf16(a):
    return jnp.asarray(a, jnp.bfloat16)


def _nchw_bf16(a):
    return _nchw(np.asarray(jnp.asarray(a).astype(jnp.float32))).bfloat16()


def _f32(t):
    return _nhwc(t.float())


@pytest.mark.parametrize("fill", ["randn", "relu"])
def test_bf16_forward_matches_pallas_interpret_and_pool_argmax(fill):
    """The maximum of bf16 values is exact: maxima and offsets bit-equal."""
    y = _rand((4, 58, 58, 64), 10)
    if fill == "relu":
        y = np.maximum(y - 0.25, 0.0)
    yj = _bf16(y)
    out_j, idx_j = pallas.pool_fwd_pallas(yj, interpret=True)
    out_o, idx_o = oracle.pool_argmax_forward(yj)
    out_t, idx_t = S.pool_fwd_plain(_nchw_bf16(yj))
    assert out_t.dtype == torch.bfloat16 and idx_t.dtype == torch.int8
    for out, idx in ((out_j, idx_j), (out_o, idx_o)):
        np.testing.assert_array_equal(_f32(out_t), np.asarray(out, np.float32))
        np.testing.assert_array_equal(_nhwc(idx_t).astype(np.int32),
                                      np.asarray(idx, np.int32))


def test_bf16_backward_adds_in_fp32_and_rounds_once():
    """The plain backward sums a cell's routed gradients in fp32 and rounds
    once to bf16, as the TPU kernel does (``stem_pool.py:115``, ``:140``):
    bit-equal to it in interpret mode, and to ``pool_argmax_backward`` run in
    fp32 and rounded once. ``pool_argmax_backward`` run in bf16 rounds after
    each of its adds instead; it differs only on cells that four windows
    cover (odd row and column, the only cells with more than two terms), by
    the extra roundings of the partial sums: at most 2^-6 max|g|."""
    y = np.maximum(_rand((4, 58, 58, 64), 11) - 0.25, 0.0)
    yj = _bf16(y)
    g = _bf16(_rand((4, 29, 29, 64), 12))
    _, idx_j = pallas.pool_fwd_pallas(yj, interpret=True)
    want = pallas.pool_bwd_pallas(idx_j, g, interpret=True)
    _, idx_o = oracle.pool_argmax_forward(yj)
    want_f32 = oracle.pool_argmax_backward(idx_o, g.astype(jnp.float32), (58, 58))
    want_bf16 = np.asarray(oracle.pool_argmax_backward(idx_o, g, (58, 58)), np.float32)
    _, idx_t = S.pool_fwd_plain(_nchw_bf16(yj))
    got = S.pool_bwd_plain(idx_t, _nchw_bf16(g), (58, 58))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_f32(got), np.asarray(want, np.float32))
    np.testing.assert_array_equal(
        _f32(got), np.asarray(want_f32.astype(jnp.bfloat16), np.float32))
    differ = _f32(got) != want_bf16
    assert differ.any() and not differ[:, 0::2].any() and not differ[:, :, 0::2].any()
    bound = 2.0 ** -6 * float(np.abs(np.asarray(g, np.float32)).max())
    assert np.abs(_f32(got) - want_bf16).max() <= bound


def test_bf16_autograd_pair_matches_max_pool2d():
    x = torch.from_numpy(np.maximum(_rand((2, 8, 20, 22), 13), 0)).bfloat16()
    x.requires_grad_(True)
    out = S.max_pool_3x3_s2(x)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out, F.max_pool2d(x, 3, 2, 1), rtol=0, atol=0)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(3)).bfloat16()
    (dx,) = torch.autograd.grad(out, x, g)
    _, idx = S.pool_fwd_plain(x.detach())
    assert dx.dtype == torch.bfloat16
    torch.testing.assert_close(dx, S.pool_bwd_plain(idx, g, (20, 22)), rtol=0, atol=0)
