"""Parity of the port's equality-routing max pool (``ops/pool.py``) with the
JAX package's ``ops/pool.py``: the plain version of kernel 5 against the TPU
kernel ``max_pool_3x3_s2_bwd_pallas`` in interpret mode and against the JAX
``max_pool`` VJP, on the same seeded numpy inputs (NHWC for JAX, permuted to
the port's NCHW).

In fp32 and in bf16 the two agree bit for bit: on distinct values, after a
ReLU (whole windows tie at 0, and a tied cotangent goes to every tied cell,
so a cell sums up to four terms) and on planes of -inf (every cell equals
every covering window's maximum). In bf16 both add in bf16, rounding after
each add, in the same order, so there is nothing left to round differently.
Configurations off the routed one (odd H or W, other windows) take torch's
own gradient, as the JAX op takes XLA's; there the values are distinct, so
the two agree. The CUDA kernel is held against this plain version on the
card by tests/test_torch_kernels_cuda.py."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from robot_manipulation_vq_vae_tpu.ops import pool as JaxPool
from robot_manipulation_vq_vae_tpu.ops.pallas.pool_kernel import (
    max_pool_3x3_s2_bwd_pallas,
)

from robot_manipulation_vq_vae_tpu_torch.ops import pool as P
from robot_manipulation_vq_vae_tpu_torch.ops.cuda_build import LAUNCHES

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _input(shape, kind, seed):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    if kind == "relu":
        x = np.maximum(x - 0.25, 0.0)
    elif kind == "neginf":
        x[:, :, :, ::2] = -np.inf     # every other channel a plane of -inf
    return x


def _nchw(a, dtype):
    a = np.asarray(jnp.asarray(a).astype(jnp.float32))
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2))).to(dtype)


def _nhwc(t):
    return t.float().permute(0, 2, 3, 1).numpy()


def _jax_pair(x, dtype, seed):
    """(x, z, dz) in JAX's type, dz seeded."""
    xj = jnp.asarray(x, dtype)
    zj = JaxPool.max_pool_3x3_s2(xj)
    dz = np.random.RandomState(seed).randn(*zj.shape).astype(np.float32)
    return xj, zj, jnp.asarray(dz, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["distinct", "relu", "neginf"])
@pytest.mark.parametrize("shape", [(4, 58, 58, 64), (2, 16, 12, 8)])
def test_route_plain_matches_pallas_interpret_and_the_vjp(dtype, kind, shape):
    jdt, tdt = DTYPES[dtype]
    xj, zj, dzj = _jax_pair(_input(shape, kind, 0), jdt, 1)
    want = max_pool_3x3_s2_bwd_pallas(xj, zj, dzj, interpret=True)
    _, vjp = jax.vjp(JaxPool.max_pool_3x3_s2, xj)
    (want_vjp,) = vjp(dzj)
    np.testing.assert_array_equal(np.asarray(want_vjp), np.asarray(want))
    x, z, dz = (_nchw(a, tdt) for a in (xj, zj, dzj))
    np.testing.assert_array_equal(_nhwc(P.max_pool_3x3_s2(x)), np.asarray(zj, np.float32))
    got = P.pool_route_plain(x, z, dz)
    assert got.dtype == tdt
    np.testing.assert_array_equal(_nhwc(got), np.asarray(want, np.float32))


def test_relu_inputs_route_to_every_tied_cell():
    """After a ReLU, windows of zeros send their cotangent to each zero: more
    cells get gradient than under torch's first-maximum rule."""
    x = _nchw(_input((2, 16, 12, 8), "relu", 2), torch.float32).requires_grad_(True)
    g = torch.ones(2, 8, 8, 6)
    (dx,) = torch.autograd.grad(P.max_pool_3x3_s2(x), x, g)
    (dx_torch,) = torch.autograd.grad(F.max_pool2d(x, 3, 2, 1), x, g)
    assert dx.sum() > dx_torch.sum()
    assert int((dx != 0).sum()) > int((dx_torch != 0).sum())


@pytest.mark.parametrize("dtype", DTYPES)
def test_autograd_takes_the_plain_route_on_cpu_tensors(dtype):
    jdt, tdt = DTYPES[dtype]
    xj, zj, dzj = _jax_pair(_input((2, 10, 14, 8), "relu", 3), jdt, 4)
    x = _nchw(xj, tdt).requires_grad_(True)
    before = dict(LAUNCHES)
    out = P.max_pool_3x3_s2(x)
    (dx,) = torch.autograd.grad(out, x, _nchw(dzj, tdt))
    assert LAUNCHES == before   # CPU tensors take the plain versions
    assert out.dtype == dx.dtype == tdt
    _, vjp = jax.vjp(JaxPool.max_pool_3x3_s2, xj)
    np.testing.assert_array_equal(_nhwc(dx), np.asarray(vjp(dzj)[0], np.float32))


@pytest.mark.parametrize(
    "shape,window,strides,padding",
    [((2, 57, 59, 8), (3, 3), (2, 2), ((1, 1), (1, 1))),   # odd H and W
     ((2, 58, 57, 8), (3, 3), (2, 2), ((1, 1), (1, 1))),   # odd W
     ((2, 12, 12, 8), (2, 2), (2, 2), ((0, 0), (0, 0))),
     ((2, 12, 12, 8), (3, 3), (1, 1), ((1, 1), (1, 1))),
     ((2, 11, 12, 8), (3, 3), (2, 2), ((0, 1), (1, 0)))],  # asymmetric padding
)
def test_other_configurations_take_torchs_own_gradient(shape, window, strides, padding):
    """Distinct values: torch's gradient and XLA's (SelectAndScatter) route
    each cotangent to the one maximum, as the routing would."""
    x = _input(shape, "distinct", 5)
    xj = jnp.asarray(x)
    fwd = lambda a: JaxPool.max_pool(a, window, strides, padding)  # noqa: E731
    zj, vjp = jax.vjp(fwd, xj)
    dz = jnp.asarray(np.random.RandomState(6).randn(*zj.shape).astype(np.float32))
    xt = _nchw(x, torch.float32).requires_grad_(True)
    zt = P.max_pool(xt, window, strides, padding)
    assert not P.routes(xt, zt, window, strides, padding)
    np.testing.assert_array_equal(_nhwc(zt.detach()), np.asarray(zj))
    (dx,) = torch.autograd.grad(zt, xt, _nchw(dz, torch.float32))
    np.testing.assert_array_equal(_nhwc(dx), np.asarray(vjp(dz)[0]))


def test_routes_is_the_jax_test():
    x = torch.zeros(1, 1, 8, 6)
    z = torch.zeros(1, 1, 4, 3)
    assert P.routes(x, z, (3, 3), (2, 2), ((1, 1), (1, 1)))
    assert not P.routes(x, z, (3, 3), (2, 2), ((1, 0), (1, 1)))
    assert not P.routes(torch.zeros(1, 1, 7, 6), z, (3, 3), (2, 2), ((1, 1), (1, 1)))
