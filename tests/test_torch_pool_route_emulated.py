"""Kernel 5's CUDA source (``csrc/pool_route.cu``: the equality-routing
backward of the 3x3 / stride-2 / pad-1 max pool, in fp32 and bf16) compiled
for the CPU with g++ against a host emulation of the CUDA it uses
(``tests/cuda_host_emulation.h``: a block's 256 threads are host threads,
``__syncthreads`` a barrier, bf16 16 bits rounded to nearest even, a
misaligned 16-byte vector access a failed launch), and called through the
same C entry points and argument types as on the card. dx is held to the bit
against the plain version and the JAX package's TPU kernel
(``max_pool_3x3_s2_bwd_pallas`` in interpret mode), on the same seeded numpy
inputs (NHWC for JAX, permuted to the port's NCHW): the staged plane runs at
every offset modulo 16, the last block's short run of planes, tiny and
narrow planes, the border by index, the term order of tied cells, and the row
kernel of planes past a block's budget. What only the card can show (the
compiler's code, the timing, races that a host schedule hides) stays with
tests/test_torch_kernels_cuda.py and ``chip_smoke.py``."""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from robot_manipulation_vq_vae_tpu.ops.pallas.pool_kernel import (
    max_pool_3x3_s2_bwd_pallas,
)

from robot_manipulation_vq_vae_tpu_torch.ops import pool as P
from robot_manipulation_vq_vae_tpu_torch.ops.cuda_build import CSRC_DIR, KERNELS
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

EMULATION = Path(__file__).resolve().parent / "cuda_host_emulation.h"
DTYPES = {"fp32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _host_source(src):
    """@src with its launches and its dynamic shared memory in the
    emulation's terms."""
    src = src.replace("extern __shared__ __align__(16) unsigned char smem[];",
                      "unsigned char* smem = reinterpret_cast<unsigned char*>(emu::dynamic_smem);")
    return re.sub(r"(\w+(?:<\w+>)?)<<<(.*?)>>>\((.*?)\);",
                  r"emu::launch(\2, [&] { \1(\3); });", src, flags=re.S)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """pool_route.cu built for the host, its entry points typed as on the card."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel's source for the host")
    out = tmp_path_factory.mktemp("pool_route_host")
    for header in ("cuda_runtime.h", "cuda_bf16.h"):
        (out / header).write_text(f'#include "{EMULATION}"\n')
    for header in KERNELS["pool_route"][4]:   # the source's own headers
        shutil.copy(CSRC_DIR / header, out)
    cpp = out / "pool_route.cpp"
    cpp.write_text(_host_source((CSRC_DIR / "pool_route.cu").read_text()))
    so = out / "libpool_route.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                    "-Wno-unknown-pragmas", f"-I{out}", "-o", str(so), str(cpp)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    for name, (source, entry, argtypes, _, _) in KERNELS.items():
        if source == "pool_route.cu":
            fn = getattr(lib, entry)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
    lib.pool_route_plan.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]
    return lib


def _plan(lib, planes, h, w, elem_bytes):
    plan = (ctypes.c_longlong * 3)()
    assert lib.pool_route_plan(planes, h, w, elem_bytes, plan) == 0
    return tuple(plan)


def _route(lib, x, z, dz):
    """Kernel 5 as ``pool_route_cuda`` launches it, into a dx of garbage."""
    n, c, h, w = x.shape
    dx = torch.full_like(x, float("nan"))
    suffix = "" if x.dtype == torch.float32 else "_bf16"
    fn = getattr(lib, f"pool_route{suffix}_launch")
    assert fn(x.data_ptr(), z.data_ptr(), dz.data_ptr(), n * c, h, w,
              dx.data_ptr(), None) == 0
    return dx


def _view(t, offset):
    """@t as a contiguous view @offset elements into a buffer of its own."""
    buf = torch.full((t.numel() + offset,), float("nan"), dtype=t.dtype)
    v = buf[offset:].view(t.shape)
    v.copy_(t)
    assert v.is_contiguous() and v.data_ptr() % 16 == (offset * v.element_size()) % 16
    return v


def _inputs(shape, kind, dtype, seed=0):
    """Seeded numpy x (NHWC, as JAX takes it), its pool z and a seeded dz,
    in @dtype: distinct values, ReLU'd randn - 0.25 (about 60 % zeros, so
    whole windows tie at 0) or every other channel a plane of -inf (every
    cell equals every window over it)."""
    n, c, h, w = shape
    rng = np.random.RandomState(seed)
    x = rng.randn(n, h, w, c).astype(np.float32)
    if kind == "relu":
        x = np.maximum(x - 0.25, 0.0)
    elif kind == "neginf":
        x[..., ::2] = -np.inf
    tdt, jdt = DTYPES[dtype]
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().to(tdt)
    zt = F.max_pool2d(xt.float(), 3, 2, 1).to(tdt)   # exact: the max of its cells
    dz = rng.randn(n, h // 2, w // 2, c).astype(np.float32)
    dzt = torch.from_numpy(dz).permute(0, 3, 1, 2).contiguous().to(tdt)
    return xt, zt, dzt


def _assert_exact(dx, x, z, dz):
    want = P.pool_route_plain(x, z, dz)
    assert dx.dtype == want.dtype
    assert torch.equal(dx, want)

    def nhwc(t):
        return jnp.asarray(t.float().permute(0, 2, 3, 1).numpy()).astype(
            jnp.float32 if t.dtype == torch.float32 else jnp.bfloat16)

    jax_dx = max_pool_3x3_s2_bwd_pallas(nhwc(x), nhwc(z), nhwc(dz), interpret=True)
    np.testing.assert_array_equal(dx.float().permute(0, 2, 3, 1).numpy(),
                                  np.asarray(jax_dx, np.float32))


# (shape, element offsets of x, z and dz): the stem's 58 x 58 in 1, 3 and 5
# planes (a block takes 2 in fp32 and 4 in bf16, so the last block is
# short); 2 x 2, 6 x 8 and 2 x 130 planes (one window row; many planes a
# block); x, z and dz as views 1, 3 and 7 elements into their buffers, so
# that each run's head and tail take other lengths and x's offset modulo 16
# differs from dx's
_CASES = [((1, 1, 58, 58), (0, 0, 0)), ((1, 3, 58, 58), (0, 0, 0)),
          ((1, 5, 58, 58), (0, 0, 0)), ((2, 3, 2, 2), (0, 0, 0)),
          ((1, 3, 6, 8), (0, 0, 0)), ((3, 1, 2, 130), (0, 0, 0)),
          ((1, 5, 58, 58), (1, 1, 1)), ((1, 3, 58, 58), (3, 3, 3)),
          ((1, 5, 58, 58), (7, 7, 7)), ((1, 3, 6, 8), (1, 3, 7)),
          ((3, 1, 2, 130), (7, 3, 1))]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["relu", "distinct", "neginf"])
@pytest.mark.parametrize("shape,offsets", _CASES)
def test_host_route_matches_plain_and_jax(lib, shape, offsets, kind, dtype):
    x, z, dz = _inputs(shape, kind, dtype)
    assert _plan(lib, shape[0] * shape[1], *shape[2:], x.element_size())[0] > 0
    xv, zv, dzv = (_view(t, o) for t, o in zip((x, z, dz), offsets))
    _assert_exact(_route(lib, xv, zv, dzv), x, z, dz)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["relu", "distinct"])
def test_host_route_takes_the_row_kernel_past_the_budget(lib, kind, dtype):
    """A 208 x 208 plane's runs do not fit a block's 40 KB in either type:
    the row kernel takes it, bit-equal as well, at a misaligned view too."""
    shape = (1, 1, 208, 208)
    x, z, dz = _inputs(shape, kind, dtype, seed=3)
    per_block, blocks, smem = _plan(lib, 1, 208, 208, x.element_size())
    assert (per_block, blocks, smem) == (0, 208 // 8, 0)   # a warp per input row
    _assert_exact(_route(lib, _view(x, 1), _view(z, 3), dz), x, z, dz)


def test_host_route_plan_at_the_stem(lib):
    """The stem's [3072, 64, 58, 58]: x, z and dz of 2 planes a block in
    fp32 and 4 in bf16, within 40 KB of shared memory."""
    fp32 = _plan(lib, 3072 * 64, 58, 58, 4)
    bf16 = _plan(lib, 3072 * 64, 58, 58, 2)
    assert fp32 == (2, 98304, (26912 + 16) + 2 * (6728 + 8 + 16))
    assert bf16 == (4, 49152, fp32[2])
    assert fp32[2] <= 40960
    assert _plan(lib, 5, 58, 58, 4)[:2] == (2, 3)
    assert _plan(lib, 1, 2, 2, 4)[:2] == (1, 1)
    plan = (ctypes.c_longlong * 3)()
    for args in ((4, 7, 8, 4), (4, 8, 0, 4), (4, 8, 8, 8), (2**31, 224, 224, 4)):
        assert lib.pool_route_plan(*args, plan) != 0
