"""The stem pool's CUDA source (``csrc/stem_pool.cu``: kernel 3, the forward
with its recorded offsets, and kernel 4, the backward, each in fp32 and
bf16) compiled for the CPU with g++ against a host emulation of the CUDA it
uses (``tests/cuda_host_emulation.h``: a block's 256 threads are host
threads, ``__syncthreads`` a barrier, bf16 16 bits rounded to nearest even,
a misaligned 16-, 8- or 4-byte vector access a failed launch), and called
through the same C entry points and argument types as on the card. The
outputs are held to the bit against the plain versions and the JAX
package's ``ops/pool_argmax``: the plane runs' staging at every offset
modulo 16, the last block's ragged run of planes, the padding by index, the
tie order, and the band kernel of large planes (its plan, ragged last bands,
odd planes, misaligned bands, rows that need dynamic shared memory and rows
too wide for it). What only the card can show
(the compiler's code, the timing, races that a host schedule hides) stays
with tests/test_torch_kernels_cuda.py and ``chip_smoke.py``."""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robot_manipulation_vq_vae_tpu.ops import pool_argmax as oracle

from robot_manipulation_vq_vae_tpu_torch.ops import stem_pool as S
from robot_manipulation_vq_vae_tpu_torch.ops.cuda_build import CSRC_DIR, KERNELS

EMULATION = Path(__file__).resolve().parent / "cuda_host_emulation.h"
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def _host_source(src):
    """@src with its launches and its dynamic shared memory in the
    emulation's terms."""
    src = src.replace("extern __shared__ __align__(16) unsigned char smem[];",
                      "unsigned char* smem = reinterpret_cast<unsigned char*>(emu::dynamic_smem);")
    return re.sub(r"(\w+(?:<\w+>)?)<<<(.*?)>>>\((.*?)\);",
                  r"emu::launch(\2, [&] { \1(\3); });", src, flags=re.S)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """stem_pool.cu built for the host, its entry points typed as on the card."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel's source for the host")
    out = tmp_path_factory.mktemp("stem_pool_host")
    for header in ("cuda_runtime.h", "math_constants.h", "cuda_bf16.h"):
        (out / header).write_text(f'#include "{EMULATION}"\n')
    for header in KERNELS["stem_pool_fwd"][4]:   # the source's own headers
        shutil.copy(CSRC_DIR / header, out)
    cpp = out / "stem_pool.cpp"
    cpp.write_text(_host_source((CSRC_DIR / "stem_pool.cu").read_text()))
    so = out / "libstem_pool.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                    "-Wno-unknown-pragmas", f"-I{out}", "-o", str(so), str(cpp)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    for name, (source, entry, argtypes, _, _) in KERNELS.items():
        if source == "stem_pool.cu":
            fn = getattr(lib, entry)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
    lib.stem_pool_fwd_plan.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]
    return lib


def _plan(lib, planes, h, w, elem_bytes):
    """(planes per block, 0 on the band path; blocks; shared memory in bytes;
    a band's output rows, 0 on the plane-run path)"""
    plan = (ctypes.c_longlong * 4)()
    assert lib.stem_pool_fwd_plan(planes, h, w, elem_bytes, plan) == 0
    return tuple(plan)


def _suffix(dtype):
    return "" if dtype == torch.float32 else "_bf16"


def _forward(lib, x):
    """Kernel 3 as ``pool_fwd_cuda`` launches it, on outputs filled with
    garbage."""
    n, c, h, w = x.shape
    ho, wo = S.pooled_hw(h, w)
    out = torch.full((n, c, ho, wo), float("nan"), dtype=x.dtype)
    idx = torch.full((n, c, ho, wo), -1, dtype=torch.int8)
    fn = getattr(lib, f"stem_pool_fwd{_suffix(x.dtype)}_launch")
    assert fn(x.data_ptr(), n * c, h, w, out.data_ptr(), idx.data_ptr(), None) == 0
    return out, idx


def _backward(lib, idx, g, hw):
    n, c = g.shape[:2]
    dx = torch.full((n, c, *hw), float("nan"), dtype=g.dtype)
    fn = getattr(lib, f"stem_pool_bwd{_suffix(g.dtype)}_launch")
    assert fn(idx.data_ptr(), g.data_ptr(), n * c, *hw, dx.data_ptr(), None) == 0
    return dx


def _input(shape, kind, dtype, offset=0, seed=0):
    """ReLU'd randn - 0.25 (about 60 % zeros: windows tie) or all zeros (every
    window ties), as a contiguous view @offset elements into its buffer."""
    n = int(np.prod(shape))
    vals = np.random.RandomState(seed).randn(n + offset).astype(np.float32)
    buf = torch.from_numpy(np.maximum(vals - 0.25, 0.0) if kind == "relu" else 0.0 * vals)
    x = buf.to(dtype)[offset:].view(shape)
    assert x.is_contiguous() and x.data_ptr() % 16 == (offset * x.element_size()) % 16
    return x


def _assert_forward_exact(x, out, idx):
    out_p, idx_p = S.pool_fwd_plain(x)
    assert torch.equal(out, out_p)
    assert torch.equal(idx, idx_p)
    y = jnp.asarray(x.float().permute(0, 2, 3, 1).numpy()).astype(
        jnp.float32 if x.dtype == torch.float32 else jnp.bfloat16)
    out_j, idx_j = oracle.pool_argmax_forward(y)
    np.testing.assert_array_equal(out.float().permute(0, 2, 3, 1).numpy(),
                                  np.asarray(out_j, np.float32))
    np.testing.assert_array_equal(idx.permute(0, 2, 3, 1).numpy().astype(np.int32),
                                  np.asarray(idx_j, np.int32))


# (shape, element offset of the view): the stem's 58 x 58 (2 planes a block
# in fp32, 4 in bf16); odd H or W; 1 x 1, 6 x 2 and 3 x 1 planes (hundreds a
# block); 5 planes, a multiple of neither 2 nor 4, so the last block takes
# fewer; the same at views 1 and 3 elements into their buffers, so that the
# runs' heads and tails take every length
_FORWARD_CASES = [((2, 3, 58, 58), 0), ((3, 2, 57, 59), 0), ((2, 3, 1, 1), 0),
                  ((1, 3, 6, 2), 0), ((2, 3, 3, 1), 0), ((1, 5, 58, 58), 0),
                  ((1, 5, 58, 58), 1), ((1, 5, 58, 58), 3), ((3, 2, 57, 59), 1)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["relu", "zeros"])
@pytest.mark.parametrize("shape,offset", _FORWARD_CASES)
def test_host_forward_matches_plain_and_jax(lib, shape, offset, kind, dtype):
    x = _input(shape, kind, DTYPES[dtype], offset)
    assert _plan(lib, shape[0] * shape[1], *shape[2:], x.element_size())[0] > 0
    _assert_forward_exact(x, *_forward(lib, x))


@pytest.mark.parametrize("dtype", DTYPES)
def test_host_forward_takes_the_tile_kernel_past_the_budget(lib, dtype):
    """A 100 x 160 plane does not fit a block's 40 KB with its outputs in
    either type: the band kernel (which took over the tile kernel's planes)
    takes it, one output row a band for the 512 blocks that one plane
    cannot give, bit-equal as well, at a misaligned view too."""
    shape = (1, 1, 100, 160)
    x = _input(shape, "relu", DTYPES[dtype], offset=1, seed=3)
    per_block, blocks, _, rows = _plan(lib, 1, 100, 160, x.element_size())
    assert (per_block, blocks, rows) == (0, 50, 1)   # 50 bands of 1 output row
    _assert_forward_exact(x, *_forward(lib, x))


# (shape, element offset of the view, input), past the budget in both types:
# odd H and W (101 x 163: 51 bands of a row, the last one's bottom padding
# row decided by index); 20 such planes (2 rows a band for 520 blocks, so
# the last band of each plane has 1 row), each band at its own offset modulo
# 16 (163 is odd), at views 1 and 3 elements into their buffers; a row too
# wide for one band of a row in 40 KB (5 x 7001: dynamic shared memory,
# about 102 KB in fp32 and 53 KB in bf16); and about the widest row the
# band kernel takes in fp32 (3 x 16001: 232,096 of 232,448 B)
_BAND_CASES = [((1, 1, 101, 163), 0, "relu"), ((1, 1, 101, 163), 0, "zeros"),
               ((1, 1, 101, 163), 3, "relu"), ((1, 20, 101, 163), 1, "relu"),
               ((1, 20, 101, 163), 3, "zeros"), ((1, 1, 5, 7001), 0, "relu"),
               ((1, 1, 5, 7001), 1, "zeros"), ((1, 1, 3, 16001), 0, "relu"),
               ((1, 1, 3, 16001), 3, "zeros")]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,offset,kind", _BAND_CASES)
def test_host_band_forward_matches_plain_and_jax(lib, shape, offset, kind, dtype):
    x = _input(shape, kind, DTYPES[dtype], offset, seed=4)
    per_block, blocks, smem, rows = _plan(lib, shape[0] * shape[1], *shape[2:],
                                          x.element_size())
    ho = S.pooled_hw(*shape[2:])[0]
    assert per_block == 0 and blocks == shape[1] * -(-ho // rows)
    assert (smem > 48 * 1024) == (shape[3] > 5000)   # past the static 48 KB
    if shape[1] == 20:
        assert rows == 2 and ho % rows == 1          # a ragged last band
    _assert_forward_exact(x, *_forward(lib, x))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["relu", "zeros"])
def test_host_band_forward_at_r3m_planes(lib, kind, dtype):
    """R3M's stem planes at small N: [1, 2, 112, 112] in fp32 (in bf16 a
    112 x 112 plane fits a block whole, so bf16 takes bands from about
    160 x 160: [1, 2, 160, 160]), one output row a band."""
    shape = (1, 2, 112, 112) if dtype == "fp32" else (1, 2, 160, 160)
    x = _input(shape, kind, DTYPES[dtype], seed=5)
    assert _plan(lib, 2, *shape[2:], x.element_size())[::3] == (0, 1)
    assert _plan(lib, 2, 112, 112, 2)[::3] == (1, 0)   # bf16 112 x 112: whole planes
    _assert_forward_exact(x, *_forward(lib, x))


def test_host_band_plan_at_the_r3m_stem(lib):
    """fp32 [N, 64, 112, 112]: 34 output rows fit 40 KB, so 2 bands of 28 a
    plane at N = 16 and 100 (2,048 and 12,800 blocks); at N = 1 bands of 7
    rows give the 512 blocks (15 input rows staged for 14). bf16 takes one
    whole plane a block."""
    assert _plan(lib, 64, 112, 112, 4) == (0, 512, 6736 + 1584 + 416, 7)
    assert _plan(lib, 16 * 64, 112, 112, 4) == (0, 2048, 25552 + 6288 + 1584, 28)
    assert _plan(lib, 100 * 64, 112, 112, 4) == (0, 12800, 33424, 28)
    assert _plan(lib, 100 * 64, 112, 112, 2)[:2] == (1, 6400)


@pytest.mark.parametrize("dtype", DTYPES)
def test_host_band_plan_refuses_rows_too_wide(lib, dtype):
    """A row whose band of one output row (3 input rows, their maxima and
    offsets) passes 227 KB: the plan returns cudaErrorInvalidValue, and the
    launcher returns it too, having launched nothing."""
    elem = 4 if dtype == "fp32" else 2
    widest, wider = (16001, 16100) if dtype == "fp32" else (30900, 31000)
    assert _plan(lib, 1, 3, widest, elem)[2] <= 232448
    plan = (ctypes.c_longlong * 4)()
    assert lib.stem_pool_fwd_plan(1, 3, wider, elem, plan) == 1   # cudaErrorInvalidValue
    x = _input((1, 1, 3, wider), "relu", DTYPES[dtype])
    out = torch.full((1, 1, 2, wider // 2), float("nan"), dtype=x.dtype)
    idx = torch.full(out.shape, -1, dtype=torch.int8)
    fn = getattr(lib, f"stem_pool_fwd{_suffix(x.dtype)}_launch")
    assert fn(x.data_ptr(), 1, 3, wider, out.data_ptr(), idx.data_ptr(), None) == 1
    assert out.isnan().all() and (idx == -1).all()



def test_host_forward_plan_at_the_stem(lib):
    """The stem's [N, 64, 58, 58]: 2 planes a block in fp32 and 4 in bf16,
    16,384 blocks at both timed shapes, within 48 KB of shared memory."""
    fp32 = _plan(lib, 512 * 64, 58, 58, 4)
    bf16 = _plan(lib, 1024 * 64, 58, 58, 2)
    assert fp32[:2] == (2, 16384) and bf16[:2] == (4, 16384)
    assert fp32[2] == (26912 + 16) + (6728 + 8 + 16) + (1682 + 14 + 16)
    assert max(fp32[2], bf16[2]) <= 48 * 1024 and fp32[3] == bf16[3] == 0
    assert _plan(lib, 1024 * 64, 58, 58, 4)[:2] == (2, 32768)
    plan = (ctypes.c_longlong * 3)()
    assert lib.stem_pool_fwd_plan(4, 0, 5, 4, plan) != 0
    assert lib.stem_pool_fwd_plan(4, 5, 5, 8, plan) != 0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 3, 58, 58), (3, 2, 57, 59), (2, 3, 1, 1),
                                   (1, 3, 6, 2), (1, 2, 100, 240)])
def test_host_backward_matches_plain(lib, shape, dtype):
    """Kernel 4 from the plain offsets of ReLU'd inputs (ties): dx bit-equal,
    with pair stores (W even) and scalar ones (W odd), one block a plane and,
    at 100 x 240, bands of window rows."""
    x = _input(shape, "relu", DTYPES[dtype], seed=1)
    _, idx = S.pool_fwd_plain(x)
    g = torch.from_numpy(np.random.RandomState(2).randn(*idx.shape).astype(np.float32))
    g = g.to(x.dtype)
    dx = _backward(lib, idx, g, shape[2:])
    assert torch.equal(dx, S.pool_bwd_plain(idx, g, shape[2:]))


_PROBE = """#include <cuda_runtime.h>
__global__ void copy16(const unsigned char* src, unsigned char* dst) {
  *reinterpret_cast<uint4*>(dst) = __ldg(reinterpret_cast<const uint4*>(src));
}
extern "C" int probe(const unsigned char* src, unsigned char* dst) {
  copy16<<<1, 1, 0, nullptr>>>(src, dst);
  return static_cast<int>(cudaGetLastError());
}
"""


def test_host_emulation_refuses_misaligned_vectors(lib, tmp_path):
    """The emulation's alignment check is live: a 16-byte copy whose source
    or destination is off a 16-byte boundary fails its launch, as on the
    card, so the tests above hold the kernel's staging to real alignment."""
    (tmp_path / "cuda_runtime.h").write_text(f'#include "{EMULATION}"\n')
    (tmp_path / "probe.cpp").write_text(_host_source(_PROBE))
    subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                    f"-I{tmp_path}", "-o", str(tmp_path / "probe.so"),
                    str(tmp_path / "probe.cpp")], check=True, capture_output=True)
    probe = ctypes.CDLL(str(tmp_path / "probe.so")).probe
    probe.argtypes, probe.restype = [ctypes.c_void_p, ctypes.c_void_p], ctypes.c_int
    buf = torch.zeros(64, dtype=torch.uint8)
    base = buf.data_ptr() + (-buf.data_ptr()) % 16
    assert probe(base, base + 32) == 0
    for src, dst in ((base + 4, base + 32), (base, base + 40), (base + 1, base + 33)):
        assert probe(src, dst) == 716   # cudaErrorMisalignedAddress
