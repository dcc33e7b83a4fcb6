"""The two LipVQ CUDA kernels' own sources (``csrc/lipvq_assign.cu``,
``csrc/lipvq_roundtrip.cu``) compiled for the CPU with g++ against a host
emulation of the CUDA they use (``tests/cuda_host_emulation.h``: a block's
256 threads are host threads, ``__syncthreads`` a barrier), and called
through the same C entry points and argument types as on the card. They are
held against their plain versions and the JAX package: the tile product's
indexing, swizzle, staging and barriers, the tie and merge order at both
tile widths and with codebook splits, and the roundtrip's stages at ragged
widths. What only the card can show (the compiler's code, the timing, races
that a host schedule hides) stays with tests/test_torch_kernels_cuda.py and
``chip_smoke.py``."""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robot_manipulation_vq_vae_tpu.ops import quantize as Q

from robot_manipulation_vq_vae_tpu_torch.models.tokenizers.lipvq import LipVQVAE
from robot_manipulation_vq_vae_tpu_torch.ops import lipvq_kernel as K
from robot_manipulation_vq_vae_tpu_torch.ops.cuda_build import CSRC_DIR, KERNELS

EMULATION = Path(__file__).resolve().parent / "cuda_host_emulation.h"


def _host_source(src):
    """@src with its launches and its dynamic shared memory in the
    emulation's terms."""
    src = src.replace("extern __shared__ __align__(16) float smem[];",
                      "float* smem = emu::dynamic_smem;")
    return re.sub(r"(\w+(?:<[^<>]*>)?)<<<(.*?)>>>\((.*?)\);",
                  r"emu::launch(\2, [&] { \1(\3); });", src, flags=re.S)


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    """name -> the kernel's C entry point, built for the host."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernels' sources for the host")
    out = tmp_path_factory.mktemp("lipvq_host")
    for header in ("cuda_runtime.h", "math_constants.h"):
        (out / header).write_text(f'#include "{EMULATION}"\n')
    shutil.copy(CSRC_DIR / "lipvq_assign_core.cuh", out)
    fns, libs = {}, {}
    for name in ("lipvq_assign", "lipvq_assign_bf16", "lipvq_roundtrip"):
        source, entry, argtypes, _, _ = KERNELS[name]
        if source not in libs:
            cpp = out / source.replace(".cu", ".cpp")
            cpp.write_text(_host_source((CSRC_DIR / source).read_text()))
            lib = out / f"lib{cpp.stem}.so"
            subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                            "-Wno-unknown-pragmas", f"-I{out}", "-o", str(lib), str(cpp)],
                           check=True, capture_output=True)
            libs[source] = ctypes.CDLL(str(lib))
        fn = getattr(libs[source], entry)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[name] = fn
    return fns


def _assign(fn, z, cb, sms):
    """The assign kernel's launch as ``l2_nearest_cuda`` makes it, for a card
    of @sms SMs."""
    n, d = z.shape
    k = cb.shape[0]
    c_sq = (cb * cb).sum(-1)
    width, splits, per_split = K._assign_splits(n, k, sms)
    idx = torch.full((n,), -1, dtype=torch.int32)
    z_q = torch.full_like(z, float("nan"))
    part_v = torch.empty(splits, n)
    part_i = torch.empty(splits, n, dtype=torch.int32)
    err = fn(z.data_ptr(), cb.data_ptr(), c_sq.data_ptr(), n, d, k, width, splits,
             per_split, idx.data_ptr(), z_q.data_ptr(),
             part_v.data_ptr() if splits > 1 else None,
             part_i.data_ptr() if splits > 1 else None, None)
    assert err == 0
    return idx, z_q


def _exact_inputs(n, k, d, seed=5):
    """Small integers: every distance is exact in fp32 in any order."""
    rng = np.random.RandomState(seed)
    return (torch.from_numpy(rng.randint(-3, 4, (n, d)).astype(np.float32)),
            torch.from_numpy(rng.randint(-3, 4, (k, d)).astype(np.float32)))


# (N, D, K, SM count): the plan (tile width, codebook splits) in the comment
@pytest.mark.parametrize("n,d,k,sms", [
    (16, 976, 1024, 132),   # 64, 16: the B = 1 request's shape
    (300, 210, 1030, 132),  # 64, 17
    (200, 37, 1024, 3),     # 128, 2
    (130, 1, 300, 1),       # 128, 1
    (1000, 3, 50, 132),     # 64, 1
    (77, 212, 256, 1),      # 128, 1: D not a multiple of 4
])
def test_host_assign_kernel_matches_plain_and_jax(host_kernels, n, d, k, sms):
    z, cb = _exact_inputs(n, k, d)
    idx, z_q = _assign(host_kernels["lipvq_assign"], z, cb, sms)
    idx_p, _ = K.l2_nearest_plain(z, cb)
    idx_x, _ = Q.l2_nearest(jnp.asarray(z.numpy()), jnp.asarray(cb.numpy()))
    np.testing.assert_array_equal(idx.numpy(), idx_p.numpy())
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_x))
    assert torch.equal(z_q, cb[idx.long()])


@pytest.mark.parametrize("n,sms", [(100, 132), (300, 3)])
@pytest.mark.parametrize("period", [2, 64])
def test_host_assign_kernel_keeps_the_first_index_on_a_tie(host_kernels, n, sms, period):
    """Code k repeats at k + period, ... over K = 256: exact ties inside one
    thread's columns, across threads, tiles and splits, at width 64 (4
    splits) and 128 (2 splits)."""
    z, base = _exact_inputs(n, period, 48)
    cb = base.repeat(256 // period, 1)
    idx, _ = _assign(host_kernels["lipvq_assign"], z, cb, sms)
    idx_p, _ = K.l2_nearest_plain(z, cb)
    assert int(idx.max()) < period
    np.testing.assert_array_equal(idx.numpy(), idx_p.numpy())


def _assign_bf16(fn, z, cb, sms):
    """The bf16 instance's launch as ``l2_nearest_cuda`` makes it: a bf16
    codebook, z fp32, c_sq over the upcast codebook."""
    n, d = z.shape
    k = cb.shape[0]
    c_sq = (cb.float() * cb.float()).sum(-1)
    width, splits, per_split = K._assign_splits(n, k, sms)
    idx = torch.full((n,), -1, dtype=torch.int32)
    z_q = torch.full_like(z, float("nan"))
    part_v = torch.empty(splits, n)
    part_i = torch.empty(splits, n, dtype=torch.int32)
    err = fn(z.data_ptr(), cb.data_ptr(), c_sq.data_ptr(),
             n, d, k, width, splits, per_split, idx.data_ptr(), z_q.data_ptr(),
             part_v.data_ptr() if splits > 1 else None,
             part_i.data_ptr() if splits > 1 else None, None)
    assert err == 0
    return idx, z_q


# kernel 1's bf16 instance: the bf16 codebook read as it lies (8-byte vector
# loads where D is a multiple of 4, else one element at a time) against an
# fp32 z, on exact inputs (small integers: every distance exact in any order)
@pytest.mark.parametrize("n,d,k,sms", [
    (16, 976, 1024, 132),   # 64, 16: the B = 1 request's shape
    (200, 37, 1024, 3),     # 128, 2, D not a multiple of 4
    (77, 212, 256, 1),      # 128, 1
    (300, 210, 1030, 132),  # 64, 17
    (512, 976, 1024, 132),  # 64, 16: the bf16 paper step's shape
    (130, 100, 300, 1),     # 128, 1: a ragged last row tile and code tile
])
def test_host_assign_bf16_kernel_matches_plain_and_pallas(host_kernels, n, d, k, sms):
    from robot_manipulation_vq_vae_tpu.ops.pallas.lipvq_kernel import l2_nearest_pallas

    z, cb = _exact_inputs(n, k, d)
    cb = cb.to(torch.bfloat16)
    idx, z_q = _assign_bf16(host_kernels["lipvq_assign_bf16"], z, cb, sms)
    idx_p, zq_p = K.l2_nearest_plain(z, cb)
    idx_x, zq_x = l2_nearest_pallas(jnp.asarray(z.numpy()),
                                    jnp.asarray(cb.float().numpy()).astype(jnp.bfloat16),
                                    512, True)
    np.testing.assert_array_equal(idx.numpy(), idx_p.numpy())
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_x))
    assert z_q.dtype == torch.float32 and torch.equal(z_q, zq_p)
    np.testing.assert_array_equal(z_q.float().numpy(), np.asarray(zq_x, np.float32))


def test_host_assign_bf16_kernel_reads_unaligned_views(host_kernels):
    """z and the codebook one element into their storage: no vector load,
    and the same codes."""
    z, cb = _exact_inputs(70, 100, 64)
    zo = torch.cat([torch.zeros(1), z.flatten()])[1:].view(70, 64)
    cbb = torch.cat([torch.zeros(1), cb.flatten()]).to(torch.bfloat16)[1:].view(100, 64)
    idx, z_q = _assign_bf16(host_kernels["lipvq_assign_bf16"], zo, cbb, 3)
    idx_p, zq_p = K.l2_nearest_plain(zo, cbb)
    np.testing.assert_array_equal(idx.numpy(), idx_p.numpy())
    assert torch.equal(z_q, zq_p)


def _roundtrip(fn, x, w):
    (w1, b1), (w2, b2) = w["enc_w"]
    wl, bl = w["lip_w"]
    cb = w["codebook"]
    (w3, b3), (w4, b4), (w5, b5) = w["dec_w"]
    n, in_dim = x.shape
    out_dim = w5.shape[1]
    c_sq = (cb * cb).sum(-1)
    recon = torch.full((n, out_dim), float("nan"))
    idx = torch.full((n,), -1, dtype=torch.int32)
    err = fn(x.data_ptr(), n, in_dim, w1.data_ptr(), b1.data_ptr(), w1.shape[1],
             w2.data_ptr(), b2.data_ptr(), w2.shape[1], wl.data_ptr(), bl.data_ptr(),
             wl.shape[1], cb.data_ptr(), c_sq.data_ptr(), cb.shape[0], w3.data_ptr(),
             b3.data_ptr(), w4.data_ptr(), b4.data_ptr(), w5.data_ptr(), b5.data_ptr(),
             out_dim, recon.data_ptr(), idx.data_ptr(), None)
    return err, recon, idx


def _odd_weights(gen):
    """in 7, h1 33, H 100, L 37, K 100, out 7: every staged row is ragged."""
    def dense(i, o):
        return (torch.randn(i, o, generator=gen) / i ** 0.5,
                0.1 * torch.randn(o, generator=gen))

    return dict(enc_w=(dense(7, 33), dense(33, 100)), lip_w=dense(100, 37),
                codebook=torch.rand(100, 37, generator=gen),
                dec_w=(dense(37, 33), dense(33, 100), dense(100, 7)))


# the tokenizer's widths with weights ~N(0, 0.5^2) as in chip_smoke.py, the
# kernel's width limits (h1 64, H 128, L 256, out 16, K = 1030), and ragged
# widths; each at an N that is not a multiple of 64
@pytest.mark.parametrize("case", ["tokenizer", "limits", "ragged"])
def test_host_roundtrip_kernel_matches_plain(host_kernels, case):
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        if case == "ragged":
            w, feature = _odd_weights(gen), 7
        else:
            feature, latent, codes = (12, 210, 1024) if case == "tokenizer" else (16, 256, 1030)
            model = LipVQVAE(feature, latent, num_codes=codes)
            if case == "tokenizer":
                for p in model.parameters():
                    p.copy_(0.5 * torch.randn(p.shape, generator=gen))
            w = model.fused_weights()
        x = torch.randn(130, feature, generator=gen)
        err, recon, idx = _roundtrip(host_kernels["lipvq_roundtrip"], x, w)
        recon_p, idx_p = K.lipvq_roundtrip_plain(x, **w)
    assert err == 0
    np.testing.assert_array_equal(idx.numpy(), idx_p.numpy())
    rel = ((recon - recon_p).abs() / recon_p.abs().clamp_min(1.0)).max()
    assert float(rel) <= 1e-4


def test_host_roundtrip_refuses_widths_past_its_limits(host_kernels):
    gen = torch.Generator().manual_seed(3)
    w = _odd_weights(gen)
    w["enc_w"] = (w["enc_w"][0], (torch.randn(33, 129, generator=gen), torch.zeros(129)))
    err, _, _ = _roundtrip(host_kernels["lipvq_roundtrip"], torch.randn(5, 7, generator=gen), w)
    assert err != 0
