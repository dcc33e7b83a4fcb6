"""The port's CUDA kernels against their plain PyTorch versions on the card
(``cuda`` marker: they skip where there is none), and the wrappers' device
rule: the two LipVQ kernels (the assign in fp32 and its bf16 instance) and
the assign's backward (``L2Nearest``), the
stem pool's forward and backward in fp32 and bf16, and the equality-routing
pool backward (kernel 5) in fp32 and bf16. This file imports neither JAX nor
the JAX package, so that it runs on a machine with only PyTorch:

    RMVQ_TESTS_ON_TPU=1 python -m pytest tests/test_torch_kernels_cuda.py

(the variable keeps the repository's conftest from importing JAX)."""

import pytest
import torch
import torch.nn.functional as F

from robot_manipulation_vq_vae_tpu_torch.models.tokenizers.lipvq import LipVQVAE
from robot_manipulation_vq_vae_tpu_torch.ops import lipvq_kernel as K
from robot_manipulation_vq_vae_tpu_torch.ops import pool as P
from robot_manipulation_vq_vae_tpu_torch.ops import stem_pool as S
from robot_manipulation_vq_vae_tpu_torch.ops.cuda_build import LAUNCHES


@pytest.fixture
def cuda_device():
    """The card; decided at run time, never while the module is imported."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels run only there")
    return torch.device("cuda")


def _near_code_inputs(n, k, d, device):
    """Rows near random codes: far from every Voronoi boundary."""
    gen = torch.Generator().manual_seed(5)
    cb = torch.randn(k, d, generator=gen)
    z = cb[torch.randint(0, k, (n,), generator=gen)] + 0.1 * torch.randn(n, d, generator=gen)
    return z.to(device), cb.to(device)


def test_wrappers_take_the_plain_version_on_cpu_tensors():
    z, cb = _near_code_inputs(20, 32, 8, "cpu")
    before = dict(LAUNCHES)
    idx, zq = K.l2_nearest_cuda(z, cb)
    idx_p, zq_p = K.l2_nearest_plain(z, cb)
    assert LAUNCHES == before
    assert idx.dtype == torch.int32
    torch.testing.assert_close(idx, idx_p, rtol=0, atol=0)
    torch.testing.assert_close(zq, zq_p, rtol=0, atol=0)


def _exact_inputs(n, k, d, device, seed=5):
    """Small integers: every distance is exact in fp32 whatever the order of
    the sums, so codes of equal distance tie exactly and the first index must
    win, in the kernel as in the plain version."""
    gen = torch.Generator().manual_seed(seed)
    cb = torch.randint(-3, 4, (k, d), generator=gen).float()
    z = torch.randint(-3, 4, (n, d), generator=gen).float()
    return z.to(device), cb.to(device)


# (inputs, N, D, K): the tile width and the codebook splits that
# _assign_splits takes for each on an H100's 132 SMs are in the comments
_ASSIGN_CASES = [
    ("near", 16, 976, 1024),     # 64 codes, 16 splits
    ("near", 300, 210, 1024),    # 64, 16
    ("near", 65, 37, 1024),      # 64, 16
    ("near", 512, 976, 1024),    # 64, 16
    ("near", 4096, 37, 1024),    # 128, 4
    ("near", 4224, 37, 1024),    # 128, 4
    ("near", 16896, 37, 1024),   # 128, 1
    ("exact", 300, 37, 100),     # 64, 2
    ("exact", 300, 210, 1030),   # 64, 17
    ("exact", 20000, 37, 1030),  # 128, 1
    ("exact", 300, 3, 1024),     # 64, 16
    ("exact", 4224, 1, 1024),    # 128, 4
    ("exact", 16896, 3, 100),    # 128, 1
    ("exact", 1000, 3, 50),      # 64, 1
]


@pytest.mark.cuda
@pytest.mark.parametrize("inputs,n,d,k", _ASSIGN_CASES)
def test_assign_kernel_matches_plain(cuda_device, inputs, n, d, k):
    make = _near_code_inputs if inputs == "near" else _exact_inputs
    z, cb = make(n, k, d, cuda_device)
    before = LAUNCHES["lipvq_assign"]
    idx_k, zq_k = K.l2_nearest_cuda(z, cb)
    torch.cuda.synchronize()
    assert LAUNCHES["lipvq_assign"] == before + 1
    idx_p, _ = K.l2_nearest_plain(z, cb)
    torch.testing.assert_close(idx_k, idx_p, rtol=0, atol=0)
    torch.testing.assert_close(zq_k, cb[idx_k.long()], rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("n,width", [(100, 64), (8448, 128)])
@pytest.mark.parametrize("period", [2, 64])
def test_assign_kernel_keeps_the_first_index_on_a_tie(cuda_device, n, width, period):
    """Code k repeats at k + period, k + 2 period, ... over K = 256: exact
    ties inside one thread's columns (k and k + 2; k and k + 64 at width
    128), across threads (k + 4), across code tiles and across splits (the
    codebook is split in 4 ranges at width 64 and 2 at width 128)."""
    z, base = _exact_inputs(n, period, 48, cuda_device)
    cb = base.repeat(256 // period, 1)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert K._assign_splits(n, 256, sms)[0] == width
    idx, zq = K.l2_nearest_cuda(z, cb)
    idx_p, _ = K.l2_nearest_plain(z, cb)
    assert int(idx.max()) < period
    torch.testing.assert_close(idx, idx_p, rtol=0, atol=0)
    torch.testing.assert_close(zq, cb[idx.long()], rtol=0, atol=0)


def _check_roundtrip(rec_k, idx_k, rec_p, idx_p):
    """Codes equal on at least 99.9 % of the rows (near ties may flip); recon
    within 1e-4 on the rows whose codes agree."""
    same = idx_k == idx_p
    assert same.float().mean() >= 0.999
    torch.testing.assert_close(rec_k[same], rec_p[same], rtol=0, atol=1e-4)


@pytest.mark.cuda
# the tokenizer's widths at an N that is not a multiple of 64, and the
# kernel's width limits (h1 64, H 128, L 256, out 16) with K = 1030
@pytest.mark.parametrize("n,feature,latent,codes", [(1000, 12, 210, 1024),
                                                    (4097, 16, 256, 1030)])
def test_roundtrip_kernel_matches_plain(cuda_device, n, feature, latent, codes):
    gen = torch.Generator().manual_seed(1)
    model = LipVQVAE(feature, latent, num_codes=codes)
    x = torch.randn(n, feature, generator=gen).to(cuda_device)
    model.to(cuda_device)
    before = LAUNCHES["lipvq_roundtrip"]
    with torch.no_grad():
        rec_k, idx_k = model.roundtrip_fused(x)
        rec_p, idx_p = K.lipvq_roundtrip_plain(x, **model.fused_weights())
    assert LAUNCHES["lipvq_roundtrip"] == before + 1
    _check_roundtrip(rec_k, idx_k, rec_p, idx_p)


@pytest.mark.cuda
def test_roundtrip_kernel_takes_widths_that_are_not_multiples_of_4(cuda_device):
    """in 7, h1 33, H 100, L 37, K 100, out 7: every staged weight row is
    ragged and takes the scalar loads."""
    gen = torch.Generator().manual_seed(2)

    def dense(i, o):
        return (torch.randn(i, o, generator=gen) / i ** 0.5,
                0.1 * torch.randn(o, generator=gen))

    w = dict(enc_w=(dense(7, 33), dense(33, 100)), lip_w=dense(100, 37),
             codebook=torch.rand(100, 37, generator=gen),
             dec_w=(dense(37, 33), dense(33, 100), dense(100, 7)))
    x = torch.randn(130, 7, generator=gen)
    rec_p, idx_p = K.lipvq_roundtrip_plain(x, **w)

    def to_card(v):
        return tuple(map(to_card, v)) if isinstance(v, tuple) else v.to(cuda_device)

    rec_k, idx_k = K.lipvq_roundtrip_cuda(
        x.to(cuda_device), **{key: to_card(v) for key, v in w.items()})
    _check_roundtrip(rec_k.cpu(), idx_k.cpu(), rec_p, idx_p)


@pytest.mark.cuda
def test_kernel_path_refuses_gradients_and_bad_inputs(cuda_device):
    """The raw launches are forward only (autograd goes through L2Nearest and
    MaxPool3x3S2) and take fp32, contiguous tensors of matching shapes."""
    cb = torch.randn(64, 16, device=cuda_device, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward only"):
        K.l2_nearest_cuda(torch.randn(8, 16, device=cuda_device), cb)
    with pytest.raises(TypeError):
        K.l2_nearest_cuda(torch.randn(8, 16, device=cuda_device).double(),
                          cb.detach().double())
    with pytest.raises(ValueError):
        K.l2_nearest_cuda(torch.randn(8, 15, device=cuda_device), cb.detach())
    x = torch.randn(2, 4, 9, 9, device=cuda_device)
    with pytest.raises(RuntimeError, match="forward only"):
        S.pool_fwd_cuda(x.clone().requires_grad_(True))
    with pytest.raises(ValueError, match="contiguous"):
        S.pool_fwd_cuda(x.permute(0, 1, 3, 2))
    with pytest.raises(TypeError):
        S.pool_fwd_cuda(x.double())
    _, idx = S.pool_fwd_cuda(x)
    with pytest.raises(ValueError):
        S.pool_bwd_cuda(idx, torch.randn(2, 4, 5, 5, device=cuda_device), (11, 11))
    with pytest.raises(TypeError):
        S.pool_bwd_cuda(idx.int(), torch.randn(2, 4, 5, 5, device=cuda_device), (9, 9))


@pytest.mark.cuda
def test_l2_nearest_backward_matches_plain_autograd(cuda_device):
    """The codebook's gradient through L2Nearest (the kernel forward, an
    index_add_ backward) against autograd through the plain gather; z gets
    none."""
    z, cb = _near_code_inputs(512, 1024, 976, cuda_device)
    w = torch.randn_like(z)
    zk, cbk = z.clone().requires_grad_(True), cb.clone().requires_grad_(True)
    before = LAUNCHES["lipvq_assign"]
    _, zq = K.l2_nearest(zk, cbk)
    (zq * w).sum().backward()
    assert LAUNCHES["lipvq_assign"] == before + 1
    cbp = cb.clone().requires_grad_(True)
    idx_p, _ = K.l2_nearest_plain(z, cb)
    (cbp[idx_p.long()] * w).sum().backward()
    assert zk.grad is None
    torch.testing.assert_close(cbk.grad, cbp.grad, rtol=0, atol=1e-5)


def _check_bf16_assign(z, cb, idx_k, zq_k):
    """Kernel 1's bf16 instance against the plain version: the codes equal
    off near ties (where they differ, the two codes' distances, in float64
    from the upcast operands, within 1e-5 of each other, relatively), and
    z_q the code's own value, in fp32, to the bit."""
    idx_p, _ = K.l2_nearest_plain(z, cb)
    diff = (idx_k != idx_p).nonzero().squeeze(1)
    if len(diff):
        z64, cb64 = z[diff].double(), cb.double()
        d_k = ((z64 - cb64[idx_k[diff].long()]) ** 2).sum(-1)
        d_p = ((z64 - cb64[idx_p[diff].long()]) ** 2).sum(-1)
        gap = (d_k - d_p).abs() / d_p.abs().clamp_min(1e-30)
        assert float(gap.max()) <= 1e-5, float(gap.max())
    assert len(diff) <= max(1, len(z) // 1000)
    assert zq_k.dtype == torch.float32
    assert torch.equal(zq_k, cb[idx_k.long()].float())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [256, 320, 512, 65536])
def test_assign_bf16_kernel_matches_plain(cuda_device, n):
    """The bf16 codebook and an fp32 z, as the mixed-precision step gives
    them, at the paper's D = 976, K = 1024: sigmoid-range latents, as
    LipVQ's z_e is."""
    gen = torch.Generator().manual_seed(6)
    cb = (torch.rand(1024, 976, generator=gen) * 1.6 - 0.3).bfloat16().to(cuda_device)
    z = torch.rand(n, 976, generator=gen).to(cuda_device)
    before = LAUNCHES["lipvq_assign_bf16"]
    idx_k, zq_k = K.l2_nearest_cuda(z, cb)
    torch.cuda.synchronize()
    assert LAUNCHES["lipvq_assign_bf16"] == before + 1
    _check_bf16_assign(z, cb, idx_k, zq_k)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,k", [(300, 37, 1030), (8448, 48, 256), (100, 976, 1024)])
def test_assign_bf16_kernel_exact_inputs_and_ties(cuda_device, n, d, k):
    """Small integers (exact in bf16 and in every fp32 sum): the codes to
    the bit, the first index on the ties of a repeating codebook."""
    z, base = _exact_inputs(n, 64, d, cuda_device)
    cb = base.repeat(-(-k // 64), 1)[:k].bfloat16()
    idx, zq = K.l2_nearest_cuda(z, cb)
    idx_p, zq_p = K.l2_nearest_plain(z, cb)
    assert int(idx.max()) < 64
    assert torch.equal(idx, idx_p) and torch.equal(zq, zq_p)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 3])
def test_assign_bf16_kernel_takes_misaligned_views(cuda_device, offset):
    z, cb = _exact_inputs(70, 100, 64, cuda_device)
    zo = torch.cat([torch.zeros(offset, device=cuda_device), z.flatten()])
    cbb = torch.cat([torch.zeros(offset, device=cuda_device), cb.flatten()]).bfloat16()
    zo, cbb = zo[offset:].view(70, 64), cbb[offset:].view(100, 64)
    idx, zq = K.l2_nearest_cuda(zo, cbb)
    idx_p, zq_p = K.l2_nearest_plain(zo, cbb)
    assert torch.equal(idx, idx_p) and torch.equal(zq, zq_p)


@pytest.mark.cuda
def test_assign_bf16_backward_on_the_card(cuda_device):
    """The codebook's gradient through the bf16 instance: the fp32 cotangent
    (fp32 z, as in the paper step) summed by ``index_add_``, whose fp32
    atomics add in any order, then rounded once to the codebook's bf16."""
    gen = torch.Generator().manual_seed(8)
    cb = torch.rand(1024, 976, generator=gen).bfloat16().to(cuda_device)
    z = torch.rand(512, 976, generator=gen).to(cuda_device)
    w = torch.randn(512, 976, generator=gen).to(cuda_device)
    cbk = cb.clone().requires_grad_(True)
    before = LAUNCHES["lipvq_assign_bf16"]
    idx, zq = K.l2_nearest(z, cbk)
    (zq * w).sum().backward()
    assert LAUNCHES["lipvq_assign_bf16"] == before + 1
    want = torch.zeros(1024, 976).index_add_(0, idx.cpu().long(), w.cpu())
    assert cbk.grad.dtype == torch.bfloat16
    torch.testing.assert_close(cbk.grad.float().cpu(), want, rtol=2 ** -8, atol=1e-6)


def _relu_input(shape, device, seed):
    """~60 % zeros after the ReLU: whole windows tie at 0."""
    gen = torch.Generator().manual_seed(seed)
    return torch.relu(torch.randn(shape, generator=gen) - 0.25).to(device)


# the backward's edges: H or W of 1, 2 and 3; both odd; one odd; planes
# larger than one staged tile (bands of window rows: [1, 2, 130, 258], 24
# rows a band in fp32 and 41 in bf16; bands of rows and columns: W = 7001 and
# 16001); each on ReLU'd inputs and on zeros, where every interior window
# records offset 0
_POOL_EDGE_SHAPES = [(64, 64, 58, 58), (2, 64, 57, 59), (3, 5, 1, 2), (2, 3, 1, 1),
                     (2, 3, 2, 2), (2, 3, 3, 3), (2, 3, 1, 7), (2, 3, 6, 2), (2, 3, 3, 8),
                     (2, 4, 58, 57), (2, 4, 57, 58), (2, 3, 40, 130), (1, 2, 130, 258),
                     (1, 2, 131, 259), (1, 1, 5, 7001), (1, 1, 3, 16001)]


def _pool_input(shape, kind, device, seed):
    return torch.zeros(shape, device=device) if kind == "zeros" else _relu_input(
        shape, device, seed)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["relu", "zeros"])
@pytest.mark.parametrize("shape", _POOL_EDGE_SHAPES)
def test_stem_pool_kernels_match_plain(cuda_device, shape, kind):
    """Maxima and offsets bit-equal, ties included; dx bit-equal too (the
    kernel adds a cell's routed gradients in the plain version's order)."""
    x = _pool_input(shape, kind, cuda_device, 1)
    before = dict(LAUNCHES)
    out_k, idx_k = S.pool_fwd_cuda(x)
    torch.cuda.synchronize()
    assert LAUNCHES["stem_pool_fwd"] == before["stem_pool_fwd"] + 1
    out_p, idx_p = S.pool_fwd_plain(x)
    torch.testing.assert_close(out_k, out_p, rtol=0, atol=0)
    torch.testing.assert_close(idx_k, idx_p, rtol=0, atol=0)
    torch.testing.assert_close(out_k, F.max_pool2d(x, 3, 2, 1), rtol=0, atol=0)
    g = torch.randn(out_k.shape, generator=torch.Generator().manual_seed(2)).to(cuda_device)
    dx_k = S.pool_bwd_cuda(idx_k, g, shape[2:])
    torch.cuda.synchronize()
    assert LAUNCHES["stem_pool_bwd"] == before["stem_pool_bwd"] + 1
    torch.testing.assert_close(dx_k, S.pool_bwd_plain(idx_p, g, shape[2:]), rtol=0, atol=0)


@pytest.mark.cuda
def test_stem_pool_autograd_runs_both_kernels(cuda_device):
    x = _relu_input((4, 64, 58, 58), cuda_device, 3).requires_grad_(True)
    before = dict(LAUNCHES)
    out = S.max_pool_3x3_s2(x)
    g = torch.randn_like(out)
    (dx,) = torch.autograd.grad(out, x, g)
    assert LAUNCHES["stem_pool_fwd"] == before["stem_pool_fwd"] + 1
    assert LAUNCHES["stem_pool_bwd"] == before["stem_pool_bwd"] + 1
    out_p = S.max_pool_3x3_s2(x, use_kernel=False)
    (dx_p,) = torch.autograd.grad(out_p, x, g)
    torch.testing.assert_close(dx, dx_p, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["relu", "zeros"])
@pytest.mark.parametrize("shape", _POOL_EDGE_SHAPES)
def test_stem_pool_bf16_kernels_match_plain(cuda_device, shape, kind):
    """bf16: maxima and offsets bit-equal; dx bit-equal (both add in fp32 in
    the same order and round once)."""
    x = _pool_input(shape, kind, cuda_device, 4).bfloat16()
    before = dict(LAUNCHES)
    out_k, idx_k = S.pool_fwd_cuda(x)
    g = torch.randn(out_k.shape, generator=torch.Generator().manual_seed(5)).to(
        cuda_device).bfloat16()
    dx_k = S.pool_bwd_cuda(idx_k, g, shape[2:])
    torch.cuda.synchronize()
    assert LAUNCHES["stem_pool_fwd_bf16"] == before["stem_pool_fwd_bf16"] + 1
    assert LAUNCHES["stem_pool_bwd_bf16"] == before["stem_pool_bwd_bf16"] + 1
    assert LAUNCHES["stem_pool_fwd"] == before["stem_pool_fwd"]
    out_p, idx_p = S.pool_fwd_plain(x)
    assert out_k.dtype == dx_k.dtype == torch.bfloat16
    torch.testing.assert_close(out_k, out_p, rtol=0, atol=0)
    torch.testing.assert_close(idx_k, idx_p, rtol=0, atol=0)
    torch.testing.assert_close(dx_k, S.pool_bwd_plain(idx_p, g, shape[2:]), rtol=0, atol=0)


# the stems of the bf16 training steps: ICLMamba_GMM's 32 x 10 frames a
# group, BC_Transformer's 100 x 10, the diffusion policy's 100 x 2, 10 x 10
# windows of BC_Transformer on the other cores, and R3M's stem in bf16 at its
# request and training N (runs of whole bf16 planes)
_BF16_STEP_SHAPES = [(320, 64, 58, 58), (1000, 64, 58, 58), (200, 64, 58, 58),
                     (100, 64, 58, 58), (1, 64, 112, 112), (16, 64, 112, 112),
                     (100, 64, 112, 112)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", _BF16_STEP_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_stem_pool_bf16_at_the_bf16_step_shapes(cuda_device, shape):
    """Kernels 3 and 4 in bf16 at the bf16 steps' stems, on ReLU'd inputs
    (ties): one launch each, on runs of whole planes; maxima, offsets and dx
    bit-equal to the plain versions."""
    x = _pool_input(shape, "relu", cuda_device, 8).bfloat16()
    assert S.pool_fwd_plan(shape, torch.bfloat16)[0] > 0
    before = dict(LAUNCHES)
    out_k, idx_k = S.pool_fwd_cuda(x)
    g = torch.randn(out_k.shape, generator=torch.Generator().manual_seed(9)).to(
        cuda_device).bfloat16()
    dx_k = S.pool_bwd_cuda(idx_k, g, shape[2:])
    torch.cuda.synchronize()
    assert LAUNCHES["stem_pool_fwd_bf16"] == before["stem_pool_fwd_bf16"] + 1
    assert LAUNCHES["stem_pool_bwd_bf16"] == before["stem_pool_bwd_bf16"] + 1
    out_p, idx_p = S.pool_fwd_plain(x)
    torch.testing.assert_close(out_k, out_p, rtol=0, atol=0)
    torch.testing.assert_close(idx_k, idx_p, rtol=0, atol=0)
    torch.testing.assert_close(dx_k, S.pool_bwd_plain(idx_p, g, shape[2:]), rtol=0, atol=0)


# R3M's stem ([N, 64, 112, 112], a 224 x 224 input): in fp32 a plane's input,
# maxima and offsets (65,856 B) pass a block's budget and the launcher takes
# the band kernel; in bf16 (34,496 B) one plane fits a block, and a 160 x 160
# plane takes the bf16 band kernel
_R3M_STEM = (4, 64, 112, 112)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["relu", "zeros"])
@pytest.mark.parametrize("dtype,shape,per_block", [
    (torch.float32, _R3M_STEM, 0), (torch.bfloat16, _R3M_STEM, 1),
    (torch.bfloat16, (2, 64, 160, 160), 0)], ids=["fp32_r3m", "bf16_r3m", "bf16_160"])
def test_stem_pool_tile_path_at_the_r3m_stem(cuda_device, dtype, shape, per_block, kind):
    """Kernel 3 at R3M's stem, through the launcher's band kernel (which took
    over the tile kernel's planes) where a plane passes a block's budget:
    maxima and offsets bit-equal to the plain version, ties included, and
    kernel 4's dx from them too."""
    x = _pool_input(shape, kind, cuda_device, 6).to(dtype)
    plan = S.pool_fwd_plan(shape, dtype)
    assert plan[0] == per_block and (plan[3] > 0) == (per_block == 0)   # 0: bands
    out_k, idx_k = S.pool_fwd_cuda(x)
    out_p, idx_p = S.pool_fwd_plain(x)
    torch.testing.assert_close(out_k, out_p, rtol=0, atol=0)
    torch.testing.assert_close(idx_k, idx_p, rtol=0, atol=0)
    g = torch.randn(out_k.shape, generator=torch.Generator().manual_seed(7)).to(
        cuda_device, dtype)
    torch.testing.assert_close(S.pool_bwd_cuda(idx_k, g, shape[2:]),
                               S.pool_bwd_plain(idx_p, g, shape[2:]), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("n,rows,blocks", [(1, 7, 512), (16, 28, 2048), (100, 28, 12800)])
def test_stem_pool_band_kernel_at_the_r3m_shapes(cuda_device, n, rows, blocks):
    """fp32 [N, 64, 112, 112] at R3M's request and training N: the plan's
    bands (7 output rows at N = 1 for 512 blocks, 2 of 28 a plane at N = 16
    and 100), one launch, maxima and offsets bit-equal on ReLU'd inputs."""
    shape = (n, 64, 112, 112)
    x = _relu_input(shape, cuda_device, 11)
    per_block, n_blocks, _, n_rows = S.pool_fwd_plan(shape, torch.float32)
    assert (per_block, n_blocks, n_rows) == (0, blocks, rows)
    before = LAUNCHES["stem_pool_fwd"]
    out_k, idx_k = S.pool_fwd_cuda(x)
    torch.cuda.synchronize()
    assert LAUNCHES["stem_pool_fwd"] == before + 1
    out_p, idx_p = S.pool_fwd_plain(x)
    assert torch.equal(out_k, out_p) and torch.equal(idx_k, idx_p)
    assert torch.equal(out_k, F.max_pool2d(x, 3, 2, 1))


# past the budget in both types: odd H and W, one band of a row each (101 x
# 163), 20 such planes (2 rows a band, a ragged last band), views 1 and 3
# elements in (each band at its own offset modulo 16), a row that needs
# dynamic shared memory past 48 KB (5 x 7001), and about the widest fp32
# row (3 x 16001: 232,096 B)
_BAND_CASES = [((1, 1, 101, 163), 0), ((1, 1, 101, 163), 3), ((1, 20, 101, 163), 1),
               ((2, 20, 101, 163), 3), ((1, 1, 5, 7001), 1), ((1, 1, 3, 16001), 0),
               ((1, 1, 3, 16001), 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["relu", "zeros"])
@pytest.mark.parametrize("shape,offset", _BAND_CASES)
def test_stem_pool_band_kernel_edges(cuda_device, shape, offset, kind, dtype):
    n = torch.Size(shape).numel()
    buf = _pool_input((n + offset,), kind, cuda_device, 12).to(dtype)
    x = buf[offset:].view(shape)
    assert S.pool_fwd_plan(shape, dtype)[0] == 0
    out_k, idx_k = S.pool_fwd_cuda(x)
    torch.cuda.synchronize()
    out_p, idx_p = S.pool_fwd_plain(x)
    torch.testing.assert_close(out_k, out_p, rtol=0, atol=0)
    torch.testing.assert_close(idx_k, idx_p, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,w", [(torch.float32, 16100), (torch.bfloat16, 31000)])
def test_stem_pool_band_kernel_refuses_rows_too_wide(cuda_device, dtype, w):
    """A row whose band of one output row passes 227 KB: a ValueError that
    names the width, and no launch."""
    x = torch.zeros(1, 1, 3, w, device=cuda_device, dtype=dtype)
    name = "stem_pool_fwd" if dtype == torch.float32 else "stem_pool_fwd_bf16"
    before = LAUNCHES[name]
    with pytest.raises(ValueError, match=f"W = {w}"):
        S.pool_fwd_cuda(x)
    assert LAUNCHES[name] == before


# MCR pretraining's stem ([160, 64, 112, 112]: 32 x 5 frames at 224 x 224,
# forward and backward) and an odd plane of the same class: kernel 4 takes
# whole planes at 112 x 112 in both types (57 x 57 staged windows, 16,245 B
# in fp32 under its 16,384 B budget); at 111 x 113 fp32 takes bands of 55
# window rows, bf16 whole planes
_MCR_STEM_PLANS = {
    (torch.float32, (160, 64, 112, 112)): (56, 56, 10240, 16245),
    (torch.bfloat16, (160, 64, 112, 112)): (56, 56, 10240, 9747),
    (torch.float32, (3, 64, 111, 113)): (55, 57, 384, 16240),
    (torch.bfloat16, (3, 64, 111, 113)): (56, 57, 192, 9918),
}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["relu", "zeros"])
@pytest.mark.parametrize("dtype,shape", list(_MCR_STEM_PLANS),
                         ids=["fp32_160", "bf16_160", "fp32_odd", "bf16_odd"])
def test_stem_pool_kernels_at_the_mcr_stem(cuda_device, dtype, shape, kind):
    """Kernels 3 and 4 at MCR pretraining's stem and an odd 112-class plane:
    maxima, offsets and dx bit-equal to the plain versions, ties included;
    kernel 3 through the band kernel in fp32, kernel 4's tiles as planned,
    one launch each."""
    x = _pool_input(shape, kind, cuda_device, 15).to(dtype)
    assert S.pool_bwd_plan(shape, dtype) == _MCR_STEM_PLANS[dtype, shape]
    assert (S.pool_fwd_plan(shape, dtype)[0] == 0) == (dtype == torch.float32)
    suffix = "" if dtype == torch.float32 else "_bf16"
    before = dict(LAUNCHES)
    out_k, idx_k = S.pool_fwd_cuda(x)
    g = torch.randn(out_k.shape, generator=torch.Generator().manual_seed(16)).to(
        cuda_device, dtype)
    dx_k = S.pool_bwd_cuda(idx_k, g, shape[2:])
    torch.cuda.synchronize()
    assert LAUNCHES[f"stem_pool_fwd{suffix}"] == before[f"stem_pool_fwd{suffix}"] + 1
    assert LAUNCHES[f"stem_pool_bwd{suffix}"] == before[f"stem_pool_bwd{suffix}"] + 1
    out_p, idx_p = S.pool_fwd_plain(x)
    assert torch.equal(out_k, out_p) and torch.equal(idx_k, idx_p)
    assert torch.equal(dx_k, S.pool_bwd_plain(idx_p, g, shape[2:]))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 64, 112, 112), (1, 64, 58, 58)])
def test_stem_pool_forward_replays_from_a_cuda_graph(cuda_device, shape):
    """Kernel 3 captured in a CUDA graph (as chip_smoke.py's graph_ms times
    it) replays the eager launch's maxima and offsets on new inputs."""
    x = _relu_input(shape, cuda_device, 13)
    S.pool_fwd_cuda(x)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out_g, idx_g = S.pool_fwd_cuda(x)
    x.copy_(_relu_input(shape, cuda_device, 14))
    graph.replay()
    torch.cuda.synchronize()
    out_p, idx_p = S.pool_fwd_plain(x)
    assert torch.equal(out_g, out_p) and torch.equal(idx_g, idx_p)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [0, 1, 7])
# 5 and 9 planes of the stem's size (a block takes 2 in fp32 and 4 in bf16,
# so the last block takes fewer), and a plane too large for a block (the
# band kernel)
@pytest.mark.parametrize("shape", [(1, 5, 58, 58), (3, 3, 57, 59), (1, 1, 100, 160)])
def test_stem_pool_forward_takes_misaligned_views(cuda_device, shape, offset, dtype):
    """x a contiguous view @offset elements into its buffer, so that the
    forward's staged runs start off their 16-byte boundaries (an odd offset
    in both types): maxima and offsets bit-equal to the plain version's."""
    n = torch.Size(shape).numel()
    buf = _relu_input((n + offset,), cuda_device, 8).to(dtype)
    x = buf[offset:].view(shape)
    assert x.is_contiguous() and x.data_ptr() % 16 == offset * x.element_size() % 16
    name = "stem_pool_fwd" if dtype == torch.float32 else "stem_pool_fwd_bf16"
    before = LAUNCHES[name]
    out_k, idx_k = S.pool_fwd_cuda(x)
    torch.cuda.synchronize()
    assert LAUNCHES[name] == before + 1
    out_p, idx_p = S.pool_fwd_plain(x)
    torch.testing.assert_close(out_k, out_p, rtol=0, atol=0)
    torch.testing.assert_close(idx_k, idx_p, rtol=0, atol=0)
    per_block = S.pool_fwd_plan(shape, dtype)[0]
    assert (per_block == 0) == (shape[2:] == (100, 160))


def _route_input(shape, kind, device, dtype):
    gen = torch.Generator().manual_seed(6)
    x = torch.randn(shape, generator=gen)
    if kind == "relu":
        x = torch.relu(x - 0.25)
    elif kind == "neginf":
        x[:, ::2] = float("-inf")
    return x.to(device, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["distinct", "relu", "neginf"])
@pytest.mark.parametrize("shape", [(64, 64, 58, 58), (2, 3, 6, 8), (3, 5, 2, 130)])
def test_pool_route_kernel_matches_plain(cuda_device, dtype, kind, shape):
    """Kernel 5 bit-equal to its plain version: the same four terms per cell
    added in the same order, in the gradient's type."""
    x = _route_input(shape, kind, cuda_device, dtype)
    z = F.max_pool2d(x, 3, 2, 1)
    dz = torch.randn(z.shape, generator=torch.Generator().manual_seed(7)).to(
        cuda_device, dtype)
    name = "pool_route" if dtype == torch.float32 else "pool_route_bf16"
    before = LAUNCHES[name]
    dx_k = P.pool_route_cuda(x, z, dz)
    torch.cuda.synchronize()
    assert LAUNCHES[name] == before + 1
    assert dx_k.dtype == dtype
    torch.testing.assert_close(dx_k, P.pool_route_plain(x, z, dz), rtol=0, atol=0)


def _route_view(t, offset):
    """@t as a contiguous view @offset elements into a buffer of its own."""
    buf = torch.full((t.numel() + offset,), float("nan"), dtype=t.dtype, device=t.device)
    v = buf[offset:].view(t.shape)
    v.copy_(t)
    assert v.is_contiguous() and v.data_ptr() % 16 == offset * v.element_size() % 16
    return v


def _check_route(x, z, dz, dtype):
    name = "pool_route" if dtype == torch.float32 else "pool_route_bf16"
    before = LAUNCHES[name]
    dx_k = P.pool_route_cuda(x, z, dz)
    torch.cuda.synchronize()
    assert LAUNCHES[name] == before + 1
    torch.testing.assert_close(dx_k, P.pool_route_plain(x, z, dz), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [0, 1, 7])
# 1, 5 and 9 planes of the stem's size: a block takes 2 in fp32 and 4 in
# bf16, so the last block takes fewer
@pytest.mark.parametrize("planes", [1, 5, 9])
def test_pool_route_kernel_takes_misaligned_views(cuda_device, planes, offset, dtype):
    """x, z and dz contiguous views @offset elements into their buffers, so
    that the staged runs start off their 16-byte boundaries and x's offset
    modulo 16 differs from dx's: dx bit-equal to the plain version's, on the
    plane runs."""
    shape = (1, planes, 58, 58)
    x = _route_input(shape, "relu", cuda_device, dtype)
    z = F.max_pool2d(x, 3, 2, 1)
    dz = torch.randn(z.shape, generator=torch.Generator().manual_seed(8)).to(
        cuda_device, dtype)
    assert P.pool_route_plan(shape, dtype)[0] > 0
    _check_route(*(_route_view(t, offset) for t in (x, z, dz)), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pool_route_kernel_takes_the_rows_past_the_budget(cuda_device, dtype):
    """224 x 224 planes do not fit a block's budget: the row kernel takes
    them, bit-equal, at a misaligned view too."""
    shape = (1, 3, 224, 224)
    per_block, blocks, _ = P.pool_route_plan(shape, dtype)
    assert per_block == 0 and blocks == 3 * 224 // 8
    x = _route_input(shape, "relu", cuda_device, dtype)
    z = F.max_pool2d(x, 3, 2, 1)
    dz = torch.randn(z.shape, generator=torch.Generator().manual_seed(9)).to(
        cuda_device, dtype)
    _check_route(x, z, dz, dtype)
    _check_route(_route_view(x, 1), _route_view(z, 3), dz, dtype)


@pytest.mark.cuda
def test_pool_autograd_launches_kernel_5_only_where_it_routes(cuda_device):
    x = _route_input((4, 64, 58, 58), "relu", cuda_device, torch.float32)
    x.requires_grad_(True)
    before = LAUNCHES["pool_route"]
    out = P.max_pool_3x3_s2(x)
    g = torch.randn_like(out)
    (dx,) = torch.autograd.grad(out, x, g)
    assert LAUNCHES["pool_route"] == before + 1
    (dx_p,) = torch.autograd.grad(P.max_pool_3x3_s2(x, use_kernel=False), x, g)
    torch.testing.assert_close(dx, dx_p, rtol=0, atol=0)
    odd = _route_input((2, 64, 57, 59), "distinct", cuda_device, torch.float32)
    odd.requires_grad_(True)
    out = P.max_pool_3x3_s2(odd)
    g = torch.randn_like(out)
    (dx,) = torch.autograd.grad(out, odd, g)
    assert LAUNCHES["pool_route"] == before + 1
    (dx_t,) = torch.autograd.grad(F.max_pool2d(odd, 3, 2, 1), odd, g)
    torch.testing.assert_close(dx, dx_t, rtol=0, atol=0)


@pytest.mark.cuda
def test_pool_kernels_refuse_other_types(cuda_device):
    x = torch.randn(2, 4, 8, 8, device=cuda_device)
    z = F.max_pool2d(x, 3, 2, 1)
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(TypeError):
            P.pool_route_cuda(x.to(dtype), z.to(dtype), z.to(dtype))
        with pytest.raises(TypeError):
            S.pool_fwd_cuda(x.to(dtype))
    with pytest.raises(TypeError):
        P.pool_route_cuda(x, z.bfloat16(), z)
    with pytest.raises(ValueError):
        P.pool_route_cuda(x[..., :7].contiguous(), z, z)


def _demo_store(n_demos=3, length=37, img=48, seed=0):
    """Demos in a MemoryStore (this file needs no h5py): two low-dim keys, a
    camera, actions and a language string per demo."""
    import json

    import numpy as np

    from robot_manipulation_vq_vae_tpu_torch.data.memory_store import MemoryStore

    rng = np.random.default_rng(seed)
    store = MemoryStore()
    store.create_group("data").attrs["env_args"] = json.dumps({"env_name": "Fake"})
    for i in range(n_demos):
        ep = store.create_group(f"data/demo_{i}")
        ep.attrs.update(num_samples=length, ep_meta=json.dumps({"lang": f"task {i}"}))
        ep.create_dataset("obs/eef_pos", data=rng.standard_normal((length, 3), np.float32))
        ep.create_dataset("obs/cam_image", data=rng.integers(
            0, 256, (length, img, img, 3), dtype=np.uint8))
        ep.create_dataset("actions", data=rng.uniform(-1, 1, (length, 7)).astype(np.float32))
    return store


@pytest.mark.cuda
def test_prefetcher_on_the_card_yields_the_synchronous_stream(cuda_device, monkeypatch):
    """DataLoader(reuse_buffers=True) at depth 2, 20 batches over two passes,
    a preparation that returns strided views: every batch the card receives
    equals the synchronous stream's to the bit, while the consumer keeps the
    card busy with other work on its own stream. Without the copy-event wait
    the loader's ring would be refilled under a copy in flight."""
    import numpy as np

    from robot_manipulation_vq_vae_tpu_torch import native
    from robot_manipulation_vq_vae_tpu_torch.data import dataset as D
    from robot_manipulation_vq_vae_tpu_torch.data.loader import DataLoader
    from robot_manipulation_vq_vae_tpu_torch.data.prefetch import DevicePrefetcher
    from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils as ObsUtils
    from robot_manipulation_vq_vae_tpu_torch.utils.lang_utils import LangEncoder

    ObsUtils.initialize_obs_utils_with_obs_specs(
        {"obs": {"low_dim": ["eef_pos"], "rgb": ["cam_image"]}})
    store = _demo_store()
    monkeypatch.setattr(D, "open_hdf5", lambda *a, **k: store)
    ds = D.SequenceDataset("store", obs_keys=["eef_pos", "cam_image"],
                           action_keys=["actions"], dataset_keys=["actions"],
                           action_config={}, seq_length=7, hdf5_cache_mode="all",
                           load_next_obs=False, lang_encoder=LangEncoder())
    assert native.is_available() and ds.getitem_cache is None

    def prepare(batch):
        return {"obs": {k: v[:, :4] for k, v in batch["obs"].items()},
                "actions": batch["actions"][:, 3:7], "goal_obs": None}

    def copy(tree):
        if isinstance(tree, dict):
            return {k: copy(v) for k, v in tree.items()}
        return None if tree is None else np.array(tree)

    kw = dict(batch_size=11, seed=3, num_workers=2, reuse_buffers=True)
    sync = DataLoader(ds, **kw)
    want = [copy(prepare(b)) for _ in range(2) for b in sync][:20]
    assert len(want) == 20
    busy = torch.randn(2048, 2048, device=cuda_device)
    pf = DevicePrefetcher(DataLoader(ds, **kw), prepare=prepare, depth=2,
                          device=cuda_device)
    try:
        for w in want:
            got = pf.get()
            for _ in range(4):
                busy = torch.tanh(busy @ busy / 2048)
            assert got["goal_obs"] is None
            for key in ("eef_pos", "cam_image", "lang_emb"):
                t = got["obs"][key]
                assert t.device.type == "cuda" and t.is_contiguous()
                assert torch.equal(t.cpu(), torch.from_numpy(w["obs"][key])), key
            assert torch.equal(got["actions"].cpu(), torch.from_numpy(w["actions"]))
        summary = pf.transfer_summary()
    finally:
        pf.close()
    assert not pf._thread.is_alive()
    assert summary["pinned"] and summary["batches"] == 20
    assert summary["transfer_mbytes_per_sec"] > 0


def _modality_algo(modality, device):
    """icl_gmm_paper, small, with @modality's action tokenizer (LipVQ off)
    and train.pallas_pool on: one 64x64 camera through ResNet-18, so the stem
    pool runs once per observation group."""
    from robot_manipulation_vq_vae_tpu_torch import algo as Algo
    from robot_manipulation_vq_vae_tpu_torch.config import config_factory
    from robot_manipulation_vq_vae_tpu_torch.models.tokenizers.fast import (
        FastHostEncoder,
    )
    from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils as ObsUtils
    from chip_smoke import SmokeFastProcessor, smoke_clip_encode

    cfg = config_factory("icl_gmm_paper")
    with cfg.values_unlocked():
        cfg.observation.modalities.obs.low_dim = ["eef_pos"]
        cfg.observation.modalities.obs.rgb = ["cam_image"]
        cfg.observation.encoder.rgb.core_class = "VisualCore"
        cfg.observation.encoder.rgb.core_kwargs = {
            "feature_dimension": 32, "backbone_class": "ResNet18Conv",
            "backbone_kwargs": {"pretrained": False, "input_coord_conv": False},
            "pool_class": "SpatialSoftmax",
            "pool_kwargs": {"num_kp": 16, "learnable_temperature": False,
                            "temperature": 1.0, "noise_std": 0.0},
        }
        cfg.observation.encoder.rgb.obs_randomizer_class = None
        tc = cfg.algo.transformer
        tc.context_length, tc.embed_dim, tc.num_layers, tc.num_heads = 4, 32, 1, 4
        tc.vq_vae_enabled = False
        for flag in ("bin_enabled", "ln_act_enabled", "fast_enabled"):
            tc[flag] = flag == f"{modality}_enabled"
        cfg.train.pallas_pool = True
    ObsUtils.initialize_obs_utils_with_config(cfg)
    algo = Algo.algo_factory("icl_gmm_paper", cfg, {"eef_pos": (3,), "cam_image": (64, 64, 3)},
                             7, device=device)
    if modality == "fast":
        algo.set_fast_tokenizer(FastHostEncoder.from_components(
            SmokeFastProcessor(), smoke_clip_encode))
    return algo


@pytest.mark.cuda
@pytest.mark.parametrize("modality", ["bin", "ln_act", "default", "fast"])
def test_each_tokenizer_trains_and_serves_on_the_card(cuda_device, modality):
    """A B = 4 training step (2 context sequences, 2 supervised) and a B = 2
    request: finite, and the stem pool's kernels launched once per group
    and pass (forward 2, backward 2 a step; forward 2 a request)."""
    import numpy as np

    from robot_manipulation_vq_vae_tpu_torch.ops import cuda_build as CB

    algo = _modality_algo(modality, cuda_device)
    rng = np.random.RandomState(0)

    def batch(b):
        return {"obs": {"eef_pos": rng.randn(b, 4, 3).astype(np.float32),
                        "cam_image": rng.randint(0, 256, (b, 4, 64, 64, 3), dtype=np.uint8)},
                "actions": rng.uniform(-1, 1, (b, 4, 7)).astype(np.float32)}

    CB.reset_launch_counts()
    losses = algo.train_on_batch(batch(4), epoch=0)["losses"]
    torch.cuda.synchronize()
    assert set(losses) == {"log_probs", "action_loss", "policy_grad_norms"}
    assert all(bool(torch.isfinite(v)) for v in losses.values())
    assert (LAUNCHES["stem_pool_fwd"], LAUNCHES["stem_pool_bwd"]) == (2, 2)
    assert LAUNCHES["lipvq_assign"] == 0
    CB.reset_launch_counts()
    request, ctx = batch(2), batch(2)
    action = algo.get_action(request["obs"], ctx)
    assert action.shape == (2, 7) and action.device.type == "cuda"
    assert bool(torch.isfinite(action).all())
    assert (LAUNCHES["stem_pool_fwd"], LAUNCHES["stem_pool_bwd"]) == (2, 0)


# ---------------------------------------------------------------------------
# the rest of the ICL family (the MLP, RNN and Mamba policies)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(100, 64, 58, 58), (1000, 64, 58, 58), (320, 64, 58, 58),
                                   (640, 64, 58, 58)],
                         ids=["mlp_b100", "rnn_b100xt10", "mamba_32xt10", "mamba_hvqvae_64xt10"])
def test_stem_pool_kernels_at_the_icl_family_shapes(cuda_device, shape, capsys):
    """Kernels 3 and 4 in fp32 at the stem activations of the MLP policies
    (100 frames), the RNN policies (100 x 10), icl_mamba's groups (32 x 10)
    and ICLMambaHVQVAE's batch (64 x 10): maxima, offsets and dx bit-equal to the plain versions; each
    timed (CUDA events) beside the plain version and its bound (bytes over
    the card's memory rate), and faster than the plain version."""
    from chip_smoke import bound_ms, cuda_ms

    x = _relu_input(shape, cuda_device, 4)
    out_k, idx_k = S.pool_fwd_cuda(x)
    out_p, idx_p = S.pool_fwd_plain(x)
    torch.testing.assert_close(out_k, out_p, rtol=0, atol=0)
    torch.testing.assert_close(idx_k, idx_p, rtol=0, atol=0)
    g = torch.randn(out_k.shape, generator=torch.Generator(cuda_device).manual_seed(3),
                    device=cuda_device)
    torch.testing.assert_close(S.pool_bwd_cuda(idx_k, g, shape[2:]),
                               S.pool_bwd_plain(idx_p, g, shape[2:]), rtol=0, atol=0)
    n_in, n_out = x.numel(), out_k.numel()
    rows = {"fwd": (lambda: S.pool_fwd_cuda(x), lambda: S.pool_fwd_plain(x),
                    bound_ms(4 * n_in + 5 * n_out, 8 * n_out)[0]),
            "bwd": (lambda: S.pool_bwd_cuda(idx_k, g, shape[2:]),
                    lambda: S.pool_bwd_plain(idx_p, g, shape[2:]),
                    bound_ms(5 * n_out + 4 * n_in, n_out)[0])}
    for name, (kern, plain, bound) in rows.items():
        ms, plain_ms = cuda_ms(kern)[0], cuda_ms(plain)[0]
        with capsys.disabled():
            print(f"\nstem_pool_{name} {list(shape)} fp32 ({torch.cuda.get_device_name()}): "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.4f} ms")
        assert ms < plain_ms


def _family_algo(name, device, use_kernels=True):
    """A small ICLGMM (MLP [32, 32]) or ICLMamba_GMM (one Mamba layer of 32,
    context 4, LipVQ), one 64x64 camera through ResNet-18 (2x2 features:
    the trunk's gradient is not 0) and train.pallas_pool."""
    from robot_manipulation_vq_vae_tpu_torch import algo as Algo
    from robot_manipulation_vq_vae_tpu_torch.config import config_factory
    from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils as ObsUtils

    cfg = config_factory(name)
    with cfg.values_unlocked():
        cfg.observation.modalities.obs.low_dim = ["eef_pos"]
        cfg.observation.modalities.obs.rgb = ["cam_image"]
        cfg.observation.encoder.rgb.core_class = "VisualCore"
        cfg.observation.encoder.rgb.core_kwargs = {
            "feature_dimension": 32, "backbone_class": "ResNet18Conv",
            "backbone_kwargs": {"pretrained": False, "input_coord_conv": False},
            "pool_class": "SpatialSoftmax",
            "pool_kwargs": {"num_kp": 16, "learnable_temperature": False,
                            "temperature": 1.0, "noise_std": 0.0},
        }
        cfg.observation.encoder.rgb.obs_randomizer_class = None
        cfg.algo.gmm.enabled = True
        cfg.algo.actor_layer_dims = [32, 32]
        if name == "icl_mamba":
            mc = cfg.algo.mamba
            mc.context_length, mc.embed_dim, mc.num_layers = 4, 32, 1
            mc.supervise_all_steps, mc.vq_vae_enabled, mc.ln_act_enabled = True, True, False
            mc.emb_dropout = 0.0
        cfg.train.pallas_pool = True
    ObsUtils.initialize_obs_utils_with_config(cfg)
    return Algo.algo_factory(name, cfg, {"eef_pos": (3,), "cam_image": (64, 64, 3)}, 7,
                             device=device, use_kernels=use_kernels)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["icl", "icl_mamba"])
def test_family_step_with_kernels_matches_plain(cuda_device, name):
    """One training step of ICLGMM (B = 4) and of ICLMamba_GMM (B = 4: 2
    context and 2 supervised sequences of 4) with the kernels, against one
    step of the same weights with their plain versions, batch and draws
    alike, under cuDNN's deterministic algorithms (without them the two
    steps' gradients were seen 6.2e-4 and 4.9e-4 of their largest apart on
    an H100; with them they are equal to the bit): chip_smoke's tolerances (metrics 1e-5
    relative, gradients 1e-4 of each tensor's largest, statistics 1e-6).
    The kernel step launches the stem pool once per camera and group pass
    (and the assign once)."""
    import numpy as np

    from robot_manipulation_vq_vae_tpu_torch.ops import cuda_build as CB
    from chip_smoke import compare_steps, one_step

    rng = np.random.RandomState(0)
    batch = {"obs": {"eef_pos": rng.randn(4, 4, 3).astype(np.float32),
                     "cam_image": rng.randint(0, 256, (4, 4, 64, 64, 3), dtype=np.uint8)},
             "actions": rng.uniform(-1, 1, (4, 4, 7)).astype(np.float32)}
    algo = _family_algo(name, cuda_device)
    assert type(algo).__name__ == ("ICLGMM" if name == "icl" else "ICLMamba_GMM")
    batch = algo.process_batch_for_training(batch)
    state = {k: v.clone() for k, v in algo.nets.state_dict().items()}
    CB.reset_launch_counts()
    res_k = one_step(algo, batch, deterministic=True)
    groups = 1 if name == "icl" else 2
    assert (LAUNCHES["stem_pool_fwd"], LAUNCHES["stem_pool_bwd"]) == (groups, groups)
    assert LAUNCHES["lipvq_assign"] == groups - 1
    plain = _family_algo(name, cuda_device, use_kernels=False)
    plain.nets.load_state_dict(state)
    CB.reset_launch_counts()
    res_p = one_step(plain, batch, deterministic=True)
    assert sum(LAUNCHES.values()) == 0
    assert any(float(g.abs().max()) > 0 for n, g in res_p[1].items() if "backbone" in n)
    keys = ("action_loss", "policy_grad_norms") + (("vq_vae_loss",) if groups == 2 else ())
    compare_steps(res_k, res_p, keys)


# ---------------------------------------------------------------------------
# the imitation baselines (bc's transformer-GMM policy, the diffusion policy)
# ---------------------------------------------------------------------------

def _baseline_algo(name, device, use_kernels=True):
    """A small BC_Transformer_GMM (one GPT layer of 32, context 4) or
    DiffusionPolicyUNet (down dims 16 / 32, To 2, Tp 4, its trunk with
    GroupNorm), one 64x64 camera through ResNet-18 and train.pallas_pool."""
    from robot_manipulation_vq_vae_tpu_torch import algo as Algo
    from robot_manipulation_vq_vae_tpu_torch.config import config_factory
    from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils as ObsUtils

    cfg = config_factory(name)
    with cfg.values_unlocked():
        cfg.observation.modalities.obs.low_dim = ["eef_pos"]
        cfg.observation.modalities.obs.rgb = ["cam_image"]
        cfg.observation.encoder.rgb.core_class = "VisualCore"
        cfg.observation.encoder.rgb.core_kwargs = {
            "feature_dimension": 32, "backbone_class": "ResNet18Conv",
            "backbone_kwargs": {"pretrained": False, "input_coord_conv": False},
            "pool_class": "SpatialSoftmax",
            "pool_kwargs": {"num_kp": 16, "learnable_temperature": False,
                            "temperature": 1.0, "noise_std": 0.0},
        }
        cfg.observation.encoder.rgb.obs_randomizer_class = None
        if name == "bc":
            cfg.algo.gmm.enabled = True
            tc = cfg.algo.transformer
            tc.enabled, tc.context_length, tc.embed_dim, tc.num_layers, tc.num_heads = (
                True, 4, 32, 1, 4)
        else:
            cfg.algo.horizon.prediction_horizon = 4
            cfg.algo.unet.down_dims = [16, 32]
            cfg.algo.unet.diffusion_step_embed_dim = 16
        cfg.train.pallas_pool = True
    ObsUtils.initialize_obs_utils_with_config(cfg)
    return Algo.algo_factory(name, cfg, {"eef_pos": (3,), "cam_image": (64, 64, 3)}, 7,
                             device=device, use_kernels=use_kernels)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["bc", "diffusion_policy"])
def test_baseline_step_with_kernels_matches_plain(cuda_device, name):
    """One training step of BC_Transformer_GMM (B = 4 windows of 4) and of
    DiffusionPolicyUNet (B = 4, 2 frames, 4 actions; EMA on) with the
    kernels, against one step of the same weights with F.max_pool2d's plain
    versions, batch and draws alike, under cuDNN's deterministic algorithms:
    chip_smoke's tolerances. The kernel step launches the stem pool once a
    step (forward and backward over the window's frames); the plain one
    launches nothing."""
    import numpy as np

    from robot_manipulation_vq_vae_tpu_torch.ops import cuda_build as CB
    from chip_smoke import compare_steps, one_step

    rng = np.random.RandomState(0)
    batch = {"obs": {"eef_pos": rng.randn(4, 4, 3).astype(np.float32),
                     "cam_image": rng.randint(0, 256, (4, 4, 64, 64, 3), dtype=np.uint8)},
             "actions": rng.uniform(-1, 1, (4, 4, 7)).astype(np.float32)}
    algo = _baseline_algo(name, cuda_device)
    assert type(algo).__name__ == ("BC_Transformer_GMM" if name == "bc"
                                   else "DiffusionPolicyUNet")
    batch = algo.process_batch_for_training(batch)
    state = {k: v.clone() for k, v in algo.nets.state_dict().items()}
    CB.reset_launch_counts()
    res_k = one_step(algo, batch, deterministic=True)
    assert (LAUNCHES["stem_pool_fwd"], LAUNCHES["stem_pool_bwd"]) == (1, 1)
    plain = _baseline_algo(name, cuda_device, use_kernels=False)
    plain.nets.load_state_dict(state)
    CB.reset_launch_counts()
    res_p = one_step(plain, batch, deterministic=True)
    assert sum(LAUNCHES.values()) == 0
    assert any(float(g.abs().max()) > 0 for n, g in res_p[1].items() if "backbone" in n)
    keys = (("log_probs", "action_loss", "policy_grad_norms") if name == "bc"
            else ("l2_loss",))
    compare_steps(res_k, res_p, keys)


def _offline_rl_algo(name, device, pallas_pool=True, use_kernels=True):
    """A small ``@name`` (layers [32, 32]; BCQ's VAE [32], 10 candidates in
    the backup and 100 a request, as its template) on one 64x64 camera
    through ResNet-18 with a crop, and a low-dim key."""
    from robot_manipulation_vq_vae_tpu_torch import algo as Algo
    from robot_manipulation_vq_vae_tpu_torch.config import config_factory
    from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils as ObsUtils

    cfg = config_factory(name)
    with cfg.values_unlocked():
        cfg.observation.modalities.obs.low_dim = ["eef_pos"]
        cfg.observation.modalities.obs.rgb = ["cam_image"]
        cfg.observation.encoder.rgb.core_class = "VisualCore"
        cfg.observation.encoder.rgb.core_kwargs = {
            "feature_dimension": 32, "backbone_class": "ResNet18Conv",
            "backbone_kwargs": {"pretrained": False, "input_coord_conv": False},
            "pool_class": "SpatialSoftmax",
            "pool_kwargs": {"num_kp": 16, "learnable_temperature": False,
                            "temperature": 1.0, "noise_std": 0.0},
        }
        cfg.observation.encoder.rgb.obs_randomizer_class = "CropRandomizer"
        cfg.observation.encoder.rgb.obs_randomizer_kwargs = {
            "crop_height": 58, "crop_width": 58, "num_crops": 1, "pos_enc": False}
        cfg.algo.critic.layer_dims = cfg.algo.actor.layer_dims = [32, 32]
        if name == "bcq":
            cfg.algo.action_sampler.vae.encoder_layer_dims = [32]
            cfg.algo.action_sampler.vae.decoder_layer_dims = [32]
        cfg.train.pallas_pool = pallas_pool
    ObsUtils.initialize_obs_utils_with_config(cfg)
    return Algo.algo_factory(name, cfg, {"eef_pos": (3,), "cam_image": (64, 64, 3)}, 7,
                             device=device, use_kernels=use_kernels)


# a step's stem-pool launches with one camera (forward, backward): IQL's V at
# s', 2 target critics, 2 critics, V, the actor; TD3-BC's (a step that moves
# the actor) the target actor, 2 targets, 2 critics, the actor and the
# first critic; CQL the actor 4 times, 2 critics, 2 targets; BCQ the VAE
# twice, 2 targets, 2 critics
_RL_STEP_LAUNCHES = {"iql": (7, 4), "td3_bc": (7, 3), "cql": (8, 3), "bcq": (6, 3)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(_RL_STEP_LAUNCHES))
def test_offline_rl_step_with_kernels_matches_plain(cuda_device, name):
    """One step of each offline-RL algo (B = 8 transitions, random crops)
    with the kernels against one of the same weights with their plain
    versions, batch and draws alike, under cuDNN's deterministic
    algorithms: chip_smoke's tolerances and the step's launch counts."""
    import numpy as np

    from robot_manipulation_vq_vae_tpu_torch.ops import cuda_build as CB
    from chip_smoke import compare_steps, one_step

    rng = np.random.RandomState(0)

    def obs():
        return {"eef_pos": rng.randn(8, 1, 3).astype(np.float32),
                "cam_image": rng.randint(0, 256, (8, 1, 64, 64, 3), dtype=np.uint8)}

    batch = {"obs": obs(), "next_obs": obs(),
             "actions": rng.uniform(-1, 1, (8, 1, 7)).astype(np.float32),
             "rewards": rng.rand(8, 1).astype(np.float32),
             "dones": (rng.rand(8, 1) < 0.3).astype(np.float32)}
    algo = _offline_rl_algo(name, cuda_device)
    batch = algo.process_batch_for_training(batch)
    state = {k: v.clone() for k, v in algo.nets.state_dict().items()}
    plain = _offline_rl_algo(name, cuda_device, use_kernels=False)
    plain.nets.load_state_dict(state)
    if name == "td3_bc":   # update_freq 2: the second critic step moves the actor
        algo.critic_steps = plain.critic_steps = 1
    CB.reset_launch_counts()
    res_k = one_step(algo, batch, deterministic=True)
    assert (LAUNCHES["stem_pool_fwd"], LAUNCHES["stem_pool_bwd"]) == _RL_STEP_LAUNCHES[name]
    CB.reset_launch_counts()
    res_p = one_step(plain, batch, deterministic=True)
    assert sum(LAUNCHES.values()) == 0
    assert any(float(g.abs().max()) > 0 for n, g in res_p[1].items() if "backbone" in n)
    keys = [k for k in res_p[0] if k.endswith("loss")]
    compare_steps(res_k, res_p, keys)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(_RL_STEP_LAUNCHES))
def test_offline_rl_request_with_kernels_equals_max_pool2d(cuda_device, name):
    """A B = 16 request (BCQ: 100 candidates a row) through the kernels is
    equal to the bit to the F.max_pool2d model's with the same weights and
    draws; one stem-pool forward a request (BCQ: the VAE's and the first
    critic's)."""
    import numpy as np

    from robot_manipulation_vq_vae_tpu_torch.ops import cuda_build as CB

    rng = np.random.RandomState(1)
    obs = {"eef_pos": rng.randn(16, 3).astype(np.float32),
           "cam_image": rng.randint(0, 256, (16, 64, 64, 3), dtype=np.uint8)}
    algo = _offline_rl_algo(name, cuda_device)
    twin = _offline_rl_algo(name, cuda_device, pallas_pool=False)
    twin.nets.load_state_dict(algo.nets.state_dict())
    CB.reset_launch_counts()
    algo.generator.manual_seed(3)
    got = algo.get_action(obs)
    assert LAUNCHES["stem_pool_fwd"] == (2 if name == "bcq" else 1)
    twin.generator.manual_seed(3)
    want = twin.get_action(obs)
    assert got.shape == (16, 7)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the tokenizer zoo on kernel 1, and the mesh at dp = 1
# ---------------------------------------------------------------------------

def _zoo_twins(name, device, **kw):
    """The zoo class @name with the kernel and its use_kernel=False twin,
    the same weights."""
    from robot_manipulation_vq_vae_tpu_torch.models import tokenizers as Zoo

    cls = getattr(Zoo, name)
    torch.manual_seed(0)
    a = cls(**kw).to(device)
    b = cls(**kw, use_kernel=False).to(device)
    b.load_state_dict(a.state_dict())
    return a, b


@pytest.mark.cuda
def test_vqvae_trains_through_kernel_1(cuda_device):
    """Two Adam steps of VQVAE at the bench's widths: one assign launch a
    step, losses and weights equal to the plain twin's (the codebook's
    gradient through L2Nearest's index_add_, deterministic mode)."""
    a, b = _zoo_twins("VQVAE", cuda_device, feature_dim=12, latent_dim=210,
                      num_embeddings=128)
    gen = torch.Generator(cuda_device).manual_seed(1)
    xs = [torch.randn(2048, 12, generator=gen, device=cuda_device) for _ in range(2)]
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for model, launches in ((a, 2), (b, 0)):
            opt = torch.optim.Adam(model.parameters(), lr=1e-3)
            before = LAUNCHES["lipvq_assign"]
            model.losses = []
            for x in xs:
                _, loss = model(x)
                opt.zero_grad()
                loss.backward()
                opt.step()
                model.losses.append(float(loss))
            assert LAUNCHES["lipvq_assign"] - before == launches
    finally:
        torch.use_deterministic_algorithms(False)
    assert a.losses == pytest.approx(b.losses, rel=1e-6)
    for k, v in b.state_dict().items():
        torch.testing.assert_close(a.state_dict()[k], v, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["LFQQuantizerEMA", "LFQQuantizerEMA_KMeans"])
def test_ema_quantizers_match_their_plain_twins(cuda_device, name):
    """Three training forwards (the k-means init and dead-code replacement
    with the same generator seed): one assign launch each, z_q, indices and
    every ``vq`` buffer equal to the plain twin's."""
    kw = dict(num_codes=256, code_dim=64)
    if name.endswith("KMeans"):
        kw["kmeans_iters"] = 5
    a, b = _zoo_twins(name, cuda_device, **kw)
    gen = torch.Generator(cuda_device).manual_seed(2)
    xs = [torch.sigmoid(torch.randn(1024, 64, generator=gen, device=cuda_device))
          for _ in range(3)]
    outs = {}
    for model, launches in ((a, 3), (b, 0)):
        model.train()
        draws = torch.Generator(cuda_device).manual_seed(3)
        before = LAUNCHES["lipvq_assign"]
        outs[launches] = [model(x, generator=draws) for x in xs]
        assert LAUNCHES["lipvq_assign"] - before == launches
    for (qa, ia), (qb, ib) in zip(outs[3], outs[0]):
        assert torch.equal(ia, ib) and torch.equal(qa, qb)
    for k, v in b.state_dict().items():
        torch.testing.assert_close(a.state_dict()[k], v, rtol=0, atol=0)


@pytest.mark.cuda
def test_hierarchical_lfq_trains_through_kernel_1(cuda_device):
    """Two Adam steps of HierarchicalLFQHVQVAE at q_dim 64, hidden 128: two
    assign launches a step (z and q), everything equal to the plain twin's."""
    a, b = _zoo_twins("HierarchicalLFQHVQVAE", cuda_device, feature_dim=12, z_dim=210,
                      q_dim=64, num_z_codes=256, num_q_codes=128, hidden_dim=128)
    gen = torch.Generator(cuda_device).manual_seed(4)
    xs = [torch.randn(1024, 12, generator=gen, device=cuda_device) for _ in range(2)]
    losses = {}
    for model, launches in ((a, 4), (b, 0)):
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)
        draws = torch.Generator(cuda_device).manual_seed(5)
        model.train()
        before = LAUNCHES["lipvq_assign"]
        losses[launches] = []
        for x in xs:
            _, loss = model(x, generator=draws)
            opt.zero_grad()
            loss.backward()
            opt.step()
            losses[launches].append(float(loss))
        assert LAUNCHES["lipvq_assign"] - before == launches
    assert losses[4] == pytest.approx(losses[0], rel=1e-6)
    for k, v in b.state_dict().items():
        if v.is_floating_point():
            torch.testing.assert_close(a.state_dict()[k], v, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_mesh_dp1_under_nccl_equals_unsharded_steps(cuda_device):
    """make_mesh over a one-rank nccl group; the tiny flagship (rgb, the
    stem pool's kernels) and the LipVQ paper step under shard_state and
    shard_batch equal to the bit to unsharded steps from the same state
    and draws, the kernels launched."""
    import socket
    import sys

    import torch.distributed as dist

    sys.path.insert(0, str(__import__("pathlib").Path(__file__).parent))
    import torch_mesh_workers as W

    from robot_manipulation_vq_vae_tpu_torch.parallel import make_mesh, shard_state

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh()
        assert tuple(mesh.mesh.shape) == (1, 1) and mesh.device_type == "cuda"
        legs = W.legs()
        for tag in ("flagship_rgb", "paper"):
            name, cfg_name, with_rgb, init_vq, batches, halves = legs[tag]
            runs = []
            for under_mesh in (False, True):
                algo, _ = W.leg_algo(name, cfg_name, with_rgb, init_vq, device=cuda_device)
                if under_mesh:
                    shard_state(mesh, algo)
                before = dict(LAUNCHES)
                torch.backends.cudnn.deterministic = True
                torch.use_deterministic_algorithms(True, warn_only=True)
                try:
                    losses = W.steps(algo, batches, mesh if under_mesh else None, halves)
                finally:
                    torch.backends.cudnn.deterministic = False
                    torch.use_deterministic_algorithms(False)
                launched = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
                runs.append((losses, algo.nets.state_dict(), launched))
            (want, want_state, _), (got, got_state, launched) = runs
            assert got == want
            for k, v in want_state.items():
                assert torch.equal(got_state[k], v), (tag, k)
            assert launched["stem_pool_fwd"] > 0 and launched["stem_pool_bwd"] > 0 or (
                tag == "paper")
            if tag == "paper":
                assert launched["lipvq_assign"] == len(batches)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_mesh_dp2_bf16_flagship_step_on_two_gloo_ranks(cuda_device, tmp_path):
    """Two gloo ranks on the card (staged through pinned memory) take the
    tiny flagship's bf16 leg (rgb, BatchNorm over the global batch in bf16)
    at dp = 2: kernels 3 and 4's bf16 instances launch on each rank, and
    the step equals the unsharded step on the card within the bf16 bounds
    of tests/test_torch_mesh_families.py (``check_half_leg``: metrics 1e-3
    relative, each last gradient 1e-2 of its tensor's largest, weights and
    Adam moments at test_parallel.py's 5e-4 + 1e-2 |v|, the moments also
    per tensor, buffers 1e-4 with at most 1 % of BatchNorm's statistics
    further apart; the HVQVAE's codebooks by their mass), the ranks to the
    bit."""
    import sys

    sys.path.insert(0, str(__import__("pathlib").Path(__file__).parent))
    import torch_mesh_workers as W

    from robot_manipulation_vq_vae_tpu_torch.ops import cuda_build

    cuda_build.build_kernels()   # once, before the ranks load it
    results = W.start_ranks(W.job_card_bf16, 2, tmp_path / "ranks")
    torch.backends.cudnn.deterministic = True
    try:
        ref = W.run_family_leg("flagship_bf16", device=cuda_device)
    finally:
        torch.backends.cudnn.deterministic = False
        ranks = results()
    for rank, res in enumerate(ranks):
        assert res["launched"]["stem_pool_fwd_bf16"] > 0, rank
        assert res["launched"]["stem_pool_bwd_bf16"] > 0, rank
        assert res["losses"] == ranks[0]["losses"]
        for k, v in res["nets"].items():
            assert torch.equal(v, ranks[0]["nets"][k]), (rank, k)
        readings = W.check_half_leg(res, ref, "flagship_bf16", f"rank {rank}",
                                    vq_by_mass=True)
        print(f"rank {rank}: {readings}")


@pytest.mark.cuda
def test_mesh_mp2_bc_transformer_step_on_two_gloo_ranks(cuda_device, tmp_path):
    """Two gloo ranks on the card take ``BC_Transformer_GMM`` on a camera
    at (dp, mp) = (1, 2), its GPT split as JAX's ``_param_spec`` splits it:
    kernels 3 and 4 launch on each rank as on the unsharded run, and the
    two steps, the request and the checkpoint's reload equal the unsharded
    run's on the card within tests/test_parallel.py's tolerances (losses
    rtol 1e-4 / atol 1e-5; weights, buffers and Adam moments atol 5e-4 /
    rtol 1e-2; actions 1e-3), the ranks to the bit. cuDNN runs its
    default algorithms, so each rank's replicated trunk takes gradients a
    few ulps apart from the other's: the port's step keeps the replicas
    equal itself."""
    import sys

    sys.path.insert(0, str(__import__("pathlib").Path(__file__).parent))
    import torch_mesh_workers as W

    from robot_manipulation_vq_vae_tpu_torch.ops import cuda_build

    cuda_build.build_kernels()   # once, before the ranks load it
    results = W.start_ranks(W.job_card_mp, 2, tmp_path / "ranks")
    before = dict(cuda_build.LAUNCHES)
    try:
        ref = W.run_mp_family_leg("bc_transformer_gmm_rgb", device=cuda_device)
    finally:
        ranks = results()
    launched = {k: n - before[k] for k, n in cuda_build.LAUNCHES.items()}
    assert launched["stem_pool_fwd"] > 0 and launched["stem_pool_bwd"] > 0, launched
    for rank, res in enumerate(ranks):
        assert res["launched"] == launched, (rank, res["launched"], launched)
        assert res["losses"] == ranks[0]["losses"], rank
        for k, v in res["nets"].items():
            assert torch.equal(v, ranks[0]["nets"][k]), (rank, k)
        for step, (g, w) in enumerate(zip(res["losses"], ref["losses"], strict=True)):
            for k, v in w.items():
                assert abs(g[k] - v) <= 1e-5 + 1e-4 * abs(v), (rank, step, k, g[k], v)
        for k, v in ref["nets"].items():
            if v.is_floating_point():
                torch.testing.assert_close(res["nets"][k], v, rtol=1e-2, atol=5e-4)
        for name, sd in ref["opt"].items():
            for i, st in sd["state"].items():
                for k, v in st.items():
                    torch.testing.assert_close(res["opt"][name]["state"][i][k], v,
                                               rtol=1e-2, atol=5e-4)
        torch.testing.assert_close(res["action"], ref["action"], rtol=1e-3, atol=1e-3)
        assert torch.equal(res["reloaded"], res["action"]), rank

