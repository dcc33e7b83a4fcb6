"""The port's CUDA kernels against their plain PyTorch versions on the card
(``cuda`` marker: they skip where there is none), and the wrappers' device
rule: the two LipVQ kernels and the assign's backward (``L2Nearest``), the
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [0, 1, 7])
# 5 and 9 planes of the stem's size (a block takes 2 in fp32 and 4 in bf16,
# so the last block takes fewer), and a plane too large for a block (the tile
# kernel)
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
