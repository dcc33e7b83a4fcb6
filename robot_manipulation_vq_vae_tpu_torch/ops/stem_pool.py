"""The ResNet stem's 3x3 / stride-2 / pad-1 max pool with a recorded argmax:
two kernels written in CUDA C++ for Hopper (``csrc/stem_pool.cu``), their
plain PyTorch versions, and the ``torch.autograd.Function`` that pairs them.

Counterpart of the JAX package's ``ops/pallas/stem_pool.py``:

* ``pool_fwd_cuda`` replaces the TPU kernel ``_fwd_kernel`` (reached through
  ``pool_fwd_pallas``): the max of each window and the int8 offset
  3 di + dj in 0..8 of the cell that won, the first maximum in row-major
  window order on a tie (strict ``>``), with the border padded by ``-inf``.
* ``pool_bwd_cuda`` replaces ``_bwd_kernel`` (``pool_bwd_pallas``): the
  gradient of each output routed to the input cell its offset names; it
  never reads the forward's input.

Both are bound by device memory on the H100 (about 579 MB moved each at the
fp32 policy path's [512, 64, 58, 58], 0.173 ms at 3.35 TB/s); the kernel
source says how each reads its input once and writes its output once. Tensors
are NCHW, the layout of the port's trunk; the TPU kernels' lane packing of two
columns has no counterpart here. Any H is accepted, and any W up to the
forward's widest row (a band of one output row in 227 KB of shared memory:
about 16,000 fp32 or 31,000 bf16 elements with H >= 3); the output is
floor((H - 1) / 2) + 1 by floor((W - 1) / 2) + 1, as in ``F.max_pool2d``.

Each kernel has an fp32 and a bf16 instance (mixed-precision training pools
the bf16 stem activation). The maximum is exact in either type; the backward
adds a cell's routed gradients in fp32 and rounds once to the gradient's
type, as the TPU kernel does (``stem_pool.py:115``, ``:140``).

Each wrapper runs its plain version on CPU tensors (the tests) and launches
its kernel on CUDA tensors, which must be fp32 or bf16 and NCHW-contiguous;
any other type raises, and it never falls back from the kernel. The kernels
are built by ``ops/cuda_build.py``.
"""

import ctypes
import functools

import torch
import torch.nn.functional as F

from robot_manipulation_vq_vae_tpu_torch.ops.cuda_build import (
    check_cuda_inputs,
    kernel_name,
    launch,
    library,
    on_cpu,
    stream_of,
)

# (di, dj) of the 9 window cells in row-major order; offset k = 3 di + dj
_OFFSETS = tuple((di, dj) for di in range(3) for dj in range(3))


def pooled_hw(h, w):
    return (h - 1) // 2 + 1, (w - 1) // 2 + 1


def _window(t, di, dj, ho, wo):
    """The [..., ho, wo] strided view of padded @t at window cell (di, dj)."""
    return t[..., di:di + 2 * ho - 1:2, dj:dj + 2 * wo - 1:2]


# ---------------------------------------------------------------------------
# plain versions (the formulation of the JAX package's ops/pool_argmax.py)
# ---------------------------------------------------------------------------

def pool_fwd_plain(x):
    """[N, C, H, W] -> (max [N, C, Ho, Wo], offset int8 [N, C, Ho, Wo]): the
    9 strided slices of the -inf-padded input, keeping the first maximum."""
    ho, wo = pooled_hw(*x.shape[-2:])
    xp = F.pad(x, (1, 1, 1, 1), value=float("-inf"))
    best = _window(xp, 0, 0, ho, wo)
    idx = torch.zeros(best.shape, dtype=torch.int8, device=x.device)
    for k, (di, dj) in enumerate(_OFFSETS[1:], start=1):
        v = _window(xp, di, dj, ho, wo)
        take = v > best
        best = torch.where(take, v, best)
        idx = idx.masked_fill(take, k)
    return best.contiguous(), idx


def pool_bwd_plain(idx, g, hw):
    """(offset int8 [N, C, Ho, Wo], g [N, C, Ho, Wo], (H, W)) -> dx
    [N, C, H, W] in g's type: 9 masked strided adds into a padded fp32
    accumulator (at least fp32: a float64 g stays float64), rounded once at
    the end, as the TPU kernel adds."""
    h, w = hw
    ho, wo = g.shape[-2:]
    acc = g.new_zeros(*g.shape[:-2], h + 2, w + 2,
                      dtype=torch.promote_types(g.dtype, torch.float32))
    for k, (di, dj) in enumerate(_OFFSETS):
        _window(acc, di, dj, ho, wo).add_(torch.where(idx == k, g, torch.zeros_like(g)))
    return acc[..., 1:h + 1, 1:w + 1].to(g.dtype).contiguous()


# ---------------------------------------------------------------------------
# kernels 3 and 4, each in fp32 and bf16
# ---------------------------------------------------------------------------

def pool_fwd_cuda(x):
    """Kernel 3: x [N, C, H, W] fp32 or bf16, NCHW-contiguous -> (max in x's
    type, offset int8), each [N, C, Ho, Wo]. Planes past a block's 40 KB go
    in bands of whole rows; a ValueError names a W too wide for a band of
    one output row in 227 KB of shared memory (about 16,000 fp32 or 31,000
    bf16 elements where H >= 3)."""
    if on_cpu((x,)):
        return pool_fwd_plain(x)
    name = kernel_name("stem_pool_fwd", x.dtype)
    check_cuda_inputs(name, (x,), dtypes=(x.dtype,))
    if x.dim() != 4:
        raise ValueError(f"{name}: expected [N, C, H, W], got {tuple(x.shape)}")
    n, c, h, w = x.shape
    _check_plane(h, w, x.dtype)
    ho, wo = pooled_hw(h, w)
    out = torch.empty(n, c, ho, wo, dtype=x.dtype, device=x.device)
    idx = torch.empty(n, c, ho, wo, dtype=torch.int8, device=x.device)
    launch(name, x.data_ptr(), n * c, h, w, out.data_ptr(), idx.data_ptr(),
           stream_of(x))
    return out, idx


def pool_fwd_plan(shape, dtype):
    """How kernel 3's launcher runs an input of @shape [N, C, H, W] in @dtype
    (fp32 or bf16), as ``csrc/stem_pool.cu``'s ``fwd_plan`` decides it:
    (planes per block, 0 where the band kernel takes planes too large for a
    block; blocks; a block's shared memory in bytes; a band's output rows, 0
    where blocks take whole planes). Launches nothing; builds the kernel's
    library where it is not built yet. Raises a ValueError naming W where
    the rows are too wide for a band of one output row."""
    fn = library(kernel_name("stem_pool_fwd", dtype)).stem_pool_fwd_plan
    fn.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_longlong)]
    plan = (ctypes.c_longlong * 4)()
    n, c, h, w = shape
    err = fn(n * c, h, w, torch.empty(0, dtype=dtype).element_size(), plan)
    if err != 0:
        raise ValueError(
            f"stem_pool_fwd: no plan for {tuple(shape)} in {dtype}: rows of W = {w} "
            "are too wide for one output row's 3 input rows, maxima and offsets "
            "in a block's 227 KB of shared memory")
    return tuple(plan)


@functools.lru_cache(maxsize=None)
def _check_plane(h, w, dtype):
    """Raise pool_fwd_plan's ValueError where kernel 3 has no plan for H x W
    planes in @dtype; once per plane size and type."""
    pool_fwd_plan((1, 1, h, w), dtype)


def pool_bwd_cuda(idx, g, hw):
    """Kernel 4: (offset int8, g fp32 or bf16) [N, C, Ho, Wo], contiguous,
    and the input's (H, W) -> dx [N, C, H, W] in g's type."""
    if on_cpu((idx, g)):
        return pool_bwd_plain(idx, g, hw)
    name = kernel_name("stem_pool_bwd", g.dtype)
    check_cuda_inputs(name, (idx, g), dtypes=(torch.int8, g.dtype))
    if idx.dtype != torch.int8:
        raise TypeError(f"{name}: expected int8 idx, got {idx.dtype}")
    h, w = hw
    if g.dim() != 4 or idx.shape != g.shape or tuple(g.shape[-2:]) != pooled_hw(h, w):
        raise ValueError(
            f"{name}: idx {tuple(idx.shape)}, g {tuple(g.shape)} and input "
            f"{h}x{w} do not fit"
        )
    n, c = g.shape[:2]
    dx = torch.empty(n, c, h, w, dtype=g.dtype, device=g.device)
    launch(name, idx.data_ptr(), g.data_ptr(), n * c, h, w, dx.data_ptr(),
           stream_of(g))
    return dx


class MaxPool3x3S2(torch.autograd.Function):
    """The stem pool with its recorded-argmax backward: the forward saves only
    the int8 offsets and the input's H and W (the JAX ``_vjp_fwd``)."""

    @staticmethod
    def forward(ctx, x, use_kernel):
        out, idx = (pool_fwd_cuda if use_kernel else pool_fwd_plain)(x)
        ctx.save_for_backward(idx)
        ctx.hw = tuple(x.shape[-2:])
        ctx.use_kernel = use_kernel
        return out

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        bwd = pool_bwd_cuda if ctx.use_kernel else pool_bwd_plain
        # the kernel takes contiguous tensors only; the trunk's gradients
        # arrive contiguous, so this is a no-op on the training path
        return bwd(idx, g.contiguous(), ctx.hw), None


def max_pool_3x3_s2(x, use_kernel=True):
    """Drop-in for ``F.max_pool2d(x, 3, 2, 1)`` on NCHW @x with the
    recorded-argmax backward: kernels 3 and 4 on CUDA tensors, their plain
    versions on CPU tensors or when @use_kernel is False."""
    return MaxPool3x3S2.apply(x, use_kernel)
