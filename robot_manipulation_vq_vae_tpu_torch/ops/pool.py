"""Max pooling whose backward routes by equality (counterpart of the JAX
package's ``ops/pool.py``): ``max_pool(x, window, strides, padding)`` and
``max_pool_3x3_s2`` on NCHW tensors, with kernel 5 in CUDA C++ for Hopper
(``csrc/pool_route.cu``) and its plain PyTorch version.

The forward is ``F.max_pool2d`` on the ``-inf``-padded input: in JAX it is
``lax.reduce_window``, not a TPU kernel. The backward is a
``torch.autograd.Function`` that, like the JAX op's custom VJP
(``ops/pool.py:72-93``), keeps x and z and dispatches on the configuration:

* a 3x3 window, stride 2, padding 1 and H, W even: ``pool_route_cuda``,
  which replaces the TPU kernel ``_pool_bwd_kernel``
  (``ops/pallas/pool_kernel.py:50``, behind ``max_pool_3x3_s2_bwd_pallas``):
  ``dx[i, j] = sum over the windows (p, q) covering (i, j) of
  dz[p, q] * [x[i, j] == z[p, q]]``, so a tied cotangent goes to every tied
  cell (torch's and XLA's own gradients pick one);
* any other configuration: torch's own gradient of the forward, as the JAX
  op takes XLA's.

The four routed terms of a cell are added in the TPU kernel's order, (p, q),
(p, q + 1), (p + 1, q), (p + 1, q + 1), in the gradient's type: in bf16 the
sum rounds after each add, as the TPU kernel's bf16 adds do. The wrapper runs
the plain version on CPU tensors and launches the kernel on CUDA tensors,
which must be fp32 or bf16 and contiguous; any other type raises, and it never
falls back from the kernel. ``pool_route_plan`` says how the kernel's
launcher runs a shape: runs of whole planes a block, or a warp per input row
for planes too large for a block. The JAX op takes NHWC; this one takes
NCHW, the layout of the port's trunk.
"""

import ctypes

import torch
import torch.nn.functional as F

from robot_manipulation_vq_vae_tpu_torch.ops.cuda_build import (
    check_cuda_inputs,
    kernel_name,
    launch,
    library,
    on_cpu,
    refuse_dtensors,
    stream_of,
)


def _pool_fwd(x, window, strides, padding):
    (top, bottom), (left, right) = padding
    if top == bottom <= window[0] // 2 and left == right <= window[1] // 2:
        # F.max_pool2d's own padding is -inf: no padded copy of x
        return F.max_pool2d(x, window, strides, (top, left))
    xp = F.pad(x, (left, right, top, bottom), value=float("-inf"))
    return F.max_pool2d(xp, window, strides)


# ---------------------------------------------------------------------------
# kernel 5 and its plain version
# ---------------------------------------------------------------------------

def pool_route_plain(x, z, dz):
    """x [N, C, H, W] (H, W even), z and dz [N, C, H/2, W/2] -> dx
    [N, C, H, W]: four masked terms on the [.., H/2, 2, W/2, 2] view of x,
    each window row and column broadcast over the two input rows and columns
    it starts, added in the TPU kernel's order."""
    n, c, h, w = x.shape
    ho, wo = h // 2, w // 2
    x6 = x.reshape(n, c, ho, 2, wo, 2)

    def shift(t, dim, fill):   # t at p + 1 (dim -2) or q + 1 (dim -1)
        pad = (0, 1) if dim == -1 else (0, 0, 0, 1)
        return F.pad(t.narrow(dim, 1, t.shape[dim] - 1), pad, value=fill)

    inf = float("-inf")
    z_c, d_c = shift(z, -1, inf), shift(dz, -1, 0.0)
    z_r, d_r = shift(z, -2, inf), shift(dz, -2, 0.0)
    z_b, d_b = shift(z_r, -1, inf), shift(d_r, -1, 0.0)
    odd = torch.tensor([False, True], device=x.device)
    odd_row, odd_col = odd.view(2, 1, 1), odd.view(2)

    def term(zz, dd, mask=None):
        eq = x6 == zz[:, :, :, None, :, None]
        if mask is not None:
            eq = eq & mask
        return torch.where(eq, dd[:, :, :, None, :, None], 0.0)

    dx = term(z, dz)
    dx = dx + term(z_c, d_c, odd_col)
    dx = dx + term(z_r, d_r, odd_row)
    dx = dx + term(z_b, d_b, odd_row & odd_col)
    return dx.reshape(n, c, h, w)


def pool_route_cuda(x, z, dz):
    """Kernel 5: x [N, C, H, W] with H and W even, z and dz [N, C, H/2, W/2],
    contiguous, all fp32 or all bf16 -> dx [N, C, H, W]."""
    refuse_dtensors("pool_route_cuda", (x, z, dz))
    if on_cpu((x, z, dz)):
        return pool_route_plain(x, z, dz)
    name = kernel_name("pool_route", x.dtype)
    check_cuda_inputs(name, (x, z, dz), dtypes=(x.dtype,))
    if x.dim() != 4 or x.shape[2] % 2 or x.shape[3] % 2:
        raise ValueError(f"{name}: expected [N, C, H, W] with H, W even, got "
                         f"{tuple(x.shape)}")
    n, c, h, w = x.shape
    if tuple(z.shape) != (n, c, h // 2, w // 2) or z.shape != dz.shape:
        raise ValueError(f"{name}: x {tuple(x.shape)}, z {tuple(z.shape)} and dz "
                         f"{tuple(dz.shape)} do not fit")
    dx = torch.empty_like(x)
    launch(name, x.data_ptr(), z.data_ptr(), dz.data_ptr(), n * c, h, w,
           dx.data_ptr(), stream_of(x))
    return dx


def pool_route_plan(shape, dtype):
    """How kernel 5's launcher runs an input of @shape [N, C, H, W] in @dtype
    (fp32 or bf16), as ``csrc/pool_route.cu``'s ``route_plan`` decides it:
    (planes per block, 0 where the row kernel takes planes too large for a
    block; blocks; a block's shared memory in bytes). Launches nothing;
    builds the kernel's library where it is not built yet."""
    fn = library(kernel_name("pool_route", dtype)).pool_route_plan
    fn.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_longlong)]
    plan = (ctypes.c_longlong * 3)()
    n, c, h, w = shape
    err = fn(n * c, h, w, torch.empty(0, dtype=dtype).element_size(), plan)
    if err != 0:
        raise ValueError(f"pool_route: no plan for {tuple(shape)} in {dtype}")
    return tuple(plan)


def routes(x, z, window, strides, padding):
    """Whether the backward of this pool goes through kernel 5: the JAX
    op's own test (``ops/pool.py:75-79``)."""
    h, w = x.shape[-2:]
    return (
        x.dim() == 4 and tuple(window) == (3, 3) and tuple(strides) == (2, 2)
        and tuple(map(tuple, padding)) == ((1, 1), (1, 1))
        and h % 2 == 0 and w % 2 == 0 and tuple(z.shape[-2:]) == (h // 2, w // 2)
    )


class MaxPool(torch.autograd.Function):
    """The pool with the JAX op's backward: kernel 5 (or, with
    ``use_kernel`` False, its plain version) where ``routes`` says so, torch's
    own gradient of the forward elsewhere."""

    @staticmethod
    def forward(ctx, x, window, strides, padding, use_kernel):
        z = _pool_fwd(x, window, strides, padding)
        ctx.save_for_backward(x, z)
        ctx.config = (window, strides, padding)
        ctx.use_kernel = use_kernel
        return z

    @staticmethod
    def backward(ctx, dz):
        x, z = ctx.saved_tensors
        if routes(x, z, *ctx.config):
            route = pool_route_cuda if ctx.use_kernel else pool_route_plain
            dx = route(x, z, dz.contiguous())
        else:
            with torch.enable_grad():
                xr = x.detach().requires_grad_(True)
                (dx,) = torch.autograd.grad(_pool_fwd(xr, *ctx.config), xr, dz)
        return dx, None, None, None, None


def max_pool(x, window=(3, 3), strides=(2, 2), padding=((1, 1), (1, 1)),
             use_kernel=True):
    """NCHW max pool, the same forward as ``F.max_pool2d`` with ``-inf``
    padding of ((top, bottom), (left, right)), and the equality-routing
    backward (see the module docstring)."""
    return MaxPool.apply(x, tuple(window), tuple(strides),
                         tuple(map(tuple, padding)), use_kernel)


def max_pool_3x3_s2(x, use_kernel=True):
    """The ResNet stem pool: 3x3 window, stride 2, padding 1."""
    return max_pool(x, (3, 3), (2, 2), ((1, 1), (1, 1)), use_kernel)
