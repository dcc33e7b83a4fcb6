"""The two LipVQ kernels, written in CUDA C++ for Hopper (``sm_90a``), with
their plain PyTorch versions and the build.

Counterpart of the JAX package's ``ops/pallas/lipvq_kernel.py``:

* ``l2_nearest_cuda`` replaces the TPU kernel ``_assign_kernel`` (reached
  through ``l2_nearest_pallas``): idx = argmin_k ||z - C_k||^2, first index
  on a tie, and z_q = C[idx]. The work is 2 N K D fp32 operations against
  (2 N D + K D) * 4 bytes, so on the H100 it is bound by fp32 FMAs at every
  shape the port runs. The design (``csrc/lipvq_assign.cu`` on the tile
  product of ``csrc/lipvq_assign_core.cuh``) keeps the [N, K] distance
  matrix out of device memory: each block runs a register-tiled fp32 product
  of 64 rows against tiles of 64 or 128 codes, staged from L2 16 deep and
  double-buffered, and keeps a running (min, argmin) per row in registers;
  the 4 MB codebook of the policy path cannot stay in one SM's shared
  memory, as it stayed whole in VMEM on the TPU. ``_assign_splits`` takes
  128-code tiles where the row tiles fill the card (the tokenizer-sized N)
  and 64-code tiles below; the policy path has few rows (16 per
  environment), so it also splits the codebook across blocks until about
  two blocks per SM are in flight, and a second small kernel merges the
  partial minima and gathers.
* ``lipvq_roundtrip_cuda`` replaces ``_roundtrip_kernel`` (reached through
  ``lipvq_roundtrip_pallas``): the whole tokenize + detokenize of a 64-row
  tile in one kernel, encoder MLP -> Lipschitz latent -> assign -> gather ->
  decoder MLP, with tanh-GELU as in the TPU kernel. It is bound by fp32
  operations (about 0.55 MFLOP per row against 96 bytes of input and
  output); its design (``csrc/lipvq_roundtrip.cu``) keeps every intermediate
  in shared memory and runs the five dense layers and the nearest-code
  search through the same tile product.

Each wrapper runs its plain version on CPU tensors (the tests) and launches
its kernel on CUDA tensors; it never falls back from the kernel. The raw
launches are forward only and raise when a gradient is asked of them.
Models differentiate the assignment through ``L2Nearest``
(``l2_nearest``), whose backward is the TPU kernel's custom VJP
(``lipvq_kernel.py:127-132``): no gradient for z, and the cotangent of z_q
summed into the codebook rows by index (``index_add_``, as the TPU backward
was plain XLA, ``segment_sum``), in the cotangent's type.

The kernels are built by ``ops/cuda_build.py``.
"""

import torch
import torch.nn.functional as F

from robot_manipulation_vq_vae_tpu_torch.ops.cuda_build import (
    check_cuda_inputs,
    launch,
    on_cpu,
    stream_of,
)
from robot_manipulation_vq_vae_tpu_torch.utils.mixed_precision import at_least_f32


# ---------------------------------------------------------------------------
# kernel 1: nearest-code assignment + gather
# ---------------------------------------------------------------------------

def l2_nearest_plain(z, codebook):
    """Plain version of the assign kernel: argmin_k of
    ||C_k||^2 - 2 z.C_k (first index on a tie) and the gathered codes.
    Operands narrower than fp32 are upcast first and the distances formed in
    fp32, as the TPU kernel does (c_sq from the upcast codebook, as
    ``_assign_pallas_raw`` computes it). Returns (idx [N] int32, z_q [N, D]
    in z's type)."""
    z32, cb32 = at_least_f32(z), at_least_f32(codebook)
    c_sq = (cb32 * cb32).sum(-1)
    idx = (c_sq[None, :] - 2.0 * (z32 @ cb32.t())).argmin(-1)
    return idx.to(torch.int32), codebook[idx].to(z.dtype)


def _assign_splits(n, k, sms):
    """(width, S, codes per split) for N = @n rows, K = @k codes and @sms
    SMs: 128-code tiles where the row tiles x the 128-code tiles give at
    least two blocks per SM, else 64-code tiles; and a split of the codebook
    into S ranges of whole tiles so that row tiles x S gives about two
    blocks per SM."""
    row_tiles = -(-n // 64)
    width = 128 if row_tiles * -(-k // 128) >= 2 * sms else 64
    code_tiles = -(-k // width)
    splits = min(code_tiles, max(1, -(-2 * sms // row_tiles)))
    per_split = -(-code_tiles // splits) * width
    return width, -(-k // per_split), per_split


def l2_nearest_cuda(z, codebook):
    """Fused nearest-code assignment + gather. z [N, D] fp32 and codebook
    [K, D] fp32 (kernel ``lipvq_assign``) or bf16 (``lipvq_assign_bf16``,
    the instance the mixed-precision paper step runs, whose LipVQ latent
    stays fp32: it reads the bf16 codebook as it lies, forms the distances
    in fp32 from c_sq summed over the upcast codebook, and writes z_q in
    fp32). Returns (idx [N] int32, z_q [N, D] fp32)."""
    if on_cpu((z, codebook)):
        return l2_nearest_plain(z, codebook)
    name = "lipvq_assign_bf16" if codebook.dtype == torch.bfloat16 else "lipvq_assign"
    check_cuda_inputs(name, (z, codebook), (torch.float32, torch.bfloat16))
    if z.dtype != torch.float32:
        raise TypeError(f"{name}: z must be fp32, got {z.dtype}")
    if z.dim() != 2 or codebook.dim() != 2 or z.shape[1] != codebook.shape[1]:
        raise ValueError(
            f"{name}: z {tuple(z.shape)} and codebook {tuple(codebook.shape)}"
        )
    n, d = z.shape
    k = codebook.shape[0]
    cb32 = at_least_f32(codebook)
    c_sq = (cb32 * cb32).sum(-1)
    idx = torch.empty(n, dtype=torch.int32, device=z.device)
    z_q = torch.empty_like(z)
    sms = torch.cuda.get_device_properties(z.device).multi_processor_count
    width, splits, per_split = _assign_splits(n, k, sms)
    part_v = part_i = None
    if splits > 1:
        part_v = torch.empty(splits, n, dtype=torch.float32, device=z.device)
        part_i = torch.empty(splits, n, dtype=torch.int32, device=z.device)
    stream = stream_of(z)
    launch(name, z.data_ptr(), codebook.data_ptr(), c_sq.data_ptr(),
           n, d, k, width, splits, per_split, idx.data_ptr(), z_q.data_ptr(),
           part_v.data_ptr() if part_v is not None else None,
           part_i.data_ptr() if part_i is not None else None, stream)
    return idx, z_q


class L2Nearest(torch.autograd.Function):
    """Nearest-code assignment with the codebook's gradient: forward through
    the assign kernel (or, with ``use_kernel`` False, its plain version);
    backward d_codebook = the rows of g_zq summed by idx (``index_add_``) in
    g_zq's type, as JAX's ``segment_sum`` sums them, and no gradient for z.
    The paper step's g_zq is fp32 (its z is): the sum stays fp32 and
    autograd rounds it once to a bf16 codebook's type."""

    @staticmethod
    def forward(ctx, z, codebook, use_kernel):
        nearest = l2_nearest_cuda if use_kernel else l2_nearest_plain
        idx, z_q = nearest(z, codebook)
        ctx.save_for_backward(idx)
        ctx.num_codes = codebook.shape[0]
        ctx.mark_non_differentiable(idx)
        return idx, z_q

    @staticmethod
    def backward(ctx, _g_idx, g_zq):
        (idx,) = ctx.saved_tensors
        d_cb = g_zq.new_zeros(ctx.num_codes, g_zq.shape[1])
        return None, d_cb.index_add_(0, idx.long(), g_zq), None


def l2_nearest(z, codebook, use_kernel=True):
    """Differentiable nearest-code assignment + gather: (idx [N] int32,
    z_q [N, D]); the kernel on CUDA tensors, the plain version on CPU
    tensors or when @use_kernel is False. z is fp32 (fp64 on the CPU):
    LipVQ's latent stays fp32 under mixed precision, and a bf16 z would
    need a bf16 cotangent summed in JAX's row order."""
    if z.dtype == torch.bfloat16:
        raise TypeError("l2_nearest: z must not be bf16 (LipVQ's latent is fp32)")
    return L2Nearest.apply(z, codebook, use_kernel)


# ---------------------------------------------------------------------------
# kernel 2: the whole tokenize + detokenize roundtrip
# ---------------------------------------------------------------------------

def _gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def lipvq_roundtrip_plain(x, enc_w, lip_w, codebook, dec_w):
    """Plain version of the roundtrip kernel, tanh-GELU included. Arguments
    as for :func:`lipvq_roundtrip_cuda`."""
    (w1, b1), (w2, b2) = enc_w
    wl, bl = lip_w
    (w3, b3), (w4, b4), (w5, b5) = dec_w
    h = _gelu_tanh(x @ w1 + b1)
    h = _gelu_tanh(h @ w2 + b2)
    z = torch.sigmoid(h @ wl + bl)
    idx, z_q = l2_nearest_plain(z, codebook)
    d = _gelu_tanh(z_q @ w3 + b3)
    d = _gelu_tanh(d @ w4 + b4)
    return d @ w5 + b5, idx


def lipvq_roundtrip_cuda(x, enc_w, lip_w, codebook, dec_w):
    """Fused tokenize + detokenize.

    x [N, in] fp32; enc_w ((W1 [in, h1], b1), (W2 [h1, H], b2)); lip_w
    (Wl [H, L] already L-inf row-normalized and transposed, bl [L]);
    codebook [K, L]; dec_w ((W3 [L, h1], b3), (W4 [h1, H], b4),
    (W5 [H, out], b5)). Weights keep the JAX [in, out] layout. The kernel
    takes h1 <= 64, H <= 128, L <= 256 and out <= 16.
    Returns (recon [N, out], idx [N] int32).
    """
    (w1, b1), (w2, b2) = enc_w
    wl, bl = lip_w
    (w3, b3), (w4, b4), (w5, b5) = dec_w
    tensors = (x, w1, b1, w2, b2, wl, bl, codebook, w3, b3, w4, b4, w5, b5)
    if on_cpu(tensors):
        return lipvq_roundtrip_plain(x, enc_w, lip_w, codebook, dec_w)
    name = "lipvq_roundtrip"
    check_cuda_inputs(name, tensors)
    n, in_dim = x.shape
    h1, hidden, latent = w1.shape[1], w2.shape[1], wl.shape[1]
    k, out_dim = codebook.shape[0], w5.shape[1]
    expected = {
        "W1": (w1, (in_dim, h1)), "b1": (b1, (h1,)),
        "W2": (w2, (h1, hidden)), "b2": (b2, (hidden,)),
        "Wl": (wl, (hidden, latent)), "bl": (bl, (latent,)),
        "codebook": (codebook, (k, latent)),
        "W3": (w3, (latent, h1)), "b3": (b3, (h1,)),
        "W4": (w4, (h1, hidden)), "b4": (b4, (hidden,)),
        "W5": (w5, (hidden, out_dim)), "b5": (b5, (out_dim,)),
    }
    for key, (t, shape) in expected.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {key} {tuple(t.shape)}, expected {shape}")
    if h1 > 64 or hidden > 128 or latent > 256 or out_dim > 16:
        raise ValueError(
            f"{name}: widths h1={h1} H={hidden} L={latent} out={out_dim} "
            "exceed the kernel's 64 / 128 / 256 / 16"
        )
    c_sq = (codebook * codebook).sum(-1)
    recon = torch.empty(n, out_dim, dtype=torch.float32, device=x.device)
    idx = torch.empty(n, dtype=torch.int32, device=x.device)
    stream = stream_of(x)
    launch(
        name,
        x.data_ptr(), n, in_dim, w1.data_ptr(), b1.data_ptr(), h1,
        w2.data_ptr(), b2.data_ptr(), hidden, wl.data_ptr(), bl.data_ptr(),
        latent, codebook.data_ptr(), c_sq.data_ptr(), k,
        w3.data_ptr(), b3.data_ptr(), w4.data_ptr(), b4.data_ptr(),
        w5.data_ptr(), b5.data_ptr(), out_dim, recon.data_ptr(),
        idx.data_ptr(), stream,
    )
    return recon, idx
