"""The two LipVQ kernels, written in CUDA C++ for Hopper (``sm_90a``), with
their plain PyTorch versions and the build.

Counterpart of the JAX package's ``ops/pallas/lipvq_kernel.py``:

* ``l2_nearest_cuda`` replaces the TPU kernel ``_assign_kernel`` (reached
  through ``l2_nearest_pallas``): idx = argmin_k ||z - C_k||^2, first index
  on a tie, and z_q = C[idx]. The work is 2 N K D fp32 operations against
  (2 N D + K D) * 4 bytes, so on the H100 it is bound by fp32 operations at
  every shape the port runs. The design (``csrc/lipvq_assign.cu``) keeps the
  [N, K] distance matrix out of device memory: each block streams the
  codebook from L2 in tiles and keeps a running (min, argmin) per row in
  registers; the 4 MB codebook of the policy path cannot stay in one SM's
  shared memory, as it stayed whole in VMEM on the TPU. The policy path has
  few rows (16 per environment), so the wrapper also splits the codebook
  across blocks until about two blocks per SM are in flight, and a second
  small kernel merges the partial minima and gathers.
* ``lipvq_roundtrip_cuda`` replaces ``_roundtrip_kernel`` (reached through
  ``lipvq_roundtrip_pallas``): the whole tokenize + detokenize of a 64-row
  tile in one kernel, encoder MLP -> Lipschitz latent -> assign -> gather ->
  decoder MLP, with tanh-GELU as in the TPU kernel. It is bound by fp32
  operations (about 0.55 MFLOP per row against 96 bytes of input and
  output); its design (``csrc/lipvq_roundtrip.cu``) keeps every intermediate
  in shared memory and shares the streaming argmin with the assign kernel.

Each wrapper runs its plain version on CPU tensors (the tests) and launches
its kernel on CUDA tensors; it never falls back from the kernel. The kernels
are forward only: the backward (a segment sum into the codebook) comes with
the training slice, so the kernel path raises when a gradient is asked for.

The kernels are compiled with ``nvcc`` at first use into ``build/`` at the
root of the checkout, one shared library with a plain C interface per
source, loaded with ``ctypes``. ``build_kernels()`` builds them all at once,
one ``nvcc`` per source in parallel.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch
import torch.nn.functional as F

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I = ctypes.c_void_p, ctypes.c_int
# library name -> (source, C entry point, its argument types)
_KERNELS = {
    "lipvq_assign": (
        "lipvq_assign.cu", "lipvq_assign_launch",
        [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    ),
    "lipvq_roundtrip": (
        "lipvq_roundtrip.cu", "lipvq_roundtrip_launch",
        [_P, _I, _I, _P, _P, _I, _P, _P, _I, _P, _P, _I, _P, _P, _I,
         _P, _P, _P, _P, _P, _P, _I, _P, _P, _P],
    ),
}
_HEADERS = ("lipvq_assign_core.cuh",)

# Launch counts: each wrapper adds one where it launches its kernel, and
# nowhere else.
LAUNCHES = {name: 0 for name in _KERNELS}
_LIBS = {}


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------

def _nvcc():
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _library_path(name):
    """build/lib<name>-<hash>.so, the hash over the sources and the flags, so
    that an edited source never meets a stale library."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (_KERNELS[name][0],) + _HEADERS:
        digest.update((CSRC_DIR / src).read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_kernels(names=None):
    """Compile (where not built yet) and load the named kernels, all kernels
    by default, one nvcc per source in parallel. Returns the seconds taken."""
    t0 = time.perf_counter()
    names = [n for n in (names or _KERNELS) if n not in _LIBS]
    pending = []
    for name in names:
        path = _library_path(name)
        if path.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        log = path.with_suffix(".log")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / _KERNELS[name][0])]
        with open(log, "w") as fh:
            proc = subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT)
        pending.append((name, proc, tmp, path, log))
    failed = []
    for name, proc, tmp, path, log in pending:
        if proc.wait() != 0:
            failed.append(f"{name}:\n{log.read_text()}")
        else:
            os.replace(tmp, path)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    for name in names:
        lib = ctypes.CDLL(str(_library_path(name)))
        fn = getattr(lib, _KERNELS[name][1])
        fn.argtypes = _KERNELS[name][2]
        fn.restype = ctypes.c_int
        lib.lipvq_error_string.argtypes = [ctypes.c_int]
        lib.lipvq_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return time.perf_counter() - t0


def build_log(name):
    """nvcc's output (ptxas registers, shared memory, spills) for @name."""
    log = _library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def _launch(name, *args):
    if name not in _LIBS:
        build_kernels([name])
    lib = _LIBS[name]
    err = getattr(lib, _KERNELS[name][1])(*args)
    if err != 0:
        raise RuntimeError(
            f"{name} launch failed: {lib.lipvq_error_string(err).decode()}"
        )
    LAUNCHES[name] += 1


def _check_cuda_inputs(name, tensors):
    device = tensors[0].device
    for t in tensors:
        if t.device != device:
            raise ValueError(f"{name}: tensors on {t.device} and {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
        if torch.is_grad_enabled() and t.requires_grad:
            raise RuntimeError(
                f"{name} is forward only: its backward comes with the "
                "training slice (see ROADMAP.md)"
            )


def _on_cpu(tensors):
    return all(t.device.type == "cpu" for t in tensors)


# ---------------------------------------------------------------------------
# kernel 1: nearest-code assignment + gather
# ---------------------------------------------------------------------------

def l2_nearest_plain(z, codebook):
    """Plain version of the assign kernel: argmin_k of
    ||C_k||^2 - 2 z.C_k (first index on a tie) and the gathered codes.
    Returns (idx [N] int32, z_q [N, D])."""
    c_sq = (codebook * codebook).sum(-1)
    idx = (c_sq[None, :] - 2.0 * (z @ codebook.t())).argmin(-1)
    return idx.to(torch.int32), codebook[idx]


def _assign_splits(n, k, device):
    """(S, codes per split): split the codebook into S ranges of whole
    64-code tiles so that row tiles x S gives about two blocks per SM."""
    row_tiles, code_tiles = -(-n // 64), -(-k // 64)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    splits = min(code_tiles, max(1, -(-2 * sms // row_tiles)))
    per_split = -(-code_tiles // splits) * 64
    return -(-k // per_split), per_split


def l2_nearest_cuda(z, codebook):
    """Fused nearest-code assignment + gather. z [N, D], codebook [K, D]
    fp32. Returns (idx [N] int32, z_q [N, D])."""
    if _on_cpu((z, codebook)):
        return l2_nearest_plain(z, codebook)
    name = "lipvq_assign"
    _check_cuda_inputs(name, (z, codebook))
    if z.dim() != 2 or codebook.dim() != 2 or z.shape[1] != codebook.shape[1]:
        raise ValueError(
            f"{name}: z {tuple(z.shape)} and codebook {tuple(codebook.shape)}"
        )
    n, d = z.shape
    k = codebook.shape[0]
    c_sq = (codebook * codebook).sum(-1)
    idx = torch.empty(n, dtype=torch.int32, device=z.device)
    z_q = torch.empty_like(z)
    splits, per_split = _assign_splits(n, k, z.device)
    part_v = part_i = None
    if splits > 1:
        part_v = torch.empty(splits, n, dtype=torch.float32, device=z.device)
        part_i = torch.empty(splits, n, dtype=torch.int32, device=z.device)
    stream = torch.cuda.current_stream(z.device).cuda_stream
    _launch(name, z.data_ptr(), codebook.data_ptr(), c_sq.data_ptr(),
            n, d, k, splits, per_split, idx.data_ptr(), z_q.data_ptr(),
            part_v.data_ptr() if part_v is not None else None,
            part_i.data_ptr() if part_i is not None else None, stream)
    return idx, z_q


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
    if _on_cpu(tensors):
        return lipvq_roundtrip_plain(x, enc_w, lip_w, codebook, dec_w)
    name = "lipvq_roundtrip"
    _check_cuda_inputs(name, tensors)
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
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _launch(
        name,
        x.data_ptr(), n, in_dim, w1.data_ptr(), b1.data_ptr(), h1,
        w2.data_ptr(), b2.data_ptr(), hidden, wl.data_ptr(), bl.data_ptr(),
        latent, codebook.data_ptr(), c_sq.data_ptr(), k,
        w3.data_ptr(), b3.data_ptr(), w4.data_ptr(), b4.data_ptr(),
        w5.data_ptr(), b5.data_ptr(), out_dim, recon.data_ptr(),
        idx.data_ptr(), stream,
    )
    return recon, idx
