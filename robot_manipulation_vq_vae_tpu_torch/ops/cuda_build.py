"""Build, load and launch the port's hand-written CUDA kernels, and count their
launches.

Every source in ``csrc/`` with a C entry point is compiled with ``nvcc`` for
Hopper (``sm_90a``) at first use into ``build/`` at the root of the checkout:
one shared library with a plain C interface per source, loaded with
``ctypes``. ``build_kernels()`` builds them all at once, one ``nvcc`` per
source in parallel. Each library exports ``<prefix>_error_string(int)``,
which names the CUDA error its launch function returned.

``LAUNCHES`` counts each kernel's launches: a wrapper adds one where it
launches its kernel (``launch``), and nowhere else. A kernel compiled for two
element types counts each instance under its own name (``stem_pool_fwd`` and
``stem_pool_fwd_bf16``); ``kernel_name`` picks the instance for a dtype.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# kernel name -> (source, C entry point, its argument types, error-string
# function, headers the source includes)
KERNELS = {
    "lipvq_assign": (
        "lipvq_assign.cu", "lipvq_assign_launch",
        [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P],
        "lipvq_error_string", ("lipvq_assign_core.cuh",),
    ),
    # kernel 1's bf16 instance: a bf16 codebook, z fp32
    "lipvq_assign_bf16": (
        "lipvq_assign.cu", "lipvq_assign_bf16_launch",
        [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P],
        "lipvq_error_string", ("lipvq_assign_core.cuh",),
    ),
    "lipvq_roundtrip": (
        "lipvq_roundtrip.cu", "lipvq_roundtrip_launch",
        [_P, _I, _I, _P, _P, _I, _P, _P, _I, _P, _P, _I, _P, _P, _I,
         _P, _P, _P, _P, _P, _P, _I, _P, _P, _P],
        "lipvq_error_string", ("lipvq_assign_core.cuh",),
    ),
    # the bf16 instances of kernels 3 to 5 are kernels of their own, with
    # their own entry points and launch counts
    **{
        f"stem_pool_{step}{suffix}": (
            "stem_pool.cu", f"stem_pool_{step}{suffix}_launch", argtypes,
            "stem_pool_error_string", ("stage_run.cuh",),
        )
        for step, argtypes in (("fwd", [_P, _L, _I, _I, _P, _P, _P]),
                               ("bwd", [_P, _P, _L, _I, _I, _P, _P]))
        for suffix in ("", "_bf16")
    },
    **{
        f"pool_route{suffix}": (
            "pool_route.cu", f"pool_route{suffix}_launch",
            [_P, _P, _P, _L, _I, _I, _P, _P], "pool_route_error_string",
            ("stage_run.cuh",),
        )
        for suffix in ("", "_bf16")
    },
}

LAUNCHES = {name: 0 for name in KERNELS}
_LIBS = {}   # source -> loaded library


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc():
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources():
    """source -> the headers it includes, over every kernel."""
    out = {}
    for src, _, _, _, headers in KERNELS.values():
        out.setdefault(src, set()).update(headers)
    return out


def library_path(source):
    """build/lib<stem>-<hash>.so, the hash over the source, its headers and
    the flags, so that an edited source never meets a stale library."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (source, *sorted(_sources()[source])):
        digest.update((CSRC_DIR / f).read_bytes())
    return BUILD_DIR / f"lib{Path(source).stem}-{digest.hexdigest()[:16]}.so"


def build_kernels(names=None):
    """Compile (where not built yet) and load the sources of the named
    kernels, all kernels by default, one nvcc per source in parallel.
    Returns the seconds taken."""
    t0 = time.perf_counter()
    sources = sorted({KERNELS[n][0] for n in (names or KERNELS)} - set(_LIBS))
    pending = []
    for src in sources:
        path = library_path(src)
        if path.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        log = path.with_suffix(".log")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / src)]
        with open(log, "w") as fh:
            proc = subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT)
        pending.append((src, proc, tmp, path, log))
    failed = []
    for src, proc, tmp, path, log in pending:
        if proc.wait() != 0:
            failed.append(f"{src}:\n{log.read_text()}")
        else:
            os.replace(tmp, path)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    for src in sources:
        _LIBS[src] = ctypes.CDLL(str(library_path(src)))
    for name, (src, entry, argtypes, err_fn, _) in KERNELS.items():
        if src in sources:
            fn = getattr(_LIBS[src], entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            err = getattr(_LIBS[src], err_fn)
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
    return time.perf_counter() - t0


def build_log(source):
    """nvcc's output (ptxas registers, shared memory, spills) for @source."""
    log = library_path(source).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def library(name):
    """The loaded library of kernel @name's source, built at first use."""
    src = KERNELS[name][0]
    if src not in _LIBS:
        build_kernels([name])
    return _LIBS[src]


def launch(name, *args):
    """Call kernel @name's C entry point (building it at first use), raise on
    the CUDA error it returns, and count the launch."""
    _, entry, _, err_fn, _ = KERNELS[name]
    lib = library(name)
    err = getattr(lib, entry)(*args)
    if err != 0:
        raise RuntimeError(
            f"{name} launch failed: {getattr(lib, err_fn)(err).decode()}"
        )
    LAUNCHES[name] += 1


def check_cuda_inputs(name, tensors, dtypes=(torch.float32,)):
    """Raise unless @tensors share one device, have one of @dtypes, are
    contiguous, and ask for no gradient (the raw launches have no backward:
    autograd reaches them through their ``torch.autograd.Function``)."""
    device = tensors[0].device
    for t in tensors:
        if t.device != device:
            raise ValueError(f"{name}: tensors on {t.device} and {device}")
        if t.dtype not in dtypes:
            raise TypeError(f"{name}: expected {dtypes}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
        if torch.is_grad_enabled() and t.requires_grad:
            raise RuntimeError(
                f"{name}: the raw launch is forward only; differentiate "
                "through its torch.autograd.Function"
            )


_DTYPE_SUFFIX = {torch.float32: "", torch.bfloat16: "_bf16"}


def kernel_name(base, dtype):
    """The instance of kernel @base for @dtype (fp32 or bf16); raises for any
    other type."""
    if dtype not in _DTYPE_SUFFIX:
        raise TypeError(f"{base}: expected float32 or bfloat16, got {dtype}")
    return base + _DTYPE_SUFFIX[dtype]


def on_cpu(tensors):
    return all(t.device.type == "cpu" for t in tensors)


def stream_of(t):
    return torch.cuda.current_stream(t.device).cuda_stream
