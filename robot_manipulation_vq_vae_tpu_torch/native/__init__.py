"""The host-side window gather of the data path (a copy of the JAX package's
``native/``), compiled from ``window_gather.cpp`` with ``g++`` and loaded with
``ctypes``.

The library is built at first use into ``build/`` at the root of the
checkout, under a name that carries a hash of the source and the flags, so
an edited source never meets a stale library. The build writes to a
temporary name and moves the finished library into place with
``os.replace``: a failed or interrupted build leaves no partial file under
the library's name. Without a compiler every entry point takes its numpy
version; ``is_available()`` says which path is active.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "window_gather.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-pthread")

_P, _L = ctypes.c_void_p, ctypes.c_int64
_ARGTYPES = {
    "gather_windows": [_P, _P, _P, _L, _L, _L, _L],
    "gather_windows_at": [_P, _P, _P, _P, _L, _L, _L, _L],
    "gather_windows_at_mt": [_P, _P, _P, _P, _L, _L, _L, _L, _L],
    "gather_windows_multi": [_P, _P, _P, _P, _L, _L, _L],
    "window_pad_masks": [_P, _P, _P, _L, _L],
}

_lib = None     # the loaded library, False once a build failed


def library_path():
    """build/libwindow_gather-<hash>.so, the hash over the source and flags."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libwindow_gather-{digest.hexdigest()[:16]}.so"


def build(compiler=None):
    """Compile the library (if it is not built yet) and return its path.
    Raises where the compiler is missing or fails; the temporary file of a
    failed build is removed."""
    path = library_path()
    if path.exists():
        return path
    compiler = compiler or os.environ.get("CXX") or shutil.which("g++")
    if not compiler:
        raise RuntimeError("no C++ compiler: the native window gather cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run([compiler, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{compiler} failed on {SOURCE.name}:\n{proc.stderr}")
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)
    return path


def _load():
    global _lib
    if _lib is None:
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, RuntimeError):
            _lib = False
        else:
            for name, argtypes in _ARGTYPES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = None
            _lib = lib
    return _lib


def is_available():
    """Whether the native library is the active path (else numpy)."""
    return bool(_load())


def _row_bytes(arr):
    return int(np.prod(arr.shape[1:], dtype=np.int64)) * arr.itemsize


def gather_windows(src, starts, window):
    """Edge-padded batched window gather from one demo array: src [T, ...],
    starts [N] window starts (out-of-range rows repeat the edge row);
    returns [N, window, ...]."""
    src = np.ascontiguousarray(src)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    n, t_len = starts.shape[0], src.shape[0]
    out = np.empty((n, window) + src.shape[1:], dtype=src.dtype)
    lib = _load()
    if lib:
        lib.gather_windows(src.ctypes.data, out.ctypes.data, starts.ctypes.data,
                           n, window, t_len, _row_bytes(src))
        return out
    idx = np.clip(starts[:, None] + np.arange(window)[None, :], 0, t_len - 1)
    return src[idx]


def gather_windows_at(src, out, dst_idx, starts, window):
    """Edge-padded window gather into rows @dst_idx of the preallocated batch
    buffer @out ([N_total, window, ...]) from one demo's [T, ...] array, so
    several per-demo calls fill one batch with no intermediate allocation.
    Gathers of 8 MB or more are split over threads (``RMVQ_GATHER_THREADS``,
    at most 8 by default)."""
    src = np.ascontiguousarray(src)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    dst_idx = np.ascontiguousarray(dst_idx, dtype=np.int64)
    if not out.flags.c_contiguous or out.dtype != src.dtype:
        raise ValueError("out must be C-contiguous and of the source's dtype")
    if out.shape[1:] != (window,) + src.shape[1:]:
        raise ValueError(f"out {out.shape} does not hold windows of {window} x "
                         f"{src.shape[1:]}")
    if dst_idx.shape != starts.shape or (dst_idx.size and (
            dst_idx.min() < 0 or dst_idx.max() >= out.shape[0])):
        raise ValueError("dst_idx must name rows of out, one per start")
    n, t_len = starts.shape[0], src.shape[0]
    lib = _load()
    if lib:
        row_bytes = _row_bytes(src)
        n_threads = 1
        if n * window * row_bytes >= (8 << 20):
            n_threads = int(os.environ.get("RMVQ_GATHER_THREADS",
                                           min(8, os.cpu_count() or 1)))
        if n_threads > 1:
            lib.gather_windows_at_mt(src.ctypes.data, out.ctypes.data,
                                     dst_idx.ctypes.data, starts.ctypes.data,
                                     n, window, t_len, row_bytes, n_threads)
        else:
            lib.gather_windows_at(src.ctypes.data, out.ctypes.data,
                                  dst_idx.ctypes.data, starts.ctypes.data,
                                  n, window, t_len, row_bytes)
        return out
    idx = np.clip(starts[:, None] + np.arange(window)[None, :], 0, t_len - 1)
    out[dst_idx] = src[idx]
    return out


def gather_windows_multi(srcs, starts, window):
    """Per-sample demos: srcs is a list of [T_i, ...] arrays of one row shape
    and dtype; returns [N, window, ...]."""
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    n = starts.shape[0]
    if len(srcs) != n:
        raise ValueError(f"{len(srcs)} sources for {n} starts")
    srcs = [np.ascontiguousarray(s) for s in srcs]
    if any(s.shape[1:] != srcs[0].shape[1:] or s.dtype != srcs[0].dtype
           for s in srcs):
        raise ValueError("the sources differ in row shape or dtype")
    out = np.empty((n, window) + srcs[0].shape[1:], dtype=srcs[0].dtype)
    lib = _load()
    if lib:
        ptrs = (ctypes.c_void_p * n)(*[s.ctypes.data for s in srcs])
        t_lens = np.asarray([s.shape[0] for s in srcs], dtype=np.int64)
        lib.gather_windows_multi(ptrs, t_lens.ctypes.data, out.ctypes.data,
                                 starts.ctypes.data, n, window, _row_bytes(srcs[0]))
        return out
    for i, s in enumerate(srcs):
        out[i] = s[np.clip(starts[i] + np.arange(window), 0, s.shape[0] - 1)]
    return out


def window_pad_masks(starts, t_lens, window):
    """[N, window] bool masks: True where the window row lies in its demo."""
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    t_lens = np.ascontiguousarray(t_lens, dtype=np.int64)
    n = starts.shape[0]
    lib = _load()
    if lib:
        out = np.empty((n, window), dtype=np.uint8)
        lib.window_pad_masks(out.ctypes.data, starts.ctypes.data,
                             t_lens.ctypes.data, n, window)
        return out.astype(bool)
    rows = starts[:, None] + np.arange(window)[None, :]
    return (rows >= 0) & (rows < t_lens[:, None])
