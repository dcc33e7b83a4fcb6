"""Nested-structure tensor helpers (counterpart of the JAX package's
``utils/tensor_utils.py``): what the serving path and the data path use."""

import numpy as np


def map_tensor(x, fn):
    """Apply @fn to every tensor leaf of a nested dict / list / tuple;
    ``None`` leaves stay ``None``."""
    if isinstance(x, dict):
        return {k: map_tensor(v, fn) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(map_tensor(v, fn) for v in x)
    if x is None:
        return None
    return fn(x)


def _first_leaf(x):
    if isinstance(x, dict):
        for v in x.values():
            leaf = _first_leaf(v)
            if leaf is not None:
                return leaf
        return None
    if isinstance(x, (list, tuple)):
        for v in x:
            leaf = _first_leaf(v)
            if leaf is not None:
                return leaf
        return None
    return x


def fold_time(x):
    """[B, T, ...] -> [B*T, ...] for every leaf; returns (folded, B, T)."""
    b, t = _first_leaf(x).shape[:2]
    folded = map_tensor(x, lambda a: a.reshape((b * t,) + tuple(a.shape[2:])))
    return folded, b, t


def unsqueeze_expand_at(x, size, dim):
    """Insert a new axis at @dim and repeat it @size times."""

    def f(a):
        a = a.unsqueeze(dim)
        reps = [1] * a.dim()
        reps[dim] = size
        return a.repeat(*reps)

    return map_tensor(x, f)


def to_numpy(x):
    """Every leaf as a numpy array (tensors leave the device first)."""

    def f(a):
        if hasattr(a, "detach"):
            return a.detach().cpu().numpy()
        return np.asarray(a)

    return map_tensor(x, f)


def pad_sequence_single(seq, padding, batched=False, pad_same=True,
                        pad_values=None):
    """Pad a sequence array on its time axis (0, or 1 when @batched) by
    @padding = (left, right): ``pad_same`` repeats the edge rows, else the
    rows are @pad_values (0 by default)."""
    pads = [(0, 0)] * np.ndim(seq)
    pads[1 if batched else 0] = tuple(padding)
    if pad_same:
        return np.pad(np.asarray(seq), pads, mode="edge")
    return np.pad(np.asarray(seq), pads, constant_values=pad_values or 0)
