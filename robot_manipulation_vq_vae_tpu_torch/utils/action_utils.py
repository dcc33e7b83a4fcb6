"""Action dict <-> vector packing (a copy of the JAX package's
``utils/action_utils.py``; reference ``robomimic/utils/action_utils.py``)."""

from collections import OrderedDict

import numpy as np


def action_dict_to_vector(action_dict, action_keys=None):
    """Concatenate per-key action arrays (flattened past the batch dims) in
    @action_keys order into one vector."""
    if action_keys is None:
        action_keys = list(action_dict.keys())
    parts = []
    for k in action_keys:
        v = np.asarray(action_dict[k])
        if v.ndim == 1:
            parts.append(v)
        else:
            parts.append(v.reshape(v.shape[0], -1))
    return np.concatenate(parts, axis=-1)


def vector_to_action_dict(vector, action_shapes, action_keys=None):
    """Split a packed action vector back into a dict using @action_shapes
    ({key: shape-without-batch})."""
    if action_keys is None:
        action_keys = list(action_shapes.keys())
    out = OrderedDict()
    idx = 0
    batched = np.asarray(vector).ndim > 1
    for k in action_keys:
        shape = tuple(action_shapes[k])
        size = int(np.prod(shape))
        sl = vector[..., idx : idx + size]
        out[k] = sl.reshape(sl.shape[:-1] + shape) if batched else sl.reshape(shape)
        idx += size
    return out
