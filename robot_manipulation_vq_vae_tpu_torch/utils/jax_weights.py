"""Carry the JAX package's weights into the port.

``load_jax_variables(module, flat)`` takes the JAX variables flattened to
``{"params/a/b/kernel": array, "batch_stats/a/b/mean": array, ...}`` (the
format of the JAX package's ``utils/ckpt_conversion.py::flatten_variables``)
and fills @module, whose classes say how their JAX children are named:

* ``JAX_NAMES`` (or a ``jax_names()`` method): {JAX child name: torch
  submodule path}, e.g. ``{"enc1": "encoder.0"}``, or {JAX child name:
  {its children: paths}} where the torch module has no counterpart of the
  JAX child, e.g. ``{"stem": {"conv1": "nets.0", "bn1": "nets.1"}}``;
* ``JAX_PARAMS``: raw parameters whose JAX and torch names and layouts agree;
* ``JAX_BUFFERS``: {collection: {JAX name: buffer name}} for variables of
  other collections kept as buffers, e.g. the HVQVAE's ``vq`` codebooks.

Leaves are converted by type: Linear ``kernel [in, out]`` -> ``weight
[out, in]``; Conv2d ``kernel [h, w, in, out]`` -> ``weight [out, in, h, w]``;
Conv1d ``kernel [k, in, out]`` -> ``weight [out, in, k]``;
BatchNorm ``scale``/``bias`` and ``batch_stats`` ``mean``/``var`` ->
``weight``/``bias``/``running_mean``/``running_var``; LayerNorm
``scale``/``bias``. Any key that is missing or left unused raises: there are
no partial loads.
"""

import numpy as np
import torch
import torch.nn as nn


def _leaf_entries(mod):
    """(collection, JAX leaf name, torch tensor name, transform) of a leaf."""
    same = lambda a: a  # noqa: E731
    if isinstance(mod, nn.Linear):
        out = [("params", "kernel", "weight", lambda a: a.T)]
    elif isinstance(mod, nn.Conv2d):
        out = [("params", "kernel", "weight", lambda a: a.transpose(3, 2, 0, 1))]
    elif isinstance(mod, nn.Conv1d):
        out = [("params", "kernel", "weight", lambda a: a.transpose(2, 1, 0))]
    elif isinstance(mod, nn.BatchNorm2d):
        return [("params", "scale", "weight", same), ("params", "bias", "bias", same),
                ("batch_stats", "mean", "running_mean", same),
                ("batch_stats", "var", "running_var", same)]
    elif isinstance(mod, nn.LayerNorm):
        return [("params", "scale", "weight", same), ("params", "bias", "bias", same)]
    else:
        return []
    if mod.bias is not None:
        out.append(("params", "bias", "bias", same))
    return out


def _jax_names(mod):
    if hasattr(mod, "jax_names"):
        return mod.jax_names()
    return getattr(mod, "JAX_NAMES", {})


def _entries(mod, jax_path, torch_path):
    """Yield (flat JAX key, torch state-dict key, transform) under @mod."""
    for coll, jax_leaf, torch_leaf, fn in _leaf_entries(mod):
        yield ("/".join([coll, *jax_path, jax_leaf]),
               ".".join([*torch_path, torch_leaf]), fn)
    for name in getattr(mod, "JAX_PARAMS", ()):
        yield ("/".join(["params", *jax_path, name]),
               ".".join([*torch_path, name]), lambda a: a)
    for coll, names in getattr(mod, "JAX_BUFFERS", {}).items():
        for jax_name, torch_name in names.items():
            yield ("/".join([coll, *jax_path, jax_name]),
                   ".".join([*torch_path, torch_name]), lambda a: a)
    yield from _child_entries(mod, _jax_names(mod), jax_path, torch_path)


def _child_entries(mod, names, jax_path, torch_path):
    for jax_name, torch_rel in names.items():
        if isinstance(torch_rel, dict):
            # a JAX child without a torch module of its own: its children
            # sit at these paths under @mod
            yield from _child_entries(mod, torch_rel, jax_path + [jax_name],
                                      torch_path)
            continue
        yield from _entries(
            mod.get_submodule(torch_rel),
            jax_path + [jax_name],
            torch_path + torch_rel.split("."),
        )


def load_jax_variables(module, flat):
    """Fill @module from the flat JAX variables @flat (see module docstring)."""
    state = module.state_dict()
    wanted = {k for k in state if not k.endswith("num_batches_tracked")}
    used, filled, new_state = set(), set(), {}
    for jax_key, torch_key, fn in _entries(module, [], []):
        if jax_key not in flat:
            raise KeyError(f"JAX variable {jax_key} (for {torch_key}) is missing")
        if torch_key not in state:
            raise KeyError(f"{type(module).__name__} has no tensor {torch_key}")
        if torch_key in filled:
            raise KeyError(f"{torch_key} is mapped twice")
        value = fn(np.asarray(flat[jax_key]))
        if tuple(value.shape) != tuple(state[torch_key].shape):
            raise ValueError(
                f"{jax_key} {value.shape} does not fit {torch_key} "
                f"{tuple(state[torch_key].shape)}"
            )
        new_state[torch_key] = torch.tensor(value, dtype=state[torch_key].dtype)
        used.add(jax_key)
        filled.add(torch_key)
    unused = sorted(set(flat) - used)
    if unused:
        raise KeyError(f"JAX variables left unused: {unused[:8]} ({len(unused)})")
    missing = sorted(wanted - filled)
    if missing:
        raise KeyError(f"port tensors not filled: {missing[:8]} ({len(missing)})")
    module.load_state_dict(new_state, strict=False)
