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
  other collections kept as buffers, e.g. the HVQVAE's ``vq`` codebooks;
* ``jax_stacked()``: {torch tensor name: ([JAX parameter paths], stack)}
  for a torch tensor that holds several JAX parameters, e.g. ``nn.LSTM``'s
  ``weight_ih_l0`` from four gate denses' kernels: ``stack`` takes their
  arrays in the order given and returns the torch tensor's.

Leaves are converted by type: Linear ``kernel [in, out]`` -> ``weight
[out, in]``; Conv2d ``kernel [h, w, in, out]`` -> ``weight [out, in, h, w]``;
Conv1d ``kernel [k, in, out]`` -> ``weight [out, in, k]``; ConvTranspose1d
(Flax's ``transpose_kernel=True``) ``kernel [k, out, in]`` -> ``weight [in,
out, k]``;
BatchNorm ``scale``/``bias`` and ``batch_stats`` ``mean``/``var`` ->
``weight``/``bias``/``running_mean``/``running_var``; LayerNorm and
GroupNorm ``scale``/``bias``. Any key that is missing or left unused
raises: there are no partial loads. ``jax_variables`` goes the other way.

A JAX tree traced with ``train.packed_rgb_encoders`` holds each group of
cameras' trunks as one ``packed_backbone``; it is carried across in the
default per-camera layout (``models/packed_film.py``), the cameras in the
spec order of the port's ``ObservationEncoder`` that packs them.
"""

import numpy as np
import torch
import torch.nn as nn


def _leaf_entries(mod):
    """(collection, JAX leaf name, torch tensor name, transform, its
    inverse) of a leaf."""
    same = lambda a: a  # noqa: E731
    if isinstance(mod, nn.Linear):
        t = lambda a: a.T  # noqa: E731
        out = [("params", "kernel", "weight", t, t)]
    elif isinstance(mod, nn.Conv2d):
        out = [("params", "kernel", "weight", lambda a: a.transpose(3, 2, 0, 1),
                lambda a: a.transpose(2, 3, 1, 0))]
    elif isinstance(mod, (nn.Conv1d, nn.ConvTranspose1d)):
        # Conv1d [k, in, out] -> [out, in, k]; ConvTranspose1d (Flax's
        # transpose_kernel=True) [k, out, in] -> [in, out, k]
        t = lambda a: a.transpose(2, 1, 0)  # noqa: E731
        out = [("params", "kernel", "weight", t, t)]
    elif isinstance(mod, nn.BatchNorm2d):
        return [("params", "scale", "weight", same, same),
                ("params", "bias", "bias", same, same),
                ("batch_stats", "mean", "running_mean", same, same),
                ("batch_stats", "var", "running_var", same, same)]
    elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
        return [("params", "scale", "weight", same, same),
                ("params", "bias", "bias", same, same)]
    else:
        return []
    if mod.bias is not None:
        out.append(("params", "bias", "bias", same, same))
    return out


def _jax_names(mod):
    if hasattr(mod, "jax_names"):
        return mod.jax_names()
    return getattr(mod, "JAX_NAMES", {})


def _entries(mod, jax_path, torch_path):
    """Yield (flat JAX key, torch state-dict key, transform, its inverse or
    None) under @mod."""
    same = lambda a: a  # noqa: E731
    for coll, jax_leaf, torch_leaf, fn, inv in _leaf_entries(mod):
        yield ("/".join([coll, *jax_path, jax_leaf]),
               ".".join([*torch_path, torch_leaf]), fn, inv)
    for name in getattr(mod, "JAX_PARAMS", ()):
        yield ("/".join(["params", *jax_path, name]),
               ".".join([*torch_path, name]), same, same)
    for coll, names in getattr(mod, "JAX_BUFFERS", {}).items():
        for jax_name, torch_name in names.items():
            yield ("/".join([coll, *jax_path, jax_name]),
                   ".".join([*torch_path, torch_name]), same, same)
    stacked = mod.jax_stacked() if hasattr(mod, "jax_stacked") else {}
    for torch_name, (jax_names, stack) in stacked.items():
        yield (tuple("/".join(["params", *jax_path, n]) for n in jax_names),
               ".".join([*torch_path, torch_name]), stack, None)
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


def _unflatten(flat):
    nested = {}
    for key, value in flat.items():
        *path, leaf = key.split("/")
        node = nested
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = value
    return nested


def _flatten(nested, prefix=()):
    out = {}
    for k, v in nested.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = v
    return out


def unpack_packed_backbones(module, flat):
    """@flat with every ``packed_backbone`` of the encoders of @module
    unpacked into the per-camera ``core_{key}/backbone`` layout."""
    from robot_manipulation_vq_vae_tpu_torch.models import packed_film as PackedFilm
    from robot_manipulation_vq_vae_tpu_torch.models.obs_nets import ObservationEncoder

    if not any("/packed_backbone/" in k for k in flat):
        return flat
    nested = _unflatten(flat)
    key_lists = {tuple(m.packed_rgb_keys()) for m in module.modules()
                 if isinstance(m, ObservationEncoder)}
    for keys in sorted(k for k in key_lists if k):
        if PackedFilm.has_packed_site(nested["params"], keys):
            nested = PackedFilm.convert_variables_packed_to_default(nested, list(keys))
    return _flatten(nested)


def load_jax_variables(module, flat):
    """Fill @module from the flat JAX variables @flat (see module docstring)."""
    flat = unpack_packed_backbones(module, flat)
    state = module.state_dict()
    wanted = {k for k in state if not k.endswith("num_batches_tracked")}
    used, filled, new_state = set(), set(), {}
    for jax_key, torch_key, fn, _ in _entries(module, [], []):
        # a tuple of keys: a torch tensor stacked from several JAX leaves
        jax_keys = jax_key if isinstance(jax_key, tuple) else (jax_key,)
        for key in jax_keys:
            if key not in flat:
                raise KeyError(f"JAX variable {key} (for {torch_key}) is missing")
        if torch_key not in state:
            raise KeyError(f"{type(module).__name__} has no tensor {torch_key}")
        if torch_key in filled:
            raise KeyError(f"{torch_key} is mapped twice")
        arrays = [np.asarray(flat[key]) for key in jax_keys]
        value = fn(arrays if isinstance(jax_key, tuple) else arrays[0])
        if tuple(value.shape) != tuple(state[torch_key].shape):
            raise ValueError(
                f"{jax_key} {value.shape} does not fit {torch_key} "
                f"{tuple(state[torch_key].shape)}"
            )
        new_state[torch_key] = torch.tensor(value, dtype=state[torch_key].dtype)
        used.update(jax_keys)
        filled.add(torch_key)
    unused = sorted(set(flat) - used)
    if unused:
        raise KeyError(f"JAX variables left unused: {unused[:8]} ({len(unused)})")
    missing = sorted(wanted - filled)
    if missing:
        raise KeyError(f"port tensors not filled: {missing[:8]} ({len(missing)})")
    module.load_state_dict(new_state, strict=False)


def jax_variables(module):
    """The inverse of ``load_jax_variables``: @module's tensors as the flat
    JAX variables {"params/a/b/kernel": numpy array, ...} in the JAX
    package's layouts and names (a tensor stacked from several JAX leaves
    raises)."""
    state = module.state_dict()
    flat = {}
    for jax_key, torch_key, _, inv in _entries(module, [], []):
        if inv is None:
            raise NotImplementedError(f"{torch_key} is stacked from {jax_key}")
        flat[jax_key] = np.array(inv(state[torch_key].detach().cpu().numpy()), order="C")
    return flat


def jax_tree(flat, collection="params"):
    """The nested tree of @collection of the flat JAX variables @flat (the
    layout of a Flax variable collection)."""
    return _unflatten({k[len(collection) + 1:]: v for k, v in flat.items()
                       if k.startswith(collection + "/")})


def jax_flat(tree, collection="params"):
    """The inverse of ``jax_tree``: the nested @collection @tree as flat
    JAX variables."""
    return {f"{collection}/{k}": v for k, v in _flatten(tree).items()}
