"""G per-camera FiLM ResNet-18 trunks run as one grouped pass
(``train.packed_rgb_encoders``; counterpart of the JAX package's
``models/packed_film.py``).

The math is the unpacked trunks': a convolution with ``groups=G`` computes G
independent convolutions, the filters of camera g in output block g;
BatchNorm is per channel, so it runs over the G * C concatenated channels
with each camera's statistics; FiLM's ``lang_proj`` is one Linear whose beta
and gamma halves each hold the G camera blocks (JAX ``_pack_film``). The pool
is the plain ``F.max_pool2d``, as JAX's packed trunk uses ``nn.max_pool``
whatever ``train.pallas_pool`` says, so the packed trunks launch the stem-pool
kernels 0 times. ``train.pool_free_stem`` and ``train.frozen_batch_norm``
apply as in the cameras' own trunks.

Storage: the packed modules hold no parameters or buffers. They are views
over the cameras' own ``ResNet18ConvFiLM`` modules (kept in a tuple, so not
registered twice), and each forward concatenates the per-camera parameters
into the grouped weights and writes the BatchNorm statistics back per
camera. So the state dict, the optimizers' moments and every ``.pth`` stay in
the reference per-camera layout, packed or not, and a checkpoint moves
between the two modes unchanged. The other way, packed storage with
state-dict hooks, would also have to remap the optimizers' state; the
concatenation costs one copy of the trunks' parameters a forward (about 33 M
for the flagship's three trunks).

The layout helpers (``pack_film_resnet18_params`` ...
``convert_variables_packed_to_default``) are numpy copies of the JAX
package's, for carrying a JAX ``packed_backbone`` variable tree into the port
(``utils/jax_weights.py``). The default -> packed direction
(``convert_variables_default_to_packed``, ``pack_film_resnet18_params``) has
no caller in the port: it is kept for the parity tests against JAX's.
"""

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from robot_manipulation_vq_vae_tpu_torch.models.base_nets import (
    flax_batch_norm,
    global_batch_norm,
)

_RESNET18_PLAN = [(64, 1), (64, 1), (128, 2), (128, 1),
                  (256, 2), (256, 1), (512, 2), (512, 1)]


def _cat(tensors):
    return torch.cat(list(tensors), dim=0)


def packed_batch_norm(x, bns, training):
    """Flax BatchNorm over the G * C channels of @x with the G per-camera
    ``BatchNorm2d`` modules @bns: the statistics are concatenated, and the
    ones ``flax_batch_norm`` moved (training) or rounded (a bf16 @x) written
    back to each camera. Under data parallelism (the cameras' ``dp``, set by
    ``parallel.shard_state``) a training forward normalizes by the global
    batch's statistics (``global_batch_norm``), as each camera's own
    BatchNorm does."""
    mean = _cat(bn.running_mean for bn in bns)
    var = _cat(bn.running_var for bn in bns)
    use_batch = training and not bns[0].frozen
    weight, bias = _cat(bn.weight for bn in bns), _cat(bn.bias for bn in bns)
    if use_batch and bns[0].dp is not None:
        y = global_batch_norm(x, mean, var, weight, bias, bns[0].eps, bns[0].dp)
    else:
        y = flax_batch_norm(x, mean, var, weight, bias, use_batch, bns[0].eps)
    if use_batch or x.dtype == torch.bfloat16:
        with torch.no_grad():
            for bn, m, v in zip(bns, mean.chunk(len(bns)), var.chunk(len(bns))):
                bn.running_mean.copy_(m)
                bn.running_var.copy_(v)
    return y


def _grouped_conv(x, convs, stride, padding):
    """G convolutions (@convs, one per camera) as one with ``groups=G``."""
    return F.conv2d(x, _cat(c.weight for c in convs), None, stride, padding,
                    groups=len(convs))


class _View(nn.Module):
    """A packed module over G per-camera modules it does not own."""

    def __init__(self, mods):
        super().__init__()
        self._mods = tuple(mods)

    @property
    def groups(self):
        return len(self._mods)


class PackedFiLMLayer(_View):
    """G FiLM layers as one: x [B, G*C, H, W], lang_emb [B, L]."""

    def forward(self, x, lang_emb):
        projs = [f.lang_proj for f in self._mods]
        c = projs[0].out_features // 2
        weight = _cat([p.weight[:c] for p in projs] + [p.weight[c:] for p in projs])
        bias = _cat([p.bias[:c] for p in projs] + [p.bias[c:] for p in projs])
        beta, gamma = F.linear(lang_emb, weight, bias).chunk(2, dim=-1)
        return F.relu((1.0 + gamma[:, :, None, None]) * x + beta[:, :, None, None])


class PackedBasicBlock(_View):
    """G BasicBlocks as grouped convolutions."""

    def forward(self, x):
        blocks = self._mods
        stride = blocks[0].conv1.stride
        h = _grouped_conv(x, [b.conv1 for b in blocks], stride, 1)
        h = F.relu(packed_batch_norm(h, [b.bn1 for b in blocks], self.training))
        h = _grouped_conv(h, [b.conv2 for b in blocks], 1, 1)
        h = packed_batch_norm(h, [b.bn2 for b in blocks], self.training)
        identity = x
        if blocks[0].downsample is not None:
            identity = _grouped_conv(x, [b.downsample[0] for b in blocks], stride, 0)
            identity = packed_batch_norm(identity, [b.downsample[1] for b in blocks],
                                         self.training)
        return F.relu(h + identity)


class PackedResNet18ConvFiLM(_View):
    """G ``ResNet18ConvFiLM`` trunks in one grouped pass. Input
    [B, G*3, H, W] (the cameras' images concatenated on the channels, in the
    order of @trunks); output [B, G*512, ceil(H/32), ceil(W/32)], camera g's
    features in channels [512 g, 512 (g + 1))."""

    def __init__(self, trunks):
        super().__init__(trunks)
        if len(trunks) < 2:
            raise ValueError("a packed trunk needs at least two cameras")
        self.blocks = nn.ModuleList(
            PackedBasicBlock([t._conv_blocks[i] for t in trunks])
            for i in range(len(_RESNET18_PLAN)))
        self.films = nn.ModuleList(
            PackedFiLMLayer([t._film_layers[i] for t in trunks])
            for i in range(len(_RESNET18_PLAN)))

    def forward(self, x, lang_emb):
        stems = [t._base_block for t in self._mods]
        conv = stems[0][0]
        x = _grouped_conv(x, [s[0] for s in stems], 4 if conv.pool_free else 2, 3)
        x = F.relu(packed_batch_norm(x, [s[1] for s in stems], self.training))
        if not stems[0][3].pool_free:
            x = F.max_pool2d(x, 3, 2, 1)
        for block, film in zip(self.blocks, self.films):
            x = film(block(x), lang_emb)
        return x


# ---------------------------------------------------------------------------
# the JAX package's layout helpers, on nested dicts of numpy arrays
# ---------------------------------------------------------------------------

def _get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _cat_np(trees, path):
    return np.concatenate([np.asarray(_get(t, path)) for t in trees], axis=-1)


def _pack_film(trees, path, channels):
    """Per-camera FiLM Dense [.., 2C] -> packed [.., 2GC]: the G beta
    blocks, then the G gamma blocks."""
    ks = [np.asarray(_get(t, path)) for t in trees]
    return np.concatenate([k[..., :channels] for k in ks]
                          + [k[..., channels:] for k in ks], axis=-1)


def pack_film_resnet18_params(variable_trees):
    """[G x ResNet18ConvFiLM variables] -> the packed trunk's variables (JAX
    ``pack_film_resnet18_params``): convolution kernels and BatchNorm vectors
    concatenated on the channel axis, FiLM's halves packed per camera."""
    params = [v["params"] for v in variable_trees]
    stats = [v.get("batch_stats", {}) for v in variable_trees]
    has_stats = any(bool(s) for s in stats)
    if has_stats and not all(bool(s) for s in stats):
        raise ValueError("pack all-stats or no-stats variable trees")
    p_out = {"stem_conv1": {"kernel": _cat_np(params, ["stem", "conv1", "kernel"])},
             "stem_bn1": {n: _cat_np(params, ["stem", "bn1", n]) for n in ("scale", "bias")}}
    s_out = ({"stem_bn1": {n: _cat_np(stats, ["stem", "bn1", n]) for n in ("mean", "var")}}
             if has_stats else {})
    for i, (feat, _) in enumerate(_RESNET18_PLAN):
        blk = f"block{i}"
        b_p, b_s = {}, {}
        for conv in ("conv1", "conv2", "down_conv"):
            if conv in params[0][blk]:
                b_p[conv] = {"kernel": _cat_np(params, [blk, conv, "kernel"])}
        for bn in ("bn1", "bn2", "down_bn"):
            if bn in params[0][blk]:
                b_p[bn] = {n: _cat_np(params, [blk, bn, n]) for n in ("scale", "bias")}
                if has_stats:
                    b_s[bn] = {n: _cat_np(stats, [blk, bn, n]) for n in ("mean", "var")}
        p_out[blk] = b_p
        if has_stats:
            s_out[blk] = b_s
        p_out[f"film{i}"] = {"lang_proj": {
            n: _pack_film(params, [f"film{i}", "lang_proj", n], feat)
            for n in ("kernel", "bias")}}
    out = {"params": p_out}
    if has_stats:
        out["batch_stats"] = s_out
    return out


def unpack_film_resnet18_params(packed_variables, groups):
    """Inverse of :func:`pack_film_resnet18_params`: packed variables -> G
    per-camera ResNet18ConvFiLM variable trees."""
    p = packed_variables["params"]
    s = packed_variables.get("batch_stats")

    def split(a):
        return np.split(np.asarray(a), groups, axis=-1)

    def split_film(a, channels):
        a = np.asarray(a)
        betas = np.split(a[..., :groups * channels], groups, axis=-1)
        gammas = np.split(a[..., groups * channels:], groups, axis=-1)
        return [np.concatenate([b, g], axis=-1) for b, g in zip(betas, gammas)]

    outs = [{"params": {"stem": {"conv1": {}, "bn1": {}}}} for _ in range(groups)]
    if s is not None:
        for o in outs:
            o["batch_stats"] = {"stem": {"bn1": {}}}
    for g, k in enumerate(split(p["stem_conv1"]["kernel"])):
        outs[g]["params"]["stem"]["conv1"]["kernel"] = k
    for n in ("scale", "bias"):
        for g, v in enumerate(split(p["stem_bn1"][n])):
            outs[g]["params"]["stem"]["bn1"][n] = v
    if s is not None:
        for n in ("mean", "var"):
            for g, v in enumerate(split(s["stem_bn1"][n])):
                outs[g]["batch_stats"]["stem"]["bn1"][n] = v
    for i, (feat, _) in enumerate(_RESNET18_PLAN):
        blk, film = f"block{i}", f"film{i}"
        for o in outs:
            o["params"][blk] = {}
            o["params"][film] = {"lang_proj": {}}
            if s is not None:
                o["batch_stats"][blk] = {}
        for conv in ("conv1", "conv2", "down_conv"):
            if conv in p[blk]:
                for g, k in enumerate(split(p[blk][conv]["kernel"])):
                    outs[g]["params"][blk][conv] = {"kernel": k}
        for bn in ("bn1", "bn2", "down_bn"):
            if bn not in p[blk]:
                continue
            for n in ("scale", "bias"):
                for g, v in enumerate(split(p[blk][bn][n])):
                    outs[g]["params"][blk].setdefault(bn, {})[n] = v
            if s is not None:
                for n in ("mean", "var"):
                    for g, v in enumerate(split(s[blk][bn][n])):
                        outs[g]["batch_stats"][blk].setdefault(bn, {})[n] = v
        for n in ("kernel", "bias"):
            for g, v in enumerate(split_film(p[film]["lang_proj"][n], feat)):
                outs[g]["params"][film]["lang_proj"][n] = v
    return outs


def _copy_dicts(node):
    if isinstance(node, dict):
        return {k: _copy_dicts(v) for k, v in node.items()}
    return node


def _sites(node, names, found, path=()):
    """Paths of the dicts that hold every per-camera ``core_{key}`` of
    @names and @found(node) holds for."""
    out = []
    if isinstance(node, dict):
        if all(isinstance(node.get(n), dict) for n in names) and found(node):
            out.append(path)
        for k, v in node.items():
            if k not in names and k != "packed_backbone":
                out.extend(_sites(v, names, found, path + (k,)))
    return out


def _check_site_order(parent, names):
    """Group g of a packed trunk is camera g by position alone, so a key
    list in another order than the tree's own ``core_*`` order is refused
    (JAX ``_check_site_order``)."""
    tree_order = [k for k in parent if k in set(names)]
    if tree_order != names:
        raise ValueError(
            "packed_keys order disagrees with the variable tree's own core_* "
            f"order: got {names}, tree has {tree_order}; pass the rgb keys in "
            "ObservationEncoder spec order")


def _stats_parent(variables, site):
    try:
        return _get(variables.get("batch_stats", {}), site)
    except (KeyError, TypeError):
        return None


def has_packed_site(params, packed_keys):
    """Whether the params tree @params holds a ``packed_backbone`` beside
    the cores of @packed_keys."""
    names = [f"core_{k}" for k in packed_keys]
    return bool(_sites(params, names, lambda node: "packed_backbone" in node))


def convert_variables_default_to_packed(variables, packed_keys):
    """A default-layout variable tree (``core_{key}/backbone`` per camera)
    in the packed layout (a shared ``packed_backbone``, the per-camera
    pool / proj in place). @packed_keys in encoder spec order."""
    names = [f"core_{k}" for k in packed_keys]
    out = {c: _copy_dicts(v) for c, v in variables.items()}
    sites = _sites(out["params"], names,
                   lambda node: all("backbone" in node[n] for n in names))
    if not sites:
        raise ValueError(f"no per-camera cores {names} found to pack")
    for site in sites:
        p_parent = _get(out["params"], site)
        _check_site_order(p_parent, names)
        s_parent = _stats_parent(out, site)
        cams = [{"params": p_parent[n].pop("backbone"),
                 "batch_stats": (s_parent[n].pop("backbone")
                                 if s_parent is not None
                                 and "backbone" in s_parent.get(n, {}) else {})}
                for n in names]
        packed = pack_film_resnet18_params(cams)
        p_parent["packed_backbone"] = packed["params"]
        if s_parent is not None:
            if "batch_stats" in packed:
                s_parent["packed_backbone"] = packed["batch_stats"]
            for n in names:
                if n in s_parent and not s_parent[n]:
                    del s_parent[n]
    return out


def convert_variables_packed_to_default(variables, packed_keys):
    """Inverse of :func:`convert_variables_default_to_packed`; group g of
    each ``packed_backbone`` goes to camera ``packed_keys[g]``."""
    names = [f"core_{k}" for k in packed_keys]
    out = {c: _copy_dicts(v) for c, v in variables.items()}
    sites = _sites(out["params"], names, lambda node: "packed_backbone" in node)
    if not sites:
        raise ValueError("no packed_backbone found to unpack")
    for site in sites:
        p_parent = _get(out["params"], site)
        _check_site_order(p_parent, names)
        s_parent = _stats_parent(out, site)
        packed = {"params": p_parent.pop("packed_backbone")}
        if s_parent is not None and "packed_backbone" in s_parent:
            packed["batch_stats"] = s_parent.pop("packed_backbone")
        for n, cam in zip(names, unpack_film_resnet18_params(packed, len(names))):
            p_parent[n]["backbone"] = cam["params"]
            if s_parent is not None and "batch_stats" in cam:
                s_parent.setdefault(n, {})["backbone"] = cam["batch_stats"]
    return out
