"""The GPT's tensor parallelism on local shards (JAX's ``_param_spec`` rules,
placed by ``parallel.shard_params``): the layers' own forwards call these
helpers with their ``mp`` axis (a ``parallel.AxisComm``, or None), and with
None each helper is the plain layer. Under mp a split parameter is a
DTensor that records its placement and holds this rank's shard (the
replicated ones stay plain tensors); the layers compute on that shard
(``local``) and every collective is the axis' own, explicit in
the autograd functions below (DTensor's collectives are not used: on gloo
ranks that share a card they do not run). Also the conversions between
shards and whole tensors that checkpoints and optimizer state need."""

import torch
from torch.distributed.tensor import DTensor


def local(t):
    """@t's local tensor: a DTensor's shard (differentiable), a plain tensor
    as it is."""
    return t.to_local() if isinstance(t, DTensor) else t


def is_sharded(t):
    """Whether @t is a DTensor sharded (not replicated) over its mesh."""
    return isinstance(t, DTensor) and t.placements[0].is_shard()


class _SumForward(torch.autograd.Function):
    """A row-parallel layer's partial output summed over mp; the cotangent
    is already replicated."""

    @staticmethod
    def forward(ctx, t, comm):
        return comm.all_reduce_(t.clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumBackward(torch.autograd.Function):
    """A replicated activation entering a column-parallel layer: each rank's
    cotangent is its shard's part, summed over mp."""

    @staticmethod
    def forward(ctx, t, comm):
        ctx.comm = comm
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_reduce_(g.clone()), None


class _Gather(torch.autograd.Function):
    """The full tensor of the mp ranks' shards along @dim; the backward
    keeps this rank's part of the cotangent, which every rank holds whole
    where each computes the same whole product (``sum_cotangent`` first
    where a rank uses a part of it)."""

    @staticmethod
    def forward(ctx, t, comm, dim):
        ctx.comm, ctx.dim = comm, dim
        return comm.all_gather(t, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.chunk(g, ctx.dim).contiguous(), None, None


class _Chunk(torch.autograd.Function):
    """This rank's part of a replicated tensor along @dim; the backward
    gathers the parts' cotangents, so that every rank holds the full one."""

    @staticmethod
    def forward(ctx, t, comm, dim):
        ctx.comm, ctx.dim = comm, dim
        return comm.chunk(t, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_gather(g, ctx.dim), None, None


def heads(num_heads, mp):
    """The slice of the @num_heads attention heads that this rank computes:
    all of them without @mp, an equal part under it."""
    if mp is None:
        return slice(0, num_heads)
    n = num_heads // mp.size
    return slice(mp.rank * n, (mp.rank + 1) * n)


def gathered(param, mp, dim):
    """@param whole: under @mp its shards gathered along @dim, the
    gradient cut back to this rank's shard (a rank that uses only a part of
    the whole weight passes it through ``sum_cotangent``)."""
    return param if mp is None else _Gather.apply(local(param), mp, dim)


def sum_cotangent(x, mp):
    """@x, a replicated tensor of which each rank uses a part (an
    activation entering a column-parallel product, a gathered weight of
    which it takes its rows): under @mp its cotangent is summed over the
    ranks."""
    return x if mp is None else _SumBackward.apply(x, mp)


def column_parallel(linear, x, mp):
    """@linear(@x) for a column-parallel layer (weight ``Shard(0)``): under
    @mp this rank's output features, the replicated bias cut to them."""
    if mp is None:
        return linear(x)
    bias = None if linear.bias is None else _Chunk.apply(linear.bias, mp, 0)
    return torch.nn.functional.linear(sum_cotangent(x, mp), local(linear.weight), bias)


def row_parallel(linear, x, mp):
    """@linear(@x) for a row-parallel layer (weight ``Shard(1)``, @x this
    rank's input features): under @mp the partial products summed over the
    ranks, then the replicated bias."""
    if mp is None:
        return linear(x)
    out = _SumForward.apply(torch.nn.functional.linear(x, local(linear.weight)), mp)
    return out if linear.bias is None else out + linear.bias


def sync_replicated_(grads, mp):
    """The gradients among @grads of replicated parameters (all but the
    sharded DTensors) in place as mp rank 0 holds them, in one broadcast
    over @mp: every mp rank computes the replicated modules itself, and a
    card's non-deterministic backward kernels (cuDNN's, ``index_add_``)
    give the ranks gradients a few ulps apart, which would step the
    replicas apart. Every mp rank must call it."""
    mp.broadcast_many_([g for g in grads if not is_sharded(g)])
    return grads


def full_tensor(t, comm):
    """The full tensor of @t: a sharded DTensor's shards gathered over
    @comm (its mp axis), a plain tensor as it is."""
    if not isinstance(t, DTensor):
        return t
    return comm.all_gather(t.to_local(), t.placements[0].dim)


def place_like(full, like):
    """@full (a full tensor) as @like is placed: a DTensor of @like's
    placements holding this rank's shard, or @full where @like is plain."""
    if (isinstance(full, DTensor) or not isinstance(like, DTensor)
            or tuple(full.shape) != tuple(like.shape)):
        return full
    n, r = like.device_mesh.size(), like.device_mesh.get_local_rank()
    part = full.chunk(n, like.placements[0].dim)[r]
    return DTensor.from_local(part.to(like.device, like.dtype).contiguous(),
                              like.device_mesh, like.placements, run_check=False)


def place_optimizer_state(optimizer):
    """@optimizer's state tensors placed as their parameters are
    (``place_like``), and each group that holds DTensors stepped tensor by
    tensor: torch's foreach kernels (its default on a card) take a group's
    tensors together and refuse DTensors beside plain tensors."""
    for group in optimizer.param_groups:
        if any(isinstance(p, DTensor) for p in group["params"]):
            group["foreach"] = False
    for p, st in optimizer.state.items():
        for k, v in st.items():
            if isinstance(v, torch.Tensor):
                st[k] = place_like(v, p)
