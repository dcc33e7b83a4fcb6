"""The GPT's tensor parallelism on local shards (JAX's ``_param_spec`` rules,
placed by ``parallel.shard_params``): the layers' own forwards call these
helpers with their ``mp`` axis (a ``parallel.AxisComm``, or None), and with
None each helper is the plain layer. Under mp a parameter is a DTensor that
records its placement and holds this rank's shard; the layers compute on
that shard (``local``) and every collective is the axis' own, explicit in
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
    """The full tensor of the mp ranks' shards along @dim; the backward sums
    the ranks' cotangents and keeps this rank's part."""

    @staticmethod
    def forward(ctx, t, comm, dim):
        ctx.comm, ctx.dim = comm, dim
        return comm.all_gather(t, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.chunk(ctx.comm.all_reduce_(g.clone()), ctx.dim), None, None


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
    """@param whole: under @mp its shards gathered along @dim (the gradient
    summed over mp and cut back to this rank's shard)."""
    return param if mp is None else _Gather.apply(local(param), mp, dim)


def sum_cotangent(x, mp):
    """@x, a replicated activation entering a column-parallel product: under
    @mp its cotangent is summed over the ranks (each holds its features'
    part)."""
    return x if mp is None else _SumBackward.apply(x, mp)


def column_parallel(linear, x, mp):
    """@linear(@x) for a column-parallel layer (weight ``Shard(0)``): under
    @mp this rank's output features, the replicated bias cut to them."""
    if mp is None:
        return linear(x)
    bias = None if linear.bias is None else _Chunk.apply(local(linear.bias), mp, 0)
    return torch.nn.functional.linear(sum_cotangent(x, mp), local(linear.weight), bias)


def row_parallel(linear, x, mp):
    """@linear(@x) for a row-parallel layer (weight ``Shard(1)``, @x this
    rank's input features): under @mp the partial products summed over the
    ranks, then the replicated bias."""
    if mp is None:
        return linear(x)
    out = _SumForward.apply(torch.nn.functional.linear(x, local(linear.weight)), mp)
    return out if linear.bias is None else out + local(linear.bias)


def full_tensor(t, comm):
    """The full tensor of @t: a DTensor's shards gathered over @comm (its mp
    axis), a replicated or plain tensor as it is."""
    if not isinstance(t, DTensor):
        return t
    pl = t.placements[0]
    return comm.all_gather(t.to_local(), pl.dim) if pl.is_shard() else t.to_local()


def place_like(full, like):
    """@full (a full tensor) as @like is placed: a DTensor of @like's
    placements holding this rank's shard, or @full where @like is plain."""
    if (isinstance(full, DTensor) or not isinstance(like, DTensor)
            or tuple(full.shape) != tuple(like.shape)):
        return full
    pl = like.placements[0]
    part = full
    if pl.is_shard():
        n, r = like.device_mesh.size(), like.device_mesh.get_local_rank()
        part = full.chunk(n, pl.dim)[r]
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
