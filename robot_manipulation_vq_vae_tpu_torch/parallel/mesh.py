"""Device mesh, data parallelism and the GPT's tensor-parallel rules
(counterpart of the JAX package's ``parallel/mesh.py``), in PyTorch's idiom:
one process a card, a ``torch.distributed`` process group that the caller
starts (``init_process_group`` with its address, world size and rank), and a
``('dp', 'mp')`` ``DeviceMesh`` over its ranks.

* ``dp``: data parallelism. Every rank holds the whole algo and steps it on
  its own slice of the batch (``shard_batch``, plain local tensors: the
  hand-written kernels read ``data_ptr()`` and must see local shards, never
  DTensors). The step computes what the unsharded step computes, as JAX's
  GSPMD step does: the gradients are averaged over ``dp`` (equal shards, so
  the mean of the shards' means is the global mean), BatchNorm normalizes by
  the global batch's mean and variance (an all-reduce of sums and sums of
  squares, Flax's one-pass statistics) and moves its running statistics
  towards them, and the flagship's hierarchical VQ-VAE all-reduces its EMA
  counts and sums and runs its k-means initialization and dead-code picks
  on the all-gathered batch with the generator that every rank holds in the
  same state. ``shard_state`` refuses (``NotImplementedError``) every algo
  and option whose step it does not make equal to the unsharded one.
* ``mp``: the GPT backbone's tensor-parallel rules as DTensor placements
  (``shard_params``): ``mlp_fc`` and ``qkv`` column-parallel (``Shard(0)``
  of torch's [out, in] weight), ``mlp_proj`` and the attention ``output``
  row-parallel (``Shard(1)``), everything else ``Replicate()``. The
  backbone's forward then runs on DTensors, whose sharding propagation keeps
  its semantics (``.chunk(3)`` of the column-sharded qkv output splits q, k
  and v as the unsharded one does). Training under mp > 1 is not ported.

The collectives run on the process group's backend: ``nccl`` on cards,
``gloo`` on the CPU. A CUDA tensor under ``gloo`` (two ranks that share one
card, which ``nccl`` refuses) is staged through pinned host memory: gloo's
CUDA paths are not relied on.
"""

import functools

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------


def _start_one_rank_group():
    """A process group of this process alone: nccl where there is a card,
    gloo on the CPU, over a free localhost port."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl" if torch.cuda.is_available() else "gloo",
                            init_method=f"tcp://localhost:{port}", world_size=1, rank=0)


def make_mesh(n_devices=None, mp=1):
    """A ('dp', 'mp') mesh over the ranks of the started process group, one
    process a card: [world // mp, mp], rank r at (r // mp, r % mp). With no
    group started, @n_devices None or 1 starts one of this process alone
    (nccl on a card, gloo on the CPU); more ranks need the caller's
    ``init_process_group`` with their address, world size and rank."""
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise RuntimeError(f"make_mesh: {n_devices} devices need a started process "
                               "group (torch.distributed.init_process_group, one "
                               "process a card)")
        _start_one_rank_group()
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"make_mesh: {n_devices} devices asked, the group has {world} ranks")
    if world % mp:
        raise ValueError(f"make_mesh: {world} ranks are not divisible by mp={mp}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(world).reshape(world // mp, mp),
                      mesh_dim_names=("dp", "mp"))


def batch_sharding(mesh):
    """The placements of a batch on @mesh: its leading axis over dp,
    replicated over mp."""
    return (Shard(0), Replicate())


def replicated(mesh):
    return (Replicate(), Replicate())


def _size(mesh, axis):
    return mesh.size(mesh.mesh_dim_names.index(axis))


# ---------------------------------------------------------------------------
# collectives on one mesh axis
# ---------------------------------------------------------------------------


class AxisComm:
    """Collectives over one axis of a mesh (its process group). Under
    ``gloo`` a CUDA tensor goes through pinned host memory."""

    def __init__(self, mesh, axis="dp"):
        self.group = mesh.get_group(axis)
        self.size = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        self.stage = dist.get_backend(self.group) == "gloo"

    def _wire(self, t):
        """(@t where the backend takes it, whether that is a copy): pinned
        host memory for a CUDA tensor under gloo, the card for a host
        tensor under nccl; bool as uint8."""
        wire = t.to(torch.uint8) if t.dtype == torch.bool else t
        if self.stage and wire.is_cuda:
            host = torch.empty(wire.shape, dtype=wire.dtype, pin_memory=True)
            return host.copy_(wire), True
        if not self.stage and not wire.is_cuda:
            return wire.to(torch.device("cuda", torch.cuda.current_device())), True
        return wire, wire is not t

    def all_reduce_(self, t):
        """Sum @t over the axis, in place; returns @t."""
        wire, copied = self._wire(t)
        dist.all_reduce(wire, group=self.group)
        return t.copy_(wire) if copied else t

    def all_gather(self, t):
        """The ranks' @t concatenated along dim 0 in rank order."""
        wire, _ = self._wire(t.contiguous())
        out = wire.new_empty((self.size * wire.shape[0], *wire.shape[1:]))
        dist.all_gather_into_tensor(out, wire, group=self.group)
        return out.to(t.device, t.dtype)

    def broadcast_(self, t, src=0):
        """@t from the axis' rank @src, in place; returns @t."""
        wire, copied = self._wire(t)
        dist.broadcast(wire, dist.get_global_rank(self.group, src), group=self.group)
        return t.copy_(wire) if copied else t

    def sum(self, t):
        """The sum of @t over the axis, differentiable: its backward sums the
        cotangents over the axis (every rank's loss reads the sum)."""
        return _AllReduceSum.apply(t, self)

    def mean_(self, tensors):
        """Average @tensors over the axis in place, as one flat buffer."""
        tensors = list(tensors)
        if not tensors:
            return tensors
        flat = torch.cat([t.reshape(-1) for t in tensors])
        self.all_reduce_(flat).div_(self.size)
        for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
            t.copy_(part.view_as(t))
        return tensors


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, comm):
        ctx.comm = comm
        return comm.all_reduce_(t.clone())

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_reduce_(g.clone()), None


# ---------------------------------------------------------------------------
# batches
# ---------------------------------------------------------------------------


class LocalBatch(dict):
    """This rank's shard of a batch (``shard_batch``): a dict of plain local
    tensors, with the ``layout`` it was cut by ("rows" or "halves") and the
    ``dp`` size, which a data-parallel step checks."""

    def __init__(self, items, layout, dp):
        super().__init__(items)
        self.layout = layout
        self.dp = dp


def _slice(x, rank, n, halves):
    b = x.shape[0]
    if halves:
        if b % (2 * n):
            raise ValueError(f"shard_batch: each half of a batch of {b} rows must be "
                             f"divisible by dp={n}")
        m, mid = b // (2 * n), b // 2
        rows = list(range(rank * m, (rank + 1) * m))
        rows += [mid + r for r in rows]
        if isinstance(x, torch.Tensor):
            return x[torch.as_tensor(rows, device=x.device)]
        return x[rows]
    if b % n:
        raise ValueError(f"shard_batch: a leading axis of {b} rows is not divisible "
                         f"by dp={n}")
    m = b // n
    return x[rank * m:(rank + 1) * m]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def shard_batch(mesh, batch, halves=False):
    """This rank's dp slice of every leaf's leading axis, as plain local
    tensors (or arrays), in a ``LocalBatch``: rows [r m, (r + 1) m) of rank
    r. With @halves each half of the leading axis is sliced on its own and
    the two slices concatenated, so that the rows the paper step pairs
    (context row i with supervised row B/2 + i) stay on one rank. A leading
    axis that dp does not divide raises."""
    n = _size(mesh, "dp")
    rank = mesh.get_local_rank("dp")
    return LocalBatch(_tree_map(lambda x: _slice(x, rank, n, halves), batch),
                      "halves" if halves else "rows", n)


# ---------------------------------------------------------------------------
# the GPT's tensor-parallel rules
# ---------------------------------------------------------------------------


def _backbones(module):
    from robot_manipulation_vq_vae_tpu_torch.models.transformers import GPT_Backbone

    return [m for m in module.modules() if isinstance(m, GPT_Backbone)]


def tp_placements(backbone):
    """{parameter name under @backbone: placement} of JAX's
    ``_param_spec`` in torch's [out, in] layout."""
    rules = {}
    for i, block in enumerate(backbone.nets["transformer"]):
        pre = f"nets.transformer.{i}.nets."
        rules[pre + "mlp.0.weight"] = Shard(0)                    # mlp_fc
        rules[pre + "mlp.2.weight"] = Shard(1)                    # mlp_proj
        rules[pre + "attention.nets.qkv.weight"] = Shard(0)
        rules[pre + "attention.nets.output.weight"] = Shard(1)
    return {name: rules.get(name, Replicate()) for name, _ in backbone.named_parameters()}


def _tp_forward(forward, mp_mesh):
    """The backbone's forward on DTensors: the input replicated over mp, the
    output gathered back to a plain tensor."""
    from torch.distributed.tensor.experimental import implicit_replication

    @functools.wraps(forward)
    def run(x):
        x = DTensor.from_local(x, mp_mesh, [Replicate()], run_check=False)
        with implicit_replication():
            return forward(x).full_tensor()

    return run


def shard_params(mesh, module):
    """Place every GPT backbone's parameters under @module by the
    tensor-parallel rules (``tp_placements``) over mp, in place; returns
    @module. With mp = 1 the parameters stay plain replicated tensors."""
    if _size(mesh, "mp") == 1:
        return module
    mp_mesh = mesh["mp"]
    for backbone in _backbones(module):
        placements = tp_placements(backbone)
        for name, param in list(backbone.named_parameters()):
            owner, _, leaf = name.rpartition(".")
            sub = backbone.get_submodule(owner) if owner else backbone
            dt = distribute_tensor(param.detach(), mp_mesh, [placements[name]])
            setattr(sub, leaf, torch.nn.Parameter(dt, requires_grad=param.requires_grad))
        backbone.forward = _tp_forward(backbone.forward, mp_mesh)
    return module


# ---------------------------------------------------------------------------
# an algo under the mesh
# ---------------------------------------------------------------------------


def _dp_refusals(algo):
    """What this algo's step has that the dp step does not make equal to the
    unsharded step: a list of reasons (empty when covered)."""
    from robot_manipulation_vq_vae_tpu_torch.algo.icl import (
        ICLTransformer_GMM,
        ICLTransformerHVQVAE,
    )
    from robot_manipulation_vq_vae_tpu_torch.models.base_nets import SpatialSoftmax

    name = type(algo).__name__
    if type(algo) not in (ICLTransformerHVQVAE, ICLTransformer_GMM):
        return [f"{name} (covered: ICLTransformerHVQVAE and icl_gmm_paper with LipVQ)"]
    out = []
    if type(algo) is ICLTransformer_GMM and not algo.vq_vae_enabled:
        out.append(f"{name}'s action tokenizer other than LipVQ (the default encoder "
                   "attends over the flattened batch; bin, LN-act and FAST are not "
                   "covered)")
    train = algo.global_config.train
    for opt in ("mixed_precision", "packed_rgb_encoders"):
        if train.get(opt, False):
            out.append(f"train.{opt}")
    for path, m in algo.nets.named_modules():
        if isinstance(m, torch.nn.Dropout) and m.p > 0:
            out.append(f"dropout {m.p} at {path} (each rank would draw its own masks, "
                       "not the unsharded step's one draw)")
        if isinstance(m, SpatialSoftmax) and m.noise_std > 0:
            out.append(f"SpatialSoftmax keypoint noise at {path}")
        for key, rands in (getattr(m, "randomizers", None) or {}).items():
            if rands:
                out.append(f"the {key} randomizers at {path} (per-row draws)")
    return out


def _broadcast_state(comm, algo):
    """Every rank starts from dp rank 0's weights, buffers, optimizer state
    and generator."""
    for t in algo.nets.state_dict().values():
        comm.broadcast_(t)
    for opt in algo.optimizers.values():
        for state in opt.state.values():
            for v in state.values():
                if isinstance(v, torch.Tensor):
                    comm.broadcast_(v)
    algo.generator.set_state(comm.broadcast_(algo.generator.get_state()))
    for m in algo.nets.modules():
        if hasattr(m, "_initialized") and hasattr(m, "codebooks_initialized"):
            m._initialized = bool(m.codebooks_initialized)


def shard_state(mesh, algo):
    """Put @algo under @mesh, in place; returns @algo. Every rank holds the
    parameters (replicated: the tensor-parallel rules at mp = 1), the
    optimizer state follows its parameters, and every rank takes dp rank
    0's weights, buffers, optimizer state and generator state, which stands
    in for JAX's replicated ``rng``. Under dp > 1 ``train_on_batch`` then
    takes only ``shard_batch``'s shards and runs the data-parallel step;
    an algo or option whose step that would change raises
    ``NotImplementedError`` here, named."""
    dp, mp = _size(mesh, "dp"), _size(mesh, "mp")
    if mp > 1:
        raise NotImplementedError(
            f"shard_state: training under mp={mp} is not ported (shard_params places "
            "the GPT backbones for a forward)")
    if dp == 1:
        return algo
    refused = _dp_refusals(algo)
    if refused:
        raise NotImplementedError(
            f"shard_state: data parallelism (dp={dp}) is not ported for: "
            + "; ".join(refused))
    comm = AxisComm(mesh, "dp")
    _broadcast_state(comm, algo)
    algo.set_data_parallel(comm)
    return algo
