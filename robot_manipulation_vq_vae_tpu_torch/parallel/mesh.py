"""Device mesh, data parallelism and tensor parallelism
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
  same state. The bin tokenizer's running range is the global batch's (an
  all-reduce of the ranks' minima and maxima), and the default action
  encoder attends over the global sequence (every rank encodes the
  all-gathered context actions and keeps its rows). Every other random draw of the step (dropout, the
  randomizers' crops, color jitter and noise, SpatialSoftmax's keypoint
  noise) is taken at the global batch's shape from that generator, and the
  rank keeps its rows (``utils.draws.global_draw``): the ranks together draw the
  unsharded step's one draw, as GSPMD does. ``get_action`` under dp takes
  ``shard_batch``'s shards and returns the global batch's actions on every
  rank (a GMM's mixture gathered and sampled whole from the replicated
  generator; a stepwise policy's state, an RNN's hidden state or ACT's
  queue, holds the rank's rows). An offline-RL algo averages each
  network's gradient over ``dp`` before clipping it (each critic of an
  ensemble with its own optimizer), takes TD3-BC's lambda from the global
  batch's mean |Q| and its candidates' draws at the global batch's shape; a
  hierarchical algo's planner and actor share the axis; MCR pretraining
  reads its negatives from the all-gathered embeddings (``AxisComm.gather``,
  differentiable). ``shard_state`` refuses (``NotImplementedError``) every
  algo whose step it does not make equal to the unsharded one.
* ``mp``: JAX's tensor-parallel rules (``_param_spec``) over the whole
  module tree (``TP_RULES``, ``shard_params``): every attention block's
  ``mlp_fc`` and ``qkv`` column-parallel (``Shard(0)`` of torch's [out, in]
  weight), its ``mlp_proj`` and attention ``output`` row-parallel
  (``Shard(1)``), wherever the block sits (the GPTs, ACT's style encoder),
  and the ViT's ``qkv`` (MVP) column-parallel; everything else
  replicated, so that every algo and option runs under mp (the networks
  without such weights replicated over mp). The split weights become
  DTensors of those placements over the mp axis, which record the layout
  and hold this rank's shard (every other parameter stays a plain
  tensor); the modules are given the mp axis and
  their own forwards compute on the local shards (``utils.tensor_parallel``),
  every collective ``AxisComm``'s in an explicit autograd function, never
  DTensor's own (on gloo ranks that share a card, DTensor's collectives on
  CUDA shards kill the rank). Each rank attends with its own heads: it
  all-gathers the qkv weight (its ``Shard(0)`` rows do not follow the heads)
  and reduces that gradient; the row-parallel outputs are all-reduced.
  Where mp does not divide the heads, and in the ViT, the weights are
  gathered and every rank computes every head; GEGLU gathers ``mlp_fc``
  (see ``SelfAttentionBlock._geglu_rows``). The gradients come back in
  their parameters' placements, so the optimizers step the local shards
  with no collective. The trunks, the tokenizers and the kernels stay on
  plain replicated tensors; ``Algo.serialize`` gathers full tensors in the
  reference layout and ``deserialize`` places them again. Under mixed
  precision the bf16 copies are the local shards cast, in their placements.
  Every mp rank computes the replicated modules itself: the forwards
  alike (the same weights, inputs and draws), but on a card the backward's
  non-deterministic kernels (cuDNN's, ``index_add_``) part the ranks'
  gradients by a few ulps, so each replicated parameter steps with mp
  rank 0's gradient on every mp rank (``Algo._sync_grads``) and the
  replicas stay equal to the bit.

The collectives run on the process group's backend: ``nccl`` on cards,
``gloo`` on the CPU. A CUDA tensor under ``gloo`` (two ranks that share one
card, which ``nccl`` refuses) is staged through pinned host memory: gloo's
CUDA paths are not relied on.
"""

import collections

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from robot_manipulation_vq_vae_tpu_torch.algo.act import ACT
from robot_manipulation_vq_vae_tpu_torch.algo.algo import (
    HierarchicalAlgo,
    PlannerAlgo,
    ValueAlgo,
)
from robot_manipulation_vq_vae_tpu_torch.algo.diffusion_policy import DiffusionPolicyUNet
from robot_manipulation_vq_vae_tpu_torch.algo.gl import ValuePlanner
from robot_manipulation_vq_vae_tpu_torch.algo.icl import ICL
from robot_manipulation_vq_vae_tpu_torch.algo.mcr_pretrain import MCRPretrainer
from robot_manipulation_vq_vae_tpu_torch.models.pretrained_nets import ViTBlock
from robot_manipulation_vq_vae_tpu_torch.models.transformers import (
    SelfAttention,
    SelfAttentionBlock,
)
from robot_manipulation_vq_vae_tpu_torch.utils.draws import take_rows
from robot_manipulation_vq_vae_tpu_torch.utils.tensor_parallel import (
    local,
    place_optimizer_state,
)

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


def make_mesh(n_devices=None, mp=1, device=None):
    """A ('dp', 'mp') mesh over the ranks of the started process group, one
    process a card: [world // mp, mp], rank r at (r // mp, r % mp). With no
    group started, @n_devices None or 1 starts one of this process alone
    (nccl on a card, gloo on the CPU); more ranks need the caller's
    ``init_process_group`` with their address, world size and rank. The
    mesh's device type is @device's, the device the algo trains on
    ("cuda" where there is a card when @device is None), whatever the
    backend: the GPT's DTensor shards under mp stay on that device
    (``shard_state`` refuses an algo on another)."""
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
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    return DeviceMesh(torch.device(device).type,
                      torch.arange(world).reshape(world // mp, mp),
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


_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}


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

    def all_reduce_(self, t, op="sum"):
        """Reduce @t over the axis in place by @op ("sum", "min" or "max");
        returns @t."""
        wire, copied = self._wire(t)
        dist.all_reduce(wire, op=_OPS[op], group=self.group)
        return t.copy_(wire) if copied else t

    def all_gather(self, t, dim=0):
        """The ranks' @t concatenated along @dim in rank order."""
        t = t.movedim(dim, 0)
        wire, _ = self._wire(t.contiguous())
        out = wire.new_empty((self.size * wire.shape[0], *wire.shape[1:]))
        dist.all_gather_into_tensor(out, wire, group=self.group)
        return out.to(t.device, t.dtype).movedim(0, dim)

    def broadcast_(self, t, src=0):
        """@t from the axis' rank @src, in place; returns @t."""
        wire, copied = self._wire(t)
        dist.broadcast(wire, dist.get_global_rank(self.group, src), group=self.group)
        return t.copy_(wire) if copied else t

    def sum(self, t):
        """The sum of @t over the axis, differentiable: its backward sums the
        cotangents over the axis (every rank's loss reads the sum)."""
        return _AllReduceSum.apply(t, self)

    def gather(self, t):
        """The ranks' @t concatenated along dim 0 in rank order,
        differentiable: its backward gives each rank its own rows of the
        cotangent summed over the axis (every rank's loss may read every
        rank's rows)."""
        return _AllGather.apply(t, self)

    def chunk(self, t, dim=0):
        """This rank's equal part of @t along @dim."""
        if t.shape[dim] % self.size:
            raise ValueError(f"a dim of {t.shape[dim]} is not divisible by {self.size} ranks")
        return t.chunk(self.size, dim)[self.rank]

    def mean_(self, tensors):
        """Average @tensors over the axis in place, as one flat buffer (a
        DTensor: its local shard)."""
        return self._flat_(tensors, lambda flat: self.all_reduce_(flat).div_(self.size))

    def broadcast_many_(self, tensors, src=0):
        """@tensors from the axis' rank @src, in place, as one flat
        buffer."""
        return self._flat_(tensors, lambda flat: self.broadcast_(flat, src))

    @staticmethod
    def _flat_(tensors, collective):
        """@collective on @tensors' local tensors concatenated, copied
        back in place; returns them."""
        tensors = [local(t) for t in tensors]
        if not tensors:
            return tensors
        flat = torch.cat([t.reshape(-1) for t in tensors])
        collective(flat)
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


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, comm):
        ctx.comm = comm
        return comm.all_gather(t)

    @staticmethod
    def backward(ctx, g):
        comm = ctx.comm
        return comm.chunk(comm.all_reduce_(g.contiguous().clone())).contiguous(), None


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
    return LocalBatch(_tree_map(lambda x: take_rows(x, rank, n, halves), batch),
                      "halves" if halves else "rows", n)


# ---------------------------------------------------------------------------
# the tensor-parallel rules (JAX's ``_param_spec``)
# ---------------------------------------------------------------------------


# JAX's ``_param_spec`` in torch's [out, in] layout, by the module that holds
# the weight: a JAX spec P(None, "mp") of a kernel [in, out] is column-parallel,
# ``Shard(0)`` of torch's weight; P("mp", None) is row-parallel, ``Shard(1)``.
# Every other parameter is replicated, a plain tensor.
TP_RULES = (
    (SelfAttentionBlock, {"nets.mlp.0.weight": Shard(0),     # mlp_fc
                          "nets.mlp.2.weight": Shard(1)}),   # mlp_proj
    (SelfAttention, {"nets.qkv.weight": Shard(0),            # qkv
                     "nets.output.weight": Shard(1)}),       # attention/output
    (ViTBlock, {"attn.qkv.weight": Shard(0)}),               # qkv
)

def tp_placements(module):
    """{parameter name under @module: placement} of ``TP_RULES`` over its
    whole tree."""
    rules = {}
    for name, m in module.named_modules():
        for cls, weights in TP_RULES:
            if isinstance(m, cls):
                rules.update({f"{name}.{w}" if name else w: pl for w, pl in weights.items()})
    return {name: rules.get(name, Replicate()) for name, _ in module.named_parameters()}


def _check_divisible(module, mp):
    """Raise ``ValueError`` for a split weight of @module whose dim @mp does
    not divide (JAX cannot place it either)."""
    params = dict(module.named_parameters())
    for name, pl in tp_placements(module).items():
        if pl.is_shard() and params[name].shape[pl.dim] % mp:
            raise ValueError(f"shard_params: {name} {tuple(params[name].shape)} is not "
                             f"divisible by mp={mp} along dim {pl.dim}")


def shard_params(mesh, module):
    """Place @module's parameters by the tensor-parallel rules
    (``tp_placements``) over mp, in place, and give the modules that compute
    on them the mp axis (``mp``); returns @module. A split weight becomes a
    DTensor holding this rank's shard; the rest stay plain (replicated)
    tensors. With mp = 1
    nothing changes. A dim that mp does not divide raises ``ValueError``
    before anything is placed. Optimizers that hold the replaced parameters
    must be given the new ones (``shard_state`` does)."""
    if _size(mesh, "mp") == 1:
        return module
    mp_mesh = mesh["mp"]
    comm = AxisComm(mesh, "mp")
    _check_divisible(module, comm.size)
    params = dict(module.named_parameters())
    for name, pl in tp_placements(module).items():
        if not pl.is_shard():
            continue
        param = params[name]
        owner, _, leaf = name.rpartition(".")
        sub = module.get_submodule(owner) if owner else module
        part = comm.chunk(param.detach(), pl.dim)
        dt = DTensor.from_local(part.contiguous(), mp_mesh, [pl], run_check=False)
        setattr(sub, leaf, torch.nn.Parameter(dt, requires_grad=param.requires_grad))
    for m in module.modules():
        if hasattr(type(m), "mp"):
            m.mp = comm
    return module


def _replace_optimizer_params(optimizer, new_of):
    """@optimizer over the parameters @new_of gives ({id(old): new}), its
    state carried over and placed as the new parameters are."""
    for group in optimizer.param_groups:
        group["params"] = [new_of.get(id(p), p) for p in group["params"]]
    optimizer.state = collections.defaultdict(
        dict, {new_of.get(id(p), p): st for p, st in optimizer.state.items()})
    place_optimizer_state(optimizer)


# ---------------------------------------------------------------------------
# an algo under the mesh
# ---------------------------------------------------------------------------


# what the sharded step covers: the ICL family (the MLP, RNN, transformer,
# HVQVAE and Mamba policies and the paper's every tokenizer), the bc classes,
# ICLVAE and the MCR policies (subclasses of ICL), the diffusion policy, ACT,
# offline RL, the subgoal planners, the hierarchical algos and MCR's
# representation pretraining, each with every option, at any (dp, mp)
_COVERED = (ICL, DiffusionPolicyUNet, ACT, ValueAlgo, PlannerAlgo, HierarchicalAlgo,
            ValuePlanner, MCRPretrainer)


def _components(algo):
    """The algos that hold @algo's state: itself, or a hierarchical algo's
    planner and actor (a value planner's planner and value algo), each with
    its own networks, optimizers and generator."""
    if isinstance(algo, HierarchicalAlgo):
        return _components(algo.planner) + _components(algo.actor)
    if isinstance(algo, ValuePlanner):
        return _components(algo.planner) + _components(algo.value_net)
    return [algo]


def _broadcast(comm, module, optimizers, generator):
    """Every rank of @comm's axis takes its rank 0's weights and buffers of
    @module, state of @optimizers and @generator's state (a DTensor: its
    local shard)."""
    for t in module.state_dict().values():
        comm.broadcast_(local(t))
    for opt in optimizers:
        for state in opt.state.values():
            for v in state.values():
                if isinstance(v, torch.Tensor):
                    comm.broadcast_(local(v))
    generator.set_state(comm.broadcast_(generator.get_state()))


def _broadcast_state(comm, algo):
    """Every rank of @comm's axis starts from its rank 0's weights, buffers,
    optimizer state and generator of every component of @algo (the
    networks of an offline-RL algo's ensemble and their targets, each with
    its optimizer; a hierarchical algo's planner and actor)."""
    for part in _components(algo):
        module, optimizers = _networks(part)
        _broadcast(comm, module, optimizers, part.generator)
        for m in module.modules():
            if hasattr(m, "_initialized") and hasattr(m, "codebooks_initialized"):
                m._initialized = bool(m.codebooks_initialized)


def _networks(part):
    """(module, optimizers) of a component: an algo's networks and
    optimizers, MCR pretraining's model and optimizer."""
    if isinstance(part, MCRPretrainer):
        return part.model, [part.optimizer]
    return part.nets, list(part.optimizers.values())


def _shard_component(mesh, comm, part):
    """@part's parameters placed over mp (``shard_params``), its optimizers
    given the new ones, and the mp axis."""
    module, optimizers = _networks(part)
    part.mp = comm
    before = dict(module.named_parameters())
    shard_params(mesh, module)
    new_of = {id(before[n]): p for n, p in module.named_parameters() if p is not before[n]}
    for opt in optimizers:
        _replace_optimizer_params(opt, new_of)


def shard_state(mesh, algo):
    """Put @algo under @mesh, in place; returns @algo. Every rank takes its
    axes' rank 0's weights, buffers, optimizer state and generator state,
    which stands in for JAX's replicated ``rng``. Under mp > 1 each
    component's parameters are placed by ``shard_params`` (JAX's
    ``_param_spec``: the attention blocks' and the ViT's split weights;
    everything else replicated) and the optimizers step their shards; the
    mp ranks of a dp shard take the same draws from the same generator
    state, so they step identically. Under dp > 1 ``train_on_batch`` and
    ``get_action`` then take only ``shard_batch``'s shards and run the
    data-parallel step. An algo whose step that would change raises
    ``NotImplementedError`` here, named; a weight dim that mp does not
    divide, ``ValueError``."""
    dp, mp = _size(mesh, "dp"), _size(mesh, "mp")
    if dp == 1 and mp == 1:
        return algo
    if mp > 1 and mesh.device_type != algo.device.type:
        raise ValueError(f"shard_state: a {mesh.device_type!r} mesh for an algo on "
                         f"{algo.device.type!r} (its shards would leave the algo's "
                         "device): make_mesh(..., device=algo.device)")
    if not isinstance(algo, _COVERED):
        raise NotImplementedError(
            f"shard_state: (dp={dp}, mp={mp}) is not ported for: {type(algo).__name__} "
            "(covered: the ICL, bc and MCR families, the diffusion policy, ACT, offline RL, "
            "the hierarchical family and MCR pretraining)")
    if mp > 1:
        comm = AxisComm(mesh, "mp")
        parts = _components(algo)
        for part in parts:   # before anything moves
            _check_divisible(_networks(part)[0], mp)
        _broadcast_state(comm, algo)
        for part in parts:
            _shard_component(mesh, comm, part)
        algo.mp = comm
    if dp > 1:
        comm = AxisComm(mesh, "dp")
        _broadcast_state(comm, algo)
        algo.set_data_parallel(comm)
    return algo
