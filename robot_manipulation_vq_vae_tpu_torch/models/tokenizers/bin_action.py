"""Adaptive-bin action tokenizer, the ``bin_enabled`` modality (counterpart of
the JAX package's ``models/tokenizers/bin_action.py``): per-dimension running
min / max statistics, uniform bins between them, one embedding table per
action dimension, then concat + MLP.

State, under the names the ``.pth`` checkpoint carries
(``...action_network.<name>``):

* ``running_min`` / ``running_max`` [A] and ``num_step`` (int32): buffers,
  the JAX ``bin_stats`` collection. A training forward (``self.training``)
  moves them before the boundaries are computed, until ``num_step`` reaches
  ``num_step_stop``; eval forwards leave them alone. They are read in the
  actions' type: under mixed precision the JAX step casts them to bf16
  with its inputs, so they round-trip through bf16 each step (the
  boundaries are then fp32 from the bf16 range).
* ``embedding`` [A, num_bins, E]: the per-dimension tables fused into one
  parameter, so the lookup is one gather.
* ``out_fc1`` / ``out_fc2``: the projection, exact (erf) GELU after each.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F


def bin_index(actions, lo, hi, num_bins):
    """The bin of each action value: [N, A] -> [N, A] int64 in
    [0, num_bins - 1].

    The boundaries are ``lo + (hi - lo) * steps`` with ``steps`` the JAX
    package's ``linspace(0, 1, num_bins + 1)`` as XLA computes it: the iota
    times the reciprocal of num_bins, the last step exactly 1
    (``torch.linspace`` rounds some steps the other way, which moves values
    that sit on a boundary to another bin). The index is the count of
    boundaries strictly below the value, which is ``searchsorted(side=
    "left")`` for sorted finite boundaries and 0, as in JAX, where they are
    NaN (a model that never trained: lo = +inf, hi = -inf); then
    ``clamp(idx - 1, 0, num_bins - 1)``.
    """
    # a bf16 range (mixed precision) gives fp32 boundaries, as the jitted
    # JAX step computes them
    kw = dict(dtype=torch.promote_types(lo.dtype, torch.float32), device=lo.device)
    lo, hi = lo.to(kw["dtype"]), hi.to(kw["dtype"])
    # built on the device without a host-to-device copy (torch.tensor, or an
    # item assignment, would stall the host until the card drains its queue)
    iota = torch.arange(num_bins + 1, **kw)
    steps = (iota * torch.full((), num_bins, **kw).reciprocal()).masked_fill(
        iota == num_bins, 1.0)
    boundaries = lo[:, None] + (hi - lo)[:, None] * steps[None]     # [A, nb + 1]
    idx = (boundaries[None] < actions[..., None]).sum(-1)           # [N, A]
    return (idx - 1).clamp(0, num_bins - 1)


class AdaptiveBinActionEmbedding(nn.Module):
    """actions [N, action_dim] -> embeddings [N, output_dim]."""

    JAX_NAMES = {"out_fc1": "out_fc1", "out_fc2": "out_fc2"}
    JAX_PARAMS = ("embedding",)
    JAX_BUFFERS = {"bin_stats": {"running_min": "running_min",
                                 "running_max": "running_max",
                                 "num_step": "num_step"}}

    NUM_BINS, EMBEDDING_DIM = 20, 64

    def __init__(self, action_dim, output_dim, num_step_stop=10000):
        super().__init__()
        self.action_dim, self.num_bins = action_dim, self.NUM_BINS
        self.num_step_stop = num_step_stop
        self.register_buffer("running_min", torch.full((action_dim,), float("inf")))
        self.register_buffer("running_max", torch.full((action_dim,), float("-inf")))
        self.register_buffer("num_step", torch.zeros((), dtype=torch.int32))
        self.embedding = nn.Parameter(
            torch.randn(action_dim, self.NUM_BINS, self.EMBEDDING_DIM))
        width = action_dim * self.EMBEDDING_DIM
        self.out_fc1 = nn.Linear(width, width // 2)
        self.out_fc2 = nn.Linear(width // 2, output_dim)
        for lin in (self.out_fc1, self.out_fc2):
            nn.init.zeros_(lin.bias)

    @torch.no_grad()
    def _update_stats(self, actions):
        """Widen the running range to @actions' while num_step is below
        num_step_stop (branch-free: no host sync on a card)."""
        enabled = self.num_step < self.num_step_stop
        lo, hi = self.running_min.to(actions.dtype), self.running_max.to(actions.dtype)
        new_lo = torch.minimum(lo, actions.min(0).values)
        new_hi = torch.maximum(hi, actions.max(0).values)
        self.running_min.copy_(torch.where(enabled, new_lo, lo))
        self.running_max.copy_(torch.where(enabled, new_hi, hi))
        self.num_step.add_(enabled.to(self.num_step.dtype))

    def forward(self, actions):
        if self.training:
            self._update_stats(actions.detach())
        idx = bin_index(actions.detach(), self.running_min.to(actions.dtype),
                        self.running_max.to(actions.dtype), self.num_bins)
        dims = torch.arange(self.action_dim, device=actions.device)[None]
        flat = self.embedding.reshape(-1, self.embedding.shape[-1])
        emb = flat[(dims * self.num_bins + idx).reshape(-1)]
        emb = emb.reshape(actions.shape[0], -1)
        return F.gelu(self.out_fc2(F.gelu(self.out_fc1(emb))))
