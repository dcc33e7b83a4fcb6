"""GPT backbone, pre-LN minGPT style (counterpart of the JAX package's
``models/transformers.py``): multi-head self-attention with an optional causal
mask, a 4x MLP with exact (erf) GELU or GEGLU, pre-LN residual blocks and a
final LayerNorm; and the sinusoidal positional encoding.

LayerNorms use Flax's epsilon, 1e-6, not torch's default 1e-5. The dropouts
are ``base_nets.Dropout`` (Flax's semantics, drawn from the algo's
generator). Parameters keep the reference torch key names
(``nets.transformer.{i}.nets.*``, ``nets.output_ln``).

Under tensor parallelism (``parallel.shard_params``, JAX's ``_param_spec``)
the blocks are given their ``mp`` axis and compute on their parameters'
local shards through ``utils.tensor_parallel``: each rank attends with its
own heads (with every head where mp does not divide them) and holds its
part of the MLP's hidden units (GEGLU's too); without it the same forwards
compute every head and unit.
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from robot_manipulation_vq_vae_tpu_torch.models.base_nets import Dropout
from robot_manipulation_vq_vae_tpu_torch.utils import tensor_parallel as TP
from robot_manipulation_vq_vae_tpu_torch.utils.mixed_precision import at_least_f32

# Flax nn.LayerNorm's default epsilon (torch's default is 1e-5)
LN_EPS = 1e-6


def sinusoidal_positional_encoding(t, embed_dim, device=None):
    """The sin / cos encoding of positions 0 .. @t - 1: [t, embed_dim], sines
    in the even columns and cosines in the odd ones. It is a constant, and is
    computed in float32 whatever the model's dtype, as the JAX package
    computes it."""
    half_ids = torch.arange(0, embed_dim, 2, dtype=torch.float32, device=device)
    div_term = torch.exp(half_ids * (-math.log(10000.0) / embed_dim))
    ang = torch.arange(t, dtype=torch.float32, device=device)[:, None] * div_term
    pe = torch.zeros(t, embed_dim, dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(ang)
    pe[:, 1::2] = torch.cos(ang)
    return pe


class GEGLU(nn.Module):
    """The GLU variant: the first half of the features times the exact GELU
    of the second half ([..., 2n] -> [..., n])."""

    def forward(self, x):
        a, b = x.chunk(2, dim=-1)
        return a * F.gelu(b)


class SelfAttention(nn.Module):
    """Multi-head self-attention with an optional causal (tril) mask. Under
    tensor parallelism (``mp``) this rank's heads: their q, k and v from the
    gathered qkv weight (its ``Shard(0)`` rows do not follow the heads), the
    attention dropout's mask drawn for every head and cut to them, and the
    row-parallel output projection summed over mp. Where mp does not divide
    the heads, every rank attends with every head on the gathered qkv and
    output weights."""

    JAX_NAMES = {"qkv": "nets.qkv", "output": "nets.output"}
    # the tensor-parallel axis (``parallel.shard_params``)
    mp = None

    def __init__(self, embed_dim, num_heads, causal=True, attn_dropout=0.1,
                 output_dropout=0.1):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"width {embed_dim} is not a multiple of {num_heads} heads")
        self.num_heads = num_heads
        self.causal = causal
        self.nets = nn.ModuleDict({
            "qkv": nn.Linear(embed_dim, 3 * embed_dim, bias=False),
            "attn_dropout": Dropout(attn_dropout),
            "output": nn.Linear(embed_dim, embed_dim),
            "output_dropout": Dropout(output_dropout),
        })

    def forward(self, x):
        b, t, d = x.shape
        nh, dh = self.num_heads, d // self.num_heads
        # the axis the heads are split over: mp where it divides them
        split = self.mp if self.mp is not None and nh % self.mp.size == 0 else None
        heads = TP.heads(nh, split)
        n = heads.stop - heads.start
        q, k, v = self._qkv(x, heads, dh, split).chunk(3, dim=-1)
        q, k, v = (a.reshape(b, t, n, dh).transpose(1, 2) for a in (q, k, v))
        # the JAX products ask for fp32 results (preferred_element_type): a
        # bf16 q and k (mixed precision) are multiplied in fp32
        att = (at_least_f32(q) @ at_least_f32(k).transpose(-1, -2)) / math.sqrt(dh)
        if self.causal:
            mask = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
            att = att.masked_fill(~mask, float("-inf"))
        att = self.nets["attn_dropout"](torch.softmax(att, dim=-1), (b, nh, t, t),
                                        (slice(None), heads))
        y = (att @ v).transpose(1, 2).reshape(b, t, n * dh)
        out = self.nets["output"]
        if self.mp is not None and split is None:
            y = F.linear(y, TP.gathered(out.weight, self.mp, 1), out.bias)
        else:
            y = TP.row_parallel(out, y, split)
        return self.nets["output_dropout"](y)

    def _qkv(self, x, heads, dh, split):
        """q, k and v of @heads, concatenated (@split: the axis the heads
        are split over, or None)."""
        if self.mp is None:
            return self.nets["qkv"](x)
        w = TP.gathered(self.nets["qkv"].weight, self.mp, 0)
        if split is None:
            return F.linear(x, w)
        d = x.shape[-1]
        w = TP.sum_cotangent(w, split).reshape(3, d, d)
        w = w[:, heads.start * dh:heads.stop * dh].reshape(-1, d)
        return F.linear(TP.sum_cotangent(x, split), w)


class SelfAttentionBlock(nn.Module):
    """Pre-LN residual block: x + attn(ln1(x)); x + mlp(ln2(x)). With
    ``activation="geglu"`` the MLP's first layer is twice as wide and GEGLU
    halves it; any other activation but ``"gelu"`` raises."""

    JAX_NAMES = {"attention": "nets.attention", "ln1": "nets.ln1",
                 "ln2": "nets.ln2", "mlp_fc": "nets.mlp.0", "mlp_proj": "nets.mlp.2"}
    # the tensor-parallel axis (``parallel.shard_params``): this rank's part
    # of the MLP's hidden units (``mlp_fc`` column-, ``mlp_proj``
    # row-parallel)
    mp = None

    def __init__(self, embed_dim, num_heads, causal=True, attn_dropout=0.1,
                 output_dropout=0.1, activation="gelu"):
        super().__init__()
        if activation not in ("gelu", "geglu"):
            raise NotImplementedError(f"activation {activation} is not ported")
        self.geglu = activation == "geglu"
        self.nets = nn.ModuleDict({
            "attention": SelfAttention(embed_dim, num_heads, causal,
                                       attn_dropout, output_dropout),
            "ln1": nn.LayerNorm(embed_dim, eps=LN_EPS),
            "ln2": nn.LayerNorm(embed_dim, eps=LN_EPS),
            "mlp": nn.Sequential(
                nn.Linear(embed_dim, (8 if self.geglu else 4) * embed_dim),
                GEGLU() if self.geglu else nn.GELU(),
                nn.Linear(4 * embed_dim, embed_dim),
                Dropout(output_dropout),
            ),
        })

    def forward(self, x):
        x = x + self.nets["attention"](self.nets["ln1"](x))
        fc, act, proj, drop = self.nets["mlp"]
        h = self.nets["ln2"](x)
        if self.geglu and self.mp is not None:
            h = F.linear(TP.sum_cotangent(h, self.mp), *self._geglu_rows(fc))
        else:
            h = TP.column_parallel(fc, h, self.mp)
        return x + drop(TP.row_parallel(proj, act(h), self.mp))

    def _geglu_rows(self, fc):
        """GEGLU under mp: the ``mlp_fc`` weight and bias rows of this rank's
        hidden units, its part of the value half and of the gate half. JAX's
        contiguous ``Shard(0)`` of the [2 n, d] weight gives rank 0 value
        rows alone and the last rank gate rows alone, so the weight is
        gathered and each rank takes its rows of both halves (their
        gradient summed over mp); ``mlp_proj`` stays row-parallel over the
        same hidden units."""
        n = fc.out_features // 2
        m, r = n // self.mp.size, self.mp.rank
        rows = torch.cat([torch.arange(r * m, (r + 1) * m),
                          torch.arange(n + r * m, n + (r + 1) * m)])
        rows = rows.to(TP.local(fc.weight).device)
        w = TP.sum_cotangent(TP.gathered(fc.weight, self.mp, 0), self.mp)
        b = TP.sum_cotangent(fc.bias, self.mp)
        return w[rows], b[rows]


class GPT_Backbone(nn.Module):
    """Stack of SelfAttentionBlocks + output LayerNorm."""

    def __init__(self, embed_dim, context_length, causal=True, attn_dropout=0.1,
                 block_output_dropout=0.1, num_layers=6, num_heads=8,
                 activation="gelu"):
        super().__init__()
        self.context_length = context_length
        self.nets = nn.ModuleDict({
            "transformer": nn.Sequential(*[
                SelfAttentionBlock(embed_dim, num_heads, causal, attn_dropout,
                                   block_output_dropout, activation)
                for _ in range(num_layers)
            ]),
            "output_ln": nn.LayerNorm(embed_dim, eps=LN_EPS),
        })

    def jax_names(self):
        names = {f"block{i}": f"nets.transformer.{i}"
                 for i in range(len(self.nets["transformer"]))}
        names["output_ln"] = "nets.output_ln"
        return names

    def forward(self, x):
        if x.shape[1] > self.context_length:
            raise ValueError(
                f"sequence length {x.shape[1]} exceeds context {self.context_length}"
            )
        return self.nets["output_ln"](self.nets["transformer"](x))
