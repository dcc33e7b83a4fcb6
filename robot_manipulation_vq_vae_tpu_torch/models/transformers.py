"""GPT backbone, pre-LN minGPT style (counterpart of the JAX package's
``models/transformers.py``): multi-head self-attention with an optional causal
mask, exact (erf) GELU 4x MLP, pre-LN residual blocks and a final LayerNorm.

LayerNorms use Flax's epsilon, 1e-6, not torch's default 1e-5. Parameters
keep the reference torch key names (``nets.transformer.{i}.nets.*``,
``nets.output_ln``).
"""

import math

import torch
import torch.nn as nn

from robot_manipulation_vq_vae_tpu_torch.utils.mixed_precision import at_least_f32

# Flax nn.LayerNorm's default epsilon (torch's default is 1e-5)
LN_EPS = 1e-6


class SelfAttention(nn.Module):
    """Multi-head self-attention with an optional causal (tril) mask."""

    JAX_NAMES = {"qkv": "nets.qkv", "output": "nets.output"}

    def __init__(self, embed_dim, num_heads, causal=True, attn_dropout=0.1,
                 output_dropout=0.1):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"width {embed_dim} is not a multiple of {num_heads} heads")
        self.num_heads = num_heads
        self.causal = causal
        self.nets = nn.ModuleDict({
            "qkv": nn.Linear(embed_dim, 3 * embed_dim, bias=False),
            "attn_dropout": nn.Dropout(attn_dropout),
            "output": nn.Linear(embed_dim, embed_dim),
            "output_dropout": nn.Dropout(output_dropout),
        })

    def forward(self, x):
        b, t, d = x.shape
        nh, dh = self.num_heads, d // self.num_heads
        q, k, v = self.nets["qkv"](x).chunk(3, dim=-1)
        q, k, v = (a.reshape(b, t, nh, dh).transpose(1, 2) for a in (q, k, v))
        # the JAX products ask for fp32 results (preferred_element_type): a
        # bf16 q and k (mixed precision) are multiplied in fp32
        att = (at_least_f32(q) @ at_least_f32(k).transpose(-1, -2)) / math.sqrt(dh)
        if self.causal:
            mask = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
            att = att.masked_fill(~mask, float("-inf"))
        att = self.nets["attn_dropout"](torch.softmax(att, dim=-1))
        y = (att @ v).transpose(1, 2).reshape(b, t, d)
        return self.nets["output_dropout"](self.nets["output"](y))


class SelfAttentionBlock(nn.Module):
    """Pre-LN residual block: x + attn(ln1(x)); x + mlp(ln2(x))."""

    JAX_NAMES = {"attention": "nets.attention", "ln1": "nets.ln1",
                 "ln2": "nets.ln2", "mlp_fc": "nets.mlp.0", "mlp_proj": "nets.mlp.2"}

    def __init__(self, embed_dim, num_heads, causal=True, attn_dropout=0.1,
                 output_dropout=0.1, activation="gelu"):
        super().__init__()
        if activation != "gelu":
            raise NotImplementedError(f"activation {activation} is not ported yet")
        self.nets = nn.ModuleDict({
            "attention": SelfAttention(embed_dim, num_heads, causal,
                                       attn_dropout, output_dropout),
            "ln1": nn.LayerNorm(embed_dim, eps=LN_EPS),
            "ln2": nn.LayerNorm(embed_dim, eps=LN_EPS),
            "mlp": nn.Sequential(
                nn.Linear(embed_dim, 4 * embed_dim),
                nn.GELU(),
                nn.Linear(4 * embed_dim, embed_dim),
                nn.Dropout(output_dropout),
            ),
        })

    def forward(self, x):
        x = x + self.nets["attention"](self.nets["ln1"](x))
        return x + self.nets["mlp"](self.nets["ln2"](x))


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
