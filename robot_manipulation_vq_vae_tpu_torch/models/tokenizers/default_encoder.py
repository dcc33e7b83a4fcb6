"""Default action encoder, used when every tokenizer flag is off (counterpart
of the JAX package's ``models/tokenizers/default_encoder.py``): a
spectral-norm MLP (A -> 64 -> 128 -> D, exact GELU between), four post-LN
transformer encoder layers and an output Linear.

It keeps the JAX package's semantics where they differ from
``torch.nn.utils.spectral_norm`` and ``nn.TransformerEncoderLayer``:

* every forward runs one power iteration from the stored ``u`` and the
  gradient flows through it (``v``, the new ``u`` and sigma are not
  detached); only a training forward stores the new ``u``;
* attention runs over the whole flattened batch: the input [B*T, D] is one
  sequence of B*T tokens, as the reference feeds it to a
  ``batch_first=False`` encoder unbatched;
* 8 heads where D is a multiple of 8, else one; LayerNorm epsilon 1e-6;
  dropout fixed at 0.1 in each layer;
* under mixed precision every layer computes in bf16, and the power
  iteration runs on a bf16 copy of ``u``, whose result is stored back.

Checkpoint names (``...action_network.<name>``): ``sn{1,2,3}.weight``
[out, in], ``.bias``, ``.u`` (the JAX ``spectral`` collection, a buffer);
``layers.{i}.{q,k,v,attn_out,ff1,ff2,ln1,ln2}.*`` (JAX ``enc{i}``);
``out.*``.
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from robot_manipulation_vq_vae_tpu_torch.models.transformers import LN_EPS


SN_EPS = 1e-12


def _normalize(v):
    return v / (torch.linalg.vector_norm(v) + SN_EPS)


class SNDense(nn.Linear):
    """Linear layer with spectral normalization by one power iteration a
    forward. ``weight`` is [out, in] (the JAX kernel transposed); ``u`` [out]
    is a buffer that a training forward overwrites."""

    JAX_BUFFERS = {"spectral": {"u": "u"}}

    def __init__(self, in_features, out_features):
        super().__init__(in_features, out_features)
        nn.init.zeros_(self.bias)
        self.register_buffer("u", torch.randn(out_features))

    def forward(self, x):
        w = self.weight
        # under mixed precision the JAX step iterates on a bf16 copy of u
        u = _normalize(self.u.to(w.dtype))
        v = _normalize(u @ w)             # [in]
        u_new = _normalize(w @ v)         # [out]
        sigma = torch.dot(u_new @ w, v)
        if self.training:
            with torch.no_grad():
                self.u.copy_(u_new)
        return F.linear(x, w / sigma, self.bias)


class TorchTransformerEncoderLayer(nn.Module):
    """Post-LN encoder layer over one unbatched sequence [S, D]: separate
    q / k / v projections, softmax attention, exact-GELU feed-forward."""

    JAX_NAMES = {n: n for n in ("q", "k", "v", "attn_out", "ff1", "ff2", "ln1", "ln2")}

    def __init__(self, d_model):
        super().__init__()
        # the reference's nhead=8 fails for a width that is not a multiple of
        # 8; the JAX package falls back to one head there
        self.nh = 8 if d_model % 8 == 0 else 1
        self.q, self.k, self.v, self.attn_out = (nn.Linear(d_model, d_model)
                                                 for _ in range(4))
        self.ff1 = nn.Linear(d_model, 256)
        self.ff2 = nn.Linear(256, d_model)
        self.ln1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.ln2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.drop_attn, self.drop_ff, self.drop_out = (nn.Dropout(0.1)
                                                       for _ in range(3))

    def forward(self, x):
        s, d = x.shape
        nh, dh = self.nh, d // self.nh
        q, k, v = (lin(x).reshape(s, nh, dh).transpose(0, 1)
                   for lin in (self.q, self.k, self.v))
        # JAX divides by sqrt(dh) cast to the input's type (bf16 under mixed
        # precision)
        scale = float(torch.tensor(math.sqrt(dh), dtype=torch.float64).to(x.dtype))
        att = torch.softmax((q @ k.transpose(-1, -2)) / scale, dim=-1)
        y = (att @ v).transpose(0, 1).reshape(s, d)
        x = self.ln1(x + self.drop_attn(self.attn_out(y)))
        h = self.drop_ff(F.gelu(self.ff1(x)))
        return self.ln2(x + self.drop_out(self.ff2(h)))


class DefaultActionEncoder(nn.Module):
    """actions [N, action_dim] -> [N, output_dim], attention across all N."""

    JAX_NAMES = {"sn1": "sn1", "sn2": "sn2", "sn3": "sn3", "out": "out",
                 **{f"enc{i}": f"layers.{i}" for i in range(4)}}

    def __init__(self, action_dim, output_dim):
        super().__init__()
        self.sn1 = SNDense(action_dim, 64)
        self.sn2 = SNDense(64, 128)
        self.sn3 = SNDense(128, output_dim)
        self.layers = nn.ModuleList(TorchTransformerEncoderLayer(output_dim)
                                    for _ in range(4))
        self.out = nn.Linear(output_dim, output_dim)
        nn.init.zeros_(self.out.bias)

    def forward(self, actions_flat):
        h = F.gelu(self.sn2(F.gelu(self.sn1(actions_flat))))
        h = self.sn3(h)
        for layer in self.layers:
            h = layer(h)
        return self.out(h)
