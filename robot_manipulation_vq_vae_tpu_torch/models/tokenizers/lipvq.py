"""LipVQ-VAE action tokenizer (counterpart of the JAX package's
``models/tokenizers/lipvq.py``):

    x --enc(in->64->GELU->128->GELU)--> h
      --LipschitzDense (L-inf row-normalized, sigmoid)--> z_e
      --nearest code--> z_q
      --dec(latent->64->GELU->128->GELU)--> --Linear--> x_recon

    loss = MSE(x_recon, x) + 0.25 MSE(sg(z_q), z_e) + 0.25 MSE(z_q, sg(z_e))

GELU is the exact (erf) form everywhere except in the fused roundtrip, whose
kernel uses tanh-GELU as the TPU kernel did. Under mixed precision
(``utils/mixed_precision.py``) the encoder MLP runs in bf16, the latent
layer's product in fp32 (so z_e is fp32), the bf16 codebook is searched by
kernel 1's bf16 instance, which gives z_q in z_e's type, fp32, as the TPU
kernel's output takes z's type, and the decoder runs in fp32. The decoder reads the raw
gathered code (no straight-through estimator), and the training forward
returns the detached quantized code as the latent. Parameters keep the
reference torch key names (``encoder.0``, ``to_latent.W``,
``quantizer.codebook``, ...).

The nearest-code search runs through the CUDA assign kernel on a card
(``ops/lipvq_kernel.py``, differentiated by ``L2Nearest``);
``use_kernel=False`` selects the plain version explicitly.
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from robot_manipulation_vq_vae_tpu_torch.ops import lipvq_kernel as K
from robot_manipulation_vq_vae_tpu_torch.utils.mixed_precision import at_least_f32


def _lipschitz_weight(W, ci):
    """Each row of W scaled by min(1, softplus(ci) / sum|row|)."""
    absrowsum = W.abs().sum(1, keepdim=True)
    return W * torch.clamp(F.softplus(ci)[:, None] / absrowsum, max=1.0)


class LipschitzDense(nn.Module):
    """L-inf row-normalized linear layer + sigmoid; W is [out, in]."""

    JAX_PARAMS = ("W", "b", "ci")

    def __init__(self, in_dim, features):
        super().__init__()
        self.W = nn.Parameter(torch.randn(features, in_dim))
        self.b = nn.Parameter(torch.zeros(features))
        self.ci = nn.Parameter(torch.ones(features))

    def normalized_weight(self):
        return _lipschitz_weight(self.W, self.ci)

    def forward(self, x):
        # an fp32 product, as the JAX layer's preferred_element_type asks:
        # under mixed precision the latent is fp32 from bf16 inputs
        w = self.normalized_weight()
        return torch.sigmoid(at_least_f32(x) @ at_least_f32(w).t() + self.b)


class LFQQuantizer(nn.Module):
    """Learnable-codebook nearest-neighbour quantizer. ``use_kernel`` picks
    the CUDA assign kernel (the default; its wrapper runs the plain version
    on CPU tensors) or, when False, the plain version on any device."""

    JAX_PARAMS = ("codebook",)

    def __init__(self, num_codes, code_dim, use_kernel=True):
        super().__init__()
        bound = math.sqrt(6.0 / code_dim)  # kaiming_uniform, fan_in = code_dim
        self.codebook = nn.Parameter(
            torch.empty(num_codes, code_dim).uniform_(-bound, bound)
        )
        self.use_kernel = use_kernel

    def forward(self, z_e):
        """Returns (z_q, idx int32); z_q carries the codebook's gradient."""
        idx, z_q = K.l2_nearest(z_e.contiguous(), self.codebook, self.use_kernel)
        return z_q, idx

    def lookup(self, idx):
        return self.codebook[idx.long()]


class LipVQVAE(nn.Module):
    """The LipVQ-VAE tokenizer. Call modes (inputs [..., feature_dim]):
      forward(x)         -> (z_latent, loss)   [training forward]
      encode(x)          -> (z_e, idx)         [tokenize]
      decode_codes(idx)  -> x_recon            [detokenize]
      roundtrip(x)       -> (x_recon, idx)
      roundtrip_fused(x) -> (x_recon, idx)     [one CUDA kernel, tanh-GELU]
    """

    JAX_NAMES = {"enc1": "encoder.0", "enc2": "encoder.2",
                 "to_latent": "to_latent", "quantizer": "quantizer",
                 "dec1": "decoder.0", "dec2": "decoder.2",
                 "to_output": "to_output"}

    def __init__(self, feature_dim, latent_dim, num_codes=1024, hidden_dim=128,
                 use_kernel=True):
        super().__init__()
        self.feature_dim = feature_dim
        self.latent_dim = latent_dim
        self.encoder = nn.Sequential(
            nn.Linear(feature_dim, 64), nn.GELU(),
            nn.Linear(64, hidden_dim), nn.GELU(),
        )
        self.to_latent = LipschitzDense(hidden_dim, latent_dim)
        self.quantizer = LFQQuantizer(num_codes, latent_dim, use_kernel=use_kernel)
        self.decoder = nn.Sequential(
            nn.Linear(latent_dim, 64), nn.GELU(),
            nn.Linear(64, hidden_dim), nn.GELU(),
        )
        self.to_output = nn.Linear(hidden_dim, feature_dim)
        for lin in (*self.encoder[::2], *self.decoder[::2], self.to_output):
            nn.init.zeros_(lin.bias)

    def _encode(self, x):
        return self.to_latent(self.encoder(x))

    def _decode(self, z_q):
        return self.to_output(self.decoder(z_q))

    def forward(self, x):
        """Training forward: returns (z_latent, loss)."""
        lead = x.shape[:-1]
        flat = x.reshape(-1, x.shape[-1])
        z_e = self._encode(flat)
        z_q, _ = self.quantizer(z_e)
        x_recon = self._decode(z_q)
        recon_loss = F.mse_loss(x_recon, flat.to(x_recon.dtype))
        commitment = F.mse_loss(z_e, z_q.detach())
        codebook_l = F.mse_loss(z_q, z_e.detach())
        loss = recon_loss + 0.25 * commitment + 0.25 * codebook_l
        return z_q.detach().reshape(*lead, self.latent_dim), loss

    def encode(self, x):
        """Tokenize: x [..., feature_dim] -> (z_e latents, code indices)."""
        lead = x.shape[:-1]
        z_e = self._encode(x.reshape(-1, x.shape[-1]))
        _, idx = self.quantizer(z_e)
        return z_e.reshape(*lead, self.latent_dim), idx.reshape(lead)

    def decode_codes(self, idx):
        """Detokenize: code indices [...] -> reconstructed actions."""
        x = self._decode(self.quantizer.lookup(idx.reshape(-1)))
        return x.reshape(*idx.shape, self.feature_dim)

    def roundtrip(self, x):
        """Tokenize + detokenize, layer by layer."""
        lead = x.shape[:-1]
        z_e = self._encode(x.reshape(-1, x.shape[-1]))
        z_q, idx = self.quantizer(z_e)
        x_recon = self._decode(z_q)
        return x_recon.reshape(*lead, self.feature_dim), idx.reshape(lead)

    def fused_weights(self):
        """The roundtrip kernel's arguments: weights in the [in, out] layout,
        the Lipschitz weight row-normalized and transposed."""
        e1, e2 = self.encoder[0], self.encoder[2]
        d1, d2 = self.decoder[0], self.decoder[2]

        def t(lin):
            return (lin.weight.t().contiguous(), lin.bias.contiguous())

        return dict(
            enc_w=(t(e1), t(e2)),
            lip_w=(self.to_latent.normalized_weight().t().contiguous(),
                   self.to_latent.b.contiguous()),
            codebook=self.quantizer.codebook.contiguous(),
            dec_w=(t(d1), t(d2), t(self.to_output)),
        )

    @torch.no_grad()
    def roundtrip_fused(self, x):
        """Tokenize + detokenize as ONE kernel (``lipvq_roundtrip_cuda``):
        encoder MLP, Lipschitz latent, nearest-code search, gather and
        decoder MLP per 64-row tile, tanh-GELU. Forward only, so it runs
        without autograd."""
        lead = x.shape[:-1]
        flat = x.reshape(-1, x.shape[-1]).contiguous()
        recon, idx = K.lipvq_roundtrip_cuda(flat, **self.fused_weights())
        return recon.reshape(*lead, self.feature_dim), idx.reshape(lead)


# the reference class name
LLFQVAE_V4 = LipVQVAE
