"""Classic VQ-VAE tokenizer backbones (counterpart of the JAX package's
``models/tokenizers/vqvae.py``), the earlier tokenizer iterations the paper
kept beside LipVQ:

  VQVAE      - ReLU MLP encoder and decoder (ReLU on the decoder's last
               layer too, as the reference has it), L2 nearest code, the
               straight-through estimator, commitment 0.25; the codebook is
               a parameter drawn U(-1/K, 1/K);
  LFQVAE     - spectral-norm encoder whose "quantizer" is an L2
               normalization onto the unit sphere; reconstruction loss only;
  LSTMVQVAE  - three stacked LSTM layers in the encoder and three in the
               decoder, with soft quantization: a softmax over minus the
               squared distances mixes the codes, so no argmin is taken.

``VQVAE``'s nearest-code search is kernel 1 on a card
(``ops/lipvq_kernel.py::l2_nearest``: the CUDA assign kernel, differentiated
by ``L2Nearest``, whose backward sums the cotangent of z_q into the codebook
rows by index, the gradient that JAX's ``jnp.take`` gives the embedding
loss); ``use_kernel=False`` selects the plain version. Parameter names are
the JAX module's (``enc1`` ... ``dec3``, ``codebook``, ``in_proj``,
``out_proj``) in the torch layout, so that
``utils/jax_weights.py::load_jax_variables`` carries JAX variables across.
"""

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from robot_manipulation_vq_vae_tpu_torch.models.tokenizers.default_encoder import SNDense
from robot_manipulation_vq_vae_tpu_torch.ops import lipvq_kernel as K
from robot_manipulation_vq_vae_tpu_torch.ops import quantize as Q


def _linear(cin, cout):
    lin = nn.Linear(cin, cout)
    nn.init.zeros_(lin.bias)
    return lin


def _uniform_codebook(num, dim):
    return nn.Parameter(torch.empty(num, dim).uniform_(-1.0 / num, 1.0 / num))


def _mse(a, b):
    return ((a - b) ** 2).mean()


class VQVAE(nn.Module):
    """Plain VQ-VAE: forward(x [N, feature_dim]) -> (z_latent, loss)."""

    JAX_NAMES = {n: n for n in ("enc1", "enc2", "enc3", "dec1", "dec2", "dec3")}
    JAX_PARAMS = ("codebook",)

    def __init__(self, feature_dim, latent_dim, num_embeddings=128,
                 commitment_cost=0.25, use_kernel=True):
        super().__init__()
        self.commitment_cost = commitment_cost
        self.use_kernel = use_kernel
        self.enc1, self.enc2 = _linear(feature_dim, 64), _linear(64, 128)
        self.enc3 = _linear(128, latent_dim)
        self.dec1, self.dec2 = _linear(latent_dim, 128), _linear(128, 64)
        self.dec3 = _linear(64, feature_dim)
        self.codebook = _uniform_codebook(num_embeddings, latent_dim)

    def quantize(self, z_e):
        """(straight-through z_q, embedding + commitment loss, idx int32)."""
        idx, z_q = K.l2_nearest(z_e.contiguous(), self.codebook, self.use_kernel)
        commitment = self.commitment_cost * _mse(z_q.detach(), z_e)
        embedding = _mse(z_q, z_e.detach())
        return Q.straight_through(z_e, z_q), embedding + commitment, idx

    def forward(self, x):
        h = F.relu(self.enc2(F.relu(self.enc1(x))))
        z_e = F.relu(self.enc3(h))
        z_q, q_loss, _ = self.quantize(z_e)
        h = F.relu(self.dec2(F.relu(self.dec1(z_q))))
        x_recon = F.relu(self.dec3(h))
        return z_q.detach(), _mse(x_recon, x) + q_loss


class LFQVAE(nn.Module):
    """Spectral-norm encoder + unit-sphere "quantization", reconstruction
    loss only: forward(x) -> (z_latent, loss). The JAX module's
    ``update_stats`` flag is the module's ``training`` here: a forward in
    train mode moves each ``SNDense``'s ``u`` buffer (the JAX ``spectral``
    collection), one in eval mode does not."""

    JAX_NAMES = {n: n for n in ("enc1", "enc2", "enc3", "dec1", "dec2", "dec3")}

    def __init__(self, feature_dim, latent_dim):
        super().__init__()
        self.enc1, self.enc2 = SNDense(feature_dim, 64), SNDense(64, 128)
        self.enc3 = SNDense(128, latent_dim)
        self.dec1, self.dec2 = _linear(latent_dim, 128), _linear(128, 64)
        self.dec3 = _linear(64, feature_dim)

    def forward(self, x):
        h = F.relu(self.enc2(F.relu(self.enc1(x))))
        z_q = Q.l2_normalize(F.relu(self.enc3(h)))
        h = F.relu(self.dec2(F.relu(self.dec1(z_q))))
        x_recon = F.relu(self.dec3(h))
        return z_q.detach(), _mse(x_recon, x)


_GATES = ("i", "f", "g", "o")   # Flax's and torch's gate order


def _lstm_stacked(jax_cell, layer):
    """{torch nn.LSTM tensor: ([JAX paths], stack)} of layer @layer from the
    Flax ``OptimizedLSTMCell`` at @jax_cell: the input kernels ``i*`` and
    the hidden ``h*`` stacked gate by gate and transposed; ``bias_hh`` from
    the ``h*`` biases, the cell's only bias; ``bias_ih`` zeros."""
    ii = [f"{jax_cell}/i{g}/kernel" for g in _GATES]
    hh = [f"{jax_cell}/h{g}/kernel" for g in _GATES]
    hb = [f"{jax_cell}/h{g}/bias" for g in _GATES]
    return {
        f"weight_ih_l{layer}": (ii, lambda a: np.concatenate([k.T for k in a], 0)),
        f"weight_hh_l{layer}": (hh, lambda a: np.concatenate([k.T for k in a], 0)),
        f"bias_hh_l{layer}": (hb, np.concatenate),
        f"bias_ih_l{layer}": (hb, lambda a: np.zeros_like(np.concatenate(a))),
    }


class LSTMVQVAE(nn.Module):
    """LSTM encoder and decoder with soft quantization: forward(x [B, T,
    feature_dim]) -> (z_latent [B*T, latent_dim], loss).

    Flax's ``OptimizedLSTMCell`` has one bias a gate, on its hidden denses;
    ``nn.LSTM`` has two. The port keeps ``nn.LSTM`` (cuDNN on a card) with
    ``bias_ih_l*`` held at zero and ``requires_grad=False``: the JAX bias
    sits in ``bias_hh_l*``, and an optimizer moves only that one, as optax
    moves JAX's. Exact GELU after ``in_proj`` and ``out_proj``."""

    JAX_NAMES = {"in_proj": "in_proj", "out_proj": "out_proj"}
    JAX_PARAMS = ("codebook",)

    def __init__(self, feature_dim, latent_dim, num_embeddings=128,
                 commitment_cost=0.25, num_layers=3):
        super().__init__()
        self.feature_dim = feature_dim
        self.num_layers = num_layers
        self.commitment_cost = commitment_cost
        self.in_proj = _linear(feature_dim, latent_dim)
        self.encoder = nn.LSTM(latent_dim, latent_dim, num_layers, batch_first=True)
        self.out_proj = _linear(latent_dim, feature_dim)
        self.decoder = nn.LSTM(feature_dim, feature_dim, num_layers, batch_first=True)
        for lstm in (self.encoder, self.decoder):
            for k in range(num_layers):
                bias = getattr(lstm, f"bias_ih_l{k}")
                nn.init.zeros_(bias)
                bias.requires_grad_(False)
        self.codebook = _uniform_codebook(num_embeddings, latent_dim)

    def jax_stacked(self):
        out = {}
        for prefix, lstm in (("enc", "encoder"), ("dec", "decoder")):
            for k in range(self.num_layers):
                for name, entry in _lstm_stacked(f"{prefix}{k}/cell", k).items():
                    out[f"{lstm}.{name}"] = entry
        return out

    def soft_quantize(self, z_e):
        """softmax(-d^2) mixture of the codes: (straight-through z_q, loss)."""
        flat = z_e.reshape(-1, z_e.shape[-1])
        q = torch.softmax(-Q.l2_distance_sq(flat, self.codebook), dim=-1)
        z_q = (q @ self.codebook).reshape(z_e.shape)
        commitment = self.commitment_cost * _mse(z_q.detach(), z_e)
        embedding = _mse(z_q, z_e.detach())
        return Q.straight_through(z_e, z_q), embedding + commitment

    def forward(self, x_btd):
        b, t, _ = x_btd.shape
        h, _ = self.encoder(F.gelu(self.in_proj(x_btd)))
        z_q, q_loss = self.soft_quantize(h)
        d, _ = self.decoder(F.gelu(self.out_proj(z_q)))
        recon = d.reshape(b * t, self.feature_dim)
        loss = _mse(recon, x_btd.reshape(b * t, -1)) + q_loss
        return z_q.detach().reshape(b * t, -1), loss
