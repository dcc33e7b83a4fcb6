"""The LFQ EMA / k-means quantizers and the flat hierarchical LFQ VAE
(counterpart of the JAX package's ``models/tokenizers/hq_vae.py``).

The JAX ``vq`` collection is a set of buffers with the same names
(``codebook``, ``ema_cluster_size``, ``ema_codebook``; the k-means variant
adds ``usage_counts``, ``usage_ma``, ``entropy_ma`` and ``initialized``).
They move only in a training forward (the module in train mode), as JAX's
``training and not is_initializing()`` moves them, under ``no_grad``. The
nearest-code search is kernel 1 (``ops/lipvq_kernel.py::l2_nearest_cuda``,
forward only: the codebook is state, not a parameter, so z_q carries no
gradient); ``use_kernel=False`` selects its plain version.

Random draws: JAX takes two ``vq`` keys on every training call of the
k-means variant, the k-means key even after the first call. The port draws
from an explicit ``torch.Generator`` where a draw is needed (the k-means
seeding on the first training batch, the dead-code picks on every one), or
takes the draws given in ``draws`` ({"first", "noise"} for
``ops/quantize.py::kmeans``, {"pick"} for ``replace_dead_codes``), which is
how the tests give both sides the same draws.

Whether the k-means codebook is initialized is mirrored on the host, so that
no step reads the ``initialized`` buffer back from the card; loading a state
dict sets the mirror.
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from robot_manipulation_vq_vae_tpu_torch.models.tokenizers.lipvq import LipschitzDense
from robot_manipulation_vq_vae_tpu_torch.ops import lipvq_kernel as K
from robot_manipulation_vq_vae_tpu_torch.ops import quantize as Q


def _kaiming_codebook(num_codes, code_dim):
    bound = math.sqrt(6.0 / code_dim)   # kaiming_uniform, fan_in = code_dim
    return torch.empty(num_codes, code_dim).uniform_(-bound, bound)


class LFQQuantizerEMA(nn.Module):
    """Nearest-code quantizer whose codebook follows the EMA of its
    assignments: forward(z_e [N, D]) -> (z_q, idx int32)."""

    _VQ = ("codebook", "ema_cluster_size", "ema_codebook")
    JAX_BUFFERS = {"vq": {n: n for n in _VQ}}

    def __init__(self, num_codes, code_dim, decay=0.99, epsilon=1e-5,
                 use_kernel=True):
        super().__init__()
        self.num_codes = num_codes
        self.decay = decay
        self.epsilon = epsilon
        self.use_kernel = use_kernel
        cb = _kaiming_codebook(num_codes, code_dim)
        self.register_buffer("codebook", cb)
        self.register_buffer("ema_cluster_size", torch.zeros(num_codes))
        self.register_buffer("ema_codebook", cb.clone())

    def nearest(self, z_e):
        """(idx int32, z_q) of @z_e in the codebook, without gradient."""
        z = z_e.detach().contiguous()
        search = K.l2_nearest_cuda if self.use_kernel else K.l2_nearest_plain
        return search(z, self.codebook)

    def _ema(self, flat, idx):
        """The new EMA counts and sums of the assignments @idx of @flat."""
        counts, sums = Q.assignment_stats(flat, idx, self.num_codes)
        d = self.decay
        return (counts, d * self.ema_cluster_size + (1 - d) * counts,
                d * self.ema_codebook + (1 - d) * sums)

    def forward(self, z_e, generator=None, draws=None):
        idx, z_q = self.nearest(z_e)
        if self.training:
            with torch.no_grad():
                _, new_size, new_avg = self._ema(z_e.detach(), idx)
                self.ema_cluster_size.copy_(new_size)
                self.ema_codebook.copy_(new_avg)
                self.codebook.copy_(new_avg / (new_size + self.epsilon)[:, None])
        return z_q, idx


class LFQQuantizerEMA_KMeans(LFQQuantizerEMA):
    """The EMA quantizer with a k-means initialization on the first training
    batch, usage and entropy telemetry, and dead-code replacement by batch
    samples (EMA count below ``dead_threshold``): forward(z_e, generator,
    draws) -> (z_q, idx int32).

    The codebook after the EMA step is ``new_avg / ((size + eps) / (n + K
    eps))``, as the JAX module writes it (``hq_vae.py:133-137``): it divides
    by each code's share of the EMA mass n, where the usual Laplace smoothing
    multiplies that share back by n (ROADMAP.md, Queue 3)."""

    _VQ = LFQQuantizerEMA._VQ + ("usage_counts", "usage_ma", "entropy_ma", "initialized")
    JAX_BUFFERS = {"vq": {n: n for n in _VQ}}

    def __init__(self, num_codes, code_dim, decay=0.99, epsilon=1e-5,
                 dead_threshold=5.0, kmeans_iters=25, use_kernel=True):
        super().__init__(num_codes, code_dim, decay, epsilon, use_kernel)
        self.dead_threshold = dead_threshold
        self.kmeans_iters = kmeans_iters
        self.register_buffer("usage_counts", torch.zeros(num_codes))
        self.register_buffer("usage_ma", torch.zeros(num_codes))
        self.register_buffer("entropy_ma", torch.zeros(()))
        self.register_buffer("initialized", torch.zeros((), dtype=torch.bool))
        self._initialized = False   # host mirror of ``initialized``

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)
        if prefix + "initialized" in state_dict:
            self._initialized = bool(state_dict[prefix + "initialized"])

    @torch.no_grad()
    def _kmeans_init(self, flat, generator, draws):
        centers, _ = Q.kmeans(flat, self.num_codes, self.kmeans_iters, generator,
                              draws.get("first"), draws.get("noise"))
        self.codebook.copy_(centers)
        self.ema_codebook.copy_(centers)
        self.initialized.fill_(True)
        self._initialized = True

    @torch.no_grad()
    def _update(self, flat, idx, generator, draws):
        counts, new_size, new_avg = self._ema(flat, idx)
        norm = (new_size + self.epsilon) / (new_size.sum() + self.num_codes * self.epsilon)
        cb = new_avg / norm[:, None]
        self.usage_counts.add_(counts)
        self.usage_ma.mul_(0.99).add_(0.01 * (counts > 0).to(self.usage_ma.dtype))
        p = counts / (counts.sum() + 1e-8)
        self.entropy_ma.mul_(0.99).add_(0.01 * -(p * torch.log(p + 1e-8)).sum())
        cb, new_avg, new_size = Q.replace_dead_codes(
            cb, new_avg, new_size, flat, self.dead_threshold, normalize=False,
            generator=generator, pick=draws.get("pick"))
        self.ema_cluster_size.copy_(new_size)
        self.ema_codebook.copy_(new_avg)
        self.codebook.copy_(cb)

    def forward(self, z_e, generator=None, draws=None):
        draws = draws or {}
        flat = z_e.detach()
        if self.training and not self._initialized:
            self._kmeans_init(flat, generator, draws)
        idx, z_q = self.nearest(z_e)
        if self.training:
            self._update(flat, idx, generator, draws)
        return z_q, idx


class HierarchicalLFQHVQVAE(nn.Module):
    """Flat hierarchical LFQ VAE: GELU encoder -> Lipschitz latent -> Z-level
    k-means EMA quantizer -> Lipschitz projection of the detached z_q ->
    Q-level k-means EMA quantizer -> GELU decoder. forward(x [N,
    feature_dim], generator, draws) -> (detached q_q, recon + 0.25 commit);
    @draws is {"z_quantizer": {...}, "q_quantizer": {...}}."""

    JAX_NAMES = {n: n for n in ("enc1", "enc2", "to_z", "z_quantizer", "q_encoder",
                                "q_quantizer", "dec1", "dec2", "to_output")}

    def __init__(self, feature_dim, z_dim, q_dim, num_z_codes=1024, num_q_codes=512,
                 hidden_dim=128, use_kernel=True):
        super().__init__()

        def dense(cin, cout):
            lin = nn.Linear(cin, cout)
            nn.init.zeros_(lin.bias)
            return lin

        self.enc1, self.enc2 = dense(feature_dim, 64), dense(64, hidden_dim)
        self.to_z = LipschitzDense(hidden_dim, z_dim)
        self.z_quantizer = LFQQuantizerEMA_KMeans(num_z_codes, z_dim, dead_threshold=3,
                                                  use_kernel=use_kernel)
        self.q_encoder = LipschitzDense(z_dim, q_dim)
        self.q_quantizer = LFQQuantizerEMA_KMeans(num_q_codes, q_dim, dead_threshold=1,
                                                  use_kernel=use_kernel)
        self.dec1, self.dec2 = dense(q_dim, 64), dense(64, hidden_dim)
        self.to_output = dense(hidden_dim, feature_dim)

    def forward(self, x, generator=None, draws=None):
        draws = draws or {}
        h = F.gelu(self.enc2(F.gelu(self.enc1(x))))
        z_e = self.to_z(h)
        z_q, _ = self.z_quantizer(z_e, generator, draws.get("z_quantizer"))
        q_e = self.q_encoder(z_q.detach())
        q_q, _ = self.q_quantizer(q_e, generator, draws.get("q_quantizer"))
        d = F.gelu(self.dec2(F.gelu(self.dec1(q_q))))
        recon_loss = ((self.to_output(d) - x) ** 2).mean()
        commit = ((z_q.detach() - z_e) ** 2).mean() + ((q_q.detach() - q_e) ** 2).mean()
        return q_q.detach(), recon_loss + 0.25 * commit

    def codebook_usage(self):
        """Codes with EMA mass, from the quantizers' buffers (read back to
        the host)."""
        z_size = self.z_quantizer.ema_cluster_size
        q_size = self.q_quantizer.ema_cluster_size
        return {
            "z_used": int((z_size > 0).sum()),
            "q_used": int((q_size > 0).sum()),
            "z_utilization": float((z_size > 0).float().mean()),
            "q_utilization": float((q_size > 0).float().mean()),
        }
