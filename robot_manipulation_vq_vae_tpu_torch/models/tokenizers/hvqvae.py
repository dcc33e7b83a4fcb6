"""Hierarchical VQ-VAE action-sequence tokenizer with MSTCN encoder and
decoder (counterpart of the JAX package's ``models/tokenizers/hvqvae.py``
:51-436):

  actions [B, T, A] --MSTCN dilated-conv encoder--> embeddings [B, T, D]
    --cosine nearest in codebook Z (straight-through)--> quantized_z
    --cosine nearest in codebook Q (straight-through)--> quantized_q
    --MSTCN decoder--> reconstructed actions

The JAX ``vq`` collection (codebooks, EMA counts and sums, ``initialized``)
is a set of buffers here. A training forward (the module in train mode)
initializes the codebooks once by k-means on the first batch, quantizes, and
then, under ``no_grad``, takes one EMA step of the statistics and replaces
dead codes by batch samples, in the JAX order (``:306-370``). Whether the
codebooks are initialized is mirrored on the host, so that no step reads the
flag back from the device; loading a state dict sets the mirror.

Parameters keep the reference torch layout and names that the JAX package's
``utils/ckpt_conversion.py::convert_hvqvae`` reads:
``encoder.input_projection``, ``encoder.stages.{s}.layers.{i}.conv`` (Conv1d
[O, I, k]), ``encoder.ln``, ``decoder.output_projection``, and the buffers
``codebook_z``, ..., ``codebooks_initialized``. The convolutions run on
[B, C, T]; the public functions take and give [B, T, C] as in JAX.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from robot_manipulation_vq_vae_tpu_torch.models.transformers import LN_EPS
from robot_manipulation_vq_vae_tpu_torch.ops import quantize as Q


def _linear(cin, cout):
    lin = nn.Linear(cin, cout)
    nn.init.zeros_(lin.bias)
    return lin


class DilatedTemporalConvLayer(nn.Module):
    """Dilated 1-D conv ('SAME' padding) + ReLU + dropout + residual, on
    [B, C, T]; a 1x1 conv maps the residual when the widths differ."""

    def __init__(self, in_features, features, kernel_size=3, dilation=1,
                 dropout=0.0):
        super().__init__()
        if kernel_size % 2 == 0:
            raise NotImplementedError("only odd kernel sizes are ported")
        self.conv = nn.Conv1d(in_features, features, kernel_size, dilation=dilation,
                              padding=(kernel_size - 1) * dilation // 2)
        nn.init.zeros_(self.conv.bias)
        self.dropout = nn.Dropout(dropout)
        self.residual = None
        if in_features != features:
            self.residual = nn.Conv1d(in_features, features, 1)

    def jax_names(self):
        names = {"conv": "conv"}
        if self.residual is not None:
            names["residual"] = "residual"
        return names

    def forward(self, x):
        h = self.dropout(F.relu(self.conv(x)))
        return h + (x if self.residual is None else self.residual(x))


class MSTCNStage(nn.Module):
    """Stack of dilated conv layers, dilation 1, 2, 4, ..., 2^(L-1)."""

    def __init__(self, num_layers, features, kernel_size=3, dropout=0.0):
        super().__init__()
        self.layers = nn.ModuleList(
            DilatedTemporalConvLayer(features, features, kernel_size, 2 ** i, dropout)
            for i in range(num_layers)
        )

    def jax_names(self):
        return {f"layer{i}": f"layers.{i}" for i in range(len(self.layers))}

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


class ActionEncoder(nn.Module):
    """Linear projection -> MSTCN stages -> LayerNorm: [B, T, A] -> [B, T, D]."""

    def __init__(self, action_dim, embed_dim, num_stages=2, num_layers_per_stage=10,
                 dropout=0.1):
        super().__init__()
        self.input_projection = _linear(action_dim, embed_dim)
        self.stages = nn.ModuleList(
            MSTCNStage(num_layers_per_stage, embed_dim, dropout=dropout)
            for _ in range(num_stages)
        )
        self.ln = nn.LayerNorm(embed_dim, eps=LN_EPS)

    def jax_names(self):
        names = {f"stage{s}": f"stages.{s}" for s in range(len(self.stages))}
        names.update(input_projection="input_projection", ln="ln")
        return names

    def forward(self, actions):
        x = self.input_projection(actions).transpose(1, 2)
        for stage in self.stages:
            x = stage(x)
        return self.ln(x.transpose(1, 2))


class ActionDecoder(nn.Module):
    """MSTCN stages -> linear output projection: [B, T, D] -> [B, T, A]."""

    def __init__(self, action_dim, embed_dim, num_stages=2, num_layers_per_stage=10,
                 dropout=0.1):
        super().__init__()
        self.stages = nn.ModuleList(
            MSTCNStage(num_layers_per_stage, embed_dim, dropout=dropout)
            for _ in range(num_stages)
        )
        self.output_projection = _linear(embed_dim, action_dim)

    def jax_names(self):
        names = {f"stage{s}": f"stages.{s}" for s in range(len(self.stages))}
        names["output_projection"] = "output_projection"
        return names

    def forward(self, embeddings):
        x = embeddings.transpose(1, 2)
        for stage in self.stages:
            x = stage(x)
        return self.output_projection(x.transpose(1, 2))


# the ``vq`` collection: JAX name -> buffer name
_VQ_BUFFERS = {
    "codebook_z": "codebook_z", "codebook_q": "codebook_q",
    "cluster_size_z": "cluster_size_z", "embed_avg_z": "embed_avg_z",
    "cluster_size_q": "cluster_size_q", "embed_avg_q": "embed_avg_q",
    "initialized": "codebooks_initialized",
}


class HierarchicalVQVAE(nn.Module):
    """Two-level EMA-codebook VQ-VAE over action sequences. ``forward``
    returns the reference's output dict; in train mode it also updates the
    codebook buffers, drawing from @generator (the k-means seeding and the
    dead-code samples). The arguments are the JAX module's fields;
    ``commitment_cost`` and ``beta`` are unused there too (the loss takes
    its own weights)."""

    JAX_NAMES = {"encoder": "encoder", "decoder": "decoder"}
    JAX_BUFFERS = {"vq": _VQ_BUFFERS}

    def __init__(self, action_dim, embed_dim=512, num_subclusters=128,
                 num_clusters=64, commitment_cost=1.0, ema_decay=0.99,
                 num_stages=2, beta=0.8, num_layers_per_stage=10, dropout=0.1,
                 eps=1e-5, replace_threshold_z=1.0, replace_threshold_q=1.0,
                 kmeans_init=True, use_cosine=True, normalize_after_ema=True,
                 kmeans_iters=25):
        super().__init__()
        self.action_dim = action_dim
        self.embed_dim = embed_dim
        self.num_subclusters = num_subclusters
        self.num_clusters = num_clusters
        self.ema_decay = ema_decay
        self.eps = eps
        self.replace_threshold_z = replace_threshold_z
        self.replace_threshold_q = replace_threshold_q
        self.kmeans_init = kmeans_init
        self.use_cosine = use_cosine
        self.normalize_after_ema = normalize_after_ema
        self.kmeans_iters = kmeans_iters
        self.encoder = ActionEncoder(action_dim, embed_dim, num_stages,
                                     num_layers_per_stage, dropout)
        self.decoder = ActionDecoder(action_dim, embed_dim, num_stages,
                                     num_layers_per_stage, dropout)

        def codebook(k):
            cb = torch.empty(k, embed_dim).uniform_(-1.0 / k, 1.0 / k)
            return Q.l2_normalize(cb) if use_cosine else cb

        cz, cq = codebook(num_subclusters), codebook(num_clusters)
        self.register_buffer("codebook_z", cz)
        self.register_buffer("codebook_q", cq)
        self.register_buffer("cluster_size_z", torch.zeros(num_subclusters))
        self.register_buffer("embed_avg_z", cz.clone())
        self.register_buffer("cluster_size_q", torch.zeros(num_clusters))
        self.register_buffer("embed_avg_q", cq.clone())
        self.register_buffer("codebooks_initialized", torch.zeros((), dtype=torch.bool))
        self._initialized = False   # host mirror of codebooks_initialized

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)
        key = prefix + "codebooks_initialized"
        if key in state_dict:
            self._initialized = bool(state_dict[key])

    # ------------------------------------------------------------ quantizers
    def _quantize(self, x, codebook, use_ste=True):
        """Nearest codes of x [B, T, D] (gathered from the raw codebook), the
        straight-through value, the indices [B, T] and the distances."""
        b, t, d = x.shape
        flat = x.reshape(-1, d)
        if self.use_cosine:
            idx, sims = Q.cosine_nearest(flat, codebook)
        else:
            sims = -Q.l2_distance_sq(flat, codebook).clamp_min(0.0).sqrt()
            idx = sims.argmax(-1)
        quantized = codebook[idx].reshape(b, t, d)
        if use_ste:
            base = Q.l2_normalize(x) if self.use_cosine else x
            quantized = Q.straight_through(base, quantized)
        return quantized, idx.reshape(b, t), (1.0 - sims).reshape(b, t, -1)

    # ------------------------------------------------------------ k-means init
    @torch.no_grad()
    def _maybe_kmeans_init(self, embeddings, generator):
        """The first training batch seeds both codebooks (k-means, or
        Gaussian draws without ``kmeans_init``) and the EMA statistics with
        that batch's assignment counts and sums of the raw embeddings."""
        if self._initialized:
            return
        flat = embeddings.detach().reshape(-1, embeddings.shape[-1])
        kz, kq = self.num_subclusters, self.num_clusters
        if self.kmeans_init:
            cz, _ = Q.kmeans(flat, kz, self.kmeans_iters, generator)
            cq, _ = Q.kmeans(flat, kq, self.kmeans_iters, generator)
        else:
            cz, cq = (torch.randn(k, flat.shape[1], generator=generator,
                                  device=flat.device, dtype=flat.dtype)
                      for k in (kz, kq))
        if self.use_cosine:
            cz, cq = Q.l2_normalize(cz), Q.l2_normalize(cq)
            flat_n = Q.l2_normalize(flat)
            az, aq = (flat_n @ cz.t()).argmax(-1), (flat_n @ cq.t()).argmax(-1)
        else:
            az = Q.l2_distance_sq(flat, cz).argmin(-1)
            aq = Q.l2_distance_sq(flat, cq).argmin(-1)
        nz, sz = Q.assignment_stats(flat, az, kz)
        nq, sq = Q.assignment_stats(flat, aq, kq)
        for name, value in (("codebook_z", cz), ("codebook_q", cq),
                            ("cluster_size_z", nz), ("embed_avg_z", sz),
                            ("cluster_size_q", nq), ("embed_avg_q", sq)):
            getattr(self, name).copy_(value)
        self.codebooks_initialized.fill_(True)
        self._initialized = True

    @torch.no_grad()
    def _update_codebooks(self, embeddings, quantized_z, z_idx, q_idx, generator):
        """One EMA step (Z on the raw embeddings, Q on quantized_z), then
        dead-code replacement from the batch."""
        d = embeddings.shape[-1]
        emb_flat = embeddings.detach().reshape(-1, d)
        sub_flat = quantized_z.detach().reshape(-1, d)
        normalize = self.normalize_after_ema and self.use_cosine
        nz, sz, cz = Q.ema_update(emb_flat, z_idx.reshape(-1), self.cluster_size_z,
                                  self.embed_avg_z, self.ema_decay, self.eps, normalize)
        nq, sq, cq = Q.ema_update(sub_flat, q_idx.reshape(-1), self.cluster_size_q,
                                  self.embed_avg_q, self.ema_decay, self.eps, normalize)
        cz, sz, nz = Q.replace_dead_codes(cz, sz, nz, emb_flat, self.replace_threshold_z,
                                          self.use_cosine, generator)
        cq, sq, nq = Q.replace_dead_codes(cq, sq, nq, sub_flat, self.replace_threshold_q,
                                          self.use_cosine, generator)
        for name, value in (("cluster_size_z", nz), ("embed_avg_z", sz),
                            ("codebook_z", cz), ("cluster_size_q", nq),
                            ("embed_avg_q", sq), ("codebook_q", cq)):
            getattr(self, name).copy_(value)

    # ------------------------------------------------------------ forward
    def forward(self, actions, generator=None):
        """actions [B, T, A] -> {embeddings, quantized_z, quantized_q,
        reconstructed_actions, z_indices, q_indices, z_distances,
        q_distances}."""
        embeddings = self.encoder(actions)
        if self.training:
            self._maybe_kmeans_init(embeddings, generator)
        quantized_z, z_idx, z_dists = self._quantize(embeddings, self.codebook_z)
        quantized_q, q_idx, q_dists = self._quantize(quantized_z, self.codebook_q)
        reconstructed = self.decoder(quantized_q)
        if self.training:
            self._update_codebooks(embeddings, quantized_z, z_idx, q_idx, generator)
        return {
            "embeddings": embeddings,
            "quantized_z": quantized_z,
            "quantized_q": quantized_q,
            "reconstructed_actions": reconstructed,
            "z_indices": z_idx,
            "q_indices": q_idx,
            "z_distances": z_dists,
            "q_distances": q_dists,
        }

    # ------------------------------------------------------------ tokenizer API
    def encode_indices(self, actions):
        """Tokenize: actions [B, T, A] -> (z_indices, q_indices), each [B, T]."""
        embeddings = self.encoder(actions)
        _, z_idx, _ = self._quantize(embeddings, self.codebook_z, use_ste=False)
        qz = self.codebook_z[z_idx.reshape(-1)].reshape(embeddings.shape)
        _, q_idx, _ = self._quantize(qz, self.codebook_q, use_ste=False)
        return z_idx, q_idx

    def decode_q_indices(self, q_idx):
        """Detokenize: cluster indices [B, T] -> reconstructed actions."""
        emb = self.codebook_q[q_idx.reshape(-1)]
        return self.decoder(emb.reshape(*q_idx.shape, self.embed_dim))


def compute_vqvae_loss(outputs, true_actions, commitment_cost=1.0, lambda_rec=1.0,
                       use_cosine=True):
    """Reconstruction MSE + commitment terms; the commitment compares
    normalized pairs under cosine quantization, the quantized side detached."""
    l_rec = ((outputs["reconstructed_actions"] - true_actions) ** 2).mean()

    def commit(a, b):
        if use_cosine:
            return ((Q.l2_normalize(a) - Q.l2_normalize(b.detach())) ** 2).mean()
        return ((a - b.detach()) ** 2).mean()

    l_cz = commit(outputs["embeddings"], outputs["quantized_z"])
    l_cq = commit(outputs["quantized_z"], outputs["quantized_q"])
    return {
        "vqvae_loss": commitment_cost * (l_cz + l_cq) + lambda_rec * l_rec,
        "L_rec": l_rec,
        "L_commit_z": l_cz,
        "L_commit_q": l_cq,
    }


def get_codebook_usage(vqvae, replace_threshold_z=1.0, replace_threshold_q=1.0):
    """Codebook utilization telemetry from a ``HierarchicalVQVAE``'s EMA
    counts. Reads the counts back to the host."""
    nz, nq = vqvae.cluster_size_z, vqvae.cluster_size_q
    z_used, q_used = int((nz > 0).sum()), int((nq > 0).sum())
    z_total, q_total = int(nz.shape[0]), int(nq.shape[0])
    return {
        "z_used": z_used,
        "z_total": z_total,
        "z_usage_pct": 100.0 * z_used / max(1, z_total),
        "z_utilization": z_used / max(1, z_total),
        "q_utilization": q_used / max(1, q_total),
        "q_used": q_used,
        "q_total": q_total,
        "q_usage_pct": 100.0 * q_used / max(1, q_total),
        "z_dead": int((nz < replace_threshold_z).sum()),
        "q_dead": int((nq < replace_threshold_q).sum()),
    }
