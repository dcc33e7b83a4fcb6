"""MCR representation pretraining (counterpart of the JAX package's
``algo/mcr_pretrain.py``): a ResNet trunk trained with the time-contrastive
(TCN) InfoNCE loss over frame quintuples, with optional behavior-cloning and
state-alignment losses; ``MCRPretrainer.export_trunk`` writes the trunk that
the ``mcr`` policies warm-start from (``algo/mcr.py``).

Batch layout: ``images`` uint8 [B, 5, H, W, 3] (frame 0 the clip's start, 1
its end, 2-4 the ordered TCN triplet s0, s1, s2), ``actions`` [B, 5, A],
``state_s0`` / ``state_s2`` [B, D] (read where ``align_state_weight`` > 0).

One step encodes all B x 5 frames in one trunk pass (NCHW, channels-last
at the input as in JAX), takes the three losses and one Adam step, the
BatchNorm statistics moving in training mode. The cross-video negatives are
``num_negatives`` permutations of the batch: drawn from the trainer's
generator, or passed in (``neg_perms``), so that a test can replay the JAX
step's ``jax.random.permutation`` draws. The exported trunk is the JAX
package's pickle: the trunk's parameters as nested dicts of float32 numpy
arrays under the Flax names, so that either package's export warm-starts
either package's policy.

Data parallelism (``parallel.shard_state``, ``set_data_parallel``), as
JAX's GSPMD step over a sharded batch: each rank takes its
``parallel.shard_batch`` rows; BatchNorm normalizes by the global batch;
the negatives' permutations are drawn over the global batch from the
generator every rank holds in the same state (a caller's ``neg_perms`` are
the global ones), and each rank reads its rows' negatives from the
all-gathered s0 and s2 embeddings through ``AxisComm.gather``, whose
backward hands each rank the cotangent of its rows summed over the ranks;
the rank's loss is the mean over its rows, and Adam steps on the gradient
averaged over the ranks (a gradient that came back through the gather is
counted once, on the rank whose rows it belongs to). The metrics are the
global batch's.
"""

import pickle

import numpy as np
import torch
import torch.nn as nn

from robot_manipulation_vq_vae_tpu_torch import resolve_device
from robot_manipulation_vq_vae_tpu_torch.models.base_nets import (
    ResNet18Conv,
    ResNet34Conv,
    ResNet50Conv,
)
from robot_manipulation_vq_vae_tpu_torch.models.pretrained_nets import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    resize_bilinear,
)
from robot_manipulation_vq_vae_tpu_torch.utils import tensor_parallel as TP
from robot_manipulation_vq_vae_tpu_torch.utils.jax_weights import jax_tree, jax_variables

EPS = 1e-8

_TRUNKS = {18: ResNet18Conv, 34: ResNet34Conv, 50: ResNet50Conv}
_OUTDIMS = {18: 512, 34: 512, 50: 2048}
# Flax's LayerNorm epsilon
_LN_EPS = 1e-6


# the float32 constants of the JAX package's compiled preprocessing: XLA
# turns each division by a constant into a product with its float32
# reciprocal
_INV_255 = float(np.float32(1.0) / np.float32(255.0))
_MEAN = np.asarray(IMAGENET_MEAN, np.float32)
_INV_STD = np.float32(1.0) / np.asarray(IMAGENET_STD, np.float32)


def _constants(x):
    return (torch.tensor(_MEAN, dtype=torch.float64, device=x.device),
            torch.tensor(_INV_STD, dtype=torch.float64, device=x.device))


def _normalize_frames(x):
    """uint8 @x -> float32 (x / 255 - mean) / std, rounded as the JAX
    package's compiled step rounds it: x times the float32 1/255 less the
    mean in one fused multiply-add, then the product with the float32
    1 / std. float64 holds the multiply-add exactly (8 x 24 bits), so each
    step is rounded to float32 once. (Eager JAX and plain torch divide, and
    land 1 ulp away on most pixels: a few Adam steps of a small trunk
    amplify that to percents.)"""
    mean, inv_std = _constants(x)
    y = (torch.as_tensor(x).double() * _INV_255 - mean).float()
    return (y.double() * inv_std).float()


def mcr_preprocess(x):
    """uint8 [..., H, W, 3] -> ImageNet-normalized float32 [..., 224, 224, 3]
    (JAX ``mcr_preprocess``): / 255; where the frame is not 224 x 224, its
    shorter side resized to 256 bilinearly (half-pixel centres, antialiased
    when shrinking, as ``jax.image.resize``) and the centre 224 x 224 cut
    out; then the ImageNet mean and deviation (see ``_normalize_frames``;
    after a resize the product by 1/255, the difference and the product by
    1 / std are each rounded)."""
    x = torch.as_tensor(x)
    h, w = x.shape[-3], x.shape[-2]
    if (h, w) == (224, 224):
        return _normalize_frames(x)
    nh, nw = (256, int(256 * w / h)) if h <= w else (int(256 * h / w), 256)
    lead = x.shape[:-3]
    nchw = (x.float() * _INV_255).reshape(-1, h, w, x.shape[-1]).permute(0, 3, 1, 2)
    x = resize_bilinear(nchw, nh, nw).permute(0, 2, 3, 1).reshape(*lead, nh, nw, -1)
    top, left = int(round((nh - 224) / 2.0)), int(round((nw - 224) / 2.0))
    x = x[..., top:top + 224, left:left + 224, :]
    mean, inv_std = _constants(x)
    return ((x - mean.float()) * inv_std.float())


class MCRRepresentation(nn.Module):
    """The trunk (ResNet-@size, global average pool) with the optional
    state projector (``align_state_weight`` > 0; its input @state_dim, by
    default the reference's 14 x ``state_window``, + 7 x (``state_window``
    - 1) with ``use_action``) and BC heads (``bc_weight`` > 0) (JAX
    ``MCRRepresentation``). ``forward(batch, neg_perms)`` returns (the full
    loss, {metric: 0-d tensor})."""

    # the data-parallel axis (``parallel.AxisComm``), set by
    # ``MCRPretrainer.set_data_parallel``: the batch holds this rank's rows
    # of the global batch that @neg_perms permute
    dp = None

    def __init__(self, size=34, hidden_dim=1024, l2dist=True, tcn_weight=1.0,
                 align_state_weight=0.0, bc_weight=0.0, state_window=3, use_action=False,
                 action_dim=7, num_negatives=3, bc_feature_dim=50, bc_hidden_dim=512,
                 resize_to_224=True, state_dim=None):
        super().__init__()
        self.size, self.l2dist = size, l2dist
        self.tcn_weight, self.align_state_weight = tcn_weight, align_state_weight
        self.bc_weight, self.num_negatives = bc_weight, num_negatives
        self.resize_to_224 = resize_to_224
        self.outdim = _OUTDIMS[size]
        self.trunk = _TRUNKS[size]()
        names = {"trunk": "trunk"}
        if align_state_weight > 0.0:
            if state_dim is None:
                state_dim = 14 * state_window + (7 * (state_window - 1) if use_action else 0)
            self.state_encoder = nn.Sequential(nn.Linear(state_dim, hidden_dim), nn.ReLU(),
                                               nn.Linear(hidden_dim, self.outdim))
            names["state_encoder"] = {"layers_0": "state_encoder.0",
                                      "layers_2": "state_encoder.2"}
        if bc_weight > 0.0:
            self.bc_trunk_dense = nn.Linear(self.outdim, bc_feature_dim)
            self.bc_trunk_norm = nn.LayerNorm(bc_feature_dim, eps=_LN_EPS)
            self.bc_policy = nn.Sequential(
                nn.Linear(bc_feature_dim, bc_hidden_dim), nn.ReLU(),
                nn.Linear(bc_hidden_dim, bc_hidden_dim), nn.ReLU(),
                nn.Linear(bc_hidden_dim, action_dim))
            names.update(bc_trunk_dense="bc_trunk_dense", bc_trunk_norm="bc_trunk_norm",
                         bc_policy={f"layers_{i}": f"bc_policy.{i}" for i in (0, 2, 4)})
        self.JAX_NAMES = names

    def _dtype(self):
        return next(self.parameters()).dtype

    def encode(self, images):
        """uint8 [N, H, W, 3] -> pooled features [N, outdim]. The input is
        prepared in float32, as JAX prepares it, then cast to the trunk's
        type."""
        if self.resize_to_224:
            x = mcr_preprocess(images)
        else:
            x = _normalize_frames(images)
        x = x.to(self._dtype()).permute(0, 3, 1, 2).contiguous()
        return self.trunk(x).mean(dim=(-2, -1))

    def bc_predict(self, features):
        return self.bc_policy(torch.tanh(self.bc_trunk_norm(self.bc_trunk_dense(features))))

    def sim(self, a, b):
        """-||a - b|| (0 with a zero gradient where a = b, as torch's norm
        at 0), or the cosine similarity (norms floored at EPS)."""
        if self.l2dist:
            d2 = ((a - b) ** 2).sum(-1)
            zero = d2 == 0.0
            return -torch.where(zero, torch.zeros_like(d2),
                                torch.sqrt(torch.where(zero, torch.ones_like(d2), d2)))
        an = a / a.norm(dim=-1, keepdim=True).clamp_min(EPS)
        bn = b / b.norm(dim=-1, keepdim=True).clamp_min(EPS)
        return (an * bn).sum(-1)

    def forward(self, batch, neg_perms):
        """@neg_perms: [num_negatives, B] permutations of the batch rows."""
        images = batch["images"]
        b, s = images.shape[:2]
        alles = self.encode(images.reshape(b * s, *images.shape[2:]))
        alle = alles.reshape(b, s, -1)
        es0, es1, es2 = alle[:, 2], alle[:, 3], alle[:, 4]
        metrics, full_loss = {}, 0.0

        if self.tcn_weight > 0.0:
            sim_0_2, sim_1_2, sim_0_1 = self.sim(es2, es0), self.sim(es2, es1), self.sim(es1, es0)
            all0, all2, perms = es0, es2, neg_perms
            if self.dp is not None:
                # this rank's rows of the global permutations, read from
                # every rank's embeddings
                all0, all2 = self.dp.gather(es0), self.dp.gather(es2)
                perms = neg_perms[:, self.dp.rank * b:(self.dp.rank + 1) * b]
            neg0 = torch.stack([self.sim(es0, all0[p]) for p in perms], dim=-1)
            neg2 = torch.stack([self.sim(es2, all2[p]) for p in perms], dim=-1)
            smooth1 = -torch.log(EPS + torch.exp(sim_1_2) / (
                EPS + torch.exp(sim_0_2) + torch.exp(sim_1_2) + torch.exp(neg2).sum(-1)))
            smooth2 = -torch.log(EPS + torch.exp(sim_0_1) / (
                EPS + torch.exp(sim_0_1) + torch.exp(sim_0_2) + torch.exp(neg0).sum(-1)))
            tcn_loss = ((smooth1 + smooth2) / 2.0).mean()
            metrics["tcnloss"] = tcn_loss
            metrics["aligned"] = ((sim_0_2 < sim_1_2) & (sim_0_1 > sim_0_2)).float().mean()
            full_loss = full_loss + self.tcn_weight * tcn_loss

        if self.bc_weight > 0.0:
            actions = batch["actions"].reshape(b * s, -1).to(alles.dtype)
            bc_loss = ((self.bc_predict(alles) - actions) ** 2).mean()
            metrics["bc_loss"] = bc_loss
            full_loss = full_loss + self.bc_weight * bc_loss

        if self.align_state_weight > 0.0:
            s0 = self.state_encoder(batch["state_s0"].to(alles.dtype))
            s2 = self.state_encoder(batch["state_s2"].to(alles.dtype))
            sim_0_0s, sim_2_2s = self.sim(es0, s0), self.sim(es2, s2)
            sim_0_2s, sim_2_0s = self.sim(es0, s2), self.sim(es2, s0)
            s0loss = -torch.log(EPS + torch.exp(sim_0_0s) / (
                EPS + torch.exp(sim_0_0s) + torch.exp(sim_0_2s)))
            s2loss = -torch.log(EPS + torch.exp(sim_2_2s) / (
                EPS + torch.exp(sim_2_2s) + torch.exp(sim_2_0s)))
            align_loss = ((s0loss + s2loss) / 2.0).mean()
            metrics["state_align_loss"] = align_loss
            metrics["stateimg_aligned"] = ((sim_0_2s < sim_0_0s)
                                           & (sim_2_0s < sim_2_2s)).float().mean()
            full_loss = full_loss + self.align_state_weight * align_loss

        metrics["full_loss"] = full_loss
        return full_loss, metrics


class MCRPretrainer:
    """The pretraining loop (JAX ``MCRPretrainer``): Adam at @lr over the
    model's parameters on @device (``cuda`` unless given); the negatives'
    permutations from a generator seeded with @seed. The model's weights
    are the caller's (the script seeds their construction)."""

    dp = None
    # the tensor-parallel axis (``parallel.shard_state``): the model holds
    # no split weight, so it is replicated over it
    mp = None

    def __init__(self, model, lr=1e-4, seed=1, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=lr)
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self.step = 0

    def set_data_parallel(self, comm):
        """Run the data-parallel step over @comm (``parallel.shard_state``;
        see the module docstring)."""
        self.dp = comm
        for m in self.model.modules():
            if hasattr(type(m), "dp"):
                m.dp = comm

    def _batch(self, batch):
        if self.dp is not None and not (getattr(batch, "layout", None) == "rows"
                                        and batch.dp == self.dp.size):
            raise ValueError("MCRPretrainer under data parallelism takes this rank's "
                             "shard_batch(mesh, batch)")
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                for k, v in batch.items()}

    def _neg_perms(self, b):
        return torch.stack([torch.randperm(b, generator=self.generator, device=self.device)
                            for _ in range(self.model.num_negatives)])

    def update(self, batch, eval=False, neg_perms=None):
        """One training step (with @eval: the losses in inference mode, no
        update, the step counter unchanged); @neg_perms [num_negatives, B]
        pins the negatives (the global batch's B under data parallelism).
        Returns {metric: float}."""
        batch = self._batch(batch)
        n = 1 if self.dp is None else self.dp.size
        perms = (self._neg_perms(batch["images"].shape[0] * n) if neg_perms is None
                 else torch.as_tensor(neg_perms, device=self.device))
        if eval:
            self.model.eval()
            with torch.no_grad():
                _, metrics = self.model(batch, perms)
        else:
            self.model.train()
            loss, metrics = self.model(batch, perms)
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            grads = [p.grad for p in self.model.parameters() if p.grad is not None]
            if self.dp is not None:
                self.dp.mean_(grads)
            if self.mp is not None:   # replicated over mp (see Algo._sync_grads)
                TP.sync_replicated_(grads, self.mp)
            self.optimizer.step()
            self.step += 1
        values = torch.stack([v.detach().to(torch.float64) for v in metrics.values()])
        if self.dp is not None:
            self.dp.mean_([values])
        return {k: float(v) for k, v in zip(metrics, values)}

    def save_snapshot(self, path):
        """The step, the model's state, the optimizer's and the generator's,
        in one file (``load_snapshot`` reads it)."""
        torch.save({"global_step": self.step, "model": self.model.state_dict(),
                    "optimizer": self.optimizer.state_dict(),
                    "generator": self.generator.get_state()}, path)

    def load_snapshot(self, path):
        tree = torch.load(path, map_location="cpu", weights_only=True)
        self.model.load_state_dict(tree["model"])
        self.optimizer.load_state_dict(tree["optimizer"])
        self.generator.set_state(tree["generator"])
        self.step = int(tree.get("global_step", 0))

    def export_trunk(self, path):
        """Write the trunk's parameters as the JAX package's pickle (see the
        module docstring)."""
        tree = jax_tree({k: v.astype(np.float32)
                         for k, v in jax_variables(self.model.trunk).items()})
        with open(path, "wb") as f:
            pickle.dump(tree, f)


def synthetic_batches(batch_size=4, image_size=64, action_dim=7, state_dim=42,
                      num_batches=None, seed=0):
    """Synthetic MCR batches (numpy, the JAX package's draws): for tests and
    dry runs."""
    rng = np.random.RandomState(seed)
    n = 0
    while num_batches is None or n < num_batches:
        yield {
            "images": rng.randint(
                0, 255, (batch_size, 5, image_size, image_size, 3)).astype(np.uint8),
            "actions": rng.uniform(-1, 1, (batch_size, 5, action_dim)).astype(np.float32),
            "state_s0": rng.randn(batch_size, state_dim).astype(np.float32),
            "state_s2": rng.randn(batch_size, state_dim).astype(np.float32),
        }
        n += 1
