"""ACT, Action Chunking with Transformers (counterpart of the JAX package's
``algo/act.py``), registered as ``act``: the DETR-VAE over action chunks.

* Style encoder (training only): non-causal self-attention blocks over
  [CLS, projected observation features, projected action chunk] -> (mu,
  logvar) of the latent z, reparametrized with a standard-normal draw.
* Decoder: ``num_queries`` learned queries through pre-LN blocks of self-
  and cross-attention to the memory [projected observation features,
  projected z] -> one action per query. Inference takes z = 0.
* Loss: the L1 of the chunk, its padded steps (``pad_mask`` 0) dropped but
  the mean taken over every element, + ``act.kl_weight`` KL against N(0, I).

Module names follow the JAX package's (``style{i}`` are the GPT's
``SelfAttentionBlock``s; a ``CrossAttentionBlock`` has ``ln1``-``ln3``,
``{self,cross}_{q,k,v,out}``, ``ff1`` and ``ff2``); LayerNorms take Flax's
epsilon, 1e-6. ``get_action`` predicts a chunk when its queue is empty and
pops one action a call; ``reset()`` (a rollout's ``start_episode``)
empties the queue. The seam ``_noise_hook()`` returns a training step's
latent draw [B, latent] (else ``self.generator`` draws it); under data
parallelism the global batch's draw, of which each rank keeps its rows.
``train.mixed_precision`` raises.
"""

import math
from collections import OrderedDict

import torch
import torch.nn as nn

from robot_manipulation_vq_vae_tpu_torch.algo.algo import (
    PolicyAlgo,
    register_algo_factory_func,
)
from robot_manipulation_vq_vae_tpu_torch.models.obs_nets import ObservationGroupEncoder
from robot_manipulation_vq_vae_tpu_torch.models.policy_nets import _groups, _inputs
from robot_manipulation_vq_vae_tpu_torch.models.transformers import (
    LN_EPS,
    SelfAttentionBlock,
)
from robot_manipulation_vq_vae_tpu_torch.utils import loss_utils as LossUtils
from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils as ObsUtils
from robot_manipulation_vq_vae_tpu_torch.utils.draws import global_draw, keep_rows


@register_algo_factory_func("act")
def algo_config_to_class(algo_config):
    return ACT, {}


def _linear(d_in, d_out):
    """A Linear with the GPT's N(0, 0.02) weights and zero bias."""
    lin = nn.Linear(d_in, d_out)
    nn.init.normal_(lin.weight, std=0.02)
    nn.init.zeros_(lin.bias)
    return lin


class CrossAttentionBlock(nn.Module):
    """Pre-LN decoder block: self-attention over the queries, cross-attention
    to the memory, then a ReLU MLP, each residual."""

    def __init__(self, embed_dim, num_heads, dim_feedforward):
        super().__init__()
        self.num_heads = num_heads
        for i in (1, 2, 3):
            setattr(self, f"ln{i}", nn.LayerNorm(embed_dim, eps=LN_EPS))
        for kind in ("self", "cross"):
            for proj in ("q", "k", "v", "out"):
                setattr(self, f"{kind}_{proj}", _linear(embed_dim, embed_dim))
        self.ff1 = _linear(embed_dim, dim_feedforward)
        self.ff2 = _linear(dim_feedforward, embed_dim)

    def jax_names(self):
        return {name: name for name, _ in self.named_children()}

    def _mha(self, q, kv, kind):
        b, tq, d = q.shape
        nh, dh = self.num_heads, d // self.num_heads

        def heads(x, proj):
            return getattr(self, f"{kind}_{proj}")(x).reshape(b, -1, nh, dh).transpose(1, 2)

        att = torch.softmax(heads(q, "q") @ heads(kv, "k").transpose(-1, -2)
                            / math.sqrt(dh), dim=-1)
        y = (att @ heads(kv, "v")).transpose(1, 2).reshape(b, tq, d)
        return getattr(self, f"{kind}_out")(y)

    def forward(self, q, memory):
        qn = self.ln1(q)
        q = q + self._mha(qn, qn, "self")
        q = q + self._mha(self.ln2(q), memory, "cross")
        return q + self.ff2(torch.relu(self.ff1(self.ln3(q))))


class DETRVAE(nn.Module):
    """The CVAE transformer policy over action chunks (see the module
    docstring)."""

    JAX_PARAMS = ("cls_embed", "query_embed")
    # the data-parallel axis (``parallel.AxisComm``): the latent's draw is
    # taken at the global batch's shape and each rank keeps its rows, set
    # by ``parallel.shard_state``
    dp = None

    def __init__(self, obs_shapes, ac_dim, num_queries, hidden_dim=512,
                 dim_feedforward=3200, enc_layers=4, dec_layers=7, nheads=8,
                 latent_dim=32, goal_shapes=None, encoder_kwargs=None):
        super().__init__()
        self.goal_shapes = goal_shapes
        self.latent_dim = latent_dim
        self.obs_encoder = ObservationGroupEncoder(_groups(obs_shapes, goal_shapes),
                                                   encoder_kwargs, feature_activation="relu")
        self.obs_proj = _linear(self.obs_encoder.output_dim, hidden_dim)
        self.action_proj = _linear(ac_dim, hidden_dim)
        self.cls_embed = nn.Parameter(0.02 * torch.randn(1, 1, hidden_dim))
        self.style_blocks = nn.ModuleList([
            SelfAttentionBlock(hidden_dim, nheads, causal=False, attn_dropout=0.0,
                               output_dropout=0.0)
            for _ in range(enc_layers)])
        self.latent_head = _linear(hidden_dim, 2 * latent_dim)
        self.latent_proj = _linear(latent_dim, hidden_dim)
        self.query_embed = nn.Parameter(0.02 * torch.randn(1, num_queries, hidden_dim))
        self.dec_blocks = nn.ModuleList([
            CrossAttentionBlock(hidden_dim, nheads, dim_feedforward)
            for _ in range(dec_layers)])
        self.action_head = _linear(hidden_dim, ac_dim)

    def jax_names(self):
        names = {n: n for n in ("obs_encoder", "obs_proj", "action_proj", "latent_head",
                                "latent_proj", "action_head")}
        names.update({f"style{i}": f"style_blocks.{i}" for i in range(len(self.style_blocks))})
        names.update({f"dec{i}": f"dec_blocks.{i}" for i in range(len(self.dec_blocks))})
        return names

    def obs_features(self, obs_dict, goal_dict=None, generator=None):
        return self.obs_encoder(
            _inputs(obs_dict, goal_dict, self.goal_shapes, over_time=False), generator)

    def encode_style(self, obs_feat, actions):
        """[CLS, observation, action tokens] -> (mu, logvar) [B, latent]."""
        b = actions.shape[0]
        tokens = torch.cat([self.cls_embed.expand(b, -1, -1),
                            self.obs_proj(obs_feat)[:, None],
                            self.action_proj(actions)], dim=1)
        for blk in self.style_blocks:
            tokens = blk(tokens)
        return self.latent_head(tokens[:, 0]).chunk(2, dim=-1)

    def decode(self, obs_feat, z):
        """The action chunk [B, num_queries, A] of the memory [obs, z]."""
        memory = torch.stack([self.obs_proj(obs_feat), self.latent_proj(z)], dim=1)
        q = self.query_embed.expand(obs_feat.shape[0], -1, -1)
        for blk in self.dec_blocks:
            q = blk(q, memory)
        return self.action_head(q)

    def forward_train(self, obs_dict, actions, goal_dict=None, eps=None, generator=None):
        """{"a_hat", "mu", "logvar"}: the chunk decoded from z = mu +
        exp(logvar / 2) @eps (a standard-normal draw [B, latent])."""
        obs_feat = self.obs_features(obs_dict, goal_dict, generator)
        mu, logvar = self.encode_style(obs_feat, actions)
        if eps is None:
            eps = global_draw(lambda s: torch.randn(s, generator=generator, device=mu.device,
                                                    dtype=mu.dtype), mu.shape, self.dp)
        z = mu + torch.exp(0.5 * logvar) * eps
        return {"a_hat": self.decode(obs_feat, z), "mu": mu, "logvar": logvar}

    def forward(self, obs_dict, goal_dict=None):
        """Inference with z = 0: the action chunk [B, num_queries, A]."""
        obs_feat = self.obs_features(obs_dict, goal_dict)
        return self.decode(obs_feat, obs_feat.new_zeros(obs_feat.shape[0], self.latent_dim))


class ACT(PolicyAlgo):
    """See the module docstring."""

    _noise_hook = None

    def _create_networks(self):
        cfg = self.algo_config.act
        self.chunk_size = self.global_config.train.seq_length
        self.nets["policy"] = DETRVAE(
            obs_shapes=self.obs_shapes,
            goal_shapes=self.goal_shapes or None,
            ac_dim=self.ac_dim,
            num_queries=self.chunk_size,
            hidden_dim=cfg.hidden_dim,
            dim_feedforward=cfg.dim_feedforward,
            enc_layers=cfg.enc_layers,
            dec_layers=cfg.dec_layers,
            nheads=cfg.nheads,
            latent_dim=cfg.latent_dim,
            encoder_kwargs=ObsUtils.obs_encoder_kwargs_from_config(self.obs_config.encoder),
        )
        self.kl_weight = float(cfg.kl_weight)
        self._ac_queue = []

    def process_batch_for_training(self, batch):
        """The observations at t = 0, except ``pad_mask``, which keeps its
        time axis ([B, chunk, 1]; ones where the batch has none), and the
        first ``train.seq_length`` actions."""
        actions = batch["actions"][:, :self.chunk_size]
        obs = {k: v[:, 0] for k, v in batch["obs"].items() if k != "pad_mask"}
        pad = batch["obs"].get("pad_mask")
        obs["pad_mask"] = (torch.ones(actions.shape[:2] + (1,)) if pad is None
                           else torch.as_tensor(pad)[:, :self.chunk_size])
        return {"obs": obs, "goal_obs": batch.get("goal_obs", None), "actions": actions}

    def _losses(self, batch):
        obs = dict(batch["obs"])
        keep = (torch.as_tensor(obs.pop("pad_mask")).to(self.device) != 0).to(self._dtype())
        obs, actions = self._device_batch({"obs": obs, "actions": batch["actions"]})
        eps = (None if self._noise_hook is None
               else keep_rows(self._draw(self._noise_hook()), self.dp))
        out = self.nets["policy"].forward_train(
            obs, actions, goal_dict=self._obs(batch.get("goal_obs") or None), eps=eps,
            generator=self.generator)
        l1 = ((out["a_hat"] - actions).abs() * keep).mean()
        kl = LossUtils.kld_0_1_loss(out["mu"], out["logvar"])
        return OrderedDict(l1_loss=l1, kl_loss=kl, action_loss=l1 + self.kl_weight * kl)

    def _train_step(self, batch):
        return self._policy_step(self._losses(batch))

    def _validate_step(self, batch):
        return self._losses(batch)

    def log_info(self, info):
        losses = info["losses"]
        l1 = float(losses["l1_loss"])
        return OrderedDict(Loss=float(losses["action_loss"]), L1_Loss=l1,
                           Reconstruction_Loss=l1, KL_Loss=float(losses["kl_loss"]))

    def reset(self):
        """A new episode: the next call predicts a fresh chunk."""
        self._ac_queue = []

    @torch.inference_mode()
    def get_action(self, obs_dict, goal_dict=None):
        """The next action [B, A] of the current chunk; a call that finds the
        queue empty predicts a chunk from @obs_dict ([B, ...]). Under data
        parallelism the queue holds this rank's rows, and every rank returns
        the global batch's action."""
        self._check_obs_request(obs_dict, goal_dict)
        if not self._ac_queue:
            chunk = self.nets["policy"](self._obs(obs_dict), goal_dict=self._obs(goal_dict))
            self._ac_queue = list(chunk.unbind(1))
        return self._gather_rows(self._ac_queue.pop(0))
