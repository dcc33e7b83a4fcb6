"""Conservative Q-Learning (counterpart of the JAX package's ``algo/cql.py``),
registered as ``cql``: a tanh-wrapped Gaussian actor (``use_tanh``; without
it the reference's policy loss broadcasts a (B,) log probability against a
(B, 1) Q, so the class refuses it, as the JAX one does), an ensemble of
critics with targets, and the conservative penalty

    W (min_q_weight (mean logsumexp{Q(s, a_rand) - log U, Q(s, a_curr) -
    log pi, Q(s, a_next) - log pi} - mean Q(s, a)) - target_q_gap)

over ``critic.num_random_actions`` uniform, current-policy and
next-policy candidates per row (the latter two drawn at s and s' tiled, all
three scored at s).

One step, in the JAX step's order:

1. the actor: mean(alpha log pi(a~|s) - min_i Q_i(s, a~)) over a
   reparameterized sample (the dataset's log likelihood for the first
   ``actor.bc_start_steps`` steps), one optimizer step; with
   ``actor.target_entropy`` (``"default"``: -A) the entropy weight alpha =
   exp(``log_entropy_weight``) steps its own plain Adam (the actor's
   learning rate) on -log alpha (mean log pi + target entropy);
2. the critics' target, from the actor as stepped: with
   ``critic.num_action_samples`` > 1 the maximum over that many samples at
   s' of each target critic, then the ensemble's minimum; else one sample,
   and without ``deterministic_backup`` minus the stepped alpha x its log
   probability;
3. each critic: TD + W x the penalty, one step each, then its target by
   ``polyak``; with ``critic.target_q_gap`` >= 0, W = exp(``log_cql_weight``)
   (clipped to [0, 1e6]) steps its own plain Adam (the critic's learning
   rate) on -W x the critics' mean penalty, else W = ``critic.cql_weight``.

The actor runs in training mode everywhere in the step, the critics and
targets in inference mode. In inference mode a critic's encoder treats each
row alone, so each critic encodes s once and scores the tiled candidates on
its features tiled (the JAX step encodes s tiled three times). The draws (the
standard normals of ``actor``, ``backup``, ``curr``, ``next`` and the
uniforms in [-1, 1] of ``rand``, [B * N, A], the JAX step's keys) may be
injected through ``_noise_hook``, else they come from the algo's generator;
under data parallelism either is the global batch's draw, of which the rank
keeps its rows (``_draws``). The penalty's and the entropy weight's terms
are means over the rank's rows, so that the ranks' equal shards average to
the global batch's. ``get_action`` is tanh of the actor's mean.
"""

import math
from collections import OrderedDict

import torch
import torch.nn as nn

from robot_manipulation_vq_vae_tpu_torch.algo.algo import (
    PolicyAlgo,
    ValueAlgo,
    n_step_returns,
    register_algo_factory_func,
)
from robot_manipulation_vq_vae_tpu_torch.algo.iql import critic_ensemble, polyak, td_loss
from robot_manipulation_vq_vae_tpu_torch.models import policy_nets as PolicyNets
from robot_manipulation_vq_vae_tpu_torch.models import value_nets as ValueNets
from robot_manipulation_vq_vae_tpu_torch.utils.draws import global_draw


@register_algo_factory_func("cql")
def algo_config_to_class(algo_config):
    return CQL, {}


class LogWeight(nn.Module):
    """A learned log weight: one parameter ``param`` [1], 0 at the start (the
    reference's ``BaseNets.Parameter``; the JAX tree's scalar ``value``)."""

    def __init__(self):
        super().__init__()
        self.param = nn.Parameter(torch.zeros(1))

    def jax_stacked(self):
        return {"param": (["value"], lambda arrays: arrays[0].reshape(1))}

    def forward(self):
        return self.param[0]


class CQL(PolicyAlgo, ValueAlgo):
    """CQL (see the module docstring). Metrics: ``actor/loss``,
    ``actor/log_prob``, ``entropy_weight``, ``entropy_weight_loss``,
    ``critic/cql_weight``, ``critic/critic{i}_loss``,
    ``critic/critic{i}_td``, ``critic/cql_weight_loss``."""

    TRAIN_MODE_NETS = ("actor",)
    _noise_hook = None

    def _create_networks(self):
        cfg = self.algo_config
        enc = self._encoder_kwargs()
        if cfg.actor.net.type != "gaussian":
            raise NotImplementedError("CQL's actor is a Gaussian")
        if not cfg.actor.net.common.get("use_tanh", True):
            raise NotImplementedError(
                "CQL without use_tanh broadcasts its policy loss to (B, B) in the "
                "reference; not ported")
        g = cfg.actor.net.gaussian
        self.nets["actor"] = PolicyNets.GaussianActorNetwork(
            obs_shapes=self.obs_shapes, ac_dim=self.ac_dim,
            mlp_layer_dims=tuple(cfg.actor.layer_dims), fixed_std=g.fixed_std,
            init_std=g.init_std, init_last_fc_weight=g.get("init_last_fc_weight", None),
            std_activation=cfg.actor.net.common.std_activation,
            low_noise_eval=cfg.actor.net.common.low_noise_eval, use_tanh=True,
            encoder_kwargs=enc)
        vb = cfg.critic.get("value_bounds", None)
        critic_ensemble(self, lambda: ValueNets.ActionValueNetwork(
            obs_shapes=self.obs_shapes, ac_dim=self.ac_dim,
            mlp_layer_dims=tuple(cfg.critic.layer_dims),
            value_bounds=tuple(vb) if vb else None, encoder_kwargs=enc))
        te, tq = cfg.actor.target_entropy, cfg.critic.target_q_gap
        self.automatic_entropy_tuning = te is not None
        self.automatic_cql_tuning = tq is not None and tq >= 0.0
        self.target_entropy = -float(self.ac_dim) if te in (None, "default") else float(te)
        self.target_q_gap = float(tq) if self.automatic_cql_tuning else 0.0
        self.bc_start_steps = int(cfg.actor.get("bc_start_steps", 0))
        if self.automatic_entropy_tuning:
            self.nets["log_entropy_weight"] = LogWeight()
        if self.automatic_cql_tuning:
            self.nets["log_cql_weight"] = LogWeight()

    def _create_optimizers(self):
        cfg, optim = self.algo_config, self.algo_config.optim_params
        mg = self.global_config.train.get("max_grad_norm", None)
        self._add_optimizer("actor", self.nets["actor"], optim.actor,
                            cfg.actor.get("max_gradient_norm", None) or mg)
        for i, critic in enumerate(self.nets["critic"]):
            self._add_optimizer(f"critic{i}", critic, optim.critic,
                                cfg.critic.get("max_gradient_norm", None) or mg)
        for name, lr_of in (("log_entropy_weight", optim.actor),
                            ("log_cql_weight", optim.critic)):
            if name in self.nets:
                plain = {"learning_rate": {"initial": lr_of.learning_rate.initial,
                                           "scheduler_type": "constant"}}
                self._add_optimizer(name, self.nets[name], plain)

    def process_batch_for_training(self, batch):
        cfg = self.algo_config
        return n_step_returns(batch, int(cfg.n_step), float(cfg.discount))

    def _draws(self, b):
        """The step's draws: {actor, backup, curr, next, rand}, each with this
        rank's rows of the global batch's draw under data parallelism:
        ``backup`` [n_samples, B, A] along its axis 1; ``curr``, ``next`` and
        ``rand`` [B n_rand, A] are batch-major (a row's candidates together,
        as ``repeat_interleave`` tiles the observations), so along axis 0."""
        cfg, a = self.algo_config.critic, self.ac_dim
        n_rand, n_samples = int(cfg.num_random_actions), int(cfg.get("num_action_samples", 1))
        draws = self._hooked("_noise_hook")
        if draws is not None:
            return self._local_rows(draws, {"backup": 1 if n_samples > 1 else 0})
        dtype, dev = self._dtype(), self.device

        def normal(*shape, dim=0):
            return global_draw(lambda s: torch.randn(
                s, generator=self.generator, device=dev, dtype=dtype), shape, self.dp, dim=dim)

        backup = normal(n_samples, b, a, dim=1) if n_samples > 1 else normal(b, a)
        rand = global_draw(lambda s: torch.rand(
            s, generator=self.generator, device=dev, dtype=dtype), (b * n_rand, a),
            self.dp) * 2.0 - 1.0
        return {"actor": normal(b, a), "backup": backup, "curr": normal(b * n_rand, a),
                "next": normal(b * n_rand, a), "rand": rand}

    def _min_q(self, critics, feats, acts):
        """min over @critics of Q on their features @feats and @acts."""
        return torch.stack([c.head(f, acts) for c, f in zip(critics, feats)]).min(0).values

    def _rl_step(self, batch, gates, validate):
        cfg = self.algo_config
        obs, next_obs, acts = batch["obs"], batch["next_obs"], batch["actions"]
        critics, targets = self.nets["critic"], self.nets["critic_target"]
        actor = self.nets["actor"]
        b = acts.shape[0]
        n_rand = int(cfg.critic.num_random_actions)
        n_samples = int(cfg.critic.get("num_action_samples", 1))
        eps = self._draws(b)
        metrics = OrderedDict()

        # 1. the actor, and the entropy weight
        log_ent = (self.nets["log_entropy_weight"]() if self.automatic_entropy_tuning
                   else obs[next(iter(obs))].new_zeros(()))
        entropy_weight = log_ent.detach().exp()
        dist = actor(obs, generator=self.generator)
        pi, pre_tanh = dist.rsample_with_pretanh(eps=eps["actor"])
        logp = dist.log_prob(pi, pre_tanh)[:, None]
        # the critics' features of s, as they are before their steps: the
        # actor's Q reads them detached, the critics' losses in step 3
        feats = [c.features(obs) for c in critics]
        baseline = self._min_q(critics, [f.detach() for f in feats], pi)
        if self.bc_start_steps > 0 and self.global_step < self.bc_start_steps:
            baseline = dist.log_prob(acts)[:, None]
        metrics["actor/loss"] = (entropy_weight * logp - baseline).mean()
        metrics["actor/log_prob"] = logp.mean()
        metrics["entropy_weight"] = entropy_weight
        self._update("actor", metrics["actor/loss"], validate)
        if self.automatic_entropy_tuning:
            metrics["entropy_weight_loss"] = -log_ent * (logp.mean().detach()
                                                         + self.target_entropy)
            self._update("log_entropy_weight", metrics["entropy_weight_loss"], validate)
            backup_weight = self.nets["log_entropy_weight"]().detach().exp()
        else:
            backup_weight = entropy_weight

        # 2. the critics' target, from the stepped actor
        with torch.no_grad():
            next_dist = actor(next_obs, generator=self.generator)
            target_feats = [t.features(next_obs) for t in targets]
            if n_samples > 1:
                cand, _ = next_dist.rsample_with_pretanh((n_samples,), eps=eps["backup"])
                cand = cand.transpose(0, 1).reshape(b * n_samples, -1)
                target_qs = torch.stack([
                    t.head(f.repeat_interleave(n_samples, 0), cand).reshape(b, n_samples)
                    .max(1, keepdim=True).values
                    for t, f in zip(targets, target_feats)]).min(0).values
            else:
                next_a, next_pre = next_dist.rsample_with_pretanh(eps=eps["backup"])
                target_qs = self._min_q(targets, target_feats, next_a)
                if not cfg.critic.deterministic_backup:
                    target_qs = target_qs - backup_weight * next_dist.log_prob(
                        next_a, next_pre)[:, None]
            q_target = (batch["rewards"] + (1.0 - batch["dones"])
                        * float(cfg.discount) ** int(cfg.n_step) * target_qs)

            # the conservative candidates
            rand_log_prob = float(self.ac_dim) * math.log(0.5)
            tiled_obs = {k: v.repeat_interleave(n_rand, 0) for k, v in obs.items()}
            tiled_next = {k: v.repeat_interleave(n_rand, 0) for k, v in next_obs.items()}
            curr_dist = actor(tiled_obs, generator=self.generator)
            next_dist_t = actor(tiled_next, generator=self.generator)
            cql_curr, curr_pre = curr_dist.rsample_with_pretanh(eps=eps["curr"])
            cql_next, next_pre_t = next_dist_t.rsample_with_pretanh(eps=eps["next"])
            curr_logp = curr_dist.log_prob(cql_curr, curr_pre).reshape(b, n_rand)
            next_logp = next_dist_t.log_prob(cql_next, next_pre_t).reshape(b, n_rand)
        if self.automatic_cql_tuning:
            log_cql = self.nets["log_cql_weight"]()
        else:
            log_cql = q_target.new_tensor(float(cfg.critic.cql_weight)).log()
        cql_weight = log_cql.detach().exp().clamp(0.0, 1e6)
        metrics["critic/cql_weight"] = cql_weight

        # 3. the critics, their targets and the cql weight
        gaps = []
        for i, (critic, f) in enumerate(zip(critics, feats)):
            q_data = critic.head(f, acts)
            td = td_loss(q_data, q_target, cfg.critic.use_huber)
            tiled = f.repeat_interleave(n_rand, 0)
            cat = torch.cat([critic.head(tiled, eps["rand"]).reshape(b, n_rand) - rand_log_prob,
                             critic.head(tiled, cql_next).reshape(b, n_rand) - next_logp,
                             critic.head(tiled, cql_curr).reshape(b, n_rand) - curr_logp], 1)
            gap = (float(cfg.critic.min_q_weight)
                   * (torch.logsumexp(cat, 1).mean() - q_data.mean()) - self.target_q_gap)
            metrics[f"critic/critic{i + 1}_loss"] = td + cql_weight * gap
            metrics[f"critic/critic{i + 1}_td"] = td
            gaps.append(gap.detach())
            self._update(f"critic{i}", metrics[f"critic/critic{i + 1}_loss"], validate)
            if not validate:
                polyak(targets[i], critic, float(cfg.target_tau))
        if self.automatic_cql_tuning:
            mean_gap = sum(gaps) / len(gaps)
            metrics["critic/cql_weight_loss"] = -log_cql.exp().clamp(0.0, 1e6) * mean_gap
            self._update("log_cql_weight", metrics["critic/cql_weight_loss"], validate)
        return metrics

    @torch.inference_mode()
    def get_action(self, obs_dict, goal_dict=None):
        """tanh of the actor's mean: observations [B, ...] -> [B, A] (under
        data parallelism the global batch's, on every rank)."""
        self._check_obs_request(obs_dict, goal_dict)
        return self._gather_rows(torch.tanh(self.nets["actor"](self._obs(obs_dict)).mean))

    @torch.inference_mode()
    def get_state_action_value(self, obs_dict, actions, goal_dict=None):
        return self.nets["critic"][0](self._obs(obs_dict), self._draw(actions))
