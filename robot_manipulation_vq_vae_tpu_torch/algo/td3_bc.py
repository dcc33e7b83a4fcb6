"""TD3-BC (counterpart of the JAX package's ``algo/td3_bc.py``), registered as
``td3_bc``.

Batches are n-step: the discounted sum of the first ``n_step`` rewards, s'
``n_step`` - 1 steps on (with ``infinite_horizon`` a done row's return is
scaled by 1 / (1 - gamma^n)). One step:

* the target actor's actions at s', plus ``actor.noise_std`` x N(0, 1)
  clipped to ``actor.noise_clip``, clipped to [-1, 1];
* the target Q: ``critic.ensemble.weight`` x the minimum over the target
  critics plus the rest x the maximum; each critic regresses r + gamma^n
  (1 - done) Q' and steps while its epoch window is open;
* the actor's loss, -lambda mean Q(s, pi(s)) + mean (pi(s) - a)^2 with
  lambda = ``alpha`` / mean |Q| (no gradient through lambda), through the
  first critic as it is after its step;
* the actor and every target move only on every ``actor.update_freq``-th
  critic gradient step (and while the actor's window is open). The count of
  critic gradient steps, ``critic_steps``, is saved with the optimizers and
  restored on resume.

The actor runs in training mode, the critics and targets in inference
mode. The smoothing noise's standard normal [B, A] may be injected through
``_noise_hook`` (the JAX step draws it from its key), else it comes from
the algo's generator. ``get_action`` is the actor's action. Under data
parallelism the noise is drawn at the global batch's shape (a hook's too)
and lambda's mean |Q| is the global batch's (the ranks' sums and counts
all-reduced).
"""

from collections import OrderedDict

import torch

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


@register_algo_factory_func("td3_bc")
def algo_config_to_class(algo_config):
    return TD3_BC, {}


def ensemble_target(qs, weight):
    """@weight x the minimum over the ensemble's axis 0 of @qs plus the rest x
    the maximum."""
    return weight * qs.min(0).values + (1 - weight) * qs.max(0).values


class TD3_BC(PolicyAlgo, ValueAlgo):
    """TD3-BC (see the module docstring). Metrics:
    ``critic/critic{i}_loss``, ``actor/loss``."""

    TRAIN_MODE_NETS = ("actor",)
    TRAINING_COUNTERS = ("critic_steps",)
    _noise_hook = None

    def _create_networks(self):
        cfg = self.algo_config
        enc = self._encoder_kwargs()
        vb = cfg.critic.value_bounds
        critic_ensemble(self, lambda: ValueNets.ActionValueNetwork(
            obs_shapes=self.obs_shapes, ac_dim=self.ac_dim,
            mlp_layer_dims=tuple(cfg.critic.layer_dims),
            value_bounds=tuple(vb) if vb else None, encoder_kwargs=enc))
        self.nets["actor"] = PolicyNets.ActorNetwork(
            obs_shapes=self.obs_shapes, ac_dim=self.ac_dim,
            mlp_layer_dims=tuple(cfg.actor.layer_dims), encoder_kwargs=enc)
        self.nets["actor_target"] = self._target_of(self.nets["actor"])
        self.critic_steps = 0

    def _create_optimizers(self):
        optim = self.algo_config.optim_params
        mg = self.global_config.train.get("max_grad_norm", None)
        for i, critic in enumerate(self.nets["critic"]):
            self._add_optimizer(f"critic{i}", critic, optim.critic, mg)
        self._add_optimizer("actor", self.nets["actor"], optim.actor, mg)

    def process_batch_for_training(self, batch):
        cfg = self.algo_config
        return n_step_returns(batch, int(cfg.n_step), float(cfg.discount),
                              cfg.infinite_horizon)

    def _smoothing_noise(self, like):
        """The target policy's smoothing noise: clip(noise_std N(0, 1))."""
        cfg = self.algo_config.actor
        normal = self._hooked("_noise_hook")
        if normal is None:
            normal = global_draw(lambda s: torch.randn(
                s, generator=self.generator, device=like.device, dtype=like.dtype), like.shape,
                self.dp)
        else:
            normal = self._local_rows(normal)
        return (float(cfg.noise_std) * normal).clamp(-float(cfg.noise_clip),
                                                     float(cfg.noise_clip))

    def _rl_step(self, batch, gates, validate):
        cfg = self.algo_config
        obs, next_obs, acts = batch["obs"], batch["next_obs"], batch["actions"]
        critics, targets = self.nets["critic"], self.nets["critic_target"]
        discount = float(cfg.discount) ** int(cfg.n_step)
        with torch.no_grad():
            next_a = self.nets["actor_target"](next_obs)
            next_a = (next_a + self._smoothing_noise(next_a)).clamp(-1.0, 1.0)
            q_next = ensemble_target(torch.stack([t(next_obs, next_a) for t in targets]),
                                     float(cfg.critic.ensemble.weight))
            q_target = batch["rewards"] + (1.0 - batch["dones"]) * discount * q_next
        metrics = OrderedDict()
        for i, critic in enumerate(critics):
            loss = td_loss(critic(obs, acts), q_target, cfg.critic.use_huber)
            metrics[f"critic/critic{i + 1}_loss"] = loss
            self._update(f"critic{i}", loss, validate, gates["critic"])

        # the actor's Q through the first critic as stepped; the critic's
        # encoder takes no part in the actor's gradient
        pi = self.nets["actor"](obs, generator=self.generator)
        with torch.no_grad():
            feats = critics[0].features(obs)
        q_pi = critics[0].head(feats, pi)
        # lambda's mean |Q| over the global batch: the ranks' sums and counts
        q_abs = torch.stack([q_pi.abs().sum(), q_pi.new_tensor(q_pi.numel())]).detach()
        if self.dp is not None:
            self.dp.all_reduce_(q_abs)
        lam = float(cfg.alpha) / (q_abs[0] / q_abs[1])
        metrics["actor/loss"] = -lam * q_pi.mean() + ((pi - acts) ** 2).mean()

        counter = self.critic_steps + int(gates["critic"] and not validate)
        if counter % int(cfg.actor.update_freq) == 0 and gates["actor"] and not validate:
            self._update("actor", metrics["actor/loss"], validate)
            tau = float(cfg.target_tau)
            polyak(self.nets["actor_target"], self.nets["actor"], tau)
            for critic, target in zip(critics, targets):
                polyak(target, critic, tau)
        if not validate:
            self.critic_steps = counter
        return metrics

    @torch.inference_mode()
    def get_action(self, obs_dict, goal_dict=None):
        self._check_obs_request(obs_dict, goal_dict)
        return self._gather_rows(self.nets["actor"](self._obs(obs_dict)))

    @torch.inference_mode()
    def get_state_action_value(self, obs_dict, actions, goal_dict=None):
        return self.nets["critic"][0](self._obs(obs_dict), self._draw(actions))
