"""Implicit Q-Learning (counterpart of the JAX package's ``algo/iql.py``),
registered as ``iql``, and ``polyak``, the target networks' update that the
rest of the offline-RL family shares.

One step (the JAX step's order of computation, every loss on the networks
as they were before the step):

* each critic of the ensemble regresses r + gamma (1 - done) V(s') (no
  gradient into V) and takes its own optimizer step; each target critic
  moves by ``polyak`` towards its stepped critic;
* V regresses the minimum over the target critics of Q(s, a) by expectile
  regression (weight ``vf_quantile`` where the error is positive);
* the actor takes the negative log likelihood of the batch's actions,
  weighted by exp(adv / beta), adv = min Q - V(s) (its maximum clipped to
  ``adv.clip_adv_value``, the weights to 100 with ``adv.use_final_clip``).

The critics, targets and V run in inference mode, the actor (Gaussian, with
``use_tanh`` tanh-wrapped, or GMM) in training mode. ``get_action`` samples
the actor's distribution in inference mode (its scale 1e-4 with
``low_noise_eval``); a test injects the draws through ``_sample_hook`` (the
standard normal [B, A], or for the GMM (component [B], standard normal)),
else they come from the algo's generator.
"""

from collections import OrderedDict

import torch
import torch.nn as nn

from robot_manipulation_vq_vae_tpu_torch.algo.algo import (
    PolicyAlgo,
    ValueAlgo,
    register_algo_factory_func,
)
from robot_manipulation_vq_vae_tpu_torch.models import policy_nets as PolicyNets
from robot_manipulation_vq_vae_tpu_torch.models import value_nets as ValueNets
from robot_manipulation_vq_vae_tpu_torch.models.distributions import GMMActionDistribution
from robot_manipulation_vq_vae_tpu_torch.utils import loss_utils as LossUtils


@register_algo_factory_func("iql")
def algo_config_to_class(algo_config):
    return IQL, {}


def polyak(target, online, tau):
    """target <- (1 - tau) target + tau online, over the parameters of the
    modules @target and @online."""
    with torch.no_grad():
        t = list(target.parameters())
        torch._foreach_mul_(t, 1.0 - tau)
        torch._foreach_add_(t, list(online.parameters()), alpha=tau)


def td_loss(q, q_target, use_huber):
    """The critics' regression loss: mean squared or smooth-l1."""
    if use_huber:
        return LossUtils.smooth_l1_loss(q, q_target)
    return ((q - q_target) ** 2).mean()


def critic_ensemble(algo, make, n=None):
    """The ensemble ``critic`` of @n (``algo_config.critic.ensemble.n``)
    networks ``make()`` and its frozen copy ``critic_target``."""
    algo.n_critics = algo.algo_config.critic.ensemble.n if n is None else n
    algo.nets["critic"] = nn.ModuleList([make() for _ in range(algo.n_critics)])
    algo.nets["critic_target"] = algo._target_of(algo.nets["critic"])


def sample_actor(dist, generator, draws):
    """A sample of the actor's distribution @dist: @draws injected (a
    standard normal, or a GMM's (component, standard normal)), else drawn
    from @generator."""
    if isinstance(dist, GMMActionDistribution):
        mode, eps = draws if draws is not None else (None, None)
        return dist.sample(generator, mode=mode, eps=eps)
    return dist.sample(generator, eps=draws)


class IQL(PolicyAlgo, ValueAlgo):
    """IQL (see the module docstring). Metrics: ``critic/critic{i}_loss``,
    ``vf_loss``, ``actor/loss``, ``actor/log_prob``, ``adv/adv_mean``,
    ``adv/weight_mean``."""

    TRAIN_MODE_NETS = ("actor",)
    _sample_hook = None

    def _create_networks(self):
        cfg = self.algo_config
        enc = self._encoder_kwargs()
        critic_ensemble(self, lambda: ValueNets.ActionValueNetwork(
            obs_shapes=self.obs_shapes, ac_dim=self.ac_dim,
            mlp_layer_dims=tuple(cfg.critic.layer_dims), encoder_kwargs=enc))
        self.nets["vf"] = ValueNets.ValueNetwork(
            obs_shapes=self.obs_shapes, mlp_layer_dims=tuple(cfg.critic.layer_dims),
            encoder_kwargs=enc)
        net, common = cfg.actor.net, cfg.actor.net.common
        if net.type == "gaussian":
            self.nets["actor"] = PolicyNets.GaussianActorNetwork(
                obs_shapes=self.obs_shapes, ac_dim=self.ac_dim,
                mlp_layer_dims=tuple(cfg.actor.layer_dims),
                fixed_std=net.gaussian.fixed_std, init_std=net.gaussian.init_std,
                init_last_fc_weight=net.gaussian.get("init_last_fc_weight", None),
                std_activation=common.std_activation, low_noise_eval=common.low_noise_eval,
                use_tanh=common.get("use_tanh", False), encoder_kwargs=enc)
        elif net.type == "gmm":
            self.nets["actor"] = PolicyNets.GMMActorNetwork(
                obs_shapes=self.obs_shapes, ac_dim=self.ac_dim,
                mlp_layer_dims=tuple(cfg.actor.layer_dims),
                num_modes=net.gmm.num_modes, min_std=net.gmm.min_std,
                std_activation=common.std_activation, low_noise_eval=common.low_noise_eval,
                encoder_kwargs=enc)
        else:
            raise ValueError(f"unknown actor type {net.type}")

    def _create_optimizers(self):
        cfg, optim = self.algo_config, self.algo_config.optim_params
        mg = self.global_config.train.get("max_grad_norm", None)
        for i, critic in enumerate(self.nets["critic"]):
            self._add_optimizer(f"critic{i}", critic, optim.critic,
                                cfg.critic.get("max_gradient_norm", None) or mg)
        self._add_optimizer("vf", self.nets["vf"], optim.vf, mg)
        self._add_optimizer("actor", self.nets["actor"], optim.actor,
                            cfg.actor.get("max_gradient_norm", None) or mg)

    def process_batch_for_training(self, batch):
        """(s, a, r, s', done) at the first step of each window."""
        return {"obs": {k: v[:, 0] for k, v in batch["obs"].items()},
                "next_obs": {k: v[:, 0] for k, v in batch["next_obs"].items()},
                "goal_obs": batch.get("goal_obs", None),
                "actions": batch["actions"][:, 0],
                "rewards": batch["rewards"][:, 0].reshape(-1, 1),
                "dones": batch["dones"][:, 0].reshape(-1, 1)}

    def _rl_step(self, batch, gates, validate):
        cfg = self.algo_config
        obs, acts = batch["obs"], batch["actions"]
        critics, targets = self.nets["critic"], self.nets["critic_target"]
        with torch.no_grad():
            v_next = self.nets["vf"](batch["next_obs"])
            q_target = batch["rewards"] + (1.0 - batch["dones"]) * float(cfg.discount) * v_next
            q_min = torch.stack([t(obs, acts) for t in targets]).min(0).values
        metrics = OrderedDict()
        for i, critic in enumerate(critics):
            loss = td_loss(critic(obs, acts), q_target, cfg.critic.use_huber)
            metrics[f"critic/critic{i + 1}_loss"] = loss
            self._update(f"critic{i}", loss, validate)
        if not validate:
            for critic, target in zip(critics, targets):
                polyak(target, critic, float(cfg.target_tau))

        v = self.nets["vf"](obs)
        err = q_min - v
        expectile = float(cfg.vf_quantile)
        weight = torch.where(err > 0, err.new_tensor(expectile), err.new_tensor(1.0 - expectile))
        metrics["vf_loss"] = (weight * err ** 2).mean()
        self._update("vf", metrics["vf_loss"], validate)

        adv = q_min - v.detach()
        if cfg.adv.clip_adv_value is not None:
            adv = adv.clamp(max=cfg.adv.clip_adv_value)
        weights = torch.exp(adv / float(cfg.adv.beta))
        if cfg.adv.use_final_clip:
            weights = weights.clamp(max=100.0)
        weights = weights[:, 0]
        lp = self.nets["actor"](obs, generator=self.generator).log_prob(acts)
        metrics["actor/loss"] = (-lp * weights).mean()
        metrics["actor/log_prob"] = lp.mean()
        metrics["adv/adv_mean"] = adv.mean()
        metrics["adv/weight_mean"] = weights.mean()
        self._update("actor", metrics["actor/loss"], validate)
        return metrics

    @torch.inference_mode()
    def get_action(self, obs_dict, goal_dict=None):
        """A sample of the actor's distribution: observations [B, ...] ->
        [B, A]."""
        dist = self.nets["actor"](self._obs(obs_dict))
        return sample_actor(dist, self.generator, self._hooked("_sample_hook"))

    @torch.inference_mode()
    def get_state_value(self, obs_dict, goal_dict=None):
        return self.nets["vf"](self._obs(obs_dict))

    @torch.inference_mode()
    def get_state_action_value(self, obs_dict, actions, goal_dict=None):
        return self.nets["critic"][0](self._obs(obs_dict), self._draw(actions))
