"""Batch-Constrained Q-learning (counterpart of the JAX package's
``algo/bcq.py``), registered as ``bcq`` with its routing: ``BCQ`` (a
conditional-VAE action sampler, ``models/vae_nets.py``), ``BCQ_GMM`` (a GMM
sampler) and ``BCQ_Distributional`` (one categorical critic over
``critic.distributional.num_atoms`` atoms of ``critic.value_bounds``).

One step, in the JAX step's order, each part while its ``optim_params``
epoch window is open:

1. the action sampler: the VAE's reconstruction + ``vae.kl_weight`` KL (the
   GMM's negative log likelihood), one optimizer step;
2. the target, from the sampler as stepped: ``critic.num_action_samples``
   candidates per row at s' (perturbed by the target actor where
   ``actor.enabled``), each scored by the target critics combined as
   TD3-BC's (``critic.ensemble.weight`` x min + the rest x max), the best
   candidate's value. The distributional critic takes the candidate of the
   highest mean and projects r + gamma^n (1 - done) atoms onto the atoms
   (``loss_utils.project_values_onto_atoms``), its loss the KL divergence
   to that projection;
3. each critic steps, and its target moves by ``polyak``, on a critic
   gradient step only;
4. with ``actor.enabled``, the perturbation actor maximizes the first
   critic's Q (its mean) of one perturbed candidate per row, and its target
   moves.

``get_action`` draws ``critic.num_action_samples_rollout`` candidates per
row, perturbs them, and returns the one of the highest Q of the first critic
(the first on a tie); ``get_state_value`` returns that Q.

The perturbation actor runs in training mode in the step (the GMM sampler
too in its loss); the sampler's other calls, the critics and the targets run
in inference mode, where an encoder treats each row alone: each network
encodes a row once and its candidates are scored on the features tiled (the
JAX step encodes the observations tiled). Draws: ``_noise_hook`` returns the
step's {"enc": the VAE's standard normal [B, latent], "backup": the
candidates' latents [B * N, latent], "actor": [B, latent]} (for the GMM
sampler "backup" and "actor" are (component, standard normal) pairs), taken
as the latents themselves, clipped to ``latent_clip``; ``_sample_hook``
returns a request's prior draws (``VAEActor.sample_prior``'s) or, for the
GMM, (component, standard normal). Otherwise they come from the algo's
generator. Under data parallelism every draw is the global batch's (a
hook's too, and the candidates' [B * N, ...] row-major), of which the rank
keeps its rows: the VAE's through its ``dp``, the GMM's sampled from the
mixture gathered over the ranks; ``get_action`` takes the ranks' shards and
returns the global batch's actions on every rank.
"""

from collections import OrderedDict

import torch

from robot_manipulation_vq_vae_tpu_torch.algo.algo import (
    PolicyAlgo,
    ValueAlgo,
    module_mode,
    n_step_returns,
    register_algo_factory_func,
)
from robot_manipulation_vq_vae_tpu_torch.algo.iql import critic_ensemble, polyak, td_loss
from robot_manipulation_vq_vae_tpu_torch.algo.td3_bc import ensemble_target
from robot_manipulation_vq_vae_tpu_torch.models import policy_nets as PolicyNets
from robot_manipulation_vq_vae_tpu_torch.models import vae_nets as VAENets
from robot_manipulation_vq_vae_tpu_torch.models import value_nets as ValueNets
from robot_manipulation_vq_vae_tpu_torch.models.distributions import GMMActionDistribution
from robot_manipulation_vq_vae_tpu_torch.utils import loss_utils as LossUtils


@register_algo_factory_func("bcq")
def algo_config_to_class(algo_config):
    """The JAX routing: a distributional critic, else a GMM sampler, else
    BCQ."""
    if algo_config.critic.distributional.enabled:
        return BCQ_Distributional, {}
    if algo_config.action_sampler.get("gmm", {}).get("enabled", False):
        return BCQ_GMM, {}
    return BCQ, {}


class PerturbationActor(ValueNets.ActionValueNetwork):
    """(s, a) -> clip(a + ``perturbation_scale`` tanh(MLP([features, a])),
    -1, 1): BCQ's bounded correction of a sampled action (its layers in the
    value networks' layout, the output at ``nets.decoder.nets.action``)."""

    HEAD = "action"

    def __init__(self, obs_shapes, ac_dim, layer_dims=(300, 400), perturbation_scale=0.05,
                 goal_shapes=None, encoder_kwargs=None):
        super().__init__(obs_shapes, ac_dim, layer_dims, None, goal_shapes, encoder_kwargs)
        self.perturbation_scale = perturbation_scale

    def _output_dim(self):
        return self.ac_dim

    def head(self, feats, acts=None):
        delta = self.perturbation_scale * torch.tanh(self._raw(feats, acts))
        return (acts + delta).clamp(-1.0, 1.0)


def tile(dist, n):
    """The GMM @dist [B] with each row repeated @n times: [B * n]."""
    return GMMActionDistribution(means=dist.means.repeat_interleave(n, 0),
                                 scales=dist.scales.repeat_interleave(n, 0),
                                 logits=dist.logits.repeat_interleave(n, 0))


class BCQ(PolicyAlgo, ValueAlgo):
    """BCQ with the VAE sampler (see the module docstring). Metrics:
    ``action_sampler/loss``, ``action_sampler/kl_loss``,
    ``critic/critic{i}_loss``, ``actor/loss`` (with ``actor.enabled``)."""

    TRAIN_MODE_NETS = ("actor",)
    LOSS_KEY = "action_sampler/loss"
    _noise_hook = None
    _sample_hook = None

    def _create_networks(self):
        cfg = self.algo_config
        self._enc = self._encoder_kwargs()
        critic_ensemble(self, self._make_critic, self._n_critics())
        self.nets["action_sampler"] = self._make_sampler()
        self.actor_enabled = cfg.actor.enabled
        if self.actor_enabled:
            self.nets["actor"] = PerturbationActor(
                obs_shapes=self.obs_shapes, ac_dim=self.ac_dim,
                layer_dims=tuple(cfg.actor.layer_dims),
                perturbation_scale=cfg.actor.perturbation_scale, encoder_kwargs=self._enc)
            self.nets["actor_target"] = self._target_of(self.nets["actor"])

    def _n_critics(self):
        return self.algo_config.critic.ensemble.n

    def _make_critic(self):
        cfg = self.algo_config.critic
        return ValueNets.ActionValueNetwork(
            obs_shapes=self.obs_shapes, ac_dim=self.ac_dim,
            mlp_layer_dims=tuple(cfg.layer_dims),
            value_bounds=tuple(cfg.value_bounds) if cfg.value_bounds else None,
            encoder_kwargs=self._enc)

    def _make_sampler(self):
        return VAENets.VAEActor(obs_shapes=self.obs_shapes, ac_dim=self.ac_dim,
                                encoder_kwargs=self._enc,
                                **VAENets.vae_args_from_config(self.algo_config.action_sampler.vae))

    def _create_optimizers(self):
        optim = self.algo_config.optim_params
        mg = self.global_config.train.get("max_grad_norm", None)
        for i, critic in enumerate(self.nets["critic"]):
            self._add_optimizer(f"critic{i}", critic, optim.critic, mg)
        self._add_optimizer("action_sampler", self.nets["action_sampler"],
                            optim.action_sampler, mg)
        if self.actor_enabled:
            self._add_optimizer("actor", self.nets["actor"], optim.actor, mg)

    def process_batch_for_training(self, batch):
        cfg = self.algo_config
        return n_step_returns(batch, int(cfg.n_step), float(cfg.discount),
                              cfg.infinite_horizon)

    # ------------------------------------------------------------ the sampler
    def _sampler_loss(self, obs, acts, eps):
        """The VAE's loss (reconstruction + kl_weight KL) and metrics."""
        out = self.nets["action_sampler"].forward_train(acts, obs, eps=eps,
                                                        generator=self.generator)
        loss = (out["reconstruction_loss"]
                + float(self.algo_config.action_sampler.vae.kl_weight) * out["kl_loss"])
        return loss, OrderedDict([("action_sampler/loss", loss),
                                  ("action_sampler/kl_loss", out["kl_loss"])])

    def _candidates(self, obs, n, z=None, draws=None):
        """@n sampled actions per row of @obs: [B * n, A], row-major. @z: the
        latents [B * n, latent] themselves (clipped); @draws: the prior's
        draws; else the prior is sampled with the algo's generator."""
        sampler = self.nets["action_sampler"]
        feats = sampler.obs_features(obs).repeat_interleave(n, 0)
        if z is None:
            z = sampler.sample_prior(feats, self.generator, draws)
        else:
            z = sampler._clip(z)
        return sampler.decode(z, feats)

    # ------------------------------------------------------------ the step
    def _perturbed(self, name, obs, cand, n):
        """@cand [B * n, A] perturbed by the actor @name at the rows of
        @obs (as they are without ``actor.enabled``)."""
        if not self.actor_enabled:
            return cand
        actor = self.nets[name]
        return actor.head(actor.features(obs).repeat_interleave(n, 0), cand)

    def _critic_target(self, batch, cand, n, discount):
        """r + discount (1 - done) max over the @n candidates [B * n, A] of
        the target critics' combined Q."""
        b = batch["actions"].shape[0]
        next_obs = batch["next_obs"]
        qs = torch.stack([t.head(t.features(next_obs).repeat_interleave(n, 0), cand)
                          for t in self.nets["critic_target"]])
        q = ensemble_target(qs, float(self.algo_config.critic.ensemble.weight))
        q_max = q.reshape(b, n).max(1, keepdim=True).values
        return batch["rewards"] + (1.0 - batch["dones"]) * discount * q_max

    def _critic_losses(self, batch, target, metrics):
        """Each critic's TD loss: {optimizer name: loss}."""
        losses = {}
        for i, critic in enumerate(self.nets["critic"]):
            loss = td_loss(critic(batch["obs"], batch["actions"]), target,
                           self.algo_config.critic.use_huber)
            metrics[f"critic/critic{i + 1}_loss"] = loss
            losses[f"critic{i}"] = loss
        return losses

    def _rl_step(self, batch, gates, validate):
        cfg = self.algo_config
        obs, acts = batch["obs"], batch["actions"]
        n = int(cfg.critic.num_action_samples)
        tau = float(cfg.target_tau)
        metrics = OrderedDict()
        draws = self._local_rows(self._hooked("_noise_hook") or {})
        loss, sampler_metrics = self._sampler_loss(obs, acts, draws.get("enc"))
        metrics.update(sampler_metrics)
        self._update("action_sampler", loss, validate, gates["action_sampler"])

        with torch.no_grad():
            cand = self._candidates(batch["next_obs"], n, z=draws.get("backup"))
            cand = self._perturbed("actor_target", batch["next_obs"], cand, n)
            target = self._critic_target(batch, cand, n,
                                         float(cfg.discount) ** int(cfg.n_step))
        for name, loss in self._critic_losses(batch, target, metrics).items():
            self._update(name, loss, validate, gates["critic"])
        if gates["critic"] and not validate:
            for critic, t in zip(self.nets["critic"], self.nets["critic_target"]):
                polyak(t, critic, tau)

        if self.actor_enabled:
            with torch.no_grad():
                cand = self._candidates(obs, 1, z=draws.get("actor"))
                feats = self.nets["critic"][0].features(obs)
            perturbed = self.nets["actor"](obs, cand, generator=self.generator)
            metrics["actor/loss"] = -self.nets["critic"][0].head(feats, perturbed).mean()
            self._update("actor", metrics["actor/loss"], validate, gates["actor"])
            if gates["actor"] and not validate:
                polyak(self.nets["actor_target"], self.nets["actor"], tau)
        return metrics

    # ------------------------------------------------------------ serving
    def _scored_candidates(self, obs_dict):
        """(candidates [B, N, A], the first critic's Q [B, N]) of a request."""
        obs = self._obs(obs_dict)
        n = int(self.algo_config.critic.num_action_samples_rollout)
        draws = self._hooked("_sample_hook")
        cand = self._candidates(obs, n, draws=None if draws is None else self._local_rows(draws))
        cand = self._perturbed("actor", obs, cand, n)
        critic = self.nets["critic"][0]
        q = critic.head(critic.features(obs).repeat_interleave(n, 0), cand)
        b = cand.shape[0] // n
        return cand.reshape(b, n, -1), q.reshape(b, n)

    @torch.inference_mode()
    def get_action(self, obs_dict, goal_dict=None):
        """The candidate of the highest Q (the first on a tie): [B, A]."""
        self._check_obs_request(obs_dict, goal_dict)
        cand, q = self._scored_candidates(obs_dict)
        best = q.argmax(1)
        return self._gather_rows(cand[torch.arange(cand.shape[0], device=cand.device), best])

    @torch.inference_mode()
    def get_state_value(self, obs_dict, goal_dict=None):
        """The highest Q over the request's candidates: [B, 1]."""
        return self._scored_candidates(obs_dict)[1].max(1, keepdim=True).values

    @torch.inference_mode()
    def get_state_action_value(self, obs_dict, actions, goal_dict=None):
        return self.nets["critic"][0](self._obs(obs_dict), self._draw(actions))


class BCQ_GMM(BCQ):
    """BCQ with a GMM action sampler (``action_sampler.actor_layer_dims`` and
    ``action_sampler.gmm``): trained on the negative log likelihood in
    training mode, sampled in inference mode (scales 1e-4 with
    ``low_noise_eval``)."""

    def _make_sampler(self):
        sampler = self.algo_config.action_sampler
        gmm = sampler.get("gmm", {})
        return PolicyNets.GMMActorNetwork(
            obs_shapes=self.obs_shapes, ac_dim=self.ac_dim,
            mlp_layer_dims=tuple(sampler.get("actor_layer_dims", (300, 400))),
            num_modes=gmm.get("num_modes", 5), min_std=gmm.get("min_std", 0.0001),
            std_activation=gmm.get("std_activation", "softplus"),
            low_noise_eval=gmm.get("low_noise_eval", True), encoder_kwargs=self._enc)

    def _sampler_loss(self, obs, acts, eps):
        with module_mode(self.nets["action_sampler"], True) as sampler:
            loss = -sampler(obs, generator=self.generator).log_prob(acts).mean()
        return loss, OrderedDict([("action_sampler/loss", loss)])

    def _candidates(self, obs, n, z=None, draws=None):
        """@z or @draws: the (component, standard normal) of the samples.
        Drawn, under data parallelism, from the mixture gathered over the
        ranks, whole, of which the rank keeps its rows (the component's
        draw is not separable by rows)."""
        dist = self.nets["action_sampler"](obs)
        given = z if z is not None else draws
        if given is not None:
            return tile(dist, n).sample(self.generator, mode=given[0], eps=given[1])
        return self._local_rows(tile(self._gather_dist(dist), n).sample(self.generator))


class BCQ_Distributional(BCQ):
    """BCQ with one distributional critic (C51) over
    ``critic.distributional.num_atoms`` atoms spanning ``critic.value_bounds``.
    Its metric is ``critic/critic1_loss``: the KL divergence of the critic's
    distribution at (s, a) from the projected target."""

    def _n_critics(self):
        return 1

    def _make_critic(self):
        cfg = self.algo_config.critic
        if cfg.value_bounds is None:
            raise ValueError("the distributional critic needs critic.value_bounds")
        return ValueNets.DistributionalActionValueNetwork(
            obs_shapes=self.obs_shapes, ac_dim=self.ac_dim,
            mlp_layer_dims=tuple(cfg.layer_dims), value_bounds=tuple(cfg.value_bounds),
            num_atoms=cfg.distributional.num_atoms, encoder_kwargs=self._enc)

    def _critic_target(self, batch, cand, n, discount):
        """The projected distribution [B, atoms] of r + discount (1 - done)
        atoms at each row's candidate of the highest mean."""
        target = self.nets["critic_target"][0]
        b = batch["actions"].shape[0]
        feats = target.features(batch["next_obs"]).repeat_interleave(n, 0)
        log_probs, atoms = target.head_train(feats, cand)
        probs = log_probs.exp().reshape(b, n, -1)
        best = (probs * atoms).sum(-1).argmax(1)
        best_probs = probs[torch.arange(b, device=probs.device), best]
        values = batch["rewards"] + (1.0 - batch["dones"]) * discount * atoms[None]
        return LossUtils.project_values_onto_atoms(values, best_probs, atoms)

    def _critic_losses(self, batch, target, metrics):
        log_probs, _ = self.nets["critic"][0].forward_train(batch["obs"], batch["actions"])
        entropy = (target * torch.log(torch.where(target > 0, target,
                                                  torch.ones_like(target)))).sum(-1)
        loss = (entropy - (target * log_probs).sum(-1)).mean()
        metrics["critic/critic1_loss"] = loss
        return {"critic0": loss}
