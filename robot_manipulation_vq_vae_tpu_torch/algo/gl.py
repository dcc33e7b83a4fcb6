"""Goal learning (counterpart of the JAX package's ``algo/gl.py``),
registered as ``gl``: subgoal planners, and the value planner that ranks
their samples.

* ``GL``: ``GoalNetwork``, a ``MIMO_MLP`` from (observations, goals) to the
  subgoal observations ``next_obs[:, subgoal_horizon - 1]`` of the subgoal
  keys, trained on the sum of the per-key mean squared errors;
* ``GL_VAE``: ``SubgoalVAE``, a conditional VAE over the flattened
  subgoals, trained on reconstruction + ``vae.kl_weight`` KL against
  N(0, I); its predictions decode prior samples;
* ``ValuePlanner``: a planner and a value algo (IRIS's BCQ):
  ``num_samples`` subgoals a row, each scored by the value network's
  ``get_state_value``, the best one kept (the first on a tie, as
  ``jnp.argmax``).

The JAX steps apply the planners with ``train=False``: the networks run in
inference mode in training too (BatchNorm on its running statistics, no
crops), as here. ``sample_subgoals`` encodes each row's condition once and
tiles the features over its samples (the JAX package tiles the
observations and encodes each copy: the same values in inference mode).

Options of the ``gl`` template that the JAX classes read nowhere raise when
set off their defaults: ``vae.latent_clip``, ``vae.decoder.is_conditioned``
false, ``vae.decoder.reconstruction_sum_across_elements`` and the learned,
GMM and categorical priors (``vae.prior.learn`` / ``use_gmm`` /
``use_categorical``).

Draws, for tests: ``GL_VAE._noise_hook`` returns a step's encoder draw (the
standard normal [B, latent]), ``_prior_hook`` the prior draws of a
prediction ([rows x samples, latent]); otherwise both come from the algo's
generator.

Under data parallelism (``parallel.shard_state``) a step takes this rank's
``shard_batch`` rows, averages the gradient over the ranks before clipping
it and returns the global batch's losses; the VAE's draws (and a hook's)
are the global batch's, of which the rank keeps its rows (a prediction's
samples are row-major, a row's together), and predictions are of this
rank's rows.
"""

from collections import OrderedDict

import numpy as np
import torch
import torch.nn as nn

from robot_manipulation_vq_vae_tpu_torch.algo.algo import (
    PlannerAlgo,
    module_mode,
    register_algo_factory_func,
    sub_batch,
)
from robot_manipulation_vq_vae_tpu_torch.models import base_nets as BaseNets
from robot_manipulation_vq_vae_tpu_torch.models.obs_nets import (
    MIMO_MLP,
    ObservationDecoder,
    ObservationGroupEncoder,
)
from robot_manipulation_vq_vae_tpu_torch.models.policy_nets import _groups, _inputs
from robot_manipulation_vq_vae_tpu_torch.utils import loss_utils as LossUtils
from robot_manipulation_vq_vae_tpu_torch.utils import optim_utils as OptimUtils
from robot_manipulation_vq_vae_tpu_torch.utils.draws import global_draw, keep_rows


@register_algo_factory_func("gl")
def algo_config_to_class(algo_config):
    """The JAX routing: ``GL_VAE`` with ``vae.enabled``, else ``GL``."""
    if algo_config.vae.enabled:
        return GL_VAE, {}
    return GL, {}


class GoalNetwork(nn.Module):
    """(observations, goals) -> {subgoal key: [B, ...]} through a
    ``MIMO_MLP`` (JAX ``GoalNetwork``)."""

    JAX_NAMES = {"net": "net"}

    def __init__(self, obs_shapes, subgoal_shapes, layer_dims=(300, 400), goal_shapes=None,
                 encoder_kwargs=None):
        super().__init__()
        self.goal_shapes = goal_shapes
        self.net = MIMO_MLP(_groups(obs_shapes, goal_shapes), subgoal_shapes,
                            tuple(layer_dims), encoder_kwargs)

    def forward(self, obs_dict, goal_dict=None):
        return self.net(_inputs(obs_dict, goal_dict, self.goal_shapes, over_time=False))


class SubgoalVAE(nn.Module):
    """A conditional VAE over the flattened subgoals (JAX ``SubgoalVAE``):
    the condition is the observations' (and goals') features; ``q_net``
    reads [condition, subgoals] and gives (mean, log variance) of z;
    ``dec_mlp`` (ReLU after every layer) and the per-key heads ``dec_heads``
    read [condition, z]."""

    JAX_NAMES = {"cond_encoder": "cond_encoder", "q_net": "q_net", "dec_mlp": "dec_mlp",
                 "dec_heads": "dec_heads"}
    # the data-parallel axis (``parallel.AxisComm``): the draws are taken at
    # the global batch's shape and each rank keeps its rows
    # (``utils.draws.global_draw``), set by ``parallel.shard_state``
    dp = None

    def __init__(self, obs_shapes, subgoal_shapes, latent_dim=16,
                 encoder_layer_dims=(300, 400), decoder_layer_dims=(300, 400),
                 goal_shapes=None, encoder_kwargs=None):
        super().__init__()
        self.goal_shapes = goal_shapes
        self.subgoal_keys = list(subgoal_shapes)
        self.latent_dim = latent_dim
        self.cond_encoder = ObservationGroupEncoder(_groups(obs_shapes, goal_shapes),
                                                    encoder_kwargs, feature_activation="relu")
        cond = self.cond_encoder.output_dim
        flat = sum(int(np.prod(s)) for s in subgoal_shapes.values())
        self.q_net = BaseNets.MLP(cond + flat, 2 * latent_dim, tuple(encoder_layer_dims))
        self.dec_mlp = BaseNets.MLP(cond + latent_dim, decoder_layer_dims[-1],
                                    tuple(decoder_layer_dims[:-1]),
                                    output_activation=nn.ReLU)
        self.dec_heads = ObservationDecoder(subgoal_shapes, decoder_layer_dims[-1])

    def condition(self, obs_dict, goal_dict=None):
        return self.cond_encoder(_inputs(obs_dict, goal_dict, self.goal_shapes,
                                         over_time=False))

    def decode(self, z, cond):
        return self.dec_heads(self.dec_mlp(torch.cat([cond, z], dim=-1)))

    def forward_train(self, subgoal_dict, obs_dict, goal_dict=None, eps=None,
                      generator=None):
        """{"reconstructions", "reconstruction_loss" (the per-key MSEs
        summed), "kl_loss", "encoder_z"}; @eps the standard-normal draw
        [B, latent], else drawn from @generator."""
        cond = self.condition(obs_dict, goal_dict)
        flat = torch.cat([subgoal_dict[k].reshape(subgoal_dict[k].shape[0], -1)
                          for k in self.subgoal_keys], dim=-1)
        mu, logvar = self.q_net(torch.cat([cond, flat], dim=-1)).chunk(2, dim=-1)
        if eps is None:
            eps = global_draw(lambda s: torch.randn(s, generator=generator, device=mu.device,
                                                    dtype=mu.dtype), mu.shape, self.dp)
        z = mu + torch.exp(0.5 * logvar) * eps
        recons = self.decode(z, cond)
        recon_loss = sum(((recons[k] - subgoal_dict[k]) ** 2).mean()
                         for k in self.subgoal_keys)
        return {"reconstructions": recons, "reconstruction_loss": recon_loss,
                "kl_loss": LossUtils.kld_0_1_loss(mu, logvar), "encoder_z": z}

    def sample(self, obs_dict, goal_dict=None, num_samples=1, generator=None, draws=None):
        """@num_samples decoded prior samples a row, row-major: {key: [B x
        num_samples, ...]}; @draws the standard normal [B x num_samples,
        latent], else drawn from @generator."""
        cond = self.condition(obs_dict, goal_dict).repeat_interleave(num_samples, 0)
        z = draws if draws is not None else global_draw(
            lambda s: torch.randn(s, generator=generator, device=cond.device, dtype=cond.dtype),
            (cond.shape[0], self.latent_dim), self.dp)
        return self.decode(z, cond)


class GL(PlannerAlgo):
    """Deterministic subgoal prediction (see the module docstring). Metrics:
    ``goal_<key>_loss`` per subgoal key and their sum ``goal_loss``."""

    def __init__(self, algo_config, obs_config, global_config, obs_key_shapes, ac_dim,
                 device=None, use_kernels=True):
        self._subgoal_horizon = int(algo_config.subgoal_horizon)
        self._check_options(algo_config)
        super().__init__(algo_config, obs_config, global_config, obs_key_shapes, ac_dim,
                         device, use_kernels)
        if not self.subgoal_shapes:
            raise ValueError("GL needs at least one subgoal key: set "
                             "observation.modalities.subgoal")

    @staticmethod
    def _check_options(algo_config):
        """Refuse the VAE options that the JAX classes read nowhere."""
        if not algo_config.vae.enabled:
            return
        vae = algo_config.vae
        unported = [name for name, on in (
            ("vae.latent_clip", vae.latent_clip is not None),
            ("vae.decoder.is_conditioned false", not vae.decoder.is_conditioned),
            ("vae.decoder.reconstruction_sum_across_elements",
             vae.decoder.reconstruction_sum_across_elements),
            ("vae.prior.learn", vae.prior.learn),
            ("vae.prior.use_gmm", vae.prior.use_gmm),
            ("vae.prior.use_categorical", vae.prior.use_categorical)) if on]
        if unported:
            raise NotImplementedError(
                f"the subgoal VAE does not take {', '.join(unported)} (the JAX "
                "SubgoalVAE reads none of them)")

    def _create_networks(self):
        self.nets["goal_network"] = GoalNetwork(
            obs_shapes=self.obs_shapes, subgoal_shapes=self.subgoal_shapes,
            layer_dims=tuple(self.algo_config.ae.planner_layer_dims),
            goal_shapes=self.goal_shapes or None, encoder_kwargs=self._encoder_kwargs())

    def process_batch_for_training(self, batch):
        """The first step's observations, and as subgoals the subgoal keys
        of ``next_obs`` ``subgoal_horizon`` - 1 steps on."""
        sh = self._subgoal_horizon
        t = next(iter(batch["next_obs"].values())).shape[1]
        if t < sh:
            raise ValueError(
                f"windows of {t} steps hold no subgoal {sh} steps on: "
                f"train.seq_length must be at least algo.subgoal_horizon ({sh})")
        return {"obs": {k: v[:, 0] for k, v in batch["obs"].items()},
                "subgoals": {k: v[:, sh - 1] for k, v in batch["next_obs"].items()
                             if k in self.subgoal_shapes},
                "goal_obs": batch.get("goal_obs", None),
                "actions": batch["actions"][:, 0]}

    def get_actor_goal_for_training_from_processed_batch(self, processed_batch, **kwargs):
        """The batch's subgoals supervise the actor."""
        return processed_batch["subgoals"]

    def _losses(self, batch):
        obs, goal = self._obs(batch["obs"]), self._obs(batch.get("goal_obs") or None)
        subgoals = self._obs(batch["subgoals"])
        pred = self.nets["goal_network"](obs, goal)
        losses = OrderedDict((f"goal_{k}_loss", ((pred[k] - subgoals[k]) ** 2).mean())
                             for k in pred)
        losses["goal_loss"] = sum(losses.values())
        return losses

    def train_on_batch(self, batch, epoch, validate=False):
        """One step of the goal network on ``goal_loss``, in inference mode
        (the JAX step's ``train=False``); with @validate the losses alone."""
        self._check_shard(batch)
        with module_mode(self.nets, False), torch.set_grad_enabled(not validate):
            losses = self._losses(batch)
            if not validate:
                params = list(self.nets["goal_network"].parameters())
                grads = self._sync_grads(self._gradients(losses["goal_loss"], params))
                if self.max_grad_norm is not None:
                    OptimUtils.clip_by_global_norm_(grads, self.max_grad_norm, self.mp)
                self._step("goal_network", params, grads)
                self.global_step += 1
        return {"losses": self._dp_losses(
            OrderedDict((k, v.detach()) for k, v in losses.items()))}

    def log_info(self, info):
        log = OrderedDict((k, float(v)) for k, v in info["losses"].items())
        log["Loss"] = log.get("goal_loss", 0.0)
        return log

    @torch.inference_mode()
    def get_subgoal_predictions(self, obs_dict, goal_dict=None):
        """{subgoal key: [B, ...]} on the device."""
        with module_mode(self.nets, False):
            return self.nets["goal_network"](self._obs(obs_dict), self._obs(goal_dict))

    def sample_subgoals(self, obs_dict, goal_dict=None, num_samples=1):
        """The prediction repeated @num_samples times a row: [B x
        num_samples, ...], row-major."""
        return {k: v.repeat_interleave(num_samples, 0)
                for k, v in self.get_subgoal_predictions(obs_dict, goal_dict).items()}

    def get_action(self, obs_dict, goal_dict=None):
        raise RuntimeError("GL is a planner, not a policy")


class GL_VAE(GL):
    """The VAE subgoal planner (see the module docstring). Metrics:
    ``goal_loss`` = ``recons_loss`` + kl_weight ``kl_loss``."""

    _noise_hook = None
    _prior_hook = None

    def _create_networks(self):
        vae = self.algo_config.vae
        self.nets["goal_network"] = SubgoalVAE(
            obs_shapes=self.obs_shapes, subgoal_shapes=self.subgoal_shapes,
            latent_dim=vae.latent_dim,
            encoder_layer_dims=tuple(vae.encoder_layer_dims),
            decoder_layer_dims=tuple(vae.decoder_layer_dims),
            goal_shapes=self.goal_shapes or None, encoder_kwargs=self._encoder_kwargs())

    def _losses(self, batch):
        eps = (None if self._noise_hook is None
               else keep_rows(self._draw(self._noise_hook()), self.dp))
        out = self.nets["goal_network"].forward_train(
            self._obs(batch["subgoals"]), self._obs(batch["obs"]),
            self._obs(batch.get("goal_obs") or None), eps=eps, generator=self.generator)
        loss = (out["reconstruction_loss"]
                + float(self.algo_config.vae.kl_weight) * out["kl_loss"])
        return OrderedDict(goal_loss=loss, recons_loss=out["reconstruction_loss"],
                           kl_loss=out["kl_loss"])

    @torch.inference_mode()
    def sample_subgoals(self, obs_dict, goal_dict=None, num_samples=1):
        """@num_samples decoded prior samples a row: [B x num_samples, ...],
        row-major; each row's condition encoded once."""
        draws = (None if self._prior_hook is None
                 else keep_rows(self._draw(self._prior_hook()), self.dp))
        with module_mode(self.nets, False):
            return self.nets["goal_network"].sample(
                self._obs(obs_dict), self._obs(goal_dict), num_samples,
                generator=self.generator, draws=draws)

    def get_subgoal_predictions(self, obs_dict, goal_dict=None):
        """One decoded prior sample a row: {subgoal key: [B, ...]}."""
        return self.sample_subgoals(obs_dict, goal_dict, 1)


class ValuePlanner:
    """A planner (``GL`` / ``GL_VAE``) and a value algo (``BCQ``), each built
    from its own config section (``algo_config.planner`` / ``.value``, and
    the same of @obs_config): ``get_subgoal_predictions`` keeps, of
    ``num_samples`` planner samples a row, the one of the highest
    ``get_state_value`` (the first on a tie). The value network reads the
    subgoal keys. Holds no networks of its own (``nets`` is a view). Under
    data parallelism the planner and the value algo share the dp axis, and
    a prediction is of this rank's rows."""

    dp = None

    def __init__(self, planner_algo_class, value_algo_class, algo_config, obs_config,
                 global_config, obs_key_shapes, ac_dim, device=None, use_kernels=True):
        self.algo_config = algo_config
        self.obs_config = obs_config
        self.global_config = global_config
        self.ac_dim = ac_dim
        self.planner = planner_algo_class(
            algo_config=algo_config.planner, obs_config=obs_config.planner,
            global_config=global_config, obs_key_shapes=obs_key_shapes, ac_dim=ac_dim,
            device=device, use_kernels=use_kernels)
        self.value_net = value_algo_class(
            algo_config=algo_config.value, obs_config=obs_config.value,
            global_config=global_config, obs_key_shapes=obs_key_shapes, ac_dim=ac_dim,
            device=device, use_kernels=use_kernels)
        self.device = self.planner.device
        self.subgoal_shapes = self.planner.subgoal_shapes
        self.obs_shapes = self.planner.obs_shapes
        self.goal_shapes = self.planner.goal_shapes
        self.num_samples = int(algo_config.num_samples)
        missing = set(self.value_net.obs_shapes) - set(self.subgoal_shapes)
        if missing:
            raise ValueError(f"the value network reads {sorted(missing)}, which are not "
                             "subgoal keys: it scores the planner's subgoals")

    @property
    def nets(self):
        return nn.ModuleDict({"planner": self.planner.nets,
                              "value_net": self.value_net.nets})

    def __repr__(self):
        return (f"{type(self).__name__} (\n  planner: {self.planner!r}\n"
                f"  value_net: {self.value_net!r}\n)")

    def set_data_parallel(self, comm):
        """The planner and the value algo on the data-parallel axis @comm."""
        self.dp = comm
        self.planner.set_data_parallel(comm)
        self.value_net.set_data_parallel(comm)

    def process_batch_for_training(self, batch):
        return {"planner": self.planner.process_batch_for_training(batch),
                "value_net": self.value_net.process_batch_for_training(batch)}

    def train_on_batch(self, batch, epoch, validate=False):
        return {"planner": self.planner.train_on_batch(sub_batch(batch, "planner"), epoch,
                                                       validate),
                "value_net": self.value_net.train_on_batch(sub_batch(batch, "value_net"),
                                                           epoch, validate)}

    def log_info(self, info):
        log = OrderedDict()
        for k, v in self.planner.log_info(info["planner"]).items():
            log[f"Planner/{k}"] = v
        for k, v in self.value_net.log_info(info["value_net"]).items():
            log[f"ValueNetwork/{k}"] = v
        log["Loss"] = log.get("Planner/Loss", 0.0) + log.get("ValueNetwork/Loss", 0.0)
        return log

    def scored_subgoals(self, obs_dict, goal_dict=None):
        """(samples {key: [B, num_samples, ...]}, their values [B,
        num_samples])."""
        n = self.num_samples
        samples = self.planner.sample_subgoals(obs_dict, goal_dict, n)
        with module_mode(self.value_net.nets, False):
            values = self.value_net.get_state_value(samples).reshape(-1, n)
        return {k: v.reshape(-1, n, *v.shape[1:]) for k, v in samples.items()}, values

    def get_subgoal_predictions(self, obs_dict, goal_dict=None):
        samples, values = self.scored_subgoals(obs_dict, goal_dict)
        best = values.argmax(1)   # the first maximum, as jnp.argmax
        rows = torch.arange(best.shape[0], device=best.device)
        return {k: v[rows, best] for k, v in samples.items()}

    def sample_subgoals(self, obs_dict, goal_dict=None, num_samples=1):
        return self.planner.sample_subgoals(obs_dict, goal_dict, num_samples)

    def get_state_value(self, obs_dict, goal_dict=None):
        return self.value_net.get_state_value(obs_dict, goal_dict)

    def get_state_action_value(self, obs_dict, actions, goal_dict=None):
        return self.value_net.get_state_action_value(obs_dict, actions, goal_dict)

    def serialize(self, include_optimizer=False):
        return {"planner": self.planner.serialize(include_optimizer),
                "value_net": self.value_net.serialize(include_optimizer)}

    def deserialize(self, model_dict):
        self.planner.deserialize(model_dict["planner"])
        self.value_net.deserialize(model_dict["value_net"])

    def set_eval(self):
        self.planner.set_eval()
        self.value_net.set_eval()

    def set_train(self):
        self.planner.set_train()
        self.value_net.set_train()

    def on_epoch_end(self, epoch):
        self.planner.on_epoch_end(epoch)
        self.value_net.on_epoch_end(epoch)

    def reset(self):
        self.planner.reset()
        self.value_net.reset()

    def get_actor_goal_for_training_from_processed_batch(self, processed_batch, **kwargs):
        return self.planner.get_actor_goal_for_training_from_processed_batch(
            processed_batch["planner"], **kwargs)
