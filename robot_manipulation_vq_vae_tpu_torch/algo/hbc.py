"""Hierarchical behavioral cloning (counterpart of the JAX package's
``algo/hbc.py``), registered as ``hbc``: a subgoal planner (``GL`` or
``GL_VAE``, by ``planner.vae.enabled``) and a ``BC_RNN`` actor conditioned on
the planner's subgoal keys as its goals.

* ``mode`` "separate": the actor trains against the batch's subgoals
  (``next_obs`` ``subgoal_horizon`` - 1 steps on); "cascade": against the
  planner's predictions on the batch, made after the planner's step (a
  ``GL_VAE``'s decode prior samples).
* ``get_action`` refreshes the subgoal on its first call after a ``reset``
  and every ``subgoal_update_interval`` calls, from the planner on the
  observations' last frame where they are stacked, and steps the actor
  (whose RNN carries its state across calls) towards it.
* ``serialize`` / ``deserialize`` nest the planner's and actor's states
  under ``planner`` and ``actor``.

Under data parallelism (``parallel.shard_state``) the planner and the
actor share the dp axis: a step takes this rank's ``shard_batch`` rows of
the nested batch, and ``get_action`` takes the rank's observation shard,
refreshes the subgoal of its rows and returns the global batch's actions on
every rank (the actor's).

``actor_use_random_subgoals`` and ``latent_subgoal.enabled``, which the JAX
class reads nowhere, raise; so do observation statistics
(``train.hdf5_normalize_obs``), which the JAX class's nested batch never
applies.
"""

from collections import OrderedDict

from robot_manipulation_vq_vae_tpu_torch.algo.algo import (
    HierarchicalAlgo,
    register_algo_factory_func,
    shard_like,
    sub_batch,
)
from robot_manipulation_vq_vae_tpu_torch.algo.bc import BC_RNN
from robot_manipulation_vq_vae_tpu_torch.algo.gl import GL, GL_VAE
from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils as ObsUtils


@register_algo_factory_func("hbc")
def algo_config_to_class(algo_config):
    planner_cls = GL_VAE if algo_config.planner.vae.enabled else GL
    return HBC, dict(planner_algo_class=planner_cls, policy_algo_class=BC_RNN)


class HBC(HierarchicalAlgo):
    """See the module docstring. ``planner`` and ``actor`` are the two
    algos; ``current_subgoal`` the subgoal the actor last stepped towards."""

    def __init__(self, algo_config, obs_config, global_config, obs_key_shapes, ac_dim,
                 planner_algo_class, policy_algo_class, device=None, use_kernels=True):
        self._init_common(algo_config, obs_config, global_config, ac_dim)
        self.planner = planner_algo_class(
            algo_config=algo_config.planner, obs_config=obs_config.planner,
            global_config=global_config, obs_key_shapes=obs_key_shapes, ac_dim=ac_dim,
            device=device, use_kernels=use_kernels)
        self._create_actor(policy_algo_class, obs_key_shapes, device, use_kernels)

    def _init_common(self, algo_config, obs_config, global_config, ac_dim):
        """The settings HBC and IRIS share, checked."""
        unported = [name for name, on in (
            ("actor_use_random_subgoals", algo_config.actor_use_random_subgoals),
            ("latent_subgoal.enabled", algo_config.latent_subgoal.enabled)) if on]
        if unported:
            raise NotImplementedError(f"{', '.join(unported)} is not taken (the JAX "
                                      f"{type(self).__name__} reads none of them)")
        if algo_config.mode not in ("separate", "cascade"):
            raise ValueError(f"algo.mode {algo_config.mode!r}: 'separate' or 'cascade'")
        self.algo_config = algo_config
        self.obs_config = obs_config
        self.global_config = global_config
        self.ac_dim = ac_dim
        self._algo_mode = algo_config.mode
        self._subgoal_update_interval = int(algo_config.subgoal_update_interval)
        self._subgoal_step_count = 0
        self._current_subgoal = None

    def _create_actor(self, policy_algo_class, obs_key_shapes, device, use_kernels):
        """The actor, its goals the planner's subgoal keys (each under its
        registered modality)."""
        self.actor_goal_shapes = self.planner.subgoal_shapes
        shapes = dict(obs_key_shapes)
        shapes.update(self.actor_goal_shapes)
        obs_config = self.obs_config.actor.deepcopy()
        with obs_config.unlocked():
            goals = {"low_dim": [], "rgb": [], "depth": [], "scan": []}
            for k in self.actor_goal_shapes:
                goals[ObsUtils.OBS_KEYS_TO_MODALITIES[k]].append(k)
            for modality, keys in goals.items():
                obs_config.modalities.goal[modality] = keys
        self.actor = policy_algo_class(
            algo_config=self.algo_config.actor, obs_config=obs_config,
            global_config=self.global_config, obs_key_shapes=shapes, ac_dim=self.ac_dim,
            device=device, use_kernels=use_kernels)

    @property
    def obs_shapes(self):
        return self.actor.obs_shapes

    def process_batch_for_training(self, batch):
        out = {"planner": self.planner.process_batch_for_training(batch),
               "actor": self.actor.process_batch_for_training(batch)}
        if self._algo_mode == "separate":
            out["actor"]["goal_obs"] = (
                self.planner.get_actor_goal_for_training_from_processed_batch(
                    out["planner"]))
        return out

    def postprocess_batch_for_training(self, batch, obs_normalization_stats=None):
        if obs_normalization_stats is not None:
            raise NotImplementedError(f"{type(self).__name__} takes no observation "
                                      "statistics (train.hdf5_normalize_obs)")
        return batch

    def train_on_batch(self, batch, epoch, validate=False):
        planner_batch, actor_batch = sub_batch(batch, "planner"), sub_batch(batch, "actor")
        info = OrderedDict(planner=self.planner.train_on_batch(planner_batch, epoch,
                                                               validate))
        if self._algo_mode == "cascade":
            actor_batch["goal_obs"] = self.planner.get_subgoal_predictions(
                planner_batch["obs"])
        info["actor"] = self.actor.train_on_batch(actor_batch, epoch, validate)
        return info

    def log_info(self, info):
        log = OrderedDict()
        for k, v in self.planner.log_info(info["planner"]).items():
            log[f"Planner/{k}"] = v
        for k, v in self.actor.log_info(info["actor"]).items():
            log[f"Actor/{k}"] = v
        log["Loss"] = log.get("Planner/Loss", 0.0) + log.get("Actor/Loss", 0.0)
        return log

    @property
    def current_subgoal(self):
        return self._current_subgoal

    def _planner_obs(self, obs_dict):
        """The planner's observations: the last frame of stacked ones."""
        out = {}
        for k, shape in self.planner.obs_shapes.items():
            v = obs_dict[k]
            out[k] = v[:, -1] if v.ndim == len(shape) + 2 else v
        return out

    def get_action(self, obs_dict, goal_dict=None):
        """The actor's action towards the current subgoal: [B, A]."""
        if (self._current_subgoal is None
                or self._subgoal_step_count % self._subgoal_update_interval == 0):
            self._current_subgoal = self.get_subgoal_predictions(
                self._planner_obs(obs_dict), goal_dict)
        self._subgoal_step_count += 1
        # under data parallelism the subgoal of this rank's rows: a shard
        return self.actor.get_action(obs_dict,
                                     goal_dict=shard_like(self._current_subgoal, obs_dict))

    def get_subgoal_predictions(self, obs_dict, goal_dict=None):
        return self.planner.get_subgoal_predictions(obs_dict, goal_dict)

    def reset(self):
        self._subgoal_step_count = 0
        self._current_subgoal = None
        self.planner.reset()
        self.actor.reset()

    def set_eval(self):
        self.planner.set_eval()
        self.actor.set_eval()

    def set_train(self):
        self.planner.set_train()
        self.actor.set_train()

    def on_epoch_end(self, epoch):
        self.planner.on_epoch_end(epoch)
        self.actor.on_epoch_end(epoch)

    def serialize(self, include_optimizer=False):
        return {"planner": self.planner.serialize(include_optimizer),
                "actor": self.actor.serialize(include_optimizer)}

    def deserialize(self, model_dict):
        self.planner.deserialize(model_dict["planner"])
        self.actor.deserialize(model_dict["actor"])

    def __repr__(self):
        return (f"{type(self).__name__} (mode={self._algo_mode})\n"
                f"planner: {self.planner!r}\nactor: {self.actor!r}")
