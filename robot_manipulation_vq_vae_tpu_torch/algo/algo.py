"""Algorithm base class and registry (counterpart of the JAX package's
``algo/algo.py``): ``register_algo_factory_func`` / ``algo_factory`` and a
minimal ``Algo`` that owns its networks as ``nn.Module``s on one device, and
their optimizers.

The networks rest in eval mode, which serving uses; ``set_train`` /
``set_eval`` switch them. ``train_on_batch`` runs its step in train mode (or
in eval mode under ``no_grad`` when validating) and gives the networks back
in the mode it found them in.

``serialize`` / ``deserialize`` carry the networks' state dict under the
reference's names (``REFERENCE_NAMES``), which the JAX package's checkpoint
converter reads, and optionally everything a resumed run needs.

``PolicyAlgo`` adds the action-MSE evaluation; ``ValueAlgo`` is the base of
the offline-RL family (``n_step_returns`` builds its n-step batches); and
``RolloutPolicy`` /
``ICLRolloutPolicy`` wrap an algo for stepping environments: observation
normalization, the language embedding and the context batch on the host in
numpy, one ``get_action`` on the device, the action back on the host once
per query, then unnormalization and the runtime rot_6d conversion.
"""

import copy
import re
from collections import OrderedDict

import numpy as np
import torch

from robot_manipulation_vq_vae_tpu_torch import resolve_device
from robot_manipulation_vq_vae_tpu_torch.models import base_nets as BaseNets
from robot_manipulation_vq_vae_tpu_torch.models import obs_nets as ObsNets
from robot_manipulation_vq_vae_tpu_torch.utils import action_utils as AcUtils
from robot_manipulation_vq_vae_tpu_torch.utils import mixed_precision as MixedPrecision
from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils as ObsUtils
from robot_manipulation_vq_vae_tpu_torch.utils import optim_utils as OptimUtils
from robot_manipulation_vq_vae_tpu_torch.utils import rotation_utils as RotUtils
from robot_manipulation_vq_vae_tpu_torch.utils import tensor_utils as TensorUtils

# algo_name -> factory func (algo_config -> (cls, kwargs))
REGISTERED_ALGOS = {}

LANG_EMB_KEY = ObsUtils.LANG_EMB_KEY

# The one table from the port's state-dict names (``Algo.nets``) to the
# reference's (robomimic's ICL policies, as the JAX package's
# ``ckpt_conversion.convert_transformer_actor`` and ``convert_hvqvae`` read
# the flagship's, and ``tests/test_icl_variants_parity.py`` the MLP and RNN
# policies'): the first pattern that matches a name rewrites it; a name that
# matches none (the HVQVAE's) is the same in both. The in-encoder action
# tokenizer's state, parameters and buffers alike (the bin statistics, the
# spectral-norm vectors), goes under ``policy.nets.encoder.action_network.``
# with the names its module's docstring states; the JAX package converts
# only LipVQ's. The MLP policies' layers sit at ``policy.nets.mlp._model.*``
# and ``policy.nets.decoder.nets.<head>``; the RNN policies' at
# ``policy.nets.rnn.nets.{weight,bias}_{ih,hh}_l{k}`` (``nn.LSTM``'s) and
# ``policy.nets.rnn.per_step_net.*``. The Mamba backbone and the GRU cells
# keep the port's names under ``policy.nets.`` (the reference builds them
# from other libraries).
REFERENCE_NAMES = (
    (r"^policy\.net\.embedding\.embed_timestep$", "policy.params.embed_timestep"),
    (r"^policy\.net\.embedding\.", "policy.nets."),
    # an observation core's projection is the third layer of its nets
    (r"^policy\.(?:net\.)?encoder\.nets\.(\w+)\.obs_nets\.([^.]+)\.proj\.",
     r"policy.nets.encoder.nets.\1.obs_nets.\2.nets.2."),
    (r"^policy\.net\.", "policy.nets."),
    # the RNN policies: encoder, RNN and per-step head
    (r"^policy\.(encoder|rnn)\.", r"policy.nets.\1."),
    (r"^policy\.per_step_net\.", "policy.nets.rnn.per_step_net."),
    # the offline-RL family (robomimic's names: the critics and their
    # targets in ModuleLists, each network's layers under nets.); the VAE
    # action sampler keeps the port's names, as BC_VAE's policy does
    (r"^(actor|actor_target|action_sampler|vf|critic\.\d+|critic_target\.\d+)\."
     r"(?:nets?\.)?encoder\.nets\.(\w+)\.obs_nets\.([^.]+)\.proj\.",
     r"\1.nets.encoder.nets.\2.obs_nets.\3.nets.2."),
    (r"^(actor|actor_target|action_sampler)\.net\.", r"\1.nets."),
)


def reference_name(name):
    """The reference's name of the port's state-dict entry @name."""
    for pattern, repl in REFERENCE_NAMES:
        if re.match(pattern, name):
            return re.sub(pattern, repl, name)
    return name


def register_algo_factory_func(algo_name):
    def decorator(factory_func):
        REGISTERED_ALGOS[algo_name] = factory_func
        return factory_func

    return decorator


def algo_factory(algo_name, config, obs_key_shapes, ac_dim, device=None,
                 use_kernels=True):
    """Instantiate the algo class for @algo_name on @device (``cuda`` unless
    given; raises when there is no card and no device). ``use_kernels=False``
    runs the plain PyTorch versions of the CUDA kernels instead. The stem
    pool's kernels run only where ``config.train.pallas_pool`` asks for the
    recorded-argmax pool."""
    if algo_name not in REGISTERED_ALGOS:
        raise ValueError(
            f"algo '{algo_name}' not registered; have {sorted(REGISTERED_ALGOS)}"
        )
    algo_cls, _ = REGISTERED_ALGOS[algo_name](config.algo)
    return algo_cls(
        algo_config=config.algo,
        obs_config=config.observation,
        global_config=config,
        obs_key_shapes=obs_key_shapes,
        ac_dim=ac_dim,
        device=device,
        use_kernels=use_kernels,
    )


def device_process_obs(obs_dict, device):
    """Move observations to @device; uint8 images travel as uint8 and become
    float32 / 255 there. Everything else becomes float32."""
    out = {}
    for k, v in obs_dict.items():
        v = torch.as_tensor(v).to(device, non_blocking=True)
        out[k] = v.float() / 255.0 if v.dtype == torch.uint8 else v.float()
    return out


class Algo:
    """Base algorithm: networks in ``self.nets`` (an ``nn.ModuleDict``) on
    ``self.device``, seeded from ``config.train.seed``; an optimizer and a
    learning-rate schedule per ``optim_params`` entry that names a network;
    ``self.generator`` (on the device) draws the training randomness the
    networks take explicitly (the random crops)."""

    # whether the class ports ``train.mixed_precision``
    MIXED_PRECISION = False
    # whether get_action takes a context batch (ICLRolloutPolicy wraps it)
    TAKES_CONTEXT = False
    # counters of the algo's own (attribute names) that a resumed run needs:
    # ``serialize`` saves them with the optimizers, ``deserialize`` restores
    TRAINING_COUNTERS = ()

    def __init__(self, algo_config, obs_config, global_config, obs_key_shapes,
                 ac_dim, device=None, use_kernels=True):
        self._check_train_options(global_config.train)
        self.mixed_precision = bool(global_config.train.get("mixed_precision", False))
        self.device = resolve_device(device)
        self.algo_config = algo_config
        self.obs_config = obs_config
        self.global_config = global_config
        self.ac_dim = ac_dim
        self.use_kernels = use_kernels
        seed = int(global_config.train.seed)

        self._create_shapes(obs_config.modalities, obs_key_shapes)
        self.nets = torch.nn.ModuleDict()
        # weights are drawn on the CPU from the seed, whatever the device, and
        # without touching the caller's global generator
        with torch.random.fork_rng(devices=[]):
            torch.random.default_generator.manual_seed(seed)
            self._create_networks()
        self._set_train_modes(global_config.train)
        self.nets.to(self.device).eval()
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self.max_grad_norm = global_config.train.get("max_grad_norm", None)
        self.optimizers, self.lr_schedulers = {}, {}
        self._create_optimizers()
        self.global_step = 0   # training steps taken

    def _check_train_options(self, train_config):
        """Raise for a ``train`` option that changes the step and is not
        ported for this class, rather than train something else."""
        if train_config.get("mixed_precision", False) and not self.MIXED_PRECISION:
            raise NotImplementedError(
                f"train.mixed_precision is not ported for {type(self).__name__} "
                "yet (ROADMAP.md)"
            )

    def _set_train_modes(self, train_config):
        """Apply the model-level ``train`` options to ``self.nets``, each on
        this algo's modules only (the JAX package sets them process-wide):
        the stem pool's recorded-argmax kernels (``pallas_pool``), frozen
        BatchNorm statistics, the pool-free stride-4 stem, and the packed
        per-camera FiLM trunks. ``train.mixed_precision`` is refused for the
        cores and randomizers it has not been held against JAX with."""
        unported = self.mixed_precision and ObsNets.unported_in_mixed_precision(self.nets)
        if unported:
            raise NotImplementedError(
                f"train.mixed_precision is not ported for {', '.join(unported)} yet "
                "(ROADMAP.md)")
        BaseNets.set_stem_pool(self.nets, train_config.get("pallas_pool", False),
                               self.use_kernels)
        BaseNets.set_frozen_batch_norm(
            self.nets, train_config.get("frozen_batch_norm", False))
        BaseNets.set_pool_free_stem(self.nets, train_config.get("pool_free_stem", False))
        ObsNets.set_packed_rgb_encoders(
            self.nets, train_config.get("packed_rgb_encoders", False))

    def _create_shapes(self, obs_keys, obs_key_shapes):
        """Split obs_key_shapes into obs / goal dicts by the modality config."""
        self.obs_shapes = OrderedDict()
        self.goal_shapes = OrderedDict()
        for k in obs_key_shapes:
            for group, target in (("obs", self.obs_shapes),
                                  ("goal", self.goal_shapes)):
                if group in obs_keys and k in [
                    obs_key for modality in obs_keys[group].values()
                    for obs_key in modality
                ]:
                    target[k] = obs_key_shapes[k]
        if self.algo_config.get("language_conditioned", False):
            self.obs_shapes[LANG_EMB_KEY] = [768]  # CLIP text embedding dim

    def _create_networks(self):
        raise NotImplementedError

    def _encoder_kwargs(self):
        """The observation encoders' per-modality settings."""
        return ObsUtils.obs_encoder_kwargs_from_config(self.obs_config.encoder)

    def _num_training_steps(self):
        """``train.num_epochs * experiment.epoch_every_n_steps`` (the cosine
        schedule's horizon), or None where either is unset."""
        try:
            return int(self.global_config.train.num_epochs
                       * self.global_config.experiment.epoch_every_n_steps)
        except (AttributeError, KeyError, TypeError):
            return None

    def _create_optimizers(self):
        """An optimizer and its schedule for each ``optim_params`` entry whose
        key is a network."""
        for k, optim_params in self.algo_config.optim_params.items():
            if k in self.nets:
                self.optimizers[k], self.lr_schedulers[k] = (
                    OptimUtils.optimizer_from_optim_params(
                        self.nets[k].parameters(), optim_params,
                        self._num_training_steps(),
                    )
                )

    def _step(self, name, params, grads):
        """One step of optimizer @name with @grads on @params, then one step
        of its schedule, if it has one."""
        for p, g in zip(params, grads):
            p.grad = g
        self.optimizers[name].step()
        if name in self.lr_schedulers:
            self.lr_schedulers[name].step()

    def process_batch_for_training(self, batch):
        return batch

    def postprocess_batch_for_training(self, batch, obs_normalization_stats=None):
        """Host-side work after ``process_batch_for_training``: the observation
        normalization, where statistics are given (images become float / 255
        on the device, in the step)."""
        if obs_normalization_stats is not None:
            for group in ("obs", "goal_obs", "next_obs"):
                if batch.get(group) is not None:
                    batch[group] = ObsUtils.normalize_dict(batch[group],
                                                           obs_normalization_stats)
        return batch

    def set_train(self):
        self.nets.train()

    def set_eval(self):
        self.nets.eval()

    def on_epoch_end(self, epoch):
        pass

    def reset(self):
        """Called at the start of each rollout episode."""

    def train_on_batch(self, batch, epoch, validate=False):
        """One training step on @batch, the networks in train mode; with
        @validate, the same losses in eval mode under ``no_grad``, and
        nothing updated. The networks end in the mode they were in. Returns
        {"losses": {name: 0-d tensor}}."""
        was_training = self.nets.training
        try:
            if validate:
                self.nets.eval()
                with torch.no_grad():
                    return {"losses": self._validate_step(batch)}
            self.nets.train()
            losses = self._train_step(batch)
            self.global_step += 1
            return {"losses": losses}
        finally:
            self.nets.train(was_training)

    # ------------------------------------------------------------ checkpoints
    def _reference_names(self):
        """{port state-dict name: reference name} over ``self.nets``."""
        names = {k: reference_name(k) for k in self.nets.state_dict()}
        if len(set(names.values())) != len(names):
            raise RuntimeError("REFERENCE_NAMES maps two entries to one name")
        return names

    def _rng_state(self):
        """The state of the global generator that dropout draws from."""
        if self.device.type == "cuda":
            return torch.cuda.get_rng_state(self.device)
        return torch.get_rng_state()

    def serialize(self, include_optimizer=False):
        """The networks' state dict under the reference's names (BatchNorm
        statistics and the HVQVAE's EMA buffers included), copied to the CPU.
        With @include_optimizer, also ``training_state``: each optimizer's and
        schedule's state dict, the step counter and the ``TRAINING_COUNTERS``,
        the algo's generator (crops, k-means, dead codes) and the global
        generator (dropout), so that a resumed run draws what the
        uninterrupted run would have drawn."""
        names = self._reference_names()
        out = OrderedDict((names[k], v.detach().cpu().clone())
                          for k, v in self.nets.state_dict().items())
        if include_optimizer:
            out["training_state"] = {
                "optimizers": {n: _to_cpu(o.state_dict())
                               for n, o in self.optimizers.items()},
                "lr_schedulers": {n: s.state_dict()
                                  for n, s in self.lr_schedulers.items()},
                "step": self.global_step,
                **{name: getattr(self, name) for name in self.TRAINING_COUNTERS},
                "generator": self.generator.get_state(),
                "rng_state": self._rng_state(),
            }
        return out

    def deserialize(self, model_dict):
        """Load what ``serialize`` wrote (strictly: every entry, no other).
        A ``training_state`` restores the optimizers, schedules, step counter
        and generators too."""
        port_name = {ref: k for k, ref in self._reference_names().items()}
        weights = {k: v for k, v in model_dict.items() if k != "training_state"}
        unknown = sorted(set(weights) - set(port_name))
        if unknown:
            raise KeyError(f"checkpoint entries this algo does not have: {unknown[:5]}")
        self.nets.load_state_dict({port_name[k]: torch.as_tensor(v)
                                   for k, v in weights.items()})
        state = model_dict.get("training_state")
        if state is None:
            return
        for n, sd in state["optimizers"].items():
            self.optimizers[n].load_state_dict(sd)
        for n, sd in state["lr_schedulers"].items():
            self.lr_schedulers[n].load_state_dict(sd)
        self.global_step = int(state["step"])
        for name in self.TRAINING_COUNTERS:
            setattr(self, name, int(state[name]))
        self.generator.set_state(torch.as_tensor(state["generator"]))
        rng = torch.as_tensor(state["rng_state"])
        if self.device.type == "cuda":
            torch.cuda.set_rng_state(rng, self.device)
        else:
            torch.set_rng_state(rng)

    def _train_step(self, batch):
        raise NotImplementedError

    def _validate_step(self, batch):
        raise NotImplementedError


def _to_cpu(tree):
    """A copy of @tree (dicts, lists, tensors) with every tensor on the CPU."""
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    return tree


def to_host(action):
    """An action batch as numpy: a tensor leaves its device once."""
    if isinstance(action, torch.Tensor):
        return action.detach().cpu().numpy()
    return np.asarray(action)


class PolicyAlgo(Algo):
    """Base of the policy algorithms (the port's are the ICL policies: the
    transformer and Mamba ones take a context batch in ``get_action``
    (``TAKES_CONTEXT``) and ``_select_output`` picks the predicted step of
    a window; the MLP and RNN ones take observations alone): the training
    steps' policy call, in mixed precision where asked, and the action-MSE
    evaluation."""

    def _dtype(self):
        return next(self.nets.parameters()).dtype

    def _obs(self, obs_dict):
        """Observations on the device in the networks' dtype (float64 after
        ``nets.double()``), or None."""
        if obs_dict is None:
            return None
        return {k: v.to(self._dtype())
                for k, v in device_process_obs(obs_dict, self.device).items()}

    def _device_batch(self, batch):
        """(observations, actions) on the device, in the networks' dtype
        (``nets.double()`` runs the step in float64)."""
        actions = torch.as_tensor(batch["actions"]).to(
            self.device, torch.float32, non_blocking=True).to(self._dtype())
        return self._obs(batch["obs"]), actions

    def _draw(self, value):
        """A random draw injected by a test's hook, on the device; floating
        ones in the networks' dtype."""
        value = torch.as_tensor(value).to(self.device)
        return value.to(self._dtype()) if value.is_floating_point() else value

    def _policy_step(self, losses):
        """The backward of ``losses["action_loss"]`` into the policy's
        parameters (a parameter without gradient gets zeros, as optax steps
        it), their global norm, clipping to ``train.max_grad_norm`` and one
        step of the policy's optimizer. Returns the detached losses and
        ``policy_grad_norms``."""
        params = list(self.nets["policy"].parameters())
        grads = torch.autograd.grad(losses["action_loss"], params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        metrics = OrderedDict((k, v.detach()) for k, v in losses.items())
        metrics["policy_grad_norms"] = OptimUtils.global_norm(grads)
        if self.max_grad_norm is not None:
            OptimUtils.clip_by_global_norm_(grads, self.max_grad_norm)
        self._step("policy", params, grads)
        return metrics

    def _policy_call(self, *args, **kwargs):
        """``self.nets["policy"](*args, **kwargs)`` in a training step. Under
        ``train.mixed_precision`` the policy runs as the JAX steps run it:
        on bf16 copies of its parameters and floating inputs, each layer in
        the type that JAX's promotion gives it, and its outputs cast back
        to fp32 (``utils/mixed_precision.py``)."""
        policy = self.nets["policy"]
        if not self.mixed_precision:
            return policy(*args, **kwargs)
        return MixedPrecision.full(MixedPrecision.half_call(policy, args, kwargs))

    def _predict_actions_for_mse(self, batch):
        """Predicted actions (numpy) for an MSE batch: ``get_action`` over the
        batch's observations, with the batch as its own context where the
        policy takes one."""
        if not self.TAKES_CONTEXT:
            return to_host(self.get_action(batch["obs"]))
        ctx = {"actions": batch["actions"], "obs": batch["obs"]}
        return to_host(self.get_action(batch["obs"], context_batch=ctx))

    def compute_mse_visualize(self, trainset, validset, num_samples, savedir=None):
        """Action-prediction MSE and accuracy@{1e-3, 1e-4, 1e-5} over
        @num_samples windows of each dataset (drawn with RandomState(0)), and
        with @savedir a plot of actual against predicted actions per dataset.
        A window of actions is held at the step ``get_action`` predicts (the
        JAX package reshapes the window to the prediction's shape, which
        raises for a window of more than one step). Returns (mse_log,
        {plot name: path})."""
        from robot_manipulation_vq_vae_tpu_torch.data.loader import collate
        from robot_manipulation_vq_vae_tpu_torch.utils import vis_utils as VisUtils

        self.set_eval()
        random_state = np.random.RandomState(0)
        mapping = {"Train": trainset}
        if validset is not None:
            mapping["Valid"] = validset
        mse_log, vis_log = {}, {}
        for key, dataset in mapping.items():
            idx = random_state.choice(len(dataset), min(len(dataset), num_samples),
                                      replace=False)
            batch = self.process_batch_for_training(
                collate([dataset[int(i)] for i in idx]))
            actual = np.asarray(batch["actions"])
            pred = self._predict_actions_for_mse(batch)
            if pred.shape != actual.shape:
                actual = self._select_output(actual)
            mse = (pred - actual) ** 2
            mse_log[f"{key}/action_mse_error"] = float(np.mean(mse))
            for thr in np.logspace(-3, -5, num=3).tolist():
                mse_log[f"{key}/action_accuracy@{thr}"] = float(np.mean(mse < thr))
            if savedir is not None:
                flat_actual = actual.reshape(-1, actual.shape[-1])
                save_path = f"{savedir}/{key.lower()}_pred.png"
                VisUtils.make_model_prediction_plot(
                    hdf5_path=getattr(dataset, "hdf5_path", ""), save_path=save_path,
                    action_names=[f"a{i}" for i in range(flat_actual.shape[-1])],
                    actual_actions=flat_actual,
                    predicted_actions=pred.reshape(-1, pred.shape[-1]))
                vis_log[f"{key.lower()}_pred"] = save_path
        return mse_log, vis_log


class ValueAlgo(Algo):
    """Base of the value-learning algos, the offline-RL family (``iql``,
    ``td3_bc``, ``cql``, ``bcq``; each also a ``PolicyAlgo``):
    ``get_state_value`` / ``get_state_action_value``, and what their steps
    share.

    * ``train_on_batch`` runs ``_rl_step(batch, gates, validate)`` on the
      batch (s, a, r, s', done) on the device. Each network runs in the mode
      the JAX step gives it: those named in ``TRAIN_MODE_NETS`` in training
      mode, the others (critics, targets, V) in inference mode. With
      @validate the step computes the same losses under ``no_grad`` and
      updates nothing, as the JAX step does.
    * ``gates``: whether each ``optim_params`` entry's ``start_epoch`` /
      ``end_epoch`` window (-1 unbounded) is open at the batch's epoch; a
      closed window skips that network's update (TD3-BC, BCQ).
    * ``_add_optimizer`` / ``_update``: an optimizer per network (each critic
      of an ensemble its own, so clipping takes each one's global norm), and
      one gradient step of a loss into its parameters.
    * Target networks copy the online ones at construction, take no
      gradient, and move by ``iql.polyak`` over the parameters.
    """

    # the networks the JAX step runs with train=True
    TRAIN_MODE_NETS = ()
    # the metric ``log_info`` reports as ``Loss``
    LOSS_KEY = "actor/loss"

    def __init__(self, *args, **kwargs):
        self._opt_params, self._max_norm = {}, {}
        super().__init__(*args, **kwargs)
        if self.goal_shapes:
            raise NotImplementedError(
                f"goal-conditioned {type(self).__name__} is not ported (the JAX step "
                "passes no goals to its networks)")

    def get_state_value(self, obs_dict, goal_dict=None):
        raise NotImplementedError

    def get_state_action_value(self, obs_dict, actions, goal_dict=None):
        raise NotImplementedError

    # ------------------------------------------------------------ optimizers
    def _add_optimizer(self, name, module, optim_params, max_grad_norm=None):
        """Optimizer @name (and its schedule) over @module's parameters,
        their gradients clipped to @max_grad_norm by their global norm."""
        params = list(module.parameters())
        self.optimizers[name], self.lr_schedulers[name] = (
            OptimUtils.optimizer_from_optim_params(params, optim_params,
                                                   self._num_training_steps()))
        self._opt_params[name], self._max_norm[name] = params, max_grad_norm

    def _update(self, name, loss, validate, gate=True):
        """One step of optimizer @name on the gradient of @loss, unless
        @validate or the network's epoch @gate is closed."""
        if validate or not gate:
            return
        params = self._opt_params[name]
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        if self._max_norm[name] is not None:
            OptimUtils.clip_by_global_norm_(grads, self._max_norm[name])
        self._step(name, params, grads)

    @staticmethod
    def _target_of(module):
        """A frozen copy of @module: a target network."""
        target = copy.deepcopy(module)
        target.requires_grad_(False)
        return target

    def _check_epoch(self, net_name, epoch):
        """Whether @net_name's ``optim_params`` window is open at @epoch."""
        p = self.algo_config.optim_params[net_name]
        start, end = p.get("start_epoch", -1), p.get("end_epoch", -1)
        return (start == -1 or epoch >= start) and (end == -1 or epoch < end)

    def _epoch_gates(self, epoch):
        return {name: self._check_epoch(name, epoch)
                for name in self.algo_config.optim_params}

    # ------------------------------------------------------------ steps
    def _rl_batch(self, batch):
        """(s, a, r, s', done) on the device in the networks' dtype (the
        actions read in float32 first, as the policies read them)."""
        def to_device(v):
            return torch.as_tensor(v).to(self.device, self._dtype(), non_blocking=True)

        actions = torch.as_tensor(batch["actions"]).to(self.device, torch.float32,
                                                       non_blocking=True)
        return {"obs": self._obs(batch["obs"]), "next_obs": self._obs(batch["next_obs"]),
                "actions": actions.to(self._dtype()), "rewards": to_device(batch["rewards"]),
                "dones": to_device(batch["dones"])}

    def train_on_batch(self, batch, epoch, validate=False):
        was_training = self.nets.training
        try:
            self.nets.eval()
            for name in self.TRAIN_MODE_NETS:
                if name in self.nets:
                    self.nets[name].train()
            with torch.set_grad_enabled(not validate):
                losses = self._rl_step(self._rl_batch(batch), self._epoch_gates(epoch),
                                       validate)
            if not validate:
                self.global_step += 1
            return {"losses": OrderedDict((k, v.detach()) for k, v in losses.items())}
        finally:
            self.nets.train(was_training)

    def _rl_step(self, batch, gates, validate):
        raise NotImplementedError

    def log_info(self, info):
        """Every metric as a float, and ``Loss`` (``LOSS_KEY``'s)."""
        log = OrderedDict((k, float(v)) for k, v in info["losses"].items())
        log["Loss"] = log.get(self.LOSS_KEY, 0.0)
        return log

    def _hooked(self, name):
        """The draws that the test seam @name (``_noise_hook``,
        ``_sample_hook``) injects, on the device (arrays, or tuples or dicts
        of them), or None where it is unset."""
        def to_device(v):
            if isinstance(v, dict):
                return {k: to_device(x) for k, x in v.items()}
            if isinstance(v, tuple):
                return tuple(to_device(x) for x in v)
            return self._draw(v)

        hook = getattr(self, name)
        return None if hook is None else to_device(hook())


def n_step_returns(batch, n_step, gamma, infinite_horizon=False):
    """The first step of each window (s, a), the discounted sum of its first
    @n_step rewards, done where any of those steps is, and s' @n_step - 1
    steps on (the JAX TD3-BC / BCQ / CQL ``process_batch_for_training``).
    With @infinite_horizon a done row's return is scaled by
    1 / (1 - gamma^n). Works on numpy arrays and on tensors."""
    xp = torch if isinstance(batch["rewards"], torch.Tensor) else np
    rewards = batch["rewards"][:, :n_step]
    discounts = gamma ** np.arange(n_step)
    if xp is torch:
        discounts = torch.as_tensor(discounts, dtype=rewards.dtype, device=rewards.device)
    r = (rewards * discounts[None]).sum(1).reshape(-1, 1)
    dones = batch["dones"][:, :n_step].any(1)
    dones = (dones.float() if xp is torch else dones.astype(np.float32)).reshape(-1, 1)
    if infinite_horizon:
        r = xp.where(dones > 0, r / (1.0 - gamma ** n_step), r)
    return {"obs": {k: v[:, 0] for k, v in batch["obs"].items()},
            "next_obs": {k: v[:, n_step - 1] for k, v in batch["next_obs"].items()},
            "goal_obs": batch.get("goal_obs", None),
            "actions": batch["actions"][:, 0], "rewards": r, "dones": dones}


# ---------------------------------------------------------------------------
# rollout wrappers
# ---------------------------------------------------------------------------

class RolloutPolicy:
    """Wraps an algo for env stepping: normalize the observations, add the
    episode's language embedding, query ``get_action`` (on the algo's
    device), bring the actions to the host, unnormalize them and convert
    rot_6d at runtime. All but the query is numpy on the host.

    The language embedding is tiled over the observations' leading
    dimensions, which come from an observation whose per-frame shape the
    algo knows (``algo.obs_shapes``): [N] for a batch of envs, then [T] when
    frames are stacked. (The JAX package takes them from whichever key comes
    first, and so from an image's rows when that key is an image and frames
    are not stacked.)
    """

    def __init__(self, policy, obs_normalization_stats=None,
                 action_normalization_stats=None, lang_encoder=None):
        self.policy = policy
        self.obs_normalization_stats = obs_normalization_stats
        self.action_normalization_stats = action_normalization_stats
        self.lang_encoder = lang_encoder
        self._ep_lang_emb = None

    def start_episode(self, lang=None):
        if self.lang_encoder is not None and lang is not None:
            self._ep_lang_emb = np.asarray(self.lang_encoder.get_lang_emb(lang))
        self.policy.set_eval()
        self.policy.reset()

    def _lead_shape(self, ob):
        """The leading dimensions of @ob's values past each key's frame."""
        shapes = getattr(self.policy, "obs_shapes", None) or {}
        for k, v in ob.items():
            if k in shapes and k != LANG_EMB_KEY:
                return np.shape(v)[:np.ndim(v) - len(shapes[k])]
        raise ValueError(f"no observation of a shape the policy knows among {sorted(ob)}")

    def _prepare_observation(self, ob, batched=False):
        """@ob as the algo takes it: normalized, with the language embedding,
        and with a batch dimension added unless @batched ([N, ...] across a
        vector env)."""
        ob = dict(ob)
        if self.obs_normalization_stats is not None:
            ob = ObsUtils.normalize_dict(ob, self.obs_normalization_stats)
        if self._ep_lang_emb is not None:
            emb = self._ep_lang_emb
            ob[LANG_EMB_KEY] = np.ascontiguousarray(
                np.broadcast_to(emb, self._lead_shape(ob) + emb.shape))
        if not batched:
            return {k: np.asarray(v)[None] for k, v in ob.items()}
        return {k: np.asarray(v) for k, v in ob.items()}

    def _unnormalize_action(self, ac):
        if self.action_normalization_stats is None:
            return ac
        train = self.policy.global_config.train
        action_shapes = {
            k: np.asarray(self.action_normalization_stats[k]["offset"]).shape[1:]
            for k in self.action_normalization_stats
        }
        ac_dict = AcUtils.vector_to_action_dict(ac, action_shapes=action_shapes,
                                                action_keys=train.action_keys)
        ac_dict = ObsUtils.unnormalize_dict(ac_dict, self.action_normalization_stats)
        for key, value in ac_dict.items():
            if train.action_config.get(key, {}).get("format", None) != "rot_6d":
                continue
            conv = train.action_config[key].get("convert_at_runtime", "rot_axis_angle")
            if conv == "rot_axis_angle":
                ac_dict[key] = RotUtils.rot_6d_to_axis_angle(value).astype(value.dtype)
            elif conv == "rot_euler":
                ac_dict[key] = RotUtils.rot_6d_to_euler_angles(value, "XYZ").astype(
                    value.dtype)
            else:
                raise ValueError(conv)
        return AcUtils.action_dict_to_vector(ac_dict, action_keys=train.action_keys)

    def _finish(self, ac, batched):
        ac = to_host(ac)
        return self._unnormalize_action(ac if batched else ac[0])

    def __call__(self, ob, goal=None, batched=False):
        ob = self._prepare_observation(ob, batched=batched)
        if goal is not None:
            goal = self._prepare_observation(goal, batched=batched)
        return self._finish(self.policy.get_action(obs_dict=ob, goal_dict=goal), batched)


class ICLRolloutPolicy(RolloutPolicy):
    """Adds the in-context batch to every action query. In a batched query
    a context of one demo ([1, ...]) serves every env: it is tiled to the
    batch."""

    def __call__(self, ob, context_batch, goal=None, batched=False):
        ob = self._prepare_observation(ob, batched=batched)
        if goal is not None:
            goal = self._prepare_observation(goal, batched=batched)
        if batched and context_batch is not None:
            n = len(next(iter(ob.values())))

            def tile(v):
                v = np.asarray(v)
                return np.repeat(v, n, axis=0) if v.shape[0] == 1 else v

            context_batch = TensorUtils.map_tensor(context_batch, tile)
        return self._finish(self.policy.get_action(
            obs_dict=ob, context_batch=context_batch, goal_dict=goal), batched)


def rollout_policy_class(algo):
    """The rollout wrapper of @algo: ``ICLRolloutPolicy`` where its
    ``get_action`` takes a context window (the transformer and Mamba ICL
    policies), else ``RolloutPolicy`` (the MLP and RNN ICL policies)."""
    return ICLRolloutPolicy if algo.TAKES_CONTEXT else RolloutPolicy
