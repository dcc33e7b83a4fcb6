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
"""

import re
from collections import OrderedDict

import torch

from robot_manipulation_vq_vae_tpu_torch import resolve_device
from robot_manipulation_vq_vae_tpu_torch.models import base_nets as BaseNets
from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils as ObsUtils
from robot_manipulation_vq_vae_tpu_torch.utils import optim_utils as OptimUtils

# algo_name -> factory func (algo_config -> (cls, kwargs))
REGISTERED_ALGOS = {}

LANG_EMB_KEY = ObsUtils.LANG_EMB_KEY

# The one table from the port's state-dict names (``Algo.nets``) to the
# reference's (robomimic's ``ICLTransformerHVQVAE``, as the JAX package's
# ``ckpt_conversion.convert_transformer_actor`` and ``convert_hvqvae`` read
# them): the first pattern that matches a name rewrites it; a name that
# matches none (the HVQVAE's) is the same in both.
REFERENCE_NAMES = (
    (r"^policy\.net\.embedding\.embed_timestep$", "policy.params.embed_timestep"),
    (r"^policy\.net\.embedding\.", "policy.nets."),
    # an observation core's projection is the third layer of its nets
    (r"^policy\.net\.encoder\.nets\.(\w+)\.obs_nets\.([^.]+)\.proj\.",
     r"policy.nets.encoder.nets.\1.obs_nets.\2.nets.2."),
    (r"^policy\.net\.", "policy.nets."),
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

    def __init__(self, algo_config, obs_config, global_config, obs_key_shapes,
                 ac_dim, device=None, use_kernels=True):
        self._check_train_options(global_config.train)
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
        BaseNets.set_stem_pool(
            self.nets, global_config.train.get("pallas_pool", False), use_kernels
        )
        self.nets.to(self.device).eval()
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self.max_grad_norm = global_config.train.get("max_grad_norm", None)
        self.optimizers, self.lr_schedulers = {}, {}
        self._create_optimizers()
        self.global_step = 0   # training steps taken

    def _check_train_options(self, train_config):
        """Raise for a ``train`` option that changes the step and is not
        ported, rather than train something else."""
        options = ["frozen_batch_norm", "pool_free_stem", "packed_rgb_encoders"]
        if not self.MIXED_PRECISION:
            options.append("mixed_precision")
        for option in options:
            if train_config.get(option, False):
                raise NotImplementedError(
                    f"train.{option} is not ported for {type(self).__name__} "
                    "yet (ROADMAP.md)"
                )

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

    def _create_optimizers(self):
        """An optimizer and its schedule for each ``optim_params`` entry whose
        key is a network."""
        for k, optim_params in self.algo_config.optim_params.items():
            if k in self.nets:
                self.optimizers[k], self.lr_schedulers[k] = (
                    OptimUtils.optimizer_from_optim_params(
                        self.nets[k].parameters(), optim_params
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
        schedule's state dict, the step counter, the algo's generator (crops,
        k-means, dead codes) and the global generator (dropout), so that a
        resumed run draws what the uninterrupted run would have drawn."""
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
