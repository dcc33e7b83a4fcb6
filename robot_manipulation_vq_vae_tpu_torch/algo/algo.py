"""Algorithm base class and registry (counterpart of the JAX package's
``algo/algo.py``): ``register_algo_factory_func`` / ``algo_factory`` and a
minimal ``Algo`` that owns its networks as ``nn.Module``s on one device, and
their optimizers.

The networks rest in eval mode, which serving uses; ``train_on_batch``
switches them to train mode for one step (or keeps eval mode under
``no_grad`` when validating) and back.
"""

from collections import OrderedDict

import torch

from robot_manipulation_vq_vae_tpu_torch import resolve_device
from robot_manipulation_vq_vae_tpu_torch.models import base_nets as BaseNets
from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils as ObsUtils
from robot_manipulation_vq_vae_tpu_torch.utils import optim_utils as OptimUtils

# algo_name -> factory func (algo_config -> (cls, kwargs))
REGISTERED_ALGOS = {}

LANG_EMB_KEY = ObsUtils.LANG_EMB_KEY


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

    def train_on_batch(self, batch, epoch, validate=False):
        """One training step on @batch, the networks in train mode; with
        @validate, the same losses in eval mode under ``no_grad``, and
        nothing updated. The networks end in eval mode either way. Returns
        {"losses": {name: 0-d tensor}}."""
        if validate:
            self.nets.eval()
            with torch.no_grad():
                return {"losses": self._validate_step(batch)}
        self.nets.train()
        try:
            return {"losses": self._train_step(batch)}
        finally:
            self.nets.eval()

    def _train_step(self, batch):
        raise NotImplementedError

    def _validate_step(self, batch):
        raise NotImplementedError

