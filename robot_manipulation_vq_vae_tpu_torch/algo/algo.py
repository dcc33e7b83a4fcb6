"""Algorithm base class and registry (counterpart of the JAX package's
``algo/algo.py``): ``register_algo_factory_func`` / ``algo_factory`` and a
minimal ``Algo`` that owns its networks as ``nn.Module``s on one device.

Only serving is ported: the networks are built in eval mode, and
``train_on_batch`` comes with the training slice.
"""

from collections import OrderedDict

import torch

from robot_manipulation_vq_vae_tpu_torch import resolve_device
from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils as ObsUtils

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
    runs the plain PyTorch versions of the CUDA kernels instead."""
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
    ``self.device``, seeded from ``config.train.seed``."""

    def __init__(self, algo_config, obs_config, global_config, obs_key_shapes,
                 ac_dim, device=None, use_kernels=True):
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
        self.nets.to(self.device).eval()
        self.generator = torch.Generator(self.device).manual_seed(seed)

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

    def train_on_batch(self, batch, epoch, validate=False):
        raise NotImplementedError(
            "training is not ported yet: ROADMAP.md queues 'LipVQ backward and "
            "the paper-path training step' as the next slice"
        )

