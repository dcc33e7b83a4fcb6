"""An image policy of the ICL family through the stem pool, the port's
against the JAX package's: ``ICLGMM`` with one 32 x 32 camera (FiLM
ResNet-18 + SpatialSoftmax, a language embedding) and ``train.pallas_pool``
(the JAX package runs its recorded-argmax pool's plain formulation on the
CPU, the port its kernels' plain versions; the observation cores' features
pass through the MLP policies' ReLU). 2 steps in float64 on both sides from
the same carried-over weights and batches: metrics within 1e-8 relative,
parameters within 1e-8 of each tensor's largest; the BatchNorm statistics
within 1e-7 (Flax's one-pass variance, E[x^2] - E[x]^2, cancels even in
float64; the port takes the two-pass variance)."""

import copy

import numpy as np
import jax

from robot_manipulation_vq_vae_tpu.config import config_factory as jax_config_factory
from robot_manipulation_vq_vae_tpu.models.base_nets import set_pallas_pool
from robot_manipulation_vq_vae_tpu.utils.ckpt_conversion import flatten_variables

import robot_manipulation_vq_vae_tpu_torch.algo as PortAlgo
from robot_manipulation_vq_vae_tpu_torch.config import config_factory
from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils as PortObsUtils
from robot_manipulation_vq_vae_tpu_torch.utils.jax_weights import load_jax_variables
from torch_port_helpers import (
    check_parameters,
    check_step_metrics,
    float64_tree,
    jax_algo_jit_init,
    perturbed_variables,
)
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

A, LR = 12, 1e-4

CAM, IMG, LANG = "agentview_image", 32, 16


def _configure_rgb(cfg):
    with cfg.values_unlocked():
        cfg.observation.modalities.obs.low_dim = ["eef_pos", "lang_emb"]
        cfg.observation.modalities.obs.rgb = [CAM]
        cfg.observation.encoder.rgb.core_class = "VisualCoreLanguageConditioned"
        cfg.observation.encoder.rgb.core_kwargs = {
            "feature_dimension": 16, "backbone_class": "ResNet18ConvFiLM",
            "backbone_kwargs": {"pretrained": False, "input_coord_conv": False},
            "pool_class": "SpatialSoftmax",
            "pool_kwargs": {"num_kp": 8, "learnable_temperature": False,
                            "temperature": 1.0, "noise_std": 0.0},
        }
        cfg.observation.encoder.rgb.obs_randomizer_class = None
        cfg.algo.gmm.enabled = True
        cfg.algo.actor_layer_dims = [16, 16]
        lr = cfg.algo.optim_params.policy.learning_rate
        lr.initial, lr.scheduler_type = LR, None
        cfg.train.max_grad_norm = 1.0
        cfg.train.pallas_pool = True
    return cfg


def test_image_gmm_policy_with_the_stem_pool_matches_jax():
    shapes = {"eef_pos": (3,), CAM: (IMG, IMG, 3), "lang_emb": (LANG,)}
    rng = np.random.RandomState(6)

    def batch():
        return {"obs": {"eef_pos": rng.randn(4, 2, 3).astype(np.float32),
                        CAM: rng.randint(0, 256, (4, 2, IMG, IMG, 3)).astype(np.uint8),
                        "lang_emb": rng.randn(4, 2, LANG).astype(np.float32)},
                "actions": rng.uniform(-1, 1, (4, 2, A)).astype(np.float32)}

    batches = [batch() for _ in range(2)]
    try:
        jax_algo = jax_algo_jit_init("icl", _configure_rgb(jax_config_factory("icl")), shapes, A)
        assert type(jax_algo).__name__ == "ICLGMM"
        jax_algo.ensure_state(jax_algo.process_batch_for_training(batches[0]))
        nested, flat = perturbed_variables(
            {"params": jax_algo.state.params["policy"], **jax_algo.state.aux["policy"]}, 7)
        with jax.enable_x64():
            nested = float64_tree(nested)
            params = nested.pop("params")
            jax_algo.state = jax_algo.state.replace(
                params={"policy": params}, aux={"policy": nested},
                opt_states={"policy": jax_algo.optimizers["policy"].init(params)})
        cfg = _configure_rgb(config_factory("icl"))
        PortObsUtils.initialize_obs_utils_with_config(cfg)
        algo = PortAlgo.algo_factory("icl", cfg, shapes, A, device="cpu")
        algo.nets.double()
        load_jax_variables(algo.nets["policy"], flat)
        pools = [m for m in algo.nets.modules() if type(m).__name__ == "StemMaxPool"]
        assert len(pools) == 1 and pools[0].recorded_argmax and pools[0].use_kernel
        metrics = []
        for b in batches:
            with jax.enable_x64():
                want = jax_algo.train_on_batch(jax_algo.process_batch_for_training(b),
                                               epoch=0)["losses"]
            got = algo.train_on_batch(algo.process_batch_for_training(b), epoch=0)["losses"]
            metrics.append(({k: float(v) for k, v in want.items()},
                            {k: float(v) for k, v in got.items()}))
        expected = copy.deepcopy(algo.nets["policy"])
        load_jax_variables(expected, flatten_variables(
            {"params": jax_algo.state.params["policy"], **jax_algo.state.aux["policy"]}))
    finally:
        set_pallas_pool(False)   # Algo.__init__ set the JAX package's flag
    check_step_metrics(metrics, ("log_probs", "action_loss", "policy_grad_norms"), 1e-8)
    check_parameters(algo.nets["policy"], expected, 1e-8)
    got, want = algo.nets["policy"].state_dict(), expected.state_dict()
    stats = [k for k in got if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * 20   # 20 BatchNorms in a ResNet-18
    for k in stats:
        err = float((got[k] - want[k]).abs().max())
        assert err <= 1e-7 * float(want[k].abs().max()), f"{k}: {err}"
