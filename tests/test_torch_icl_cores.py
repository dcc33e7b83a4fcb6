"""The slice as a whole: ``icl_gmm_paper`` on ResNet-34 FiLM trunks with a
crop and ColorRandomizer's defaults (chip_smoke.py phase 16a's
configuration) against the JAX package's, for 3 ``train_on_batch`` steps
from the same carried-over weights and numpy batches, at a small size: one
40 x 40 camera cropped to 36 (the trunk's output 2 x 2, so the keypoints
pass gradient into it), 2 GPT layers of width 32, T = 3, B = 4, LipVQ,
``train.pallas_pool``. (The JAX step is slow on the CPU in float64: the
compile of its step and of its initialization take most of this file's
time, XLA's float64 convolutions most of the rest.)

The randomizers' draws are pinned: ``PinnedJaxRandom`` stands for ``jax``
inside the JAX package's ``obs_core`` while its step is traced (once; the
same crop offsets, jitter factors and orders are then constants of every
step; the jitter's ``lax.switch`` takes the pinned order's branch and
traces none of the other 23), and the port's randomizers replay its log
step after step in the same order (query group, then context group; crop,
then color). The JAX
step runs the forward a second time for the LipVQ loss, with the same keys;
that loss reads only the actions, so the second forward's pinned draws
reach nothing. Both sides
run in float64, as tests/test_torch_icl_gmm_train.py, whose docstring says
why, and are held at its tolerances: metrics within 1e-4; at least 99 % of
each parameter within 1e-5 and all within 2 lr per step; at least 95 % of
each BatchNorm statistic within 1e-5 and all within 1e-4.

Also: ``train.mixed_precision`` builds and trains every core (each is held
against the JAX bf16 step in tests/test_torch_bf16_cores.py), and this one
against JAX with, naming it."""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robot_manipulation_vq_vae_tpu.config import config_factory as jax_config_factory
from robot_manipulation_vq_vae_tpu.models import obs_core as JaxObsCore
from robot_manipulation_vq_vae_tpu.models.base_nets import set_pallas_pool
from robot_manipulation_vq_vae_tpu.utils import obs_utils as JaxObsUtils
from robot_manipulation_vq_vae_tpu.utils.ckpt_conversion import flatten_variables

import robot_manipulation_vq_vae_tpu_torch.algo as PortAlgo
from robot_manipulation_vq_vae_tpu_torch.config import config_factory
from robot_manipulation_vq_vae_tpu_torch.models import base_nets as PortBaseNets
from robot_manipulation_vq_vae_tpu_torch.models import obs_core as PortObsCore
from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils as PortObsUtils
from robot_manipulation_vq_vae_tpu_torch.utils.jax_weights import load_jax_variables
from torch_port_helpers import (
    PinnedJaxRandom,
    assert_mostly_close,
    jax_algo_jit_init,
    perturbed_variables,
    port_draws,
)
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

B, T, A, LANG, IMG, CROP, STEPS, LR = 4, 3, 12, 16, 40, 36, 3, 1e-4
CAM = "agentview_image"
LOW_DIM = {"eef_pos": (3,), "gripper_qpos": (2,)}
OBS_KEY_SHAPES = {**LOW_DIM, CAM: (IMG, IMG, 3), "lang_emb": (LANG,)}
METRICS = ("log_probs", "action_loss", "policy_grad_norms", "vq_vae_loss")


def _configure(cfg, backbone="ResNet34ConvFiLM", mixed_precision=False):
    with cfg.values_unlocked():
        cfg.observation.modalities.obs.low_dim = list(LOW_DIM) + ["lang_emb"]
        cfg.observation.modalities.obs.rgb = [CAM]
        cfg.observation.encoder.rgb.core_class = "VisualCoreLanguageConditioned"
        cfg.observation.encoder.rgb.core_kwargs = {
            "feature_dimension": 64, "backbone_class": backbone,
            "backbone_kwargs": {"pretrained": False, "input_coord_conv": False},
            "pool_class": "SpatialSoftmax",
            "pool_kwargs": {"num_kp": 32, "learnable_temperature": False,
                            "temperature": 1.0, "noise_std": 0.0},
        }
        cfg.observation.encoder.rgb.obs_randomizer_class = ["CropRandomizer",
                                                            "ColorRandomizer"]
        cfg.observation.encoder.rgb.obs_randomizer_kwargs = [
            {"crop_height": CROP, "crop_width": CROP, "num_crops": 1, "pos_enc": False},
            {}]   # ColorRandomizer's defaults
        tc = cfg.algo.transformer
        tc.context_length, tc.embed_dim, tc.num_layers, tc.num_heads = T, 32, 2, 4
        tc.emb_dropout = tc.attn_dropout = tc.block_output_dropout = 0.0
        lr = cfg.algo.optim_params.policy.learning_rate
        lr.initial, lr.scheduler_type = LR, None
        cfg.algo.optim_params.policy.regularization.L2 = 1e-2
        cfg.train.max_grad_norm = 1.0
        cfg.train.pallas_pool = True
        cfg.train.mixed_precision = mixed_precision
    return cfg


def _batch(rng):
    obs = {k: rng.randn(B, T, *s).astype(np.float32) for k, s in LOW_DIM.items()}
    obs[CAM] = rng.randint(0, 256, (B, T, IMG, IMG, 3)).astype(np.uint8)
    obs["lang_emb"] = rng.randn(B, T, LANG).astype(np.float32)
    return {"obs": obs, "actions": rng.uniform(-1, 1, (B, T, A)).astype(np.float32)}


@pytest.fixture(scope="module")
def run():
    rng = np.random.RandomState(0)
    batches = [_batch(rng) for _ in range(STEPS)]
    mp = pytest.MonkeyPatch()
    jax_cfg = _configure(jax_config_factory("icl_gmm_paper"))
    JaxObsUtils.initialize_obs_utils_with_config(jax_cfg)
    try:
        jax_algo = jax_algo_jit_init("icl_gmm_paper", jax_cfg, OBS_KEY_SHAPES, A)
        jax_algo.ensure_state(batches[0])
        variables = {"params": jax_algo.state.params["policy"],
                     **jax_algo.state.aux["policy"]}
        nested, flat = perturbed_variables(variables, 5, kernel_scale=10.0,
                                           scale_under="net/transformer/")
        with jax.enable_x64():
            nested = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), nested)
            params = nested.pop("params")
            jax_algo.state = jax_algo.state.replace(
                params={"policy": params}, aux={"policy": nested},
                opt_states={
                    "policy": jax_algo.optimizers["policy"].init(params),
                    "vq_tokenizer": jax_algo.optimizers["vq_tokenizer"].init(
                        params["net"]["encoder"]["action_network"]),
                },
            )
        port_cfg = _configure(config_factory("icl_gmm_paper"))
        PortObsUtils.initialize_obs_utils_with_config(port_cfg)
        algo = PortAlgo.algo_factory("icl_gmm_paper", port_cfg, OBS_KEY_SHAPES, A,
                                     device="cpu")
        algo.nets.double()
        load_jax_variables(algo.nets["policy"], flat)

        shim = PinnedJaxRandom(12)
        mp.setattr(JaxObsCore, "jax", shim)
        metrics, replay = [], None
        for batch in batches:
            with jax.enable_x64():
                want = jax_algo.train_on_batch(batch, epoch=0)["losses"]
            if replay is None:   # the JAX step is traced: its draws are known
                # the step's forward, then its LipVQ loss's second forward,
                # whose draws reach nothing (its loss reads the actions)
                half = len(shim.log) // 2
                assert [n for n, _ in shim.log[half:]] == [n for n, _ in shim.log[:half]]
                log = shim.log[:half]
                replay = port_draws(mp, log, PortObsCore)
            got = algo.train_on_batch(batch, epoch=0)["losses"]
            metrics.append(({k: float(want[k]) for k in METRICS},
                            {k: float(got[k]) for k in METRICS}))
        expected = copy.deepcopy(algo.nets["policy"])
        load_jax_variables(expected, flatten_variables(
            {"params": jax_algo.state.params["policy"], **jax_algo.state.aux["policy"]}))
    finally:
        mp.undo()
        set_pallas_pool(False)   # Algo.__init__ set the JAX package's flag
    return dict(metrics=metrics, port=algo, expected=expected, log=log, replay=replay,
                switches=shim.lax.pinned)


def test_the_draws_are_pinned_and_replayed(run):
    """One crop (2 randint) and one jitter (4 uniform, 1 randint) for each
    of the query and the context group, replayed once a step; JAX's jitter
    took its pinned order's branch (2 groups in each of the 2 forwards)."""
    names = [n for n, _ in run["log"]]
    assert names == (["randint"] * 2 + ["uniform"] * 4 + ["randint"]) * 2
    assert run["switches"] == 4
    assert run["replay"]["i"] == STEPS * len(names)
    trunks = [m for m in run["port"].nets.modules()
              if isinstance(m, PortBaseNets.ResNet34ConvFiLM)]
    assert len(trunks) == 1
    pools = [m for m in trunks[0].modules() if isinstance(m, PortBaseNets.StemMaxPool)]
    assert len(pools) == 1 and pools[0].recorded_argmax


@pytest.mark.parametrize("step", range(STEPS))
def test_step_metrics_match_jax(run, step):
    want, got = run["metrics"][step]
    for k in METRICS:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4, err_msg=k)


def _state_pairs(run, buffers):
    got = run["port"].nets["policy"].state_dict()
    want = run["expected"].state_dict()
    for k in got:
        is_bn_stat = k.endswith(("running_mean", "running_var"))
        if not k.endswith("num_batches_tracked") and is_bn_stat == buffers:
            yield k, got[k].numpy(), want[k].numpy()


def test_parameters_after_three_steps_match_jax(run):
    pairs = list(_state_pairs(run, buffers=False))
    assert len(pairs) == sum(1 for _ in run["port"].nets["policy"].parameters())
    for k, got, want in pairs:
        assert_mostly_close(got, want, atol=1e-5, frac=0.99,
                            max_abs=2 * LR * STEPS, msg=k)


def test_batch_norm_statistics_after_three_steps_match_jax(run):
    pairs = list(_state_pairs(run, buffers=True))
    assert len(pairs) == 2 * 36   # 36 BatchNorms in a ResNet-34
    for k, got, want in pairs:
        assert_mostly_close(got, want, atol=1e-5, frac=0.95, max_abs=1e-4, msg=k)


_HELD_CORE = {"pool_class": "SpatialSoftmax", "flatten": True, "feature_dimension": 64}


@pytest.mark.parametrize("backbone,core", [
    pytest.param("ResNet34ConvFiLM", _HELD_CORE, id="ResNet34ConvFiLM"),
    pytest.param("ResNet18ConvFiLM", _HELD_CORE, id="ResNet18ConvFiLM"),
    pytest.param("ResNet18ConvFiLM", {"pool_class": None, "feature_dimension": None},
                 id="ResNet18ConvFiLM-no-pool"),
    pytest.param("ResNet18ConvFiLM", {"pool_class": "SpatialMeanPool", "flatten": True,
                                      "feature_dimension": 64}, id="ResNet18ConvFiLM-mean-pool"),
    pytest.param("ResNet18ConvFiLM", {"pool_class": "SpatialSoftmax", "flatten": True,
                                      "feature_dimension": None}, id="ResNet18ConvFiLM-no-proj"),
])
def test_mixed_precision_refuses_the_cores_it_has_not_met(backbone, core):
    """It has met them all: each core, pool and the colour jitter is held
    against the JAX bf16 step (tests/test_torch_bf16_cores.py), so the mode
    builds with every one of these and takes a bf16 step on fp32 masters
    (the jitter's fp32 draws lift the image, and the trunk, to fp32)."""
    cfg = _configure(config_factory("icl_gmm_paper"), backbone, mixed_precision=True)
    with cfg.values_unlocked():
        cfg.observation.encoder.rgb.core_kwargs.update(core)
    PortObsUtils.initialize_obs_utils_with_config(cfg)
    algo = PortAlgo.algo_factory("icl_gmm_paper", cfg, OBS_KEY_SHAPES, A, device="cpu")
    assert algo.mixed_precision
    losses = algo.train_on_batch(_batch(np.random.RandomState(1)), epoch=0)["losses"]
    assert all(np.isfinite(float(v)) for v in losses.values())
    assert all(p.dtype == torch.float32 for p in algo.nets.parameters())
