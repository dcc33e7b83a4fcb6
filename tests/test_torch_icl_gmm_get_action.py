"""The port's slice as a whole: ``ICLTransformer_GMM`` on the
``icl_gmm_paper`` config at a small size (2 layers, width 32, 4 heads,
T = 4, two cameras of 32x32 center-cropped to 28, FiLM ResNet-18 +
SpatialSoftmax, low-dim keys and a language embedding, LipVQ over the
context actions), against the JAX package's
``ICLTransformerGMMActorNetwork.forward_train`` in eval mode with the same
weights and the same numpy inputs. Also: the import hygiene of the port
and its device rule."""

import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import robot_manipulation_vq_vae_tpu.algo as JaxAlgo
from robot_manipulation_vq_vae_tpu.algo.algo import device_process_obs
from robot_manipulation_vq_vae_tpu.config import config_factory as jax_config_factory
from robot_manipulation_vq_vae_tpu.utils import obs_utils as JaxObsUtils

import robot_manipulation_vq_vae_tpu_torch
import robot_manipulation_vq_vae_tpu_torch.algo as PortAlgo
from robot_manipulation_vq_vae_tpu_torch.config import config_factory
from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils as PortObsUtils
from robot_manipulation_vq_vae_tpu_torch.utils.jax_weights import (
    load_jax_variables,
)
from torch_port_helpers import perturbed_variables

B, T, A, LANG = 2, 4, 12, 16
CAMS = ["agentview_image", "eye_in_hand_image"]
LOW_DIM = {"eef_pos": (3,), "eef_quat": (4,), "gripper_qpos": (2,)}


def _configure(cfg):
    with cfg.values_unlocked():
        cfg.observation.modalities.obs.low_dim = list(LOW_DIM) + ["lang_emb"]
        cfg.observation.modalities.obs.rgb = CAMS
        cfg.observation.encoder.rgb.core_class = "VisualCoreLanguageConditioned"
        cfg.observation.encoder.rgb.core_kwargs = {
            "feature_dimension": 64, "backbone_class": "ResNet18ConvFiLM",
            "backbone_kwargs": {"pretrained": False, "input_coord_conv": False},
            "pool_class": "SpatialSoftmax",
            "pool_kwargs": {"num_kp": 32, "learnable_temperature": False,
                            "temperature": 1.0, "noise_std": 0.0},
        }
        cfg.observation.encoder.rgb.obs_randomizer_class = "CropRandomizer"
        cfg.observation.encoder.rgb.obs_randomizer_kwargs = {
            "crop_height": 28, "crop_width": 28, "num_crops": 1, "pos_enc": False,
        }
        tc = cfg.algo.transformer
        tc.context_length, tc.embed_dim, tc.num_layers, tc.num_heads = T, 32, 2, 4
    return cfg


OBS_KEY_SHAPES = {**LOW_DIM, **{c: (32, 32, 3) for c in CAMS}, "lang_emb": (LANG,)}


def _obs(rng):
    obs = {k: rng.randn(B, T, *s).astype(np.float32) for k, s in LOW_DIM.items()}
    obs.update({c: rng.randint(0, 256, (B, T, 32, 32, 3)).astype(np.uint8)
                for c in CAMS})
    obs["lang_emb"] = rng.randn(B, T, LANG).astype(np.float32)
    return obs


@pytest.fixture(scope="module")
def pair():
    """(JAX policy, its variables, port algo on the CPU, request)."""
    jax_cfg = _configure(jax_config_factory("icl_gmm_paper"))
    JaxObsUtils.initialize_obs_utils_with_config(jax_cfg)
    jax_algo = JaxAlgo.algo_factory("icl_gmm_paper", jax_cfg, OBS_KEY_SHAPES, A)
    policy = jax_algo.nets["policy"]

    rng = np.random.RandomState(0)
    obs, ctx_obs = _obs(rng), _obs(rng)
    ctx_act = rng.uniform(-1, 1, (B, T, A)).astype(np.float32)
    jobs = lambda o: device_process_obs({k: jnp.asarray(v) for k, v in o.items()})  # noqa: E731
    variables = policy.init(
        {"params": jax.random.PRNGKey(0)}, jobs(obs), jobs(ctx_obs),
        jnp.asarray(ctx_act), train=False, method=policy.forward_train,
    )
    # GPT weights ~N(0, 0.2^2): at their 0.02 init, attention is nearly
    # uniform and the token order would hide below the tolerance
    variables, flat = perturbed_variables(variables, 5, kernel_scale=10.0,
                                          scale_under="net/transformer/")

    port_cfg = _configure(config_factory("icl_gmm_paper"))
    PortObsUtils.initialize_obs_utils_with_config(port_cfg)
    algo = PortAlgo.algo_factory("icl_gmm_paper", port_cfg, OBS_KEY_SHAPES, A,
                                 device="cpu")
    load_jax_variables(algo.nets["policy"], flat)

    def jax_forward(low_noise_eval=None):
        return policy.apply(
            variables, jobs(obs), jobs(ctx_obs), jnp.asarray(ctx_act),
            low_noise_eval=low_noise_eval, train=False,
            method=policy.forward_train,
        )

    request = (obs, {"obs": ctx_obs, "actions": ctx_act})
    return jax_forward, algo, request


def test_latent_width_is_the_group_encoder_width(pair):
    """LipVQ's latent width is the group encoder's output width:
    2 cameras x 64 + 9 low-dim + the language embedding."""
    _, algo, _ = pair
    encoder = algo.nets["policy"].net.encoder
    assert encoder.output_dim == 2 * 64 + 9 + LANG
    assert encoder.action_network.latent_dim == encoder.output_dim


@pytest.mark.parametrize("low_noise_eval", [None, False])
def test_gmm_parameters_match_jax(pair, low_noise_eval):
    jax_forward, algo, (obs, ctx) = pair
    dist_j, vq_loss_j = jax_forward(low_noise_eval)
    dist_t, vq_loss_t = algo.action_distribution(obs, ctx, low_noise_eval=low_noise_eval)
    for name in ("means", "scales", "logits"):
        np.testing.assert_allclose(
            getattr(dist_t, name).numpy(), np.asarray(getattr(dist_j, name)),
            atol=1e-4, rtol=1e-4, err_msg=name,
        )
    if low_noise_eval is None:
        np.testing.assert_array_equal(dist_t.scales.numpy(), np.float32(1e-4))
    np.testing.assert_allclose(float(vq_loss_t), float(vq_loss_j), rtol=1e-5, atol=1e-5)


def test_sampled_action_with_injected_noise_matches_jax(pair):
    jax_forward, algo, (obs, ctx) = pair
    rng = np.random.RandomState(9)
    mode = rng.randint(0, 5, (B, T)).astype(np.int32)
    eps = rng.randn(B, T, A).astype(np.float32)
    dist_j, _ = jax_forward(False)
    dist_t, _ = algo.action_distribution(obs, ctx, low_noise_eval=False)
    want = dist_j.sample(jax.random.PRNGKey(0), mode=jnp.asarray(mode),
                         eps=jnp.asarray(eps))[:, -1]
    got = algo._select_output(dist_t.sample(mode=torch.from_numpy(mode),
                                            eps=torch.from_numpy(eps)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_get_action_is_a_finite_action_per_request(pair):
    _, algo, (obs, ctx) = pair
    action = algo.get_action(obs, ctx)
    assert action.shape == (B, A) and action.dtype == torch.float32
    assert torch.isfinite(action).all()
    assert not algo.nets.training   # serving runs the networks in eval mode


def test_entry_points_need_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _configure(config_factory("icl_gmm_paper"))
    PortObsUtils.initialize_obs_utils_with_config(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PortAlgo.algo_factory("icl_gmm_paper", cfg, OBS_KEY_SHAPES, A)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        robot_manipulation_vq_vae_tpu_torch.resolve_device(None)
    assert robot_manipulation_vq_vae_tpu_torch.resolve_device("cpu").type == "cpu"


def test_port_imports_neither_jax_nor_the_jax_package():
    code = """
import pkgutil, importlib, sys
import robot_manipulation_vq_vae_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m.startswith("jaxlib.") or m == "flax" or m.startswith("flax.")
             or m == "robot_manipulation_vq_vae_tpu"
             or m.startswith("robot_manipulation_vq_vae_tpu."))
print(len(names), bad)
assert len(names) >= 15 and not bad, bad
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(_repo_root()))
    assert out.returncode == 0, out.stdout + out.stderr


def _repo_root():
    from pathlib import Path

    return Path(robot_manipulation_vq_vae_tpu_torch.__file__).resolve().parents[1]
