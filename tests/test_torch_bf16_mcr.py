"""One ``MCR_Transformer`` bf16 step (``ICLTransformer``'s bf16 step, which
the JAX class inherits through ``BC_Transformer``) on a 32 x 32 camera
through MCR's ResNet-50 trunk with BatchNorm in training (bf16 throughout
the trunk: no randomizer lifts the image), at tests/test_torch_bc.py's
transformer sizes and B = 4, against the JAX algo's step from the same
weights and batch: every metric within 2 %, the masters fp32."""

import numpy as np
import pytest
import torch

import jax

import robot_manipulation_vq_vae_tpu.algo as JaxAlgo
from robot_manipulation_vq_vae_tpu.config import config_factory as jax_config_factory
from robot_manipulation_vq_vae_tpu.utils import obs_utils as JaxObsUtils

import robot_manipulation_vq_vae_tpu_torch.algo as PortAlgo
from robot_manipulation_vq_vae_tpu_torch.config import config_factory
from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils as PortObsUtils
from robot_manipulation_vq_vae_tpu_torch.utils.jax_weights import load_jax_variables
import test_torch_bc as BC
from torch_bf16_helpers import one_torch_thread  # noqa: F401 (autouse)
from torch_port_helpers import perturbed_variables, random_init, set_jax_state

CAM, IMG = "cam", 32


def _mcr_config(cfg):
    cfg = BC._tune(cfg, "transformer")
    with cfg.values_unlocked():
        cfg.observation.modalities.obs.low_dim = ["flat"]
        cfg.observation.modalities.obs.rgb = [CAM]
        cfg.observation.encoder.rgb.core_kwargs = {
            "feature_dimension": 16, "backbone_class": "ResNet50Conv",
            "backbone_kwargs": {"pretrained": False}, "pool_class": "SpatialSoftmax",
            "pool_kwargs": {"num_kp": 8}}
        cfg.observation.encoder.rgb.obs_randomizer_class = None
        cfg.train.mixed_precision = True
    return cfg


def test_mcr_transformer_step_on_resnet50_matches_jax(monkeypatch):
    monkeypatch.delenv("RMVQ_MCR_CKPT", raising=False)
    rng = np.random.RandomState(0)
    b, t = 4, BC.T
    batch = {"obs": {"flat": rng.randn(b, t, BC.O).astype(np.float32),
                     CAM: rng.randint(0, 256, (b, t, IMG, IMG, 3)).astype(np.uint8)},
             "actions": rng.uniform(-0.9, 0.9, (b, t, BC.A)).astype(np.float32)}
    shapes = {"flat": (BC.O,), CAM: (IMG, IMG, 3)}
    jax_cfg = _mcr_config(jax_config_factory("mcr"))
    JaxObsUtils.initialize_obs_utils_with_config(jax_cfg)
    jax_algo = JaxAlgo.algo_factory("mcr", jax_cfg, shapes, BC.A)
    cfg = _mcr_config(config_factory("mcr"))
    PortObsUtils.initialize_obs_utils_with_config(cfg)
    algo = PortAlgo.algo_factory("mcr", cfg, shapes, BC.A, device="cpu")
    assert type(algo).__name__ == type(jax_algo).__name__ == "MCR_Transformer"
    assert algo.mixed_precision
    variables = random_init(jax_algo._init_variables)(
        jax.random.PRNGKey(0), jax_algo.process_batch_for_training(batch))
    nested, flat = perturbed_variables(variables["policy"], 3)
    set_jax_state(jax_algo, {"policy": nested})
    load_jax_variables(algo.nets["policy"], flat)
    want = jax_algo.train_on_batch(jax_algo.process_batch_for_training(batch),
                                   epoch=0)["losses"]
    got = algo.train_on_batch(algo.process_batch_for_training(batch), epoch=0)["losses"]
    assert set(got) <= set(want)
    for k in got:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=2e-2, err_msg=k)
    assert all(p.dtype == torch.float32 for p in algo.nets.parameters())


@pytest.fixture(autouse=True)
def _obs_utils_reset():
    yield
    JaxObsUtils.initialize_obs_utils_with_config(jax_config_factory("bc"))
