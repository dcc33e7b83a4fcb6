"""An IQL step on image observations, the port's against the JAX package's:
one critic, B 4, a 5-d ``flat`` key and a 32 x 32 camera through ResNet-18
with group norm and SpatialSoftmax, the plain pool (``F.max_pool2d``; JAX's
``nn.max_pool``). JAX's weights carried across, float64 on both sides.
(The JAX offline-RL steps run their actors with ``train=True`` without a
mutable ``batch_stats`` collection or a randomizer key, so a BatchNorm trunk
or a crop fails there; ROADMAP.md Queue 3. The port runs both.)"""

import copy

import numpy as np

import jax

import robot_manipulation_vq_vae_tpu.algo as JaxAlgo
from robot_manipulation_vq_vae_tpu.config import config_factory as jax_config_factory
from robot_manipulation_vq_vae_tpu.utils import obs_utils as JaxObsUtils
from robot_manipulation_vq_vae_tpu.utils.ckpt_conversion import flatten_variables

import robot_manipulation_vq_vae_tpu_torch.algo as PortAlgo
from robot_manipulation_vq_vae_tpu_torch.config import config_factory
from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils as PortObsUtils
from robot_manipulation_vq_vae_tpu_torch.utils.jax_weights import load_jax_variables
from torch_offline_rl_harness import A, O, carry_weights, port_module, raw_batch, tune
from torch_port_helpers import random_init
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)


def test_image_iql_step_matches_jax():
    """One IQL step on a camera (group-norm ResNet-18, SpatialSoftmax, the
    plain pool) and a low-dim key, from the same weights: metrics within
    1e-8 relative, parameters within 1e-8 of each tensor's largest."""
    cam, img = "agentview_image", 32
    shapes = {"flat": (O,), cam: (img, img, 3)}

    def configure(cfg):
        cfg = tune(cfg, "iql")
        with cfg.values_unlocked():
            cfg.observation.modalities.obs.rgb = [cam]
            cfg.observation.encoder.rgb.core_kwargs = {
                "feature_dimension": 8, "backbone_class": "ResNet18Conv",
                "backbone_kwargs": {"pretrained": False, "input_coord_conv": False,
                                    "norm": "group"},
                "pool_class": "SpatialSoftmax", "pool_kwargs": {"num_kp": 4}}
            cfg.observation.encoder.rgb.obs_randomizer_class = None
            cfg.algo.critic.ensemble.n = 1
        return cfg

    rng = np.random.RandomState(4)
    batch = {k: (v[:4] if not isinstance(v, dict) else {kk: vv[:4] for kk, vv in v.items()})
             for k, v in raw_batch(rng).items()}
    for group in ("obs", "next_obs"):
        batch[group][cam] = rng.randint(0, 256, (4, 2, img, img, 3)).astype(np.uint8)
    jax_cfg = configure(jax_config_factory("iql"))
    JaxObsUtils.initialize_obs_utils_with_config(jax_cfg)
    jax_algo = JaxAlgo.algo_factory("iql", jax_cfg, shapes, A)
    jax_algo._init_variables = random_init(jax_algo._init_variables)
    cfg = configure(config_factory("iql"))
    PortObsUtils.initialize_obs_utils_with_config(cfg)
    algo = PortAlgo.algo_factory("iql", cfg, shapes, A, device="cpu")
    carry_weights(jax_algo, algo, batch)
    with jax.enable_x64():
        want = jax_algo.train_on_batch(jax_algo.process_batch_for_training(batch),
                                       epoch=0)["losses"]
    got = algo.train_on_batch(algo.process_batch_for_training(batch), epoch=0)["losses"]
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-8, err_msg=k)
    expected = copy.deepcopy(algo)
    for name, tree in jax_algo.state.params.items():
        load_jax_variables(port_module(expected, name), flatten_variables({"params": tree}))
    for k, w in expected.nets.state_dict().items():
        err = float((algo.nets.state_dict()[k] - w).abs().max())
        assert err <= 1e-8 * max(float(w.abs().max()), 1e-12), f"{k}: {err}"
    assert sum(type(m).__name__ == "StemMaxPool" for m in algo.nets.modules()) == 4


def test_iql_trains_batchnorm_trunks_with_crops():
    """What the JAX step cannot run: BatchNorm trunks and a crop. The actor
    (training mode) draws crops and moves its BatchNorm statistics; the
    critics, the targets and V (inference mode, as the JAX step runs them)
    keep theirs."""
    import torch

    cam, img = "agentview_image", 40
    cfg = tune(config_factory("iql"), "iql")
    with cfg.values_unlocked():
        cfg.observation.modalities.obs.rgb = [cam]
        cfg.observation.encoder.rgb.core_kwargs = {
            "feature_dimension": 8, "backbone_class": "ResNet18Conv",
            "backbone_kwargs": {"pretrained": False, "input_coord_conv": False},
            "pool_class": "SpatialSoftmax", "pool_kwargs": {"num_kp": 4}}
        cfg.observation.encoder.rgb.obs_randomizer_class = "CropRandomizer"
        cfg.observation.encoder.rgb.obs_randomizer_kwargs = {
            "crop_height": 36, "crop_width": 36, "num_crops": 1, "pos_enc": False}
    PortObsUtils.initialize_obs_utils_with_config(cfg)
    algo = PortAlgo.algo_factory("iql", cfg, {"flat": (O,), cam: (img, img, 3)}, A,
                                 device="cpu")
    rng = np.random.RandomState(5)
    batch = {k: (v[:4] if not isinstance(v, dict) else {kk: vv[:4] for kk, vv in v.items()})
             for k, v in raw_batch(rng).items()}
    for group in ("obs", "next_obs"):
        batch[group][cam] = rng.randint(0, 256, (4, 2, img, img, 3)).astype(np.uint8)
    stats = {k: v.clone() for k, v in algo.nets.state_dict().items() if "running_mean" in k}
    losses = algo.train_on_batch(algo.process_batch_for_training(batch), epoch=0)["losses"]
    assert all(bool(torch.isfinite(v)) for v in losses.values())
    after = algo.nets.state_dict()
    moved = {k for k, v in stats.items() if not torch.equal(after[k], v)}
    assert moved and all(k.startswith("actor.") for k in moved)
    assert moved == {k for k in stats if k.startswith("actor.")}
