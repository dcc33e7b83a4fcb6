"""The ``mcr`` policies, the port's against the JAX package's.

* The routing: every combination of the gmm / rnn / transformer switches
  gives the class of the JAX package's name.
* One ``train_on_batch`` step of each of the six classes at
  ``test_torch_bc.py``'s sizes and settings (low-dim observations), JAX's
  weights carried across, float64: metrics within 1e-8 relative (1e-6 for
  the transformer policies, whose JAX attention keeps float32 products),
  parameters within 1e-8 of each tensor's largest (1e-6).
* The warm start through ``RMVQ_MCR_CKPT``, both ways, on a 32 x 32 camera
  with a ResNet-18 backbone: a trunk that the JAX package's
  ``MCRPretrainer.export_trunk`` wrote is grafted onto the port's
  ``MCR_GMM`` backbone to the bit (its BatchNorm statistics stay), and one
  that the port's wrote onto the JAX package's; the two exports have the
  same names, shapes and types.
"""

import itertools
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import robot_manipulation_vq_vae_tpu.algo as JaxAlgo
from robot_manipulation_vq_vae_tpu.algo import mcr as JaxMCR
from robot_manipulation_vq_vae_tpu.algo import mcr_pretrain as JaxPretrain
from robot_manipulation_vq_vae_tpu.config import config_factory as jax_config_factory
from robot_manipulation_vq_vae_tpu.utils import obs_utils as JaxObsUtils
from robot_manipulation_vq_vae_tpu.utils.ckpt_conversion import flatten_variables

import robot_manipulation_vq_vae_tpu_torch.algo as PortAlgo
from robot_manipulation_vq_vae_tpu_torch.algo import mcr as PortMCR
from robot_manipulation_vq_vae_tpu_torch.algo import mcr_pretrain as PortPretrain
from robot_manipulation_vq_vae_tpu_torch.config import config_factory
from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils as PortObsUtils
from robot_manipulation_vq_vae_tpu_torch.utils.jax_weights import (
    jax_flat,
    jax_variables,
    load_jax_variables,
)
from test_torch_bc import _batch, _tune
from torch_port_helpers import (
    check_parameters,
    float64_tree,
    perturbed_variables,
    random_init,
    set_jax_state,
)
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

O, A = 5, 3
SWITCHES = ("gmm", "rnn", "transformer")
# test_torch_bc.py's mode -> the mcr class it routes to
CLASSES = {"plain": "MCR", "gmm": "MCR_GMM", "rnn": "MCR_RNN", "rnn_gmm": "MCR_RNN_GMM",
           "transformer": "MCR_Transformer", "transformer_gmm": "MCR_Transformer_GMM"}


@pytest.fixture(autouse=True)
def no_trunk(monkeypatch):
    monkeypatch.delenv("RMVQ_MCR_CKPT", raising=False)


@pytest.mark.parametrize("on", list(itertools.product([False, True], repeat=3)),
                         ids=lambda on: "-".join(s for s, v in zip(SWITCHES, on) if v) or "none")
def test_factory_routes_as_jax(on):
    classes = []
    for make, factory in ((jax_config_factory, JaxMCR.algo_config_to_class),
                          (config_factory, PortMCR.algo_config_to_class)):
        cfg = make("mcr")
        with cfg.values_unlocked():
            for switch, value in zip(SWITCHES, on):
                cfg.algo[switch].enabled = value
        classes.append(factory(cfg.algo)[0].__name__)
    assert classes[1] == classes[0]


@pytest.mark.parametrize("mode", sorted(CLASSES))
def test_one_step_of_each_class_matches_jax(mode):
    rng = np.random.RandomState(0)
    batch = _batch(rng)
    jax_cfg, cfg = _tune(jax_config_factory("mcr"), mode), _tune(config_factory("mcr"), mode)
    JaxObsUtils.initialize_obs_utils_with_config(jax_cfg)
    jax_algo = JaxAlgo.algo_factory("mcr", jax_cfg, {"flat": (O,)}, A)
    PortObsUtils.initialize_obs_utils_with_config(cfg)
    algo = PortAlgo.algo_factory("mcr", cfg, {"flat": (O,)}, A, device="cpu")
    assert type(algo).__name__ == type(jax_algo).__name__ == CLASSES[mode]
    variables = random_init(jax_algo._init_variables)(
        jax.random.PRNGKey(0), jax_algo.process_batch_for_training(batch))
    nested, flat = perturbed_variables(variables["policy"], 3)
    with jax.enable_x64():
        set_jax_state(jax_algo, {"policy": float64_tree(nested)})
        want = jax_algo.train_on_batch(jax_algo.process_batch_for_training(batch),
                                       epoch=0)["losses"]
    algo.nets.double()
    load_jax_variables(algo.nets["policy"], flat)
    got = algo.train_on_batch(algo.process_batch_for_training(batch), epoch=0)["losses"]
    tol = 1e-6 if mode.startswith("transformer") else 1e-8
    assert set(got) <= set(want) and "action_loss" in got
    for k in got:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=tol, atol=1e-12,
                                   err_msg=k)
    expected = PortAlgo.algo_factory("mcr", cfg, {"flat": (O,)}, A, device="cpu")
    expected.nets.double()
    load_jax_variables(expected.nets["policy"],
                       flatten_variables({"params": jax_algo.state.params["policy"]}))
    check_parameters(algo.nets["policy"], expected.nets["policy"], tol)


# ---------------------------------------------------------------------------
# the trunk warm start, both ways
# ---------------------------------------------------------------------------

CAM, IMG = "cam", 32
SHAPES = {"eef": (3,), CAM: (IMG, IMG, 3)}


def _camera(cfg):
    with cfg.values_unlocked():
        cfg.observation.modalities.obs.low_dim = ["eef"]
        cfg.observation.modalities.obs.rgb = [CAM]
        cfg.observation.encoder.rgb.core_kwargs = {
            "feature_dimension": 8, "backbone_class": "ResNet18Conv",
            "backbone_kwargs": {"pretrained": False}, "pool_class": "SpatialSoftmax",
            "pool_kwargs": {"num_kp": 4}}
        cfg.observation.encoder.rgb.obs_randomizer_class = None
        cfg.algo.actor_layer_dims = [16]
    return cfg


def _jax_export(path):
    """The JAX package's ``export_trunk`` of an 18-layer MCR trunk (its
    variables initialized under jit)."""
    model = JaxPretrain.MCRRepresentation(size=18, resize_to_224=False)
    batch = next(JaxPretrain.synthetic_batches(2, IMG, 7, seed=0))
    variables = jax.jit(lambda r, b: model.init(r, b, jnp.tile(jnp.arange(2), (3, 1))))(
        jax.random.PRNGKey(3), batch)
    trainer = object.__new__(JaxPretrain.MCRPretrainer)
    trainer.params = variables["params"]
    trainer.export_trunk(path)


def _port_export(path):
    torch.manual_seed(5)
    trainer = PortPretrain.MCRPretrainer(PortPretrain.MCRRepresentation(size=18),
                                         device="cpu")
    trainer.export_trunk(path)


def _tree_layout(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _tree_layout(v, f"{prefix}/{k}").items()}
    return {prefix: (np.asarray(tree).shape, np.asarray(tree).dtype)}


def test_exports_share_the_jax_layout(tmp_path):
    _jax_export(tmp_path / "jax.pkl")
    _port_export(tmp_path / "port.pkl")
    layouts = []
    for name in ("jax.pkl", "port.pkl"):
        with open(tmp_path / name, "rb") as f:
            layouts.append(_tree_layout(pickle.load(f)))
    assert layouts[0] == layouts[1]
    assert {dtype for _, dtype in layouts[0].values()} == {np.dtype(np.float32)}


def test_jax_export_warm_starts_the_port_policy(tmp_path, monkeypatch, capsys):
    path = str(tmp_path / "trunk.pkl")
    _jax_export(path)
    with open(path, "rb") as f:
        trunk = pickle.load(f)
    cfg = _camera(config_factory("mcr"))
    PortObsUtils.initialize_obs_utils_with_config(cfg)
    cold = PortAlgo.algo_factory("mcr", cfg, SHAPES, A, device="cpu")
    monkeypatch.setenv("RMVQ_MCR_CKPT", path)
    algo = PortAlgo.algo_factory("mcr", cfg, SHAPES, A, device="cpu")
    assert type(algo).__name__ == "MCR_GMM"
    assert "warm-started 1 visual trunks" in capsys.readouterr().out
    backbone = algo.nets["policy"].net.encoder.nets["obs"].obs_nets[CAM].backbone
    flat = jax_variables(backbone)
    for k, v in jax_flat(trunk).items():
        np.testing.assert_array_equal(flat[k], v, err_msg=k)
    # the rest of the policy, and the trunk's BatchNorm statistics, as built
    warm, fresh = algo.nets.state_dict(), cold.nets.state_dict()
    grafted = {f"policy.net.encoder.nets.obs.obs_nets.{CAM}.backbone.{k}"
               for k, v in backbone.named_parameters()}
    for k in fresh:
        if k not in grafted:
            assert torch.equal(warm[k], fresh[k]), k
    obs = {"eef": np.zeros((2, 3), np.float32),
           CAM: np.random.RandomState(0).randint(0, 256, (2, IMG, IMG, 3)).astype(np.uint8)}
    assert np.isfinite(algo.get_action(obs).numpy()).all()


def test_port_export_warm_starts_the_jax_policy(tmp_path, monkeypatch):
    path = str(tmp_path / "trunk.pkl")
    _port_export(path)
    with open(path, "rb") as f:
        trunk = pickle.load(f)
    monkeypatch.setenv("RMVQ_MCR_CKPT", path)
    cfg = _camera(jax_config_factory("mcr"))
    JaxObsUtils.initialize_obs_utils_with_config(cfg)
    jax_algo = JaxAlgo.algo_factory("mcr", cfg, SHAPES, A)
    assert type(jax_algo).__name__ == "MCR_GMM"
    jax_algo._init_variables = random_init(jax_algo._init_variables)
    opt = jax_algo.optimizers["policy"]   # its init under jit (eagerly: op by op)
    jax_algo.optimizers["policy"] = opt._replace(init=jax.jit(opt.init))
    rng = np.random.RandomState(0)
    jax_algo.ensure_state(jax_algo.process_batch_for_training({
        "obs": {"eef": rng.randn(2, 1, 3).astype(np.float32),
                CAM: rng.randint(0, 255, (2, 1, IMG, IMG, 3)).astype(np.uint8)},
        "actions": rng.randn(2, 1, A).astype(np.float32)}))
    grafted = jax_algo.state.params["policy"]["net"]["encoder"]["enc_obs"][f"core_{CAM}"][
        "backbone"]
    want = jax_flat(trunk)
    got = jax_flat(jax.device_get(grafted))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), v, err_msg=k)
