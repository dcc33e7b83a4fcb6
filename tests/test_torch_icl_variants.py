"""The rest of the ICL family that the ``icl`` factory routes to, the port's
against the JAX package's: ``ICL`` (MLP actor), ``ICLGaussian``, ``ICLGMM``,
``ICLRNN`` and ``ICLRNN_GMM``.

* The factory: every combination of the gaussian / gmm / vae / rnn /
  transformer switches routes to the class of the JAX package's name, or
  raises where it raises.
* Each of the five policies at ``tests/test_icl_variants_parity.py``'s
  sizes (B 16, a 5-d observation, A 3, T 4, MLP (8, 8), a 2-layer LSTM of
  10): the JAX weights carried across (every leaf made random), 3
  ``train_on_batch`` steps on both sides in float64 (``jax.enable_x64``;
  ``nets.double()``) at lr 1e-3 with L2 and gradient clipping, then
  ``get_action``: the RNN policies over 2 horizons of carried state (the
  reset at the horizon included), the GMM ones with the JAX sample's own
  draws injected into the port's. Losses within 1e-8 relative, every
  parameter within 1e-8 of its tensor's largest, actions within 1e-10.
* ``policy_from_checkpoint`` of an ``ICLRNN_GMM`` checkpoint written by
  ``scripts/train.train`` wraps it in ``RolloutPolicy`` (its ``get_action``
  takes no context window) and serves two horizons of actions equal to the
  trained in-memory algo's.
"""

import copy
import glob
import itertools
import json

import h5py
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import robot_manipulation_vq_vae_tpu.algo as JaxAlgo
from robot_manipulation_vq_vae_tpu.algo import icl as JaxIcl
from robot_manipulation_vq_vae_tpu.config import config_factory as jax_config_factory
from robot_manipulation_vq_vae_tpu.utils import obs_utils as JaxObsUtils
from robot_manipulation_vq_vae_tpu.utils.ckpt_conversion import flatten_variables

import robot_manipulation_vq_vae_tpu_torch.algo as PortAlgo
from robot_manipulation_vq_vae_tpu_torch.algo import icl as PortIcl
from robot_manipulation_vq_vae_tpu_torch.config import config_factory
from robot_manipulation_vq_vae_tpu_torch.scripts import train as PortTrain
from robot_manipulation_vq_vae_tpu_torch.utils import file_utils as FileUtils
from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils as PortObsUtils
from robot_manipulation_vq_vae_tpu_torch.utils.jax_weights import load_jax_variables
from torch_port_helpers import perturbed_variables, write_demo_file
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

B, O, A, T = 16, 5, 3, 4
LAYERS = (8, 8)
H_RNN, N_LSTM = 10, 2
LR, STEPS = 1e-3, 3
MODES = {"plain": "ICL", "gaussian": "ICLGaussian", "gmm": "ICLGMM", "rnn": "ICLRNN",
         "rnn_gmm": "ICLRNN_GMM"}
SWITCHES = ("gaussian", "gmm", "vae", "rnn", "transformer")


def _routed(factory, cfg):
    try:
        return factory(cfg.algo)[0].__name__
    except NotImplementedError:
        return "raises"


@pytest.mark.parametrize("on", list(itertools.product([False, True], repeat=5)),
                         ids=lambda on: "-".join(s for s, v in zip(SWITCHES, on) if v) or "none")
def test_factory_routes_as_jax(on):
    classes = []
    for make, factory in ((jax_config_factory, JaxIcl.algo_config_to_class),
                          (config_factory, PortIcl.algo_config_to_class)):
        cfg = make("icl")
        with cfg.values_unlocked():
            for switch, value in zip(SWITCHES, on):
                cfg.algo[switch].enabled = value
        classes.append(_routed(factory, cfg))
    assert classes[1] == classes[0]
    assert classes[0] != "ICLVAE"


def _tune(cfg, mode):
    """``test_icl_variants_parity.py``'s settings, with L2 and a clip limit
    below the gradient norms."""
    with cfg.values_unlocked():
        cfg.observation.modalities.obs.low_dim = ["flat"]
        cfg.observation.modalities.obs.rgb = []
        cfg.algo.transformer.enabled = False
        cfg.algo.transformer.ln_act_enabled = False
        cfg.algo.gaussian.enabled = mode == "gaussian"
        cfg.algo.gmm.enabled = mode in ("gmm", "rnn_gmm")
        cfg.algo.vae.enabled = False
        cfg.algo.rnn.enabled = mode in ("rnn", "rnn_gmm")
        cfg.algo.rnn.horizon = T
        cfg.algo.rnn.hidden_dim = H_RNN
        cfg.algo.rnn.num_layers = N_LSTM
        cfg.algo.actor_layer_dims = [] if mode.startswith("rnn") else list(LAYERS)
        # cos_loss in the action loss, so that its gradient is held too
        cfg.algo.loss.l1_weight = 0.5
        cfg.algo.loss.cos_weight = 0.25
        lr = cfg.algo.optim_params.policy.learning_rate
        lr.initial, lr.scheduler_type = LR, None
        cfg.algo.optim_params.policy.regularization.L2 = 1e-2
        cfg.train.max_grad_norm = 0.5
        cfg.train.seq_length = T
    return cfg


def _batch(rng):
    """float32 values held as float64: the JAX losses then take the targets'
    norms in float64 too (float32 targets would give its cosine loss float32
    rounding); the port's cast to float32 on the way in is exact."""
    return {"obs": {"flat": rng.randn(B, T, O).astype(np.float32).astype(np.float64)},
            "actions": rng.uniform(-0.9, 0.9, (B, T, A)).astype(np.float32).astype(
                np.float64)}


def _jax_sample_draws(key, logits):
    """(mode, eps): the draws that JAX's ``GMMActionDistribution.sample(key)``
    takes for @logits [..., M]."""
    rng_mode, rng_eps = jax.random.split(key)
    mode = jax.random.categorical(rng_mode, jnp.asarray(logits), axis=-1)
    eps = jax.random.normal(rng_eps, tuple(mode.shape) + (A,))
    return torch.from_numpy(np.array(mode)), torch.from_numpy(np.array(eps))


def _serve(jax_algo, algo, mode, rng):
    """(JAX action, port action) pairs: one request for the MLP policies,
    2 horizons of steps for the RNN ones."""
    pairs = []
    for _ in range(2 * T if mode.startswith("rnn") else 1):
        obs = {"flat": rng.randn(B, O).astype(np.float32)}
        with jax.enable_x64():
            if mode in ("gmm", "rnn_gmm"):
                key = jax.random.split(jax_algo._init_rng)[1]   # the key JAX draws with
                dist = algo.action_distribution(obs)
                logits = dist.logits.numpy()
                if mode == "rnn_gmm":   # JAX samples the [B, 1] step
                    mode_, eps = _jax_sample_draws(key, logits[:, None])
                    got = dist.sample(mode=mode_[:, 0], eps=eps[:, 0])
                else:
                    got = dist.sample(None, *_jax_sample_draws(key, logits))
            else:
                got = algo.get_action(obs)
            want = np.asarray(jax_algo.get_action(obs))
        pairs.append((want, got.numpy()))
    return pairs


@pytest.fixture(scope="module", params=sorted(MODES))
def run(request):
    """Both algos from the same weights through the same 3 batches, then
    served: what the checks compare."""
    mode = request.param
    rng = np.random.RandomState(0)
    batches = [_batch(rng) for _ in range(STEPS)]

    jax_cfg = _tune(jax_config_factory("icl"), mode)
    JaxObsUtils.initialize_obs_utils_with_config(jax_cfg)
    jax_algo = JaxAlgo.algo_factory("icl", jax_cfg, {"flat": (O,)}, A)
    assert type(jax_algo).__name__ == MODES[mode]
    jax_algo.ensure_state(jax_algo.process_batch_for_training(batches[0]))
    nested, flat = perturbed_variables({"params": jax_algo.state.params["policy"]}, 3)
    with jax.enable_x64():
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                        nested["params"])
        jax_algo.state = jax_algo.state.replace(
            params={"policy": params},
            opt_states={"policy": jax_algo.optimizers["policy"].init(params)})

    cfg = _tune(config_factory("icl"), mode)
    PortObsUtils.initialize_obs_utils_with_config(cfg)
    algo = PortAlgo.algo_factory("icl", cfg, {"flat": (O,)}, A, device="cpu")
    assert type(algo).__name__ == MODES[mode] and not algo.TAKES_CONTEXT
    algo.nets.double()
    load_jax_variables(algo.nets["policy"], flat)

    metrics = []
    for batch in batches:
        with jax.enable_x64():
            want = jax_algo.train_on_batch(jax_algo.process_batch_for_training(batch),
                                           epoch=0)["losses"]
        got = algo.train_on_batch(algo.process_batch_for_training(batch), epoch=0)["losses"]
        metrics.append(({k: float(v) for k, v in want.items()},
                        {k: float(v) for k, v in got.items()}))
    expected = copy.deepcopy(algo.nets["policy"])
    load_jax_variables(expected, flatten_variables(
        {"params": jax_algo.state.params["policy"]}))
    served = _serve(jax_algo, algo, mode, np.random.RandomState(1))
    return dict(mode=mode, metrics=metrics, got=algo.nets["policy"].state_dict(),
                want=expected.state_dict(), served=served)


def test_step_metrics_match_jax(run):
    for want, got in run["metrics"]:
        assert set(got) == set(want) and "policy_grad_norms" in got
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-8, atol=1e-12, err_msg=k)


def test_parameters_after_three_steps_match_jax(run):
    assert set(run["got"]) == set(run["want"])
    if run["mode"].startswith("rnn"):
        assert {k for k in run["got"] if k.startswith("rnn.nets.")} == {
            f"rnn.nets.{w}_{s}_l{k}" for w in ("weight", "bias") for s in ("ih", "hh")
            for k in range(N_LSTM)}
    for k, want in run["want"].items():
        err = float((run["got"][k] - want).abs().max())
        assert err <= 1e-8 * float(want.abs().max()), f"{k}: {err}"


def test_get_action_matches_jax(run):
    assert len(run["served"]) == (2 * T if run["mode"].startswith("rnn") else 1)
    for want, got in run["served"]:
        assert got.shape == (B, A)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)


@pytest.mark.parametrize("mode", ["plain", "rnn_gmm"])
def test_goal_conditioned_policies_match_jax(mode):
    """With a goal group (``observation.modalities.goal``): the goal's
    features follow the observations'; the RNN tiles each episode's goal
    over the window. The policies' outputs in float64 within 1e-10."""
    shapes = {"flat": (O,), "target": (2,)}
    cfgs = []
    for make in (jax_config_factory, config_factory):
        cfg = _tune(make("icl"), mode)
        with cfg.values_unlocked():
            cfg.observation.modalities.goal.low_dim = ["target"]
        cfgs.append(cfg)
    JaxObsUtils.initialize_obs_utils_with_config(cfgs[0])
    jax_algo = JaxAlgo.algo_factory("icl", cfgs[0], shapes, A)
    rng = np.random.RandomState(9)
    batch = jax_algo.process_batch_for_training(
        {**_batch(rng), "goal_obs": {"target": rng.randn(B, 2)}})
    jax_algo.ensure_state(batch)
    nested, flat = perturbed_variables({"params": jax_algo.state.params["policy"]}, 4)
    PortObsUtils.initialize_obs_utils_with_config(cfgs[1])
    algo = PortAlgo.algo_factory("icl", cfgs[1], shapes, A, device="cpu")
    assert dict(algo.goal_shapes) == {"target": (2,)}
    algo.nets.double()
    load_jax_variables(algo.nets["policy"], flat)
    policy = jax_algo.nets["policy"]
    with jax.enable_x64():
        want = policy.apply({"params": jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), nested["params"])},
            {"flat": jnp.asarray(batch["obs"]["flat"])},
            goal_dict={"target": jnp.asarray(batch["goal_obs"]["target"])}, train=False)
    with torch.no_grad():
        got = algo.nets["policy"]({"flat": torch.tensor(batch["obs"]["flat"])},
                                  goal_dict={"target": torch.tensor(batch["goal_obs"]["target"])})
    pairs = ([(got.means, want.means), (got.scales, want.scales), (got.logits, want.logits)]
             if mode == "rnn_gmm" else [(got, want)])
    for g, w in pairs:
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-10)
    with pytest.raises(ValueError, match="goal-conditioned"):
        algo.nets["policy"]({"flat": torch.tensor(batch["obs"]["flat"])})


# the reference names of tests/test_icl_variants_parity.py::_transplant
REFERENCE = {
    "mlp": ["policy.nets.mlp._model.0", "policy.nets.mlp._model.2"],
    "rnn": [f"policy.nets.rnn.nets.{w}_{s}_l{k}" for w in ("weight", "bias")
            for s in ("ih", "hh") for k in range(N_LSTM)],
}
HEADS = {"plain": ("action",), "gaussian": ("mean", "scale"),
         "gmm": ("mean", "scale", "logits"), "rnn": ("action",),
         "rnn_gmm": ("mean", "scale", "logits")}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_checkpoint_names_are_the_references(mode):
    """``serialize`` writes robomimic's names, which the JAX parity test
    reads off the reference policy (no two port tensors on one name)."""
    cfg = _tune(config_factory("icl"), mode)
    PortObsUtils.initialize_obs_utils_with_config(cfg)
    algo = PortAlgo.algo_factory("icl", cfg, {"flat": (O,)}, A, device="cpu")
    names = set(algo.serialize())
    if mode.startswith("rnn"):
        want = set(REFERENCE["rnn"]) | {f"policy.nets.rnn.per_step_net.nets.{h}.{leaf}"
                                        for h in HEADS[mode] for leaf in ("weight", "bias")}
    else:
        want = {f"{m}.{leaf}" for m in REFERENCE["mlp"] for leaf in ("weight", "bias")} | {
            f"policy.nets.decoder.nets.{h}.{leaf}" for h in HEADS[mode]
            for leaf in ("weight", "bias")}
    assert names == want


# ---------------------------------------------------------------------------
# a checkpoint of an RNN policy through policy_from_checkpoint
# ---------------------------------------------------------------------------

def test_rnn_checkpoint_serves_through_the_plain_rollout_policy(tmp_path, monkeypatch):
    """One epoch of ICLRNN_GMM through ``scripts/train.train`` on the test
    demos; its checkpoint, through ``policy_from_checkpoint``, is a
    ``RolloutPolicy`` and serves two horizons of actions equal to the trained
    algo's in the same wrapper (both generators seeded alike)."""
    demos = write_demo_file(str(tmp_path / "demos.hdf5"), [12, 10, 11],
                            with_images=False)
    with h5py.File(demos, "a") as f:
        f["data"].attrs["env_args"] = json.dumps({"env_name": "Fake", "type": 1,
                                                  "env_kwargs": {}})
    cfg = _tune(config_factory("icl"), "rnn_gmm")
    with cfg.values_unlocked():
        cfg.observation.modalities.obs.low_dim = ["eef_pos"]
        cfg.experiment.name = "rnn_ckpt"
        cfg.experiment.logging.terminal_output_to_txt = False
        cfg.experiment.logging.log_tb = False
        cfg.experiment.rollout.enabled = False
        cfg.experiment.epoch_every_n_steps = 2
        cfg.experiment.save.enabled = True
        cfg.experiment.save.every_n_epochs = 1
        cfg.train.data = demos
        cfg.train.output_dir = str(tmp_path / "out")
        cfg.train.num_epochs = 1
        cfg.train.batch_size = 4
        cfg.train.num_data_workers = 1
        cfg.train.dataset_keys = ["actions"]
        cfg.train.hdf5_load_next_obs = False
        cfg.train.action_config = {"actions": {"normalization": "min_max"}}
    trained = []
    factory = PortAlgo.algo_factory

    def record(*args, **kwargs):
        trained.append(factory(*args, **kwargs))
        return trained[-1]

    monkeypatch.setattr(PortTrain.Algo, "algo_factory", record)
    PortTrain.train(cfg, device="cpu")
    monkeypatch.undo()
    (path,) = glob.glob(str(tmp_path / "out" / "rnn_ckpt" / "*" / "models" / "*.pth"))
    policy, ckpt = FileUtils.policy_from_checkpoint(device="cpu", ckpt_path=path)
    assert type(policy) is PortAlgo.RolloutPolicy
    assert type(policy.policy).__name__ == "ICLRNN_GMM"
    assert json.loads(ckpt["config"])["algo"]["rnn"]["enabled"]
    twin = PortAlgo.RolloutPolicy(
        trained[0], obs_normalization_stats=ckpt.get("obs_normalization_stats"),
        action_normalization_stats=ckpt.get("action_normalization_stats"))
    rng = np.random.RandomState(4)
    for p in (policy, twin):
        p.start_episode()
        p.policy.generator.manual_seed(11)
    for _ in range(2 * T):
        ob = {"eef_pos": rng.randn(3).astype(np.float32)}
        got, want = policy(ob), twin(ob)
        assert got.shape == (A,) and np.isfinite(got).all()
        np.testing.assert_array_equal(got, want)
    assert policy.policy._rnn_counter == twin.policy._rnn_counter == 2 * T
