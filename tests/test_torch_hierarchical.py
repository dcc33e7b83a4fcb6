"""The hierarchical family, the port's against the JAX package's: ``GL``,
``GL_VAE``, ``HBC`` (``separate`` and ``cascade``), ``ValuePlanner`` and
``IRIS``.

* Small widths: two low-dim keys, A 3, B 8, windows of ``SH`` = 3 steps (the
  subgoal horizon), planner layers [32], latent 4, a 2-layer LSTM of 8 for
  the actor (horizon 4), BCQ [16] with a VAE of latent 4. JAX's weights
  carried across (every leaf made random), both sides in float64 on
  float32-representable batches, lr 1e-3 with L2 and gradient clipping.
* The draws: the VAE encoders' standard normals through both
  ``_noise_hook``s (BCQ's {"enc", "backup"} too); the prior samples of
  ``get_subgoal_predictions`` / ``sample_subgoals`` and BCQ's candidates
  pinned in the JAX modules (``PinnedJaxRandom``; the JAX planner's jitted
  inference is traced anew for each call) and replayed through the port's
  ``_prior_hook`` / ``_sample_hook``.
* GL and GL_VAE: 3 steps (metrics within 1e-8 relative, parameters within
  1e-8 of each tensor's largest), then predictions and 3 samples a row
  within 1e-8 (the trained weights' 1e-12 differences, measured 3.2e-10
  apart). HBC in both modes: 3 steps (cascade: the actor's goals the
  planner's pinned prior samples), then 12 stepwise ``get_action`` calls
  with the subgoal refreshed every 5 (calls 0, 5, 10), actions and
  subgoals within 1e-8. IRIS: 2 steps, then a request: the subgoal each row keeps (the
  index of its best of 5 samples) and the action.
* The ``hbc`` / ``iris`` templates' windows (``train.seq_length`` 1 under a
  subgoal horizon of 10) raise in both packages; the options the JAX
  classes read nowhere raise in the port; an HBC checkpoint from
  ``scripts/train.train`` serves through ``policy_from_checkpoint``
  bit-equal to the trained algo; one HBC step with a 32 x 32 camera on the
  planner's ResNet-18 with ``train.pallas_pool`` matches JAX's.
"""

import contextlib
import copy
import glob
import json
import os

import h5py
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import robot_manipulation_vq_vae_tpu.algo as JaxAlgo
from robot_manipulation_vq_vae_tpu.algo import gl as JaxGL
from robot_manipulation_vq_vae_tpu.algo.icl import _device_batch
from robot_manipulation_vq_vae_tpu.config import config_factory as jax_config_factory
from robot_manipulation_vq_vae_tpu.models import vae_nets as JaxVAENets
from robot_manipulation_vq_vae_tpu.models.base_nets import set_pallas_pool
from robot_manipulation_vq_vae_tpu.utils import obs_utils as JaxObsUtils
from robot_manipulation_vq_vae_tpu.utils.ckpt_conversion import flatten_variables

import robot_manipulation_vq_vae_tpu_torch.algo as PortAlgo
from robot_manipulation_vq_vae_tpu_torch.config import config_factory
from robot_manipulation_vq_vae_tpu_torch.scripts import train as PortTrain
from robot_manipulation_vq_vae_tpu_torch.utils import file_utils as FileUtils
from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils as PortObsUtils
from robot_manipulation_vq_vae_tpu_torch.utils.jax_weights import load_jax_variables
from torch_offline_rl_harness import port_module as bcq_module
from torch_port_helpers import (
    PinnedJaxRandom,
    check_parameters,
    check_step_metrics,
    float64_tree,
    perturbed_variables,
    random_init,
    set_jax_state,
    write_demo_file,
)
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

OBS = {"robot0_eef_pos": (3,), "object": (4,)}
B, A, SH, LATENT = 8, 3, 3, 4
LR, STEPS, CALLS, INTERVAL = 1e-3, 3, 12, 5
N_SUBGOALS, N_ROLLOUT = 5, 3
TEMPLATES = os.path.join(os.path.dirname(JaxAlgo.__file__), "..", "exps", "templates")


def _planner(node):
    node.ae.planner_layer_dims = [32]
    node.vae.encoder_layer_dims = node.vae.decoder_layer_dims = [32]
    node.vae.latent_dim = LATENT
    node.vae.kl_weight = 0.5
    node.subgoal_horizon = SH
    lr = node.optim_params.goal_network.learning_rate
    lr.initial, lr.scheduler_type = LR, None
    node.optim_params.goal_network.regularization.L2 = 1e-2


def _actor(node):
    node.actor_layer_dims = []
    node.rnn.hidden_dim, node.rnn.num_layers, node.rnn.horizon = 8, 2, 4
    node.loss.l1_weight, node.loss.cos_weight = 0.5, 0.25
    lr = node.optim_params.policy.learning_rate
    lr.initial, lr.scheduler_type = LR, None
    node.optim_params.policy.regularization.L2 = 1e-2


def _value(node):
    node.critic.layer_dims = [16]
    node.critic.num_action_samples, node.critic.num_action_samples_rollout = 2, N_ROLLOUT
    vae = node.action_sampler.vae
    vae.latent_dim = LATENT
    vae.encoder_layer_dims = vae.decoder_layer_dims = vae.prior_layer_dims = [16]
    for p in node.optim_params.values():
        p.learning_rate.initial, p.learning_rate.scheduler_type = LR, None


def tune(cfg, vae=True, mode="separate"):
    """@cfg (``gl``, ``hbc`` or ``iris``) at the small widths."""
    keys = list(OBS)
    with cfg.values_unlocked():
        cfg.train.max_grad_norm = 1.0
        cfg.train.seq_length = SH
        if cfg.algo_name == "gl":
            cfg.observation.modalities.obs.low_dim = keys
            cfg.observation.modalities.subgoal.low_dim = keys
            _planner(cfg.algo)
            cfg.algo.vae.enabled = vae
            return cfg
        cfg.algo.mode = mode
        cfg.algo.subgoal_update_interval = INTERVAL
        _actor(cfg.algo.actor)
        cfg.observation.actor.modalities.obs.low_dim = keys
        if cfg.algo_name == "hbc":
            planner, planner_obs = cfg.algo.planner, cfg.observation.planner
        else:
            vp = cfg.algo.value_planner
            planner, planner_obs = vp.planner, cfg.observation.value_planner.planner
            vp.num_samples = N_SUBGOALS
            _value(vp.value)
            cfg.observation.value_planner.value.modalities.obs.low_dim = keys
        _planner(planner)
        planner.vae.enabled = vae
        planner_obs.modalities.obs.low_dim = keys
        planner_obs.modalities.subgoal.low_dim = keys
    return cfg


def make(name, side, **kw):
    """The JAX (@side "jax") or port algo @name at the small widths."""
    if side == "jax":
        cfg = tune(jax_config_factory(name), **kw)
        JaxObsUtils.initialize_obs_utils_with_config(cfg)
        return JaxAlgo.algo_factory(name, cfg, dict(OBS), A)
    cfg = tune(config_factory(name), **kw)
    PortObsUtils.initialize_obs_utils_with_config(cfg)
    return PortAlgo.algo_factory(name, cfg, dict(OBS), A, device="cpu")


def f32(a):
    return np.asarray(a, np.float32).astype(np.float64)


def raw_batch(rng, t=SH):
    def obs():
        return {k: f32(rng.randn(B, t, *s)) for k, s in OBS.items()}

    return {"obs": obs(), "next_obs": obs(),
            "actions": f32(rng.uniform(-0.9, 0.9, (B, t, A))),
            "rewards": f32(rng.rand(B, t)), "dones": (rng.rand(B, t) < 0.25).astype(np.float64)}


def _init_batch(jax_sub, processed):
    """What @jax_sub's ``train_on_batch`` initializes its state from."""
    if isinstance(jax_sub, JaxGL.GL):
        jb = _device_batch(processed)
        jb["subgoals"] = {k: jnp.asarray(v) for k, v in processed["subgoals"].items()}
        return jb
    if isinstance(jax_sub, JaxAlgo.BCQ):
        return processed
    return _device_batch(processed)


def carry(jax_sub, port_sub, processed, seed, module_of=lambda algo, name: algo.nets[name]):
    """@jax_sub's variables (made random, float64) loaded into @port_sub
    (float64); JAX's optimizer states initialized on them."""
    variables = random_init(jax_sub._init_variables)(jax.random.PRNGKey(0),
                                                     _init_batch(jax_sub, processed))
    port_sub.nets.double()
    carried = {}
    with jax.enable_x64():
        for i, name in enumerate(sorted(variables)):
            nested, flat = perturbed_variables(variables[name], seed + i)
            carried[name] = float64_tree(nested)
            load_jax_variables(module_of(port_sub, name), flat)
        set_jax_state(jax_sub, carried)


def expected(jax_sub, port_sub, module_of=lambda algo, name: algo.nets[name]):
    """A copy of @port_sub holding @jax_sub's variables."""
    out = copy.deepcopy(port_sub)
    for name, tree in jax_sub.state.params.items():
        load_jax_variables(module_of(out, name), flatten_variables(
            {"params": tree, **jax_sub.state.aux.get(name, {})}))
    return out


def check_algo(got, want, tol=1e-8):
    for name in want.nets:
        check_parameters(got.nets[name], want.nets[name], tol)


def close(got, want, tol=1e-8, msg=""):
    got = {k: v.detach().numpy() for k, v in got.items()} if isinstance(got, dict) else got
    if isinstance(want, dict):
        assert set(got) == set(want), msg
        for k in want:
            np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=0, atol=tol,
                                       err_msg=f"{msg} {k}")
    else:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=tol,
                                   err_msg=msg)


@contextlib.contextmanager
def pinned_jax(seed):
    """The JAX planner's and VAE sampler's draws pinned (one log)."""
    pinned = PinnedJaxRandom(seed)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxGL, "jax", pinned)
        mp.setattr(JaxVAENets, "jax", pinned)
        yield pinned


def jax_draws(pinned, *caches):
    """The logged draws, the log cleared and the JAX caches of @caches
    emptied (the next call traces anew and draws anew)."""
    draws = [np.array(v) for _, v in pinned.log]
    pinned.log.clear()
    for c in caches:
        c._jit_cache.clear()
    return draws


def gl_noise(rng, n):
    return [rng.randn(B, LATENT) for _ in range(n)]


def hook(values):
    """A ``_noise_hook`` giving @values in turn (the JAX one as arrays)."""
    it = iter(values)
    return lambda: next(it)


# ---------------------------------------------------------------------------
# GL and GL_VAE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vae", [False, True], ids=["gl", "gl_vae"])
def test_gl_matches_jax(vae):
    rng = np.random.RandomState(0)
    jax_algo, algo = make("gl", "jax", vae=vae), make("gl", "port", vae=vae)
    assert type(algo).__name__ == type(jax_algo).__name__ == ("GL_VAE" if vae else "GL")
    batches = [raw_batch(rng) for _ in range(STEPS)]
    carry(jax_algo, algo, jax_algo.process_batch_for_training(batches[0]), 3)
    if vae:
        eps = gl_noise(rng, STEPS)
        jax_algo._noise_hook = hook([jnp.asarray(e) for e in eps])
        algo._noise_hook = hook(eps)
    metrics = []
    for epoch, batch in enumerate(batches):
        with jax.enable_x64():
            want = jax_algo.train_on_batch(jax_algo.process_batch_for_training(batch),
                                           epoch)["losses"]
        got = algo.train_on_batch(algo.process_batch_for_training(batch), epoch)["losses"]
        metrics.append(({k: float(v) for k, v in want.items()},
                        {k: float(v) for k, v in got.items()}))
    assert set(metrics[0][1]) == set(metrics[0][0])
    check_step_metrics(metrics, metrics[0][0], 1e-8)
    check_algo(algo, expected(jax_algo, algo))

    obs = {k: f32(rng.randn(B, *s)) for k, s in OBS.items()}
    with pinned_jax(4) as pinned, jax.enable_x64():
        for n in (None, 3):
            want = (jax_algo.get_subgoal_predictions(obs) if n is None
                    else jax_algo.sample_subgoals(obs, num_samples=n))
            draws = jax_draws(pinned, jax_algo)
            assert len(draws) == int(vae)
            if vae:
                assert draws[0].shape == (B * (n or 1), LATENT)
                algo._prior_hook = lambda d=draws[0]: d
            got = (algo.get_subgoal_predictions(obs) if n is None
                   else algo.sample_subgoals(obs, num_samples=n))
            assert got["object"].shape == (B * (n or 1), 4)
            close(got, want, msg=f"samples {n}")


# ---------------------------------------------------------------------------
# HBC
# ---------------------------------------------------------------------------

def hbc_pair(mode, steps=STEPS):
    """Both HBCs of @mode from the same weights through the same @steps
    batches: ({metrics}, jax, port)."""
    rng = np.random.RandomState(1)
    jax_algo, algo = make("hbc", "jax", mode=mode), make("hbc", "port", mode=mode)
    assert type(algo.planner).__name__ == "GL_VAE" and type(algo.actor).__name__ == "BC_RNN"
    assert set(algo.actor.goal_shapes) == set(OBS)
    batches = [raw_batch(rng) for _ in range(steps)]
    first = jax_algo.process_batch_for_training(batches[0])
    carry(jax_algo.planner, algo.planner, first["planner"], 5)
    first["actor"]["goal_obs"] = first["planner"]["subgoals"]
    carry(jax_algo.actor, algo.actor, first["actor"], 9)
    eps = gl_noise(rng, steps)
    jax_algo.planner._noise_hook = hook([jnp.asarray(e) for e in eps])
    algo.planner._noise_hook = hook(eps)
    metrics = []
    with pinned_jax(6) as pinned:
        for epoch, batch in enumerate(batches):
            with jax.enable_x64():
                want = jax_algo.train_on_batch(jax_algo.process_batch_for_training(batch),
                                               epoch)
            draws = jax_draws(pinned, jax_algo.planner)
            assert len(draws) == (mode == "cascade")
            if draws:
                algo.planner._prior_hook = lambda d=draws[0]: d
            got = algo.train_on_batch(algo.process_batch_for_training(batch), epoch)
            metrics.append((jax_algo.log_info(want), algo.log_info(got)))
    return metrics, jax_algo, algo


@pytest.mark.parametrize("mode", ["separate", "cascade"])
def test_hbc_matches_jax(mode):
    metrics, jax_algo, algo = hbc_pair(mode)
    assert set(metrics[0][1]) == set(metrics[0][0])
    check_step_metrics(metrics, metrics[0][0], 1e-8)
    check_algo(algo.planner, expected(jax_algo.planner, algo.planner))
    check_algo(algo.actor, expected(jax_algo.actor, algo.actor))

    rng = np.random.RandomState(2)
    jax_algo.reset()
    algo.reset()
    refreshed = []
    with pinned_jax(7) as pinned:
        for call in range(CALLS):
            obs = {k: f32(rng.randn(B, *s)) for k, s in OBS.items()}
            with jax.enable_x64():
                want = np.asarray(jax_algo.get_action(obs))
            draws = jax_draws(pinned, jax_algo.planner)
            if draws:
                refreshed.append(call)
                algo.planner._prior_hook = lambda d=draws[0]: d
            got = algo.get_action(obs)
            assert got.shape == (B, A)
            close(got.numpy(), want, msg=f"call {call}")
            close(algo.current_subgoal, jax_algo.current_subgoal, msg=f"call {call}")
    assert refreshed == [0, INTERVAL, 2 * INTERVAL]


# ---------------------------------------------------------------------------
# IRIS
# ---------------------------------------------------------------------------

def test_iris_matches_jax():
    rng = np.random.RandomState(3)
    jax_algo, algo = make("iris", "jax"), make("iris", "port")
    assert type(algo.planner).__name__ == "ValuePlanner"
    assert type(algo.planner.value_net).__name__ == "BCQ"
    batches = [raw_batch(rng) for _ in range(2)]
    first = jax_algo.process_batch_for_training(batches[0])
    carry(jax_algo.planner.planner, algo.planner.planner, first["planner"]["planner"], 11)
    carry(jax_algo.planner.value_net, algo.planner.value_net, first["planner"]["value_net"],
          13, module_of=bcq_module)
    first["actor"]["goal_obs"] = first["planner"]["planner"]["subgoals"]
    carry(jax_algo.actor, algo.actor, first["actor"], 17)
    eps = gl_noise(rng, 2)
    bcq = [{"enc": rng.randn(B, LATENT), "backup": rng.randn(B * 2, LATENT)}
           for _ in range(2)]
    jax_algo.planner.planner._noise_hook = hook([jnp.asarray(e) for e in eps])
    algo.planner.planner._noise_hook = hook(eps)
    jax_algo.planner.value_net._noise_hook = hook(
        [{k: jnp.asarray(v) for k, v in d.items()} for d in bcq])
    algo.planner.value_net._noise_hook = hook(bcq)
    metrics = []
    for epoch, batch in enumerate(batches):
        with jax.enable_x64():
            want = jax_algo.train_on_batch(jax_algo.process_batch_for_training(batch), epoch)
        got = algo.train_on_batch(algo.process_batch_for_training(batch), epoch)
        metrics.append((jax_algo.log_info(want), algo.log_info(got)))
    assert set(metrics[0][1]) == set(metrics[0][0])
    check_step_metrics(metrics, metrics[0][0], 1e-8)
    check_algo(algo.planner.planner, expected(jax_algo.planner.planner, algo.planner.planner))
    check_algo(algo.planner.value_net, expected(jax_algo.planner.value_net,
                                                algo.planner.value_net, bcq_module))
    check_algo(algo.actor, expected(jax_algo.actor, algo.actor))

    # a request: 5 subgoals a row scored by BCQ's value (3 candidates each)
    obs = {k: f32(rng.randn(B, *s)) for k, s in OBS.items()}
    jax_algo.reset()
    algo.reset()
    with pinned_jax(8) as pinned:
        with jax.enable_x64():
            want = np.asarray(jax_algo.get_action(obs))
        gl_draw, bcq_draw = jax_draws(pinned)
    assert gl_draw.shape == (B * N_SUBGOALS, LATENT)
    assert bcq_draw.shape == (B * N_SUBGOALS * N_ROLLOUT, LATENT)
    planner = algo.planner
    planner.planner._prior_hook = lambda: gl_draw
    planner.value_net._sample_hook = lambda: bcq_draw
    samples, values = planner.scored_subgoals(obs)
    best = values.argmax(1)
    picked = {k: v[torch.arange(B), best] for k, v in samples.items()}
    close(picked, jax_algo.current_subgoal, msg="the kept subgoal")
    second = values.topk(2, dim=1).values
    assert float((second[:, 0] - second[:, 1]).min()) > 1e-6   # no near tie
    got = algo.get_action(obs)
    close(algo.current_subgoal, jax_algo.current_subgoal, msg="current subgoal")
    close(got.numpy(), want, msg="action")


# ---------------------------------------------------------------------------
# the templates, the refused options, a checkpoint
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["hbc", "iris"])
def test_template_windows_hold_no_subgoal_in_both_packages(name):
    """The templates' ``train.seq_length`` 1 under ``subgoal_horizon`` 10:
    JAX indexes past the window, the port says why."""
    with open(os.path.join(TEMPLATES, f"{name}.json")) as f:
        template = json.load(f)
    shapes = {"robot0_eef_pos": (3,), "robot0_eef_quat": (4,),
              "robot0_gripper_qpos": (2,), "object": (10,)}
    for factory, obs_utils, algos, kwargs in (
            (jax_config_factory, JaxObsUtils, JaxAlgo, {}),
            (config_factory, PortObsUtils, PortAlgo, {"device": "cpu"})):
        cfg = factory(name, dic=template)
        assert cfg.train.seq_length == 1
        obs_utils.initialize_obs_utils_with_config(cfg)
        algo = algos.algo_factory(name, cfg, shapes, 7, **kwargs)
        batch = {g: {k: np.zeros((2, 1, *s), np.float32) for k, s in shapes.items()}
                 for g in ("obs", "next_obs")}
        batch.update(actions=np.zeros((2, 1, 7), np.float32),
                     rewards=np.zeros((2, 1), np.float32), dones=np.zeros((2, 1), np.float32))
        error = ValueError if algos is PortAlgo else IndexError
        with pytest.raises(error):
            algo.process_batch_for_training(batch)


UNTAKEN = {
    "latent_subgoal": ("latent_subgoal.enabled", True),
    "random_subgoals": ("actor_use_random_subgoals", True),
    "latent_clip": ("planner.vae.latent_clip", 2.0),
    "unconditioned_decoder": ("planner.vae.decoder.is_conditioned", False),
    "summed_reconstruction": ("planner.vae.decoder.reconstruction_sum_across_elements",
                              True),
    "learned_prior": ("planner.vae.prior.learn", True),
    "gmm_prior": ("planner.vae.prior.use_gmm", True),
    "categorical_prior": ("planner.vae.prior.use_categorical", True),
}


@pytest.mark.parametrize("option", sorted(UNTAKEN))
def test_options_the_jax_classes_ignore_raise(option):
    key, value = UNTAKEN[option]
    cfg = tune(config_factory("hbc"))
    with cfg.values_unlocked():
        node = cfg.algo
        *path, leaf = key.split(".")
        for p in path:
            node = node[p]
        node[leaf] = value
    PortObsUtils.initialize_obs_utils_with_config(cfg)
    with pytest.raises(NotImplementedError):
        PortAlgo.algo_factory("hbc", cfg, dict(OBS), A, device="cpu")


def test_hbc_refuses_observation_statistics():
    algo = make("hbc", "port")
    batch = algo.process_batch_for_training(raw_batch(np.random.RandomState(0)))
    stats = {k: {"offset": np.zeros((1, *s)), "scale": np.ones((1, *s))}
             for k, s in OBS.items()}
    with pytest.raises(NotImplementedError):
        algo.postprocess_batch_for_training(batch, obs_normalization_stats=stats)


def test_hbc_checkpoint_serves_through_policy_from_checkpoint(tmp_path, monkeypatch):
    """One epoch of HBC through ``scripts/train.train`` on the test demos;
    its checkpoint, through ``policy_from_checkpoint``, is a
    ``RolloutPolicy`` whose actions over two subgoal intervals equal the
    trained algo's in the same wrapper (both generators seeded alike)."""
    demos = write_demo_file(str(tmp_path / "demos.hdf5"), [12, 10, 11], with_images=False)
    with h5py.File(demos, "a") as f:
        f["data"].attrs["env_args"] = json.dumps({"env_name": "Fake", "type": 1,
                                                  "env_kwargs": {}})
        for ep in f["data"].values():   # the subgoals come from next_obs
            pos = ep["obs/eef_pos"][()]
            ep.create_dataset("next_obs/eef_pos", data=np.concatenate([pos[1:], pos[-1:]]))
    cfg = config_factory("hbc")
    with cfg.values_unlocked():
        for section in (cfg.observation.planner, cfg.observation.actor):
            section.modalities.obs.low_dim = ["eef_pos"]
        cfg.observation.planner.modalities.subgoal.low_dim = ["eef_pos"]
        _planner(cfg.algo.planner)
        _actor(cfg.algo.actor)
        cfg.algo.subgoal_update_interval = INTERVAL
        cfg.experiment.name = "hbc_ckpt"
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
        cfg.train.seq_length = SH
        cfg.train.dataset_keys = ["actions"]
        cfg.train.action_config = {"actions": {"normalization": "min_max"}}
    assert cfg.all_obs_keys == ["eef_pos"] and not cfg.use_goals
    trained = []
    factory = PortAlgo.algo_factory

    def record(*args, **kwargs):
        trained.append(factory(*args, **kwargs))
        return trained[-1]

    monkeypatch.setattr(PortTrain.Algo, "algo_factory", record)
    PortTrain.train(cfg, device="cpu")
    monkeypatch.undo()
    assert trained[0].planner.global_step == trained[0].actor.global_step == 2
    (path,) = glob.glob(str(tmp_path / "out" / "hbc_ckpt" / "*" / "models" / "*.pth"))
    policy, ckpt = FileUtils.policy_from_checkpoint(device="cpu", ckpt_path=path)
    assert type(policy) is PortAlgo.RolloutPolicy
    assert type(policy.policy).__name__ == "HBC"
    assert set(ckpt["model"]) == {"planner", "actor"}
    twin = PortAlgo.RolloutPolicy(
        trained[0], obs_normalization_stats=ckpt.get("obs_normalization_stats"),
        action_normalization_stats=ckpt.get("action_normalization_stats"))
    rng = np.random.RandomState(4)
    for p in (policy, twin):
        p.start_episode()
        p.policy.planner.generator.manual_seed(11)
    for _ in range(2 * INTERVAL):
        ob = {"eef_pos": rng.randn(3).astype(np.float32)}
        got, want = policy(ob), twin(ob)
        assert got.shape == (3,) and np.isfinite(got).all()
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# an image step through the stem pool
# ---------------------------------------------------------------------------

CAM, IMG = "agentview_image", 32


def _image(cfg):
    """@cfg (``hbc``, separate) with a 32 x 32 camera on a ResNet-18 (no
    randomizer) in the planner's observations, and ``train.pallas_pool``
    (the actor's image path is ``BC_RNN``'s, held by the ICL family's
    tests)."""
    tune(cfg)
    with cfg.values_unlocked():
        planner = cfg.observation.planner
        planner.modalities.obs.rgb = [CAM]
        rgb = planner.encoder.rgb
        rgb.core_class = "VisualCore"
        rgb.core_kwargs = {"feature_dimension": 8, "backbone_class": "ResNet18Conv",
                           "backbone_kwargs": {"pretrained": False},
                           "pool_class": "SpatialSoftmax",
                           "pool_kwargs": {"num_kp": 4, "noise_std": 0.0}}
        rgb.obs_randomizer_class = None
        cfg.train.pallas_pool = True
    return cfg


def test_hbc_image_step_with_the_stem_pool_matches_jax():
    """One step: the planner's trunk in inference mode (the JAX step's
    ``train=False``: running statistics, unchanged) pooling through the
    recorded-argmax stem pool (the plain versions of kernels 3 and 4 on the
    CPU); its gradient reaches the trunk."""
    shapes = {**OBS, CAM: (IMG, IMG, 3)}
    rng = np.random.RandomState(6)
    batch = raw_batch(rng)
    for g in ("obs", "next_obs"):
        batch[g][CAM] = rng.randint(0, 256, (B, SH, IMG, IMG, 3)).astype(np.uint8)
    try:
        cfg = _image(jax_config_factory("hbc"))
        JaxObsUtils.initialize_obs_utils_with_config(cfg)
        jax_algo = JaxAlgo.algo_factory("hbc", cfg, shapes, A)
        cfg = _image(config_factory("hbc"))
        PortObsUtils.initialize_obs_utils_with_config(cfg)
        algo = PortAlgo.algo_factory("hbc", cfg, shapes, A, device="cpu")
        pools = [m for m in algo.nets.modules() if type(m).__name__ == "StemMaxPool"]
        assert len(pools) == 1 and pools[0].recorded_argmax and pools[0].use_kernel
        first = jax_algo.process_batch_for_training(batch)
        carry(jax_algo.planner, algo.planner, first["planner"], 21)
        first["actor"]["goal_obs"] = first["planner"]["subgoals"]
        carry(jax_algo.actor, algo.actor, first["actor"], 23)
        eps = gl_noise(rng, 1)
        jax_algo.planner._noise_hook = hook([jnp.asarray(e) for e in eps])
        algo.planner._noise_hook = hook(eps)
        before = copy.deepcopy(algo.planner.nets.state_dict())
        with jax.enable_x64():
            want = jax_algo.log_info(jax_algo.train_on_batch(
                jax_algo.process_batch_for_training(batch), 0))
        got = algo.log_info(algo.train_on_batch(algo.process_batch_for_training(batch), 0))
    finally:
        set_pallas_pool(False)   # Algo.__init__ set the JAX package's flag
    check_step_metrics([(want, got)], want, 1e-8)
    check_algo(algo.planner, expected(jax_algo.planner, algo.planner))
    check_algo(algo.actor, expected(jax_algo.actor, algo.actor))
    after = algo.planner.nets.state_dict()
    stats = [k for k in after if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * 20   # 20 BatchNorms in a ResNet-18
    for k in stats:
        assert torch.equal(after[k], before[k]), k
    stem = [k for k in after if k.endswith("backbone.nets.0.weight")]
    assert len(stem) == 1 and not torch.equal(after[stem[0]], before[stem[0]])
