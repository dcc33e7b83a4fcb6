"""The port's rollout path against the JAX package's, on the CPU, at the
small sizes of tests/test_torch_train_harness.py (one GPT layer of width 32,
one 32 x 32 camera cropped to 28, T = 3; torch on one thread):

* ``RolloutPolicy._prepare_observation`` and ``_unnormalize_action`` equal
  to the JAX package's, with and without batching, language and frame
  stacking, rot_6d converted to axis-angle and to Euler angles; with an
  image as the first key and no frame stacking the JAX package tiles the
  language embedding over the image's rows, the port over the batch;
* ``run_rollout``, ``run_batched_rollout`` (pipes and shared memory),
  ``rollout_with_stats`` and ``should_save_from_rollout_logs`` give the JAX
  package's results and policy-call counts on a deterministic fake policy;
* the slice as a whole: a flagship checkpoint saved by the port rolls out
  through the port's ``policy_from_checkpoint`` and through the JAX
  package's reader (``load_reference_torch_checkpoint`` ->
  ``convert_flagship_checkpoint`` -> ``policy_from_checkpoint``) on equal
  fake envs, one env and a pool of two: per-step actions within 1e-5, equal
  Return, Horizon and Success_Rate; the paper policy with the GMM's
  ``mode`` / ``eps`` injected on both sides, actions within 1e-4;
* the action MSE equal to the JAX package's ``compute_mse_visualize`` for
  the same weights and windows;
* ``scripts/train.py`` with rollouts (one env and a pool), additional envs
  and the action MSE, and ``scripts/run_trained_agent.py``.
"""

import argparse
import glob
import json
import os
from types import SimpleNamespace

import h5py
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from robot_manipulation_vq_vae_tpu.algo.algo import ICLRolloutPolicy as JaxICLRolloutPolicy
from robot_manipulation_vq_vae_tpu.algo.algo import RolloutPolicy as JaxRolloutPolicy
from robot_manipulation_vq_vae_tpu.config import config_factory as jax_config_factory
from robot_manipulation_vq_vae_tpu.data.dataset import SequenceDataset as JaxSequenceDataset
from robot_manipulation_vq_vae_tpu.envs.vector_env import SubprocVectorEnv as JaxVectorEnv
from robot_manipulation_vq_vae_tpu.envs.wrappers import FrameStackWrapper as JaxFrameStack
from robot_manipulation_vq_vae_tpu.models import distributions as JaxDist
from robot_manipulation_vq_vae_tpu.models.base_nets import set_pallas_pool
from robot_manipulation_vq_vae_tpu.utils import ckpt_conversion as Conv
from robot_manipulation_vq_vae_tpu.utils import file_utils as JaxFileUtils
from robot_manipulation_vq_vae_tpu.utils import lang_utils as JaxLang
from robot_manipulation_vq_vae_tpu.utils import obs_utils as JaxObsUtils
from robot_manipulation_vq_vae_tpu.utils import train_utils as JaxTrainUtils

import robot_manipulation_vq_vae_tpu_torch.algo as PortAlgo
from robot_manipulation_vq_vae_tpu_torch.algo.algo import ICLRolloutPolicy, RolloutPolicy
from robot_manipulation_vq_vae_tpu_torch.config import config_factory
from robot_manipulation_vq_vae_tpu_torch.data.dataset import SequenceDataset
from robot_manipulation_vq_vae_tpu_torch.envs.vector_env import SubprocVectorEnv
from robot_manipulation_vq_vae_tpu_torch.envs.wrappers import FrameStackWrapper
from robot_manipulation_vq_vae_tpu_torch.models import distributions as PortDist
from robot_manipulation_vq_vae_tpu_torch.scripts import run_trained_agent as PortAgent
from robot_manipulation_vq_vae_tpu_torch.scripts import train as PortTrain
from robot_manipulation_vq_vae_tpu_torch.utils import env_utils as EnvUtils
from robot_manipulation_vq_vae_tpu_torch.utils import file_utils as FileUtils
from robot_manipulation_vq_vae_tpu_torch.utils import lang_utils as PortLang
from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils as PortObsUtils
from robot_manipulation_vq_vae_tpu_torch.utils import train_utils as TrainUtils
from robot_manipulation_vq_vae_tpu_torch.utils.jax_weights import load_jax_variables
import torch_port_fake_env as Fake
from test_torch_train_harness import A, CAMS, IMG, LOW_DIM, SHAPES, T, _batches, _configure
from torch_port_helpers import jax_algo_jit_init, perturbed_variables
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# a deterministic fake policy
# ---------------------------------------------------------------------------

ACTION_KEYS = ["action_dict/rel_pos", "action_dict/rel_rot_6d", "action_dict/gripper"]
FAKE_SHAPES = {"robot0_eef_pos": [5], "robot0_gripper_qpos": [2], "cam_image": [6, 6, 3],
               "lang_emb": [768]}


class FakePolicy:
    """Stands in for an algo: a deterministic 10-d normalized action
    (3 position, 6 rot_6d, 1 gripper) from the newest low-dim frame, the
    language embedding and the context actions."""

    def __init__(self, conversion="rot_axis_angle"):
        action_config = {k: {"normalization": None} for k in ACTION_KEYS}
        action_config["action_dict/rel_rot_6d"].update(
            format="rot_6d", convert_at_runtime=conversion)
        self.global_config = SimpleNamespace(train=SimpleNamespace(
            action_keys=ACTION_KEYS, action_config=action_config))
        self.obs_shapes = FAKE_SHAPES
        self.calls = 0

    def set_eval(self):
        pass

    def reset(self):
        pass

    def get_action(self, obs_dict, context_batch=None, goal_dict=None):
        self.calls += 1
        x = np.asarray(obs_dict["robot0_eef_pos"], np.float64)
        x = x.reshape(x.shape[0], -1, 5)[:, -1]
        ac = np.tanh(np.concatenate([x[:, :3], x[:, :3], x[:, 2:], -x[:, :1]], axis=1))
        ac[:, 3] += 1.5   # rot_6d rows away from degenerate
        ac[:, 7] += 1.5
        if "lang_emb" in obs_dict:
            ac += np.asarray(obs_dict["lang_emb"]).reshape(x.shape[0], -1)[:, :10]
        if context_batch is not None:
            ac += 0.1 * np.asarray(context_batch["actions"]).reshape(x.shape[0], -1)[:, :10]
        return ac.astype(np.float32)


def _action_stats():
    return {k: {"scale": np.full((1, n), 2.0, np.float32),
                "offset": np.full((1, n), 0.25, np.float32)}
            for k, n in zip(ACTION_KEYS, (3, 6, 1))}


def _obs_stats():
    return {"robot0_eef_pos": {"offset": np.full((1, 5), 0.5, np.float32),
                               "scale": np.full((1, 5), 3.0, np.float32)}}


def _policies(conversion="rot_axis_angle", icl=True, lang=True):
    """(port policy, JAX policy) over two fake policies, each wrapper with
    the same statistics and language encoders."""
    out = []
    for cls, lang_cls in (((ICLRolloutPolicy if icl else RolloutPolicy), PortLang),
                          ((JaxICLRolloutPolicy if icl else JaxRolloutPolicy), JaxLang)):
        out.append(cls(FakePolicy(conversion), obs_normalization_stats=_obs_stats(),
                       action_normalization_stats=_action_stats(),
                       lang_encoder=lang_cls.LangEncoder() if lang else None))
    return out


def _obs(rng, lead, image_first=False):
    obs = {"robot0_eef_pos": rng.randn(*lead, 5).astype(np.float32),
           "robot0_gripper_qpos": rng.randn(*lead, 2).astype(np.float32)}
    image = rng.randint(0, 256, (*lead, 6, 6, 3), dtype=np.uint8)
    return {"cam_image": image, **obs} if image_first else {**obs, "cam_image": image}


def _assert_dicts_equal(got, want):
    assert list(got) == list(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# the rollout policy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stacked", [False, True], ids=["one_frame", "stacked"])
@pytest.mark.parametrize("lang", [False, True], ids=["no_lang", "lang"])
@pytest.mark.parametrize("batched", [False, True], ids=["one_env", "batched"])
def test_prepare_observation_equals_jax(batched, lang, stacked):
    port, ref = _policies(lang=lang)
    lead = ((3,) if batched else ()) + ((4,) if stacked else ())
    ob = _obs(np.random.RandomState(1), lead)
    for p in (port, ref):
        p.start_episode(lang="pick the cube")
    got = port._prepare_observation(ob, batched=batched)
    want = ref._prepare_observation(ob, batched=batched)
    _assert_dicts_equal(got, want)
    if lang:
        assert got["lang_emb"].shape == ((1,) if not batched else ()) + lead + (768,)


@pytest.mark.parametrize("batched", [False, True], ids=["one_env", "batched"])
def test_language_tiles_over_the_batch_not_an_image(batched):
    """An image as the first key, frames not stacked: the JAX package takes
    the embedding's leading dimensions from that image ([N, H] batched, H
    copies unbatched); the port takes them from the batch."""
    port, ref = _policies()
    ob = _obs(np.random.RandomState(2), (3,) if batched else (), image_first=True)
    for p in (port, ref):
        p.start_episode(lang="open the drawer")
    got = port._prepare_observation(ob, batched=batched)["lang_emb"]
    want = ref._prepare_observation(ob, batched=batched)["lang_emb"]
    assert got.shape == (3, 768) if batched else got.shape == (1, 768)
    assert want.shape == ((3, 6, 768) if batched else (1, 6, 768))
    np.testing.assert_array_equal(got[0], want[0, 0])
    with pytest.raises(ValueError, match="shape the policy knows"):
        port._prepare_observation({"unknown": np.zeros((2, 3))}, batched=True)


@pytest.mark.parametrize("batched", [False, True], ids=["one_env", "batched"])
@pytest.mark.parametrize("conversion", ["rot_axis_angle", "rot_euler"])
def test_unnormalize_action_equals_jax(conversion, batched):
    port, ref = _policies(conversion)
    ac = np.random.RandomState(3).uniform(-1, 1, (4, 10) if batched else (10,)).astype(
        np.float32)
    got, want = port._unnormalize_action(ac), ref._unnormalize_action(ac)
    assert got.shape == ((4, 7) if batched else (7,)) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    port.action_normalization_stats = None
    assert port._unnormalize_action(ac) is ac


@pytest.mark.parametrize("icl", [False, True], ids=["plain", "icl"])
def test_policy_call_equals_jax(icl):
    """One env with 4 stacked frames, then a batch of 2 such envs."""
    port, ref = _policies(icl=icl)
    rng = np.random.RandomState(4)
    ctx = {"actions": rng.randn(1, 4, 10).astype(np.float32)}
    kw = {"context_batch": ctx} if icl else {}
    for p in (port, ref):
        p.start_episode(lang="stack")
    for batched, lead in ((False, (4,)), (True, (2, 4))):
        ob = _obs(rng, lead)
        got, want = port(ob, batched=batched, **kw), ref(ob, batched=batched, **kw)
        assert got.shape == ((2, 7) if batched else (7,))
        np.testing.assert_array_equal(got, want)
    assert port.policy.calls == ref.policy.calls == 2


@pytest.mark.parametrize("demos", [1, 3], ids=["one_demo", "one_per_env"])
def test_context_is_tiled_to_the_batch(demos):
    """In a batched query a context of one demo is tiled to the envs, and a
    context of one demo per env passes as it is; the actions equal JAX's."""
    port, ref = _policies()
    rng = np.random.RandomState(5)
    ctx = {"actions": rng.randn(demos, 4, 10).astype(np.float32)}
    seen = []
    get_action = port.policy.get_action

    def record(**kwargs):
        seen.append(kwargs["context_batch"]["actions"])
        return get_action(**kwargs)

    port.policy.get_action = record
    for p in (port, ref):
        p.start_episode(lang="x")
    ob = _obs(rng, (3, 4))
    np.testing.assert_array_equal(port(ob, context_batch=ctx, batched=True),
                                  ref(ob, context_batch=ctx, batched=True))
    np.testing.assert_array_equal(seen[0], np.broadcast_to(ctx["actions"], (3, 4, 10)))


def test_to_host_moves_a_tensor_once():
    from robot_manipulation_vq_vae_tpu_torch.algo.algo import to_host

    t = torch.arange(6.0).reshape(2, 3)
    assert isinstance(to_host(t), np.ndarray)
    np.testing.assert_array_equal(to_host(t), t.numpy())


# ---------------------------------------------------------------------------
# the rollout loops
# ---------------------------------------------------------------------------

def _factory(seed=0, **env_kwargs):
    meta = {"env_name": "FakeEnv", "type": Fake.FAKE_ENV_TYPE,
            "env_kwargs": {"cams": ["cam_image"], "img": 6, "seed": seed,
                           "env_lang": "lift", **env_kwargs}}
    specs = {"obs": {"low_dim": list(Fake.LOW_DIM), "rgb": ["cam_image"]}}
    return EnvUtils.EnvFactory(meta, specs, frame_stack=4)


def _no_time(logs):
    return {k: v for k, v in logs.items() if k not in ("time", "Time_Episode")}


@pytest.mark.parametrize("terminate", [False, True], ids=["horizon", "on_success"])
def test_run_rollout_equals_jax(terminate):
    port, ref = _policies()
    ctx = {"actions": np.random.RandomState(5).randn(1, 4, 10).astype(np.float32)}
    env_kw = dict(cams=["cam_image"], img=6, seed=7, env_lang="lift")
    got = TrainUtils.run_rollout(port, FrameStackWrapper(Fake.FakeEnv(**env_kw), 4),
                                 horizon=8, context_batch=ctx,
                                 terminate_on_success=terminate)
    want = JaxTrainUtils.run_rollout(ref, JaxFrameStack(Fake.FakeEnv(**env_kw), 4),
                                     horizon=8, context_batch=ctx,
                                     terminate_on_success=terminate)
    assert _no_time(got) == _no_time(want)
    assert got["Horizon"] == (5 if terminate else 8) and got["Success_Rate"] == 1.0
    assert port.policy.calls == ref.policy.calls == got["Horizon"]


@pytest.mark.parametrize("shared_obs", [False, True], ids=["pipes", "shared_memory"])
def test_run_batched_rollout_equals_jax(shared_obs):
    port, ref = _policies()
    ctx = {"actions": np.random.RandomState(6).randn(1, 4, 10).astype(np.float32)}
    fns = [_factory(seed=i) for i in range(3)]
    with SubprocVectorEnv(fns, shared_obs=shared_obs) as venv:
        got = TrainUtils.run_batched_rollout(port, venv, horizon=8, context_batch=ctx,
                                             terminate_on_success=True)
    jvenv = JaxVectorEnv(fns)
    try:
        want = JaxTrainUtils.run_batched_rollout(ref, jvenv, horizon=8, context_batch=ctx,
                                                 terminate_on_success=True)
    finally:
        jvenv.close()
    assert [_no_time(g) for g in got] == [_no_time(w) for w in want]
    assert [g["Horizon"] for g in got] == [5, 5, 5]
    assert port.policy.calls == ref.policy.calls == 5


def test_rollout_with_stats_equals_jax():
    """One env of 3 episodes, a pool of 3 envs of 5 episodes (2 passes), and
    an env whose policy raises: printed, then the fallback entry."""
    port, ref = _policies()
    ctx = {"actions": np.zeros((1, 4, 10), np.float32)}
    env_kw = dict(cams=["cam_image"], img=6, seed=2, env_lang="lift")

    class Broken(Fake.FakeEnv):
        def step(self, action):
            raise RuntimeError("the simulator fell over")

    fns = [_factory(seed=i) for i in range(3)]
    with SubprocVectorEnv(fns, shared_obs=True) as venv:
        got, _ = TrainUtils.rollout_with_stats(
            port, {"one": FrameStackWrapper(Fake.FakeEnv(**env_kw), 4), "pool": venv,
                   "broken": Broken()},
            horizon=6, context_batch=ctx, num_episodes=5, terminate_on_success=True)
    jvenv = JaxVectorEnv(fns)
    try:
        want, _ = JaxTrainUtils.rollout_with_stats(
            ref, {"one": JaxFrameStack(Fake.FakeEnv(**env_kw), 4), "pool": jvenv,
                  "broken": Broken()},
            horizon=6, context_batch=ctx, num_episodes=5, terminate_on_success=True)
    finally:
        jvenv.close()
    assert list(got) == list(want) == ["one", "pool", "broken"]
    for name in want:
        assert _no_time(got[name]) == _no_time(want[name]), name
    assert got["broken"] == {"Success_Rate": 0.0}
    assert "Time_Episode" in got["pool"] and got["pool"]["Horizon"] == 5
    # one query in the broken env before its step raises
    assert port.policy.calls == ref.policy.calls == 5 * 5 + 2 * 5 + 1


@pytest.mark.parametrize("on_return", [False, True])
@pytest.mark.parametrize("on_success", [False, True])
def test_should_save_from_rollout_logs_equals_jax(on_return, on_success):
    epochs = [{"a": {"Return": 1.0, "Success_Rate": 0.5}, "b": {"Success_Rate": 0.0}},
              {"a": {"Return": 2.0, "Success_Rate": 0.5}, "b": {"Return": 0.0,
                                                               "Success_Rate": 0.2}},
              {"a": {"Return": 0.5, "Success_Rate": 1.0}, "b": {"Success_Rate": 0.0}}]
    state = {}
    for fn in (TrainUtils.should_save_from_rollout_logs,
               JaxTrainUtils.should_save_from_rollout_logs):
        best_r, best_s, out = {"a": -np.inf, "b": -np.inf}, {"a": -1.0, "b": -1.0}, []
        for epoch, logs in enumerate(epochs):
            res = fn(logs, best_r, best_s, f"model_epoch_{epoch}", on_return, on_success)
            best_r, best_s = res["best_return"], res["best_success_rate"]
            out.append((res["epoch_ckpt_name"], res["should_save_ckpt"]))
        state[fn.__module__] = (out, best_r, best_s)
    got, want = state.values()
    assert got == want
    assert got[0][1][1] == (on_return or on_success)


def test_small_helpers_equal_jax():
    obs = [{"a": np.full(2, i), "b": np.full((1, 3), -i)} for i in range(3)]
    _assert_dicts_equal(TrainUtils.batchify_obs(obs), JaxTrainUtils.batchify_obs(obs))
    for args in ((None, 3), (5, 10), (5, 0), (5, 0, True), (3, 7)):
        assert TrainUtils.is_every_n_steps(*args) == JaxTrainUtils.is_every_n_steps(*args)
    with pytest.raises(ValueError):
        TrainUtils.is_every_n_steps(0, 1)


# ---------------------------------------------------------------------------
# the slice as a whole: a port checkpoint rolled out by both packages
# ---------------------------------------------------------------------------

def _flagship_config(context_length=T):
    cfg = _configure(config_factory("icl"))
    with cfg.values_unlocked():
        cfg.algo.transformer.context_length = context_length
        cfg.train.seq_length = 2 * context_length - 1
        cfg.train.frame_stack = context_length
    return cfg


ENV_META = {"env_name": "FakeEnv", "type": Fake.FAKE_ENV_TYPE,
            "env_kwargs": {"low_dim": {k: s[0] for k, s in LOW_DIM.items()}, "cams": CAMS,
                           "img": IMG, "ac_dim": A, "success_at": 4,
                           "env_lang": "task 0"}}


def _save_flagship(path, context_length=T):
    """A flagship trained 2 steps on the CPU and saved by the port, with
    action statistics and the fake env's metadata. Returns the algo."""
    cfg = _flagship_config(context_length)
    PortObsUtils.initialize_obs_utils_with_config(cfg)
    algo = PortAlgo.algo_factory("icl", cfg, SHAPES, A, device="cpu")
    for batch in _batches(2):
        algo.train_on_batch({"obs": {k: v[:, :context_length] for k, v in batch["obs"].items()},
                             "actions": batch["actions"][:, :context_length]}, epoch=1)
    shape_meta = {"all_shapes": {k: list(v) for k, v in SHAPES.items()},
                  "all_obs_keys": sorted(SHAPES), "ac_dim": A, "use_images": True}
    stats = {"actions": {"scale": np.full((1, A), 0.5, np.float32),
                         "offset": np.full((1, A), 0.1, np.float32)}}
    TrainUtils.save_model(algo, cfg, ENV_META, shape_meta, path,
                          action_normalization_stats=stats)
    return algo


@pytest.fixture(scope="module")
def flagship_ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("rollout") / "model_epoch_2.pth")
    _save_flagship(path)
    return path


class Recorded:
    """A rollout policy that keeps each action it returns."""

    def __init__(self, policy):
        self.policy, self.actions = policy, []

    def start_episode(self, lang=None):
        self.policy.start_episode(lang)

    def __call__(self, *args, **kwargs):
        ac = self.policy(*args, **kwargs)
        self.actions.append(np.array(ac))
        return ac


def _jax_policy(path):
    ckpt = Conv.convert_flagship_checkpoint(JaxFileUtils.load_reference_torch_checkpoint(path))
    try:
        policy, _ = JaxFileUtils.policy_from_checkpoint(ckpt_dict=ckpt)
    finally:
        set_pallas_pool(False)
    # the JAX package's reader gives the policy no language encoder
    policy.lang_encoder = JaxLang.LangEncoder()
    return policy


def _context(seed=8):
    batch = _batches(1, seed, 1)[0]
    return {"obs": batch["obs"], "actions": batch["actions"]}


def test_port_checkpoint_rolls_out_as_in_the_jax_package(flagship_ckpt):
    port, ckpt = FileUtils.policy_from_checkpoint(device="cpu", ckpt_path=flagship_ckpt)
    assert isinstance(port, ICLRolloutPolicy) and port.lang_encoder is not None
    ref = _jax_policy(flagship_ckpt)
    cfg, _ = FileUtils.config_from_checkpoint(ckpt_dict=ckpt)
    ctx = _context()
    runs = {}
    for side, policy in (("port", port), ("jax", ref)):
        env, _ = FileUtils.env_from_checkpoint(ckpt_dict=ckpt)
        rec = Recorded(policy)
        result = TrainUtils.run_rollout(rec, EnvUtils.wrap_env_from_config(env, cfg),
                                        horizon=6, context_batch=ctx,
                                        terminate_on_success=True)
        runs[side] = (rec.actions, result)
    (got, got_res), (want, want_res) = runs["port"], runs["jax"]
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.shape == w.shape == (A,)
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)
    for k in ("Return", "Horizon", "Success_Rate"):
        assert got_res[k] == want_res[k], k
    assert got_res["Horizon"] == 4 and got_res["Success_Rate"] == 1.0


def test_port_checkpoint_batched_rollout_as_in_the_jax_package(flagship_ckpt):
    """A pool of 2 spawned envs with shared memory each: the port's policy,
    then the JAX package's."""
    port, ckpt = FileUtils.policy_from_checkpoint(device="cpu", ckpt_path=flagship_ckpt)
    ref = _jax_policy(flagship_ckpt)
    cfg, _ = FileUtils.config_from_checkpoint(ckpt_dict=ckpt)
    factories = [EnvUtils.EnvFactory.from_config(ENV_META, cfg)] * 2
    runs = {}
    for side, policy in (("port", port), ("jax", ref)):
        rec = Recorded(policy)
        with SubprocVectorEnv(factories, shared_obs=True) as venv:
            runs[side] = (rec.actions, TrainUtils.run_batched_rollout(
                rec, venv, horizon=5, context_batch=_context()))
    (got, got_res), (want, want_res) = runs["port"], runs["jax"]
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.shape == (2, A)
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)
    strip = [{k: r[k] for k in ("Return", "Horizon", "Success_Rate")} for r in got_res]
    assert strip == [{k: r[k] for k in ("Return", "Horizon", "Success_Rate")}
                     for r in want_res]
    assert strip[0] == {"Return": 5.0, "Horizon": 5, "Success_Rate": 1.0}


def test_paper_policy_rollout_with_injected_noise(monkeypatch):
    """icl_gmm_paper with the JAX weights in the port: both rollout policies
    sample with the same injected ``mode`` / ``eps`` (one draw for every
    step, as the JAX call is compiled once), actions within 1e-4."""
    jax_cfg = _configure(jax_config_factory("icl_gmm_paper"), "icl_gmm_paper")
    port_cfg = _configure(config_factory("icl_gmm_paper"), "icl_gmm_paper")
    for cfg in (jax_cfg, port_cfg):
        with cfg.values_unlocked():
            cfg.train.frame_stack = T
    JaxObsUtils.initialize_obs_utils_with_config(jax_cfg)
    try:
        jax_algo = jax_algo_jit_init("icl_gmm_paper", jax_cfg, SHAPES, A)
        jax_algo.ensure_state(_batches(1, 3, 2)[0])
        variables = {"params": jax_algo.state.params["policy"],
                     **jax_algo.state.aux["policy"]}
        nested, flat = perturbed_variables(variables, 5, kernel_scale=10.0,
                                           scale_under="net/transformer/")
        params = nested.pop("params")
        jax_algo.state = jax_algo.state.replace(params={"policy": params},
                                                aux={"policy": nested})
    finally:
        set_pallas_pool(False)
    PortObsUtils.initialize_obs_utils_with_config(port_cfg)
    algo = PortAlgo.algo_factory("icl_gmm_paper", port_cfg, SHAPES, A, device="cpu")
    load_jax_variables(algo.nets["policy"], flat)

    rng = np.random.RandomState(11)
    _mode = rng.randint(0, 5, (1, T)).astype(np.int32)
    _eps = rng.randn(1, T, A).astype(np.float32)
    jax_sample = JaxDist.GMMActionDistribution.sample
    port_sample = PortDist.GMMActionDistribution.sample
    monkeypatch.setattr(
        JaxDist.GMMActionDistribution, "sample",
        lambda self, key, mode=None, eps=None: jax_sample(
            self, key, mode=jnp.asarray(_mode), eps=jnp.asarray(_eps)))
    monkeypatch.setattr(
        PortDist.GMMActionDistribution, "sample",
        lambda self, generator=None, mode=None, eps=None: port_sample(
            self, mode=torch.from_numpy(_mode), eps=torch.from_numpy(_eps)))
    stats = {"actions": {"scale": np.full((1, A), 0.5, np.float32),
                         "offset": np.zeros((1, A), np.float32)}}
    runs = {}
    for side, algo_, cls, lang in (("port", algo, ICLRolloutPolicy, PortLang),
                                   ("jax", jax_algo, JaxICLRolloutPolicy, JaxLang)):
        rec = Recorded(cls(algo_, action_normalization_stats=stats,
                           lang_encoder=lang.LangEncoder()))
        env = EnvUtils.wrap_env(Fake.FakeEnv(**ENV_META["env_kwargs"]), T)
        runs[side] = (rec.actions, TrainUtils.run_rollout(
            rec, env, horizon=4, context_batch=_context(9)))
    (got, got_res), (want, want_res) = runs["port"], runs["jax"]
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)
    assert _no_time(got_res) == _no_time(want_res)


# ---------------------------------------------------------------------------
# the action MSE
# ---------------------------------------------------------------------------

def _write_demos(path, n=3, length=10, seed=0):
    """Demos with the harness's observations, actions and a language string
    each, whose env metadata names the fake env."""
    rng = np.random.RandomState(seed)
    with h5py.File(path, "w") as f:
        data = f.create_group("data")
        data.attrs["env_args"] = json.dumps(ENV_META)
        for i in range(n):
            ep = data.create_group(f"demo_{i}")
            ep.attrs["num_samples"] = length
            ep.attrs["ep_meta"] = json.dumps({"lang": f"task {i % 2}"})
            for k, s in LOW_DIM.items():
                ep.create_dataset(f"obs/{k}", data=rng.randn(length, *s).astype(np.float32))
            for c in CAMS:
                ep.create_dataset(f"obs/{c}", data=rng.randint(
                    0, 256, (length, IMG, IMG, 3), dtype=np.uint8))
            ep.create_dataset("actions", data=rng.uniform(-1, 1, (length, A)).astype(
                np.float32))
    return path


@pytest.fixture(scope="module")
def demo_path(tmp_path_factory):
    return _write_demos(str(tmp_path_factory.mktemp("rollout_demos") / "demos.hdf5"))


def _datasets(demo_path, cfg, seq_cls, lang):
    """The training and validation datasets (both over every demo)."""
    kw = dict(hdf5_path=demo_path, obs_keys=list(LOW_DIM) + CAMS,
              action_keys=["actions"], dataset_keys=["actions"],
              action_config={"actions": {"normalization": None}},
              seq_length=cfg.train.seq_length, hdf5_cache_mode="all",
              load_next_obs=False, lang_encoder=lang.LangEncoder())
    return seq_cls(**kw), seq_cls(**kw)


def test_action_mse_equals_jax(demo_path, tmp_path):
    """A flagship with a context of one step (the JAX package's
    compute_mse_visualize reshapes the window of actions to the
    prediction's shape, which holds only then), saved by the port and read
    by the JAX package: the same windows, the same MSE and accuracies; the
    port also writes the plots."""
    path = str(tmp_path / "mse.pth")
    algo = _save_flagship(path, context_length=1)
    ckpt = Conv.convert_flagship_checkpoint(JaxFileUtils.load_reference_torch_checkpoint(path))
    try:
        jax_policy, _ = JaxFileUtils.policy_from_checkpoint(ckpt_dict=ckpt)
    finally:
        set_pallas_pool(False)
    cfg = _flagship_config(1)
    train, valid = _datasets(demo_path, cfg, SequenceDataset, PortLang)
    jtrain, jvalid = _datasets(demo_path, cfg, JaxSequenceDataset, JaxLang)
    got, vis = algo.compute_mse_visualize(train, valid, num_samples=5,
                                          savedir=str(tmp_path / "plots"))
    want, _ = jax_policy.policy.compute_mse_visualize(jtrain, jvalid, num_samples=5)
    assert set(got) == set(want) and len(got) == 8
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-7, err_msg=k)
    assert sorted(vis) == ["train_pred", "valid_pred"]
    assert all(os.path.getsize(p) > 0 for p in vis.values())


def test_action_mse_of_a_window_policy(demo_path, flagship_ckpt):
    """With a context of T = 3 steps, all supervised, with future actions
    (the flagship's configuration), ``get_action`` predicts the window's
    first step: the port holds it against that step, where the JAX
    package's reshape of the window raises."""
    algo, _ = FileUtils.algo_from_checkpoint(device="cpu", ckpt_path=flagship_ckpt)
    cfg = _flagship_config()
    train, _ = _datasets(demo_path, cfg, SequenceDataset, PortLang)
    got, vis = algo.compute_mse_visualize(train, None, num_samples=4)
    assert vis == {} and len(got) == 4
    assert sum(k.startswith("Train/action_accuracy@") for k in got) == 3
    from robot_manipulation_vq_vae_tpu_torch.data.loader import collate

    idx = np.random.RandomState(0).choice(len(train), 4, replace=False)
    batch = algo.process_batch_for_training(collate([train[int(i)] for i in idx]))
    pred = algo._predict_actions_for_mse(batch)
    want = float(np.mean((pred - batch["actions"][:, 0]) ** 2))
    assert got["Train/action_mse_error"] == pytest.approx(want, rel=1e-6)
    with pytest.raises(ValueError):
        np.asarray(batch["actions"]).reshape(pred.shape)   # the JAX package's step


# ---------------------------------------------------------------------------
# scripts
# ---------------------------------------------------------------------------

def _train_args(cfg_path, **kw):
    args = dict(config=cfg_path, algo=None, name=None, dataset=None, output_dir=None,
                debug=False, eval_only=False, auto_resume=False, device="cpu")
    args.update(kw)
    return argparse.Namespace(**args)


@pytest.mark.parametrize("batched", [False, True], ids=["one_env", "pool"])
def test_train_with_rollouts_additional_envs_and_mse(demo_path, tmp_path, monkeypatch,
                                                    batched):
    """Two epochs with rollouts every epoch in the dataset's env (one env,
    or a pool of 2 spawned envs with shared memory) and in an additional
    env, and the action MSE every epoch: the results are logged and
    returned, the best success rate saves a checkpoint named for it, and
    the pool is closed."""
    cfg = json.loads(_flagship_config().dump())
    cfg["train"].update(data=demo_path, output_dir=str(tmp_path / "out"), num_epochs=2,
                        num_data_workers=1)
    exp = cfg["experiment"]
    exp.update(epoch_every_n_steps=1, additional_envs=["FakeEnvB"], render_video=False)
    exp["rollout"].update(enabled=True, n=2, horizon=5, rate=1, warmstart=0,
                          terminate_on_success=True, batched=batched, num_batch_envs=2)
    exp["mse"].update(enabled=True, every_n_epochs=1, num_samples=4, visualize=True)
    exp["save"].update(enabled=False, on_best_rollout_success_rate=True)
    cfg_path = str(tmp_path / "cfg.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    segments = []
    setup_shm = SubprocVectorEnv._setup_shm

    def record_segment(self, first_obs_list):
        setup_shm(self, first_obs_list)
        segments.append(self.shm_name)

    monkeypatch.setattr(SubprocVectorEnv, "_setup_shm", record_segment)
    history = PortTrain.main(_train_args(cfg_path))
    assert [h["epoch"] for h in history] == [1, 2]
    for h in history:
        for env in ("FakeEnv", "FakeEnvB"):
            assert h[f"Rollout/Success_Rate/{env}"] == 1.0
            assert h[f"Rollout/Horizon/{env}"] == 4.0
            assert h[f"Rollout/Return/{env}"] == 4.0
        assert np.isfinite(h["Train/action_mse_error"]) and "Train/action_accuracy@0.001" in h
    ckpts = sorted(os.path.basename(p) for p in glob.glob(
        str(tmp_path / "out" / "harness" / "*" / "models" / "*.pth")))
    # the first epoch beats the initial -1 in both envs; the second ties
    assert ckpts == ["model_epoch_1_FakeEnv_success_1.0_FakeEnvB_success_1.0.pth"]
    plots = glob.glob(str(tmp_path / "out" / "harness" / "*" / "videos" / "mse_epoch_2" /
                          "*.png"))
    assert [os.path.basename(p) for p in plots] == ["train_pred.png"]
    assert len(segments) == (1 if batched else 0)   # the dataset env's pool
    assert not any(os.path.exists(f"/dev/shm/{name}") for name in segments)


def test_run_trained_agent(flagship_ckpt, demo_path, capsys, monkeypatch):
    """The ICL policy of a checkpoint with a context window from the demos;
    a run in which no episode finishes fails."""
    args = PortAgent.parser().parse_args([
        "--agent", flagship_ckpt, "--n_rollouts", "2", "--horizon", "6",
        "--dataset", demo_path, "--device", "cpu"])
    logs = PortAgent.main(args)
    assert logs["FakeEnv"]["Success_Rate"] == 1.0 and logs["FakeEnv"]["Horizon"] == 4.0
    assert '"Success_Rate": 1.0' in capsys.readouterr().out
    assert PortAgent.parser().parse_args(["--agent", "x.pth"]).device is None
    monkeypatch.setattr(Fake.FakeEnv, "step", lambda self, action: 1 / 0)
    with pytest.raises(RuntimeError, match="no episode of FakeEnv finished"):
        PortAgent.main(args)
