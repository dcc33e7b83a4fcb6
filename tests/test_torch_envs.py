"""The port's environment layer against the JAX package's, on the CPU:

* ``utils/rotation_utils.py`` equal to the JAX module to the bit on seeded
  inputs (the reference-oracle rotation tests need a mount that is absent);
* ``FrameStackWrapper`` equal to the JAX one on the same env;
* the spawn-context ``SubprocVectorEnv``: pipes and shared memory deliver
  the same observations; per-env observations survive the next step; a
  spawned env built by ``EnvFactory`` sees the observation registry (and
  one built without it drops the images); ``close()`` leaves no segment in
  /dev/shm and the resource tracker prints nothing;
* ``EnvGym`` against a real gymnasium ``Pendulum-v1``;
* ``EnvRobosuite`` against a structural mock of robosuite (copies of
  tests/test_env_robosuite_mock.py's tests).

Pools hold at most 3 workers.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from robot_manipulation_vq_vae_tpu.envs.wrappers import FrameStackWrapper as JaxFrameStack
from robot_manipulation_vq_vae_tpu.utils import rotation_utils as JaxRot

from robot_manipulation_vq_vae_tpu_torch.envs.env_base import EnvType
from robot_manipulation_vq_vae_tpu_torch.envs.vector_env import SubprocVectorEnv
from robot_manipulation_vq_vae_tpu_torch.envs.wrappers import FrameStackWrapper
from robot_manipulation_vq_vae_tpu_torch.utils import env_utils as EnvUtils
from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils as ObsUtils
from robot_manipulation_vq_vae_tpu_torch.utils import rotation_utils as Rot
import torch_port_fake_env as Fake

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# rotations
# ---------------------------------------------------------------------------

def _rotation_inputs(name, rng):
    """Seeded inputs of the shape @name takes, [4, 3, ...]."""
    if name.startswith("rot_6d"):
        return (rng.randn(4, 3, 6),)
    if name.startswith("matrix"):
        return (JaxRot.rot_6d_to_matrix(rng.randn(4, 3, 6)),)
    if name.startswith("quaternion"):
        return (rng.randn(4, 3, 4),)
    if name.startswith("axis_angle"):
        aa = rng.randn(4, 3, 3)
        aa[0, 0] = 0.0   # the small-angle branches
        aa[0, 1] = 1e-9
        return (aa,)
    if name.startswith("euler"):
        return (rng.uniform(-np.pi, np.pi, (4, 3, 3)),)
    raise AssertionError(name)


ROTATIONS = sorted(n for n in dir(JaxRot) if not n.startswith("_")
                   and callable(getattr(JaxRot, n)) and n != "np")


def test_rotation_module_is_a_copy():
    assert ROTATIONS == sorted(n for n in dir(Rot) if not n.startswith("_")
                               and callable(getattr(Rot, n)) and n != "np")
    assert len(ROTATIONS) == 14


@pytest.mark.parametrize("name", ROTATIONS)
def test_rotation_equals_jax_to_the_bit(name):
    args = _rotation_inputs(name, np.random.RandomState(len(name)))
    got = getattr(Rot, name)(*args)
    want = getattr(JaxRot, name)(*args)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# frame stacking
# ---------------------------------------------------------------------------

def test_frame_stack_equals_jax():
    """reset, steps, reset_to, cache / uncache of the history: the stacked
    observations of the two wrappers over two equal envs are equal."""
    kw = dict(cams=["cam_image"], img=6, seed=3)
    port = FrameStackWrapper(Fake.FakeEnv(**kw), num_frames=4)
    ref = JaxFrameStack(Fake.FakeEnv(**kw), num_frames=4)
    act = np.linspace(-1, 1, Fake.A).astype(np.float32)

    def same(a, b):
        assert set(a) == set(b) == set(Fake.LOW_DIM) | {"cam_image"}
        for k in a:
            assert a[k].shape[0] == 4
            np.testing.assert_array_equal(a[k], b[k])

    same(port.reset(), ref.reset())
    for i in range(6):
        if i == 3:
            port.cache_obs_history()
            ref.cache_obs_history()
        po, pr, pd, pi = port.step(act)
        jo, jr, jd, ji = ref.step(act)
        same(po, jo)
        assert (pr, pd) == (jr, jd)
        np.testing.assert_array_equal(pi["action"], act)
    assert port.timestep == ref.timestep == 6
    port.uncache_obs_history()
    ref.uncache_obs_history()
    same(port._get_stacked_obs_from_history(), ref._get_stacked_obs_from_history())
    same(port.reset_to({"states": np.array([2.0])}),
         ref.reset_to({"states": np.array([2.0])}))
    # the newest frame last; the wrapper delegates the rest to the env
    assert port.action_dimension == Fake.A and port.unwrapped is port.env
    assert "num_frames=4" in port._to_string()


# ---------------------------------------------------------------------------
# the spawn pool
# ---------------------------------------------------------------------------

def _factory(frame_stack=3, **env_kwargs):
    meta = {"env_name": "FakeEnv", "type": Fake.FAKE_ENV_TYPE,
            "env_kwargs": {"cams": ["cam_image"], "img": 6, **env_kwargs}}
    specs = {"obs": {"low_dim": list(Fake.LOW_DIM), "rgb": ["cam_image"]}}
    return EnvUtils.EnvFactory(meta, specs, frame_stack=frame_stack)


def test_env_factory_is_picklable_and_builds_the_wrapped_env():
    import pickle

    factory = pickle.loads(pickle.dumps(_factory(seed=4)))
    assert factory.env_class is Fake.FakeEnv
    env = factory()
    assert isinstance(env, FrameStackWrapper) and env.num_frames == 3
    assert env.env.seed == 4 and env.reset()["cam_image"].shape == (3, 6, 6, 3)
    assert isinstance(EnvUtils.EnvFactory(factory.env_meta, factory.obs_specs)(),
                      Fake.FakeEnv)


def test_pool_starts_by_spawn_by_default():
    with SubprocVectorEnv([_factory()]) as venv:
        assert type(venv.procs[0]).__name__ == "SpawnProcess"


def test_pipe_and_shared_memory_deliver_the_same_observations():
    fns = [_factory(seed=i) for i in range(3)]
    with SubprocVectorEnv(fns) as pipe, SubprocVectorEnv(fns, shared_obs=True) as shm:
        a, b = pipe.reset_batched(), shm.reset_batched()
        assert set(a) == set(b) and b["cam_image"].shape == (3, 3, 6, 6, 3)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
        actions = np.tile(np.linspace(0, 1, Fake.A, dtype=np.float32), (3, 1))
        for _ in range(3):
            oa, ra, da, ia = pipe.step_batched(actions)
            ob, rb, db, ib = shm.step_batched(actions)
            np.testing.assert_array_equal(ra, rb)
            np.testing.assert_array_equal(da, db)
            for k in oa:
                np.testing.assert_array_equal(oa[k], ob[k])
            for x, y in zip(ia, ib):
                np.testing.assert_array_equal(x["action"], y["action"])
        # the per-env API of both transports
        la, _, _, _ = pipe.step(actions)
        lb, _, _, _ = shm.step(actions)
        for x, y in zip(la, lb):
            for k in x:
                np.testing.assert_array_equal(x[k], y[k])
        assert [s["task"] for s in shm.is_success()] == [False] * 3
        assert shm.get_env_attr("seed") == [0, 1, 2]
        assert [r.shape for r in shm.render(mode="rgb_array", height=4, width=5)] == \
            [(4, 5, 3)] * 3
        assert shm.call("get_state")[0]["states"][0] == 4.0


def test_per_env_observations_survive_the_next_step():
    """The JAX pool returns views of the shared block from step / reset /
    reset_to, which the next step overwrites; the port returns copies."""
    with SubprocVectorEnv([_factory(seed=i) for i in range(2)], shared_obs=True) as venv:
        first = venv.reset()
        keep = [{k: v.copy() for k, v in o.items()} for o in first]
        stepped, _, _, _ = venv.step(np.zeros((2, Fake.A), np.float32))
        kept_step = [{k: v.copy() for k, v in o.items()} for o in stepped]
        venv.step(np.ones((2, Fake.A), np.float32))
        reset_to = venv.reset_to([{"states": np.array([1.0])}] * 2)
        venv.step(np.ones((2, Fake.A), np.float32))
        for got, want in ((first, keep), (stepped, kept_step)):
            for g, w in zip(got, want):
                for k in w:
                    np.testing.assert_array_equal(g[k], w[k])
        assert not np.array_equal(stepped[0]["cam_image"], venv._batch["cam_image"][0])
        assert not np.shares_memory(reset_to[0]["cam_image"], venv._batch["cam_image"])
        part = venv.reset(ids=[1])
        assert len(part) == 1 and not np.shares_memory(part[0]["cam_image"],
                                                       venv._batch["cam_image"])


@pytest.mark.parametrize("shared_obs", [False, True], ids=["pipes", "shared_memory"])
def test_is_success_asks_each_env(shared_obs):
    """is_success() answers each env's is_success() after the steps so far,
    whichever command came before it."""
    acts = np.zeros((2, Fake.A), np.float32)
    with SubprocVectorEnv([_factory(seed=i, success_at=2 + i) for i in range(2)],
                          shared_obs=shared_obs) as venv:
        venv.reset_batched()
        venv.step_batched(acts)
        assert venv.is_success() == venv.call("is_success") == [{"task": False}] * 2
        venv.step(acts)
        assert venv.is_success() == [{"task": True}, {"task": False}]
        assert venv.is_success() == [{"task": True}, {"task": False}]
        venv.step(acts)
        venv.get_env_attr("seed")
        assert venv.is_success() == [{"task": True}] * 2
        venv.reset(ids=[0])
        assert venv.is_success() == [{"task": False}, {"task": True}]


def test_spawned_env_sees_the_observation_registry():
    """EnvRobosuite keeps only the keys the observation registry knows. A
    spawned worker starts with an empty registry: built by EnvFactory it
    sees every configured key; built without it, the worker finds no
    registry and fails at its first observation."""
    meta = {"env_name": "Lift", "type": EnvType.ROBOSUITE_TYPE, "env_kwargs": {}}
    specs = {"obs": {"low_dim": ["robot0_eef_pos"], "rgb": ["agentview_image"]}}
    factory = EnvUtils.EnvFactory(meta, specs, env_class=Fake.MockedEnvRobosuite,
                                  use_image_obs=True)
    with SubprocVectorEnv([factory] * 2) as venv:
        obs = venv.reset()
    for o in obs:
        assert set(o) == {"robot0_eef_pos", "robot0_proprio-state", "agentview_image"}
        assert o["agentview_image"].dtype == np.float32   # processed as rgb

    with SubprocVectorEnv([Fake.bare_robosuite]) as bare:
        with pytest.raises((EOFError, ConnectionResetError)):
            bare.reset()


def test_close_leaves_no_segment_and_no_tracker_warning(tmp_path):
    """In a fresh interpreter: a shared-memory pool of 3 spawned workers is
    stepped and closed; the segment is gone after close() and is still gone
    after the interpreter exits, and neither it nor the resource tracker
    prints a warning or a traceback."""
    script = textwrap.dedent(f"""
        import os, sys
        sys.path[:0] = [{REPO!r}, {os.path.join(REPO, 'tests')!r}]
        import numpy as np
        import torch_port_fake_env as Fake
        from robot_manipulation_vq_vae_tpu_torch.envs.vector_env import SubprocVectorEnv
        from robot_manipulation_vq_vae_tpu_torch.utils import env_utils as EnvUtils

        if __name__ == "__main__":
            meta = {{"env_name": "FakeEnv", "type": Fake.FAKE_ENV_TYPE,
                     "env_kwargs": {{"cams": ["cam_image"], "img": 6}}}}
            specs = {{"obs": {{"low_dim": list(Fake.LOW_DIM), "rgb": ["cam_image"]}}}}
            venv = SubprocVectorEnv([EnvUtils.EnvFactory(meta, specs, frame_stack=2)] * 3,
                                    shared_obs=True)
            batch = venv.reset_batched()
            for _ in range(3):
                batch, _, _, _ = venv.step_batched(np.zeros((3, Fake.A), np.float32))
            name = venv.shm_name
            assert os.path.exists("/dev/shm/" + name)
            venv.close()
            print("SEGMENT", name, os.path.exists("/dev/shm/" + name))
    """)
    path = tmp_path / "pool.py"
    path.write_text(script)
    out = subprocess.run([sys.executable, str(path)], capture_output=True, text=True,
                         cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    line = [l for l in out.stdout.splitlines() if l.startswith("SEGMENT")][0]
    _, name, exists = line.split()
    assert exists == "False"
    assert not os.path.exists("/dev/shm/" + name)
    for word in ("resource_tracker", "leaked", "KeyError", "Traceback", "Warning"):
        assert word not in out.stderr, out.stderr


def test_close_is_idempotent_and_tolerates_a_held_batch():
    venv = SubprocVectorEnv([_factory()] * 2, shared_obs=True)
    held = venv.reset_batched()["cam_image"]   # a view the caller still holds
    name = venv.shm_name
    venv.close()
    venv.close()
    assert not os.path.exists(f"/dev/shm/{name}")
    assert held.shape == (2, 3, 6, 6, 3)
    assert all(not p.is_alive() for p in venv.procs)


# ---------------------------------------------------------------------------
# gymnasium
# ---------------------------------------------------------------------------

def test_env_gym_protocol_roundtrip():
    """create_env_from_metadata -> reset / step / observation / serialize on
    a real Pendulum-v1."""
    pytest.importorskip("gymnasium")
    env_meta = {"env_name": "Pendulum-v1", "type": EnvType.GYM_TYPE, "env_kwargs": {}}
    env = EnvUtils.create_env_from_metadata(env_meta=env_meta)
    ob = env.reset()
    assert set(ob) == {"flat"} and ob["flat"].shape == (3,)
    assert env.action_dimension == 1
    total_r = 0.0
    for _ in range(5):
        ob, r, done, info = env.step(np.array([0.5], np.float32))
        total_r += r
    assert ob["flat"].dtype == np.float32
    assert np.isfinite(total_r)
    assert env.is_done() in (False, True)
    assert env.serialize()["env_name"] == "Pendulum-v1"
    assert not EnvUtils.is_robosuite_env(env_meta=env_meta)
    assert env.get_state()["states"].size == 0


# ---------------------------------------------------------------------------
# robosuite, mocked
# ---------------------------------------------------------------------------

@pytest.fixture()
def mock_robosuite(monkeypatch):
    mod = Fake.mock_robosuite_module()
    monkeypatch.setitem(sys.modules, "robosuite", mod)
    ObsUtils.initialize_obs_utils_with_obs_specs(
        {"obs": {"low_dim": ["robot0_eef_pos"], "rgb": ["agentview_image"]}})
    return mod


def test_robosuite_factory_and_obs_processing(mock_robosuite):
    env_meta = {"env_name": "PnPCounterToCab", "type": 1,
                "env_kwargs": {"robots": "PandaMobile"}}
    env = EnvUtils.create_env_from_metadata(env_meta, use_image_obs=True)
    assert EnvUtils.is_robosuite_env(env_meta)
    inner = mock_robosuite._made[-1]
    assert inner.kwargs["robots"] == "PandaMobile"
    assert inner.kwargs["use_camera_obs"] is True
    assert inner.kwargs["ignore_done"] is True

    obs = env.reset()
    # registered keys kept; proprio kept; unregistered dropped
    assert set(obs) == {"robot0_eef_pos", "robot0_proprio-state", "agentview_image"}
    flipped = inner._obs()["agentview_image"][::-1]
    np.testing.assert_allclose(np.asarray(obs["agentview_image"]),
                               flipped.astype(np.float32) / 255.0, atol=1e-6)
    obs2, r, done, info = env.step(np.zeros(Fake.MOCK_A))
    assert r == 0.5 and done is False
    assert env.action_dimension == Fake.MOCK_A
    assert env.name == "PnPCounterToCab"


def test_robosuite_reset_to_semantics(mock_robosuite):
    from robot_manipulation_vq_vae_tpu_torch.envs.env_robosuite import EnvRobosuite

    env = EnvRobosuite("Lift")
    inner = mock_robosuite._made[-1]
    out = env.reset_to({"model": "<mujoco><raw/></mujoco>"})
    assert out is None
    assert inner.xml_loaded == "<mujoco><edited/></mujoco>"
    assert inner.sim.reset_count == 1
    vec = np.arange(Fake.STATE_DIM, dtype=np.float64)
    out = env.reset_to({"states": vec})
    assert out is not None
    np.testing.assert_array_equal(inner.sim.state, vec)
    state = env.get_state()
    assert state["model"] == "<mujoco><current/></mujoco>"
    np.testing.assert_array_equal(state["states"], vec)
    env.reset_to({"states": state["states"]})
    np.testing.assert_array_equal(inner.sim.state, vec)


def test_robosuite_success_reward_serialize(mock_robosuite):
    from robot_manipulation_vq_vae_tpu_torch.envs.env_robosuite import EnvRobosuite

    env = EnvRobosuite("Lift", robots="Panda")
    inner = mock_robosuite._made[-1]
    assert env.is_success() == {"task": False}
    inner.sim.state = np.full(Fake.STATE_DIM, 5.0)
    assert env.is_success() == {"task": True}
    assert env.get_reward() == 5.0
    blob = env.serialize()
    assert blob["env_name"] == "Lift"
    assert blob["env_version"] == "1.5.0-mock"
    assert blob["env_kwargs"] == {"robots": "Panda"}
    assert isinstance(env.rollout_exceptions, tuple)


def test_robosuite_create_for_data_processing(mock_robosuite):
    from robot_manipulation_vq_vae_tpu_torch.envs.env_robosuite import EnvRobosuite

    env = EnvRobosuite.create_for_data_processing(
        env_name="Kitchen", camera_names=["agentview"], camera_height=48,
        camera_width=64, reward_shaping=True)
    inner = mock_robosuite._made[-1]
    assert inner.kwargs["camera_names"] == ["agentview"]
    assert inner.kwargs["camera_heights"] == 48
    assert inner.kwargs["camera_widths"] == 64
    assert inner.kwargs["reward_shaping"] is True
    assert inner.kwargs["use_camera_obs"] is True
    assert env.reset()["agentview_image"].dtype == np.uint8   # postprocess off
    EnvRobosuite.create_for_data_processing(
        env_name="Kitchen", camera_names=[], camera_height=48, camera_width=64,
        reward_shaping=False)
    assert mock_robosuite._made[-1].kwargs["use_camera_obs"] is False


def test_robosuite_render_modes(mock_robosuite):
    from robot_manipulation_vq_vae_tpu_torch.envs.env_robosuite import EnvRobosuite

    env = EnvRobosuite("Lift")
    im = env.render(mode="rgb_array", height=8, width=6, camera_name="agentview")
    assert im.shape == (8, 6, 3)
    with pytest.raises(NotImplementedError):
        env.render(mode="weird")


def test_robosuite_needs_its_package(monkeypatch):
    from robot_manipulation_vq_vae_tpu_torch.envs.env_robosuite import EnvRobosuite

    monkeypatch.setitem(sys.modules, "robosuite", None)
    with pytest.raises(ImportError, match="robosuite"):
        EnvRobosuite("Lift")
    with pytest.raises(NotImplementedError, match="MOMART"):
        EnvUtils.get_env_class(env_type=EnvType.IG_MOMART_TYPE)


@pytest.mark.parametrize("worker_unregisters", [True, False],
                         ids=["jax_worker", "port_worker"])
def test_what_the_tracker_does_under_spawn(tmp_path, worker_unregisters):
    """Python 3.12's resource tracker keeps one set of segment names, shared
    by spawned workers: a worker that unregisters a segment it attached to,
    as the JAX package's worker does, removes the parent's registration, and
    the parent's unlink then makes the tracker print a KeyError. A worker
    that leaves the registration alone, as the port's does, prints
    nothing."""
    script = textwrap.dedent("""
        import multiprocessing as mp, sys
        from multiprocessing import resource_tracker, shared_memory

        def child(name, unregister):
            shm = shared_memory.SharedMemory(name=name)
            if unregister:
                resource_tracker.unregister(shm._name, "shared_memory")
            shm.close()

        if __name__ == "__main__":
            shm = shared_memory.SharedMemory(create=True, size=64)
            p = mp.get_context("spawn").Process(
                target=child, args=(shm.name, sys.argv[1] == "1"))
            p.start()
            p.join()
            shm.close()
            shm.unlink()
    """)
    path = tmp_path / "tracker.py"
    path.write_text(script)
    out = subprocess.run([sys.executable, str(path), "1" if worker_unregisters else "0"],
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert ("KeyError" in out.stderr) == worker_unregisters, out.stderr
