"""Environments for the port's rollout tests (tests/test_torch_envs.py,
tests/test_torch_rollout.py), importing only the port, so that the
spawned workers of ``SubprocVectorEnv`` can import them:

* ``FakeEnv``: a deterministic env whose observation layout comes from its
  constructor (low-dim keys, cameras of uint8 images): each step's
  observation is a seeded function of the env's seed and step, not of the
  action, so two frameworks whose actions differ in the last bits see the
  same observations. The reward is 1 a step, success comes at
  ``success_at`` steps, and ``info`` echoes the action. Registered under
  ``FAKE_ENV_TYPE`` so that env metadata can name it.
* a structural mock of robosuite (a copy of the one in
  tests/test_env_robosuite_mock.py), and ``MockedEnvRobosuite``, the port's
  ``EnvRobosuite`` over that mock, which a spawned worker can build.
"""

import sys
import types

import numpy as np

from robot_manipulation_vq_vae_tpu_torch.envs.env_base import EnvBase
from robot_manipulation_vq_vae_tpu_torch.envs.env_robosuite import EnvRobosuite
from robot_manipulation_vq_vae_tpu_torch.utils import env_utils as EnvUtils

FAKE_ENV_TYPE = 78
A = 7
LOW_DIM = {"robot0_eef_pos": 5, "robot0_gripper_qpos": 2}


class FakeEnv(EnvBase):
    """See the module docstring. @low_dim: {key: width}; @cams: camera keys
    of @img x @img x 3 uint8 images."""

    def __init__(self, env_name="FakeEnv", render=False, render_offscreen=False,
                 use_image_obs=False, use_depth_obs=False, postprocess_visual_obs=True,
                 low_dim=None, cams=(), img=8, ac_dim=A, success_at=5, seed=0,
                 env_lang=None, **kwargs):
        self._env_name = env_name
        self.low_dim = dict(LOW_DIM if low_dim is None else low_dim)
        self.cams, self.img = list(cams), img
        self._ac_dim, self.success_at, self.seed = ac_dim, success_at, seed
        self.env_lang = env_lang
        self._t = 0
        self._episode = 0

    def step(self, action):
        action = np.asarray(action)
        assert action.shape == (self._ac_dim,), action.shape
        self._t += 1
        return self.get_observation(), 1.0, False, {"action": action.copy()}

    def reset(self):
        self._t = 0
        self._episode += 1
        return self.get_observation()

    def reset_to(self, state):
        self._t = int(state["states"][0])
        return self.get_observation()

    def render(self, mode="human", height=None, width=None, camera_name=None):
        if mode == "rgb_array":
            return np.zeros((height or 32, width or 32, 3), np.uint8)
        return None

    def get_observation(self):
        rng = np.random.RandomState(self.seed * 100003 + self._episode * 1009 + self._t)
        obs = {k: rng.randn(w).astype(np.float32) for k, w in self.low_dim.items()}
        for c in self.cams:
            obs[c] = rng.randint(0, 256, (self.img, self.img, 3), dtype=np.uint8)
        return obs

    def get_state(self):
        return {"states": np.array([self._t], np.float64)}

    def get_reward(self):
        return 1.0

    def get_goal(self):
        return self.get_observation()

    def set_goal(self, **kwargs):
        pass

    def is_done(self):
        return False

    def is_success(self):
        return {"task": self._t >= self.success_at}

    @property
    def action_dimension(self):
        return self._ac_dim

    @property
    def name(self):
        return self._env_name

    @property
    def type(self):
        return FAKE_ENV_TYPE

    def serialize(self):
        return dict(env_name=self._env_name, type=self.type, env_kwargs={})

    @classmethod
    def create_for_data_processing(cls, *args, **kwargs):
        return cls()


EnvUtils.register_env_class(FAKE_ENV_TYPE, FakeEnv)


# ---------------------------------------------------------------------------
# robosuite mock
# ---------------------------------------------------------------------------

STATE_DIM, MOCK_A, MOCK_IMG = 7, 5, 12


class MockSimState:
    def __init__(self, vec):
        self._vec = np.asarray(vec, np.float64)

    def flatten(self):
        return self._vec.copy()


class MockSim:
    def __init__(self):
        self.state = np.zeros(STATE_DIM)
        self.reset_count = 0

    class _Model:
        @staticmethod
        def get_xml():
            return "<mujoco><current/></mujoco>"

    model = _Model()

    def reset(self):
        self.reset_count += 1

    def get_state(self):
        return MockSimState(self.state)

    def set_state_from_flattened(self, vec):
        self.state = np.asarray(vec, np.float64).copy()

    def forward(self):
        pass

    def render(self, height=None, width=None, camera_name=None):
        return np.full((height, width, 3), 7, np.uint8)


class MockRobosuiteEnv:
    def __init__(self, **kwargs):
        self.kwargs = kwargs
        self.sim = MockSim()
        self.xml_loaded = None
        self._t = 0

    def _obs(self):
        img = np.arange(MOCK_IMG * MOCK_IMG * 3, dtype=np.uint8).reshape(
            MOCK_IMG, MOCK_IMG, 3)
        return {
            "robot0_eef_pos": self.sim.state[:3].astype(np.float32),
            "robot0_proprio-state": np.ones(4, np.float32),
            "agentview_image": img,
            "object-state": np.zeros(3, np.float32),  # unregistered key
        }

    def reset(self):
        self.sim.state = np.zeros(STATE_DIM)
        return self._obs()

    def reset_from_xml_string(self, xml):
        self.xml_loaded = xml

    def edit_model_xml(self, xml):
        return xml.replace("<raw/>", "<edited/>")

    def step(self, action):
        self._t += 1
        self.sim.state = self.sim.state + 1.0
        return self._obs(), 0.5, False, {"info": 1}

    def _get_observations(self, force_update=False):
        return self._obs()

    def reward(self):
        return float(self.sim.state[0])

    def _check_success(self):
        return self.sim.state[0] > 2.0

    @property
    def action_spec(self):
        return np.zeros(MOCK_A), np.ones(MOCK_A)


def mock_robosuite_module():
    """A ``robosuite`` module whose ``make`` builds MockRobosuiteEnv and
    records each env in ``_made``."""
    mod = types.ModuleType("robosuite")
    mod.__version__ = "1.5.0-mock"
    made = []

    def make(env_name, **kwargs):
        env = MockRobosuiteEnv(env_name=env_name, **kwargs)
        made.append(env)
        return env

    mod.make = make
    mod._made = made
    return mod


class MockedEnvRobosuite(EnvRobosuite):
    """The port's EnvRobosuite over the mock, which it installs as
    ``robosuite`` where none is imported (in a spawned worker, say)."""

    def __init__(self, *args, **kwargs):
        sys.modules.setdefault("robosuite", mock_robosuite_module())
        super().__init__(*args, **kwargs)


def bare_robosuite():
    """The mocked EnvRobosuite built without filling the observation
    registry, as a spawned worker would build it from the class alone."""
    return MockedEnvRobosuite("Lift", use_image_obs=True)
