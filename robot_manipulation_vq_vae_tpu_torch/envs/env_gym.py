"""Gym environment wrapper (a copy of the JAX package's ``envs/env_gym.py``;
reference ``robomimic/envs/env_gym.py``).
Gated on the gym/gymnasium package being installed."""

import numpy as np

from robot_manipulation_vq_vae_tpu_torch.envs.env_base import EnvBase, EnvType


def _import_gym():
    try:
        import gymnasium as gym

        return gym, True
    except ImportError:
        import gym

        return gym, False


class EnvGym(EnvBase):
    """Thin EnvBase adapter over gym envs with flat observations exposed
    under the "flat" key (matching the reference convention)."""

    def __init__(self, env_name, render=False, render_offscreen=False,
                 use_image_obs=False, use_depth_obs=False,
                 postprocess_visual_obs=True, **kwargs):
        gym, self._is_gymnasium = _import_gym()
        self._env_name = env_name
        self._init_kwargs = dict(kwargs)
        self.env = gym.make(env_name, **kwargs)
        self._current_obs = None
        self._current_reward = None
        self._current_done = None

    def step(self, action):
        out = self.env.step(action)
        if len(out) == 5:  # gymnasium
            obs, reward, terminated, truncated, info = out
            done = bool(terminated or truncated)
        else:
            obs, reward, done, info = out
        self._current_obs = obs
        self._current_reward = reward
        self._current_done = done
        return self.get_observation(obs), reward, done, info

    def reset(self):
        out = self.env.reset()
        obs = out[0] if isinstance(out, tuple) else out
        self._current_obs = obs
        return self.get_observation(obs)

    def reset_to(self, state):
        if hasattr(self.env, "set_state"):
            self.env.set_state(state)
            return self.get_observation(self._current_obs)
        raise NotImplementedError

    def render(self, mode="human", height=None, width=None, camera_name=None):
        return self.env.render()

    def get_observation(self, obs=None):
        if obs is None:
            obs = self._current_obs
        return {"flat": np.asarray(obs, dtype=np.float32).reshape(-1)}

    def get_state(self):
        return {"states": np.array([])}

    def get_reward(self):
        return self._current_reward

    def get_goal(self):
        raise NotImplementedError

    def set_goal(self, **kwargs):
        raise NotImplementedError

    def is_done(self):
        return bool(self._current_done)

    def is_success(self):
        return {"task": bool(self._current_done and (self._current_reward or 0) > 0)}

    @property
    def action_dimension(self):
        return int(np.prod(self.env.action_space.shape))

    @property
    def name(self):
        return self._env_name

    @property
    def type(self):
        return EnvType.GYM_TYPE

    def serialize(self):
        return dict(
            env_name=self._env_name, type=self.type,
            env_kwargs=dict(self._init_kwargs),
        )

    @classmethod
    def create_for_data_processing(cls, camera_names, camera_height,
                                   camera_width, reward_shaping, **kwargs):
        return cls(**kwargs)
