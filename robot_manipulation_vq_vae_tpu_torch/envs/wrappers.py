"""Environment wrappers (a copy of the JAX package's ``envs/wrappers.py``;
reference ``robomimic/envs/wrappers.py``):
EnvWrapper base + FrameStackWrapper, which maintains a rolling history of
the last ``num_frames`` observations so transformer policies see
[T, ...]-stacked inputs at rollout time."""

from collections import deque

import numpy as np


class EnvWrapper:
    """Base wrapper: delegates everything to the wrapped env
    (reference wrappers.py:12-95)."""

    def __init__(self, env):
        self.env = env

    @classmethod
    def class_name(cls):
        return cls.__name__

    @property
    def unwrapped(self):
        if hasattr(self.env, "unwrapped"):
            return self.env.unwrapped
        return self.env

    def __getattr__(self, attr):
        if attr.startswith("_"):
            raise AttributeError(attr)
        result = getattr(self.env, attr)
        if callable(result):
            def hooked(*args, **kwargs):
                out = result(*args, **kwargs)
                if out is self.env:
                    return self
                return out

            return hooked
        return result

    def __repr__(self):
        return f"{self.class_name()}({self.env!r})"


class FrameStackWrapper(EnvWrapper):
    """Stack the last @num_frames observations per key
    (reference wrappers.py:97-224)."""

    def __init__(self, env, num_frames):
        assert num_frames > 1
        super().__init__(env)
        self.num_frames = num_frames
        self.obs_history = None
        self._cached_obs_history = None

    def _get_initial_obs_history(self, init_obs):
        return {
            k: deque(
                [init_obs[k][None] for _ in range(self.num_frames)],
                maxlen=self.num_frames,
            )
            for k in init_obs
        }

    def _get_stacked_obs_from_history(self):
        return {
            k: np.concatenate(self.obs_history[k], axis=0)
            for k in self.obs_history
        }

    def cache_obs_history(self):
        self._cached_obs_history = {
            k: deque(list(v), maxlen=self.num_frames)
            for k, v in self.obs_history.items()
        }

    def uncache_obs_history(self):
        self.obs_history = self._cached_obs_history
        self._cached_obs_history = None

    def reset(self):
        obs = self.env.reset()
        self.timestep = 0
        self.obs_history = self._get_initial_obs_history(obs)
        return self._get_stacked_obs_from_history()

    def reset_to(self, state):
        obs = self.env.reset_to(state)
        self.timestep = 0
        self.obs_history = self._get_initial_obs_history(obs)
        return self._get_stacked_obs_from_history()

    def step(self, action):
        obs, r, done, info = self.env.step(action)
        self.update_obs(obs, action=action, reset=False)
        obs_ret = self._get_stacked_obs_from_history()
        return obs_ret, r, done, info

    def update_obs(self, obs, action=None, reset=False):
        obs["timesteps"] = np.array([self.timestep])
        if reset:
            obs["actions"] = np.zeros(self.env.action_dimension)
        else:
            self.timestep += 1
            obs["actions"] = action[: self.env.action_dimension]
        for k in self.obs_history:
            if k in obs:
                self.obs_history[k].append(np.asarray(obs[k])[None])

    def _to_string(self):
        return f"num_frames={self.num_frames}"
