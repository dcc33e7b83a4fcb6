"""Environment abstraction (a copy of the JAX package's ``envs/env_base.py``;
reference ``robomimic/envs/env_base.py``).

MuJoCo/robosuite simulation stays a host-CPU dependency (SURVEY.md phase 5:
do not port the sim); this layer defines the protocol the rollout harness
steps against, and concrete wrappers live in ``env_gym.py`` /
``env_robosuite.py`` (gated on their sim packages).
"""

import abc


class EnvType:
    """Environment-family ids stored in checkpoint env metadata
    (reference env_base.py:9-16)."""

    ROBOSUITE_TYPE = 1
    GYM_TYPE = 2
    IG_MOMART_TYPE = 3


class EnvBase(abc.ABC):
    """Protocol: step/reset/reset_to/render/get_observation/is_success/
    serialize (reference env_base.py:19-205)."""

    @abc.abstractmethod
    def __init__(self, env_name, render=False, render_offscreen=False,
                 use_image_obs=False, use_depth_obs=False, postprocess_visual_obs=True,
                 **kwargs):
        pass

    @abc.abstractmethod
    def step(self, action):
        """Returns (observation, reward, done, info)."""

    @abc.abstractmethod
    def reset(self):
        """Returns observation dict."""

    @abc.abstractmethod
    def reset_to(self, state):
        """Reset to a simulator state dict."""

    @abc.abstractmethod
    def render(self, mode="human", height=None, width=None, camera_name=None):
        pass

    @abc.abstractmethod
    def get_observation(self):
        pass

    @abc.abstractmethod
    def get_state(self):
        pass

    @abc.abstractmethod
    def get_reward(self):
        pass

    @abc.abstractmethod
    def get_goal(self):
        pass

    @abc.abstractmethod
    def set_goal(self, **kwargs):
        pass

    @abc.abstractmethod
    def is_done(self):
        pass

    @abc.abstractmethod
    def is_success(self):
        """Returns dict with at least a "task" key."""

    @property
    @abc.abstractmethod
    def action_dimension(self):
        pass

    @property
    @abc.abstractmethod
    def name(self):
        pass

    @property
    @abc.abstractmethod
    def type(self):
        pass

    @property
    def version(self):
        return None

    @abc.abstractmethod
    def serialize(self):
        """Returns env metadata dict: {env_name, type, env_kwargs}."""

    @classmethod
    @abc.abstractmethod
    def create_for_data_processing(cls, camera_names, camera_height,
                                   camera_width, reward_shaping, **kwargs):
        pass

    @property
    def rollout_exceptions(self):
        """Exception classes that should abort (not crash) a rollout."""
        return ()
