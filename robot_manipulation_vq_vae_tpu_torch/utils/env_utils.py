"""Environment factory and helpers (a copy of the JAX package's
``utils/env_utils.py``; reference ``robomimic/utils/env_utils.py``), with a
picklable env factory, ``EnvFactory``, for the spawned workers of
``envs/vector_env.SubprocVectorEnv``."""

from robot_manipulation_vq_vae_tpu_torch.envs.env_base import EnvType
from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils as ObsUtils

# custom env-type registry: an env type id (int) -> EnvBase subclass, so that
# code outside the framework (tests, users' own simulators) can add an env
# without editing get_env_class
CUSTOM_ENV_CLASSES = {}


def register_env_class(env_type, env_class):
    """Register an EnvBase subclass for @env_type (an int not colliding with
    the EnvType constants)."""
    CUSTOM_ENV_CLASSES[env_type] = env_class
    return env_class


def get_env_class(env_meta=None, env_type=None, env=None):
    env_type = get_env_type(env_meta=env_meta, env_type=env_type, env=env)
    if env_type in CUSTOM_ENV_CLASSES:
        return CUSTOM_ENV_CLASSES[env_type]
    if env_type == EnvType.ROBOSUITE_TYPE:
        from robot_manipulation_vq_vae_tpu_torch.envs.env_robosuite import EnvRobosuite

        return EnvRobosuite
    if env_type == EnvType.GYM_TYPE:
        from robot_manipulation_vq_vae_tpu_torch.envs.env_gym import EnvGym

        return EnvGym
    if env_type == EnvType.IG_MOMART_TYPE:
        raise NotImplementedError("the iGibson MOMART env is not ported yet (ROADMAP.md)")
    raise ValueError(f"unknown env type {env_type}")


def get_env_type(env_meta=None, env_type=None, env=None):
    if sum(x is not None for x in (env_meta, env_type, env)) != 1:
        raise ValueError("pass exactly one of env_meta / env_type / env")
    if env_meta is not None:
        return env_meta["type"]
    if env is not None:
        return env.type
    return env_type


def is_robosuite_env(env_meta=None, env_type=None, env=None):
    return get_env_type(env_meta=env_meta, env_type=env_type, env=env) == (
        EnvType.ROBOSUITE_TYPE
    )


def create_env(env_type, env_name, render=False, render_offscreen=False,
               use_image_obs=False, use_depth_obs=False, env_class=None, **kwargs):
    """An env of @env_type (or of @env_class, when given)."""
    if env_class is None:
        env_class = get_env_class(env_type=env_type)
    return env_class(
        env_name=env_name,
        render=render,
        render_offscreen=render_offscreen,
        use_image_obs=use_image_obs,
        use_depth_obs=use_depth_obs,
        **kwargs,
    )


def create_env_from_metadata(env_meta, env_name=None, render=False,
                             render_offscreen=False, use_image_obs=False,
                             use_depth_obs=False, env_class=None):
    """An env from dataset or checkpoint env metadata: the language string
    and a MOMART ``ig_config`` stored beside ``env_kwargs`` go to the
    constructor too."""
    if env_name is None:
        env_name = env_meta["env_name"]
    env_kwargs = dict(env_meta.get("env_kwargs", {}))
    env_lang = env_meta.get("env_lang", None)
    if env_lang is not None:
        env_kwargs["env_lang"] = env_lang
    if "ig_config" in env_meta and "ig_config" not in env_kwargs:
        env_kwargs["ig_config"] = env_meta["ig_config"]
    return create_env(
        env_type=get_env_type(env_meta=env_meta),
        env_name=env_name,
        render=render,
        render_offscreen=render_offscreen,
        use_image_obs=use_image_obs,
        use_depth_obs=use_depth_obs,
        env_class=env_class,
        **env_kwargs,
    )


def wrap_env(env, frame_stack):
    """Stack the last @frame_stack observations when it is above 1."""
    from robot_manipulation_vq_vae_tpu_torch.envs.wrappers import FrameStackWrapper

    if frame_stack > 1:
        env = FrameStackWrapper(env, num_frames=frame_stack)
    return env


def wrap_env_from_config(env, config):
    """The config's wrappers: frame stacking whenever ``train.frame_stack > 1``
    (transformer configs set it to their context length)."""
    return wrap_env(env, config.train.frame_stack)


class EnvFactory:
    """A picklable constructor of one wrapped env, for the workers of
    ``SubprocVectorEnv``, which start by ``spawn``: a spawned worker begins
    with empty module globals, so the factory first fills the observation
    registry from @obs_specs (without it, an env that keeps only registered
    keys, as ``EnvRobosuite.get_observation`` does, drops every image), and
    carries the env class itself (pickled by reference: its module is
    imported in the worker), since ``CUSTOM_ENV_CLASSES`` is empty there.

    @obs_specs: (a list of) {group: {modality: [keys]}}, as
    ``config.observation.modalities.to_dict()``. @env_class defaults to the
    class that ``get_env_class`` gives for @env_meta in the caller's process.
    """

    def __init__(self, env_meta, obs_specs, frame_stack=1, env_class=None,
                 env_name=None, render=False, render_offscreen=False,
                 use_image_obs=False, use_depth_obs=False):
        self.env_meta = dict(env_meta)
        self.obs_specs = obs_specs
        self.frame_stack = int(frame_stack)
        self.env_class = env_class or get_env_class(env_meta=self.env_meta)
        self.kwargs = dict(env_name=env_name, render=render,
                           render_offscreen=render_offscreen,
                           use_image_obs=use_image_obs, use_depth_obs=use_depth_obs)

    @classmethod
    def from_config(cls, env_meta, config, **kwargs):
        """The factory of @config's observations and frame stacking."""
        return cls(env_meta, [config.observation.modalities.to_dict()],
                   frame_stack=config.train.frame_stack, **kwargs)

    def __call__(self):
        ObsUtils.initialize_obs_utils_with_obs_specs(self.obs_specs)
        env = create_env_from_metadata(self.env_meta, env_class=self.env_class,
                                       **self.kwargs)
        return wrap_env(env, self.frame_stack)
