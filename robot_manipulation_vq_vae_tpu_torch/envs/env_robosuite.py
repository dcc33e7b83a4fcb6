"""robosuite/RoboCasa environment wrapper (a copy of the JAX package's
``envs/env_robosuite.py``; reference
``robomimic/envs/env_robosuite.py`` and the RoboCasa variant
``robocasa/utils/robomimic/robomimic_env_wrapper.py:14-470``).

MuJoCo stepping stays on host CPUs (SURVEY.md phase 5); this wrapper only
adapts the robosuite API to the EnvBase protocol. Gated: constructing it
requires robosuite (and robocasa for kitchen envs) to be installed.
"""

import numpy as np

from robot_manipulation_vq_vae_tpu_torch.envs.env_base import EnvBase, EnvType
from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils as ObsUtils


def _require_robosuite():
    try:
        import robosuite

        return robosuite
    except ImportError as e:
        raise ImportError(
            "EnvRobosuite requires the robosuite package (and robocasa for "
            "kitchen tasks); install them on the rollout host."
        ) from e


class EnvRobosuite(EnvBase):
    def __init__(self, env_name, render=False, render_offscreen=False,
                 use_image_obs=False, use_depth_obs=False,
                 postprocess_visual_obs=True, env_lang=None, **kwargs):
        robosuite = _require_robosuite()
        self.postprocess_visual_obs = postprocess_visual_obs
        self._env_name = env_name
        self._init_kwargs = dict(kwargs)
        self._env_lang = env_lang

        kwargs = dict(kwargs)
        kwargs.update(
            dict(
                has_renderer=render,
                has_offscreen_renderer=(render_offscreen or use_image_obs),
                ignore_done=True,
                use_object_obs=True,
                use_camera_obs=use_image_obs,
                camera_depths=use_depth_obs,
            )
        )
        self.env = robosuite.make(env_name, **kwargs)

    def step(self, action):
        obs, r, done, info = self.env.step(action)
        obs = self.get_observation(obs)
        return obs, r, self.is_done(), info

    def reset(self):
        di = self.env.reset()
        return self.get_observation(di)

    def reset_to(self, state):
        should_ret = False
        if "model" in state:
            self.reset()
            xml = self.env.edit_model_xml(state["model"]) if hasattr(
                self.env, "edit_model_xml"
            ) else state["model"]
            self.env.reset_from_xml_string(xml)
            self.env.sim.reset()
        if "states" in state:
            self.env.sim.set_state_from_flattened(state["states"])
            self.env.sim.forward()
            should_ret = True
        if "goal" in state:
            self.set_goal(**state["goal"])
        if should_ret:
            return self.get_observation()
        return None

    def render(self, mode="human", height=None, width=None, camera_name="agentview"):
        if mode == "human":
            self.env.viewer.set_camera(camera_id=0)
            return self.env.render()
        if mode == "rgb_array":
            im = self.env.sim.render(
                height=height, width=width, camera_name=camera_name
            )
            return im[::-1]
        raise NotImplementedError(f"mode={mode}")

    def get_observation(self, di=None):
        if di is None:
            di = self.env._get_observations(force_update=True)
        ret = {}
        for k in di:
            if k in ObsUtils.OBS_KEYS_TO_MODALITIES and ObsUtils.key_is_obs_modality(
                k, "rgb"
            ):
                # robosuite renders flipped; keep HWC uint8 and let the
                # device-side step do the float conversion
                ret[k] = di[k][::-1]
                if self.postprocess_visual_obs:
                    ret[k] = ObsUtils.process_obs(ret[k], obs_key=k)
            elif "proprio" in k or k in ObsUtils.OBS_KEYS_TO_MODALITIES:
                ret[k] = np.asarray(di[k])
        return ret

    def get_state(self):
        xml = self.env.sim.model.get_xml()
        state = np.array(self.env.sim.get_state().flatten())
        return dict(model=xml, states=state)

    def get_reward(self):
        return self.env.reward()

    def get_goal(self):
        raise NotImplementedError

    def set_goal(self, **kwargs):
        raise NotImplementedError

    def is_done(self):
        return False  # ignore_done

    def is_success(self):
        succ = self.env._check_success()
        if isinstance(succ, dict):
            assert "task" in succ
            return succ
        return {"task": bool(succ)}

    @property
    def action_dimension(self):
        return self.env.action_spec[0].shape[0]

    @property
    def name(self):
        return self._env_name

    @property
    def type(self):
        return EnvType.ROBOSUITE_TYPE

    @property
    def version(self):
        import robosuite

        return robosuite.__version__

    def serialize(self):
        return dict(
            env_name=self.name,
            env_version=self.version,
            type=self.type,
            env_kwargs=dict(self._init_kwargs),
            env_lang=self._env_lang,
        )

    @classmethod
    def create_for_data_processing(cls, env_name, camera_names, camera_height,
                                   camera_width, reward_shaping, **kwargs):
        has_camera = len(camera_names) > 0
        new_kwargs = dict(kwargs)
        if has_camera:
            new_kwargs.update(
                camera_names=list(camera_names),
                camera_heights=camera_height,
                camera_widths=camera_width,
            )
        new_kwargs["reward_shaping"] = reward_shaping
        return cls(
            env_name=env_name,
            render=False,
            render_offscreen=has_camera,
            use_image_obs=has_camera,
            postprocess_visual_obs=False,
            **new_kwargs,
        )

    @property
    def rollout_exceptions(self):
        try:
            import mujoco

            return (mujoco.FatalError,) if hasattr(mujoco, "FatalError") else ()
        except ImportError:
            return ()
