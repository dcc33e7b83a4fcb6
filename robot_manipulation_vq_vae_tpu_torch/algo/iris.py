"""IRIS (counterpart of the JAX package's ``algo/iris.py``), registered as
``iris``: ``HBC`` whose planner is a ``ValuePlanner`` of a ``GL`` / ``GL_VAE``
planner (by ``value_planner.planner.vae.enabled``) and a ``BCQ`` value
network, from ``algo.value_planner`` and ``observation.value_planner``; the
actor is a ``BC_RNN``. Its requests score ``value_planner.num_samples``
subgoals a row by the BCQ value (each row's condition encoded once)."""

from robot_manipulation_vq_vae_tpu_torch.algo.algo import register_algo_factory_func
from robot_manipulation_vq_vae_tpu_torch.algo.bc import BC_RNN
from robot_manipulation_vq_vae_tpu_torch.algo.bcq import BCQ
from robot_manipulation_vq_vae_tpu_torch.algo.gl import GL, GL_VAE, ValuePlanner
from robot_manipulation_vq_vae_tpu_torch.algo.hbc import HBC


@register_algo_factory_func("iris")
def algo_config_to_class(algo_config):
    return IRIS, {}


class IRIS(HBC):
    def __init__(self, algo_config, obs_config, global_config, obs_key_shapes, ac_dim,
                 device=None, use_kernels=True):
        self._init_common(algo_config, obs_config, global_config, ac_dim)
        planner_cls = GL_VAE if algo_config.value_planner.planner.vae.enabled else GL
        self.planner = ValuePlanner(
            planner_algo_class=planner_cls, value_algo_class=BCQ,
            algo_config=algo_config.value_planner, obs_config=obs_config.value_planner,
            global_config=global_config, obs_key_shapes=obs_key_shapes, ac_dim=ac_dim,
            device=device, use_kernels=use_kernels)
        self._create_actor(BC_RNN, obs_key_shapes, device, use_kernels)

    def get_state_value(self, obs_dict, goal_dict=None):
        return self.planner.get_state_value(obs_dict, goal_dict)

    def get_state_action_value(self, obs_dict, actions, goal_dict=None):
        return self.planner.get_state_action_value(obs_dict, actions, goal_dict)
