"""The IRIS config (copy of the JAX package's ``config/iris_config.py``): a
value planner of a GL planner and a BCQ value network
(``algo.value_planner.{planner, value}``) and a BC-RNN actor."""

from robot_manipulation_vq_vae_tpu_torch.config.base_config import BaseConfig
from robot_manipulation_vq_vae_tpu_torch.config.bc_config import BCConfig
from robot_manipulation_vq_vae_tpu_torch.config.bcq_config import BCQConfig
from robot_manipulation_vq_vae_tpu_torch.config.gl_config import GLConfig


class IRISConfig(BaseConfig):
    ALGO_NAME = "iris"

    def algo_config(self):
        self.algo.mode = "separate"
        self.algo.actor_use_random_subgoals = False
        self.algo.subgoal_update_interval = 10

        self.algo.latent_subgoal.enabled = False
        self.algo.latent_subgoal.prior_correction.enabled = False
        self.algo.latent_subgoal.prior_correction.num_samples = 100

        self.algo.value_planner.planner = GLConfig().algo
        self.algo.value_planner.planner.subgoal_horizon = 10
        self.algo.value_planner.planner.vae.enabled = True

        self.algo.value_planner.value = BCQConfig().algo
        self.algo.value_planner.value.actor.enabled = False
        self.algo.value_planner.num_samples = 100

        self.algo.actor = BCConfig().algo
        self.algo.actor.rnn.enabled = True
        self.algo.actor.rnn.horizon = 10
        for k in ("gaussian", "gmm", "vae"):
            if k in self.algo.actor:
                del self.algo.actor[k]

        self.algo.language_conditioned = False

    def observation_config(self):
        self.observation.value_planner.planner = GLConfig().observation
        self.observation.value_planner.value = BCQConfig().observation
        self.observation.actor = BCConfig().observation

    @property
    def use_goals(self):
        return (
            len(
                self.observation.value_planner.planner.modalities.goal.low_dim
                + self.observation.value_planner.planner.modalities.goal.rgb
            )
            > 0
        )

    @property
    def all_obs_keys(self):
        keys = set()
        for group in (
            self.observation.value_planner.planner.modalities.obs.values(),
            self.observation.value_planner.planner.modalities.goal.values(),
            self.observation.value_planner.planner.modalities.subgoal.values(),
            self.observation.value_planner.value.modalities.obs.values(),
            self.observation.value_planner.value.modalities.goal.values(),
            self.observation.actor.modalities.obs.values(),
            self.observation.actor.modalities.goal.values(),
        ):
            for modality in group:
                keys.update(modality)
        return sorted(keys)
