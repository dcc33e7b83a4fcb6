"""The HBC config (copy of the JAX package's ``config/hbc_config.py``): a
GL planner section (``algo.planner``, ``observation.planner``) and a BC-RNN
actor section (``algo.actor``, ``observation.actor``)."""

from robot_manipulation_vq_vae_tpu_torch.config.base_config import BaseConfig
from robot_manipulation_vq_vae_tpu_torch.config.bc_config import BCConfig
from robot_manipulation_vq_vae_tpu_torch.config.gl_config import GLConfig


class HBCConfig(BaseConfig):
    ALGO_NAME = "hbc"

    def algo_config(self):
        self.algo.mode = "separate"
        self.algo.actor_use_random_subgoals = False
        self.algo.subgoal_update_interval = 10

        self.algo.latent_subgoal.enabled = False
        self.algo.latent_subgoal.prior_correction.enabled = False
        self.algo.latent_subgoal.prior_correction.num_samples = 100

        # nested planner (GL) and actor (BC-RNN) algo sections
        self.algo.planner = GLConfig().algo
        self.algo.planner.subgoal_horizon = 10
        self.algo.planner.vae.enabled = True

        self.algo.actor = BCConfig().algo
        self.algo.actor.rnn.enabled = True
        self.algo.actor.rnn.horizon = 10
        for k in ("gaussian", "gmm", "vae"):
            if k in self.algo.actor:
                del self.algo.actor[k]

        self.algo.language_conditioned = False

    def observation_config(self):
        self.observation.planner = GLConfig().observation
        self.observation.actor = BCConfig().observation

    @property
    def use_goals(self):
        return (
            len(
                self.observation.planner.modalities.goal.low_dim
                + self.observation.planner.modalities.goal.rgb
            )
            > 0
        )

    @property
    def all_obs_keys(self):
        keys = set()
        for group in (
            self.observation.planner.modalities.obs.values(),
            self.observation.planner.modalities.goal.values(),
            self.observation.planner.modalities.subgoal.values(),
            self.observation.actor.modalities.obs.values(),
            self.observation.actor.modalities.goal.values(),
        ):
            for modality in group:
                keys.update(modality)
        return sorted(keys)
