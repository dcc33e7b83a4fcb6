"""In-context imitation learning: the paper's LipVQ path,
``ICLTransformer_GMM`` (counterpart of the JAX package's ``algo/icl.py``
:645-720, 978-1244), registered as ``icl_gmm_paper``.

``get_action`` embeds the query observations, the context observations and
the context actions (tokenized by LipVQ-VAE inside the encoder; the tokens
are the detached quantized codes), runs the GPT over the 3T interleaved
tokens, and samples the GMM of the last step.
"""

import torch

from robot_manipulation_vq_vae_tpu_torch.algo.algo import (
    Algo,
    device_process_obs,
    register_algo_factory_func,
)
from robot_manipulation_vq_vae_tpu_torch.models import base_nets as BaseNets
from robot_manipulation_vq_vae_tpu_torch.models import policy_nets as PolicyNets
from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils as ObsUtils


@register_algo_factory_func("icl_gmm_paper")
def algo_config_to_class_gmm_paper(algo_config):
    return ICLTransformer_GMM, {}


class ICLTransformer_GMM(Algo):
    """Prompt-conditioned GMM transformer with the in-encoder LipVQ action
    tokenizer."""

    def _create_networks(self):
        if not (self.algo_config.gmm.enabled and self.algo_config.transformer.enabled):
            raise ValueError("icl_gmm_paper needs algo.gmm and algo.transformer enabled")
        tc = self.algo_config.transformer
        self.supervise_all_steps = tc.supervise_all_steps
        self.pred_future_acs = tc.pred_future_acs
        self.nets["policy"] = PolicyNets.ICLTransformerGMMActorNetwork(
            obs_shapes=self.obs_shapes,
            goal_shapes=self.goal_shapes or None,
            ac_dim=self.ac_dim,
            num_modes=self.algo_config.gmm.num_modes,
            min_std=self.algo_config.gmm.min_std,
            std_activation=self.algo_config.gmm.std_activation,
            low_noise_eval=self.algo_config.gmm.low_noise_eval,
            encoder_kwargs=ObsUtils.obs_encoder_kwargs_from_config(
                self.obs_config.encoder
            ),
            action_input_shape=self.ac_dim,
            use_kernels=self.use_kernels,
            **BaseNets.transformer_args_from_config(tc),
        )

    def _select_output(self, output):
        """The rollout action from the predicted sequence."""
        if self.supervise_all_steps and self.pred_future_acs:
            return output[:, 0]
        return output[:, -1]

    @torch.inference_mode()
    def action_distribution(self, obs_dict, context_batch, goal_dict=None,
                            low_noise_eval=None):
        """The policy's GMM over [B, T] for a request (obs [B, T, ...],
        context obs [B, T, ...], context actions [B, T, A]), and the LipVQ
        loss of the context actions."""
        policy = self.nets["policy"]
        goal = None
        if goal_dict is not None:
            goal = device_process_obs(goal_dict, self.device)
        actions = torch.as_tensor(context_batch["actions"]).to(
            self.device, torch.float32, non_blocking=True
        )
        return policy.forward_train(
            device_process_obs(obs_dict, self.device),
            device_process_obs(context_batch["obs"], self.device),
            actions, goal_dict=goal, low_noise_eval=low_noise_eval,
        )

    def get_action(self, obs_dict, context_batch, goal_dict=None):
        """Sample the action of one request: [B, ac_dim] on ``self.device``."""
        dist, _ = self.action_distribution(obs_dict, context_batch, goal_dict)
        with torch.inference_mode():
            return self._select_output(dist.sample(self.generator))
