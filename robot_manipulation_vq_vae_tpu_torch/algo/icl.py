"""In-context imitation learning: the paper's LipVQ path,
``ICLTransformer_GMM`` (counterpart of the JAX package's ``algo/icl.py``
:645-720, 978-1244), registered as ``icl_gmm_paper``.

``get_action`` embeds the query observations, the context observations and
the context actions (tokenized by LipVQ-VAE inside the encoder; the tokens
are the detached quantized codes), runs the GPT over the 3T interleaved
tokens, and samples the GMM of the last step.

``train_on_batch`` (JAX ``algo/icl.py``:1093-1216) splits the batch into a
context half and a supervised half, runs one training forward, and takes two
backward passes: the LipVQ loss steps a dedicated AdamW (lr 1e-3, weight
decay 1e-4) over the tokenizer's parameters, then the GMM's negative log
likelihood steps the policy optimizer over all policy parameters.
"""

from collections import OrderedDict

import torch

from robot_manipulation_vq_vae_tpu_torch.algo.algo import (
    Algo,
    device_process_obs,
    register_algo_factory_func,
)
from robot_manipulation_vq_vae_tpu_torch.models import base_nets as BaseNets
from robot_manipulation_vq_vae_tpu_torch.models import policy_nets as PolicyNets
from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils as ObsUtils
from robot_manipulation_vq_vae_tpu_torch.utils.optim_utils import (
    clip_by_global_norm_,
    global_norm,
)


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

    def _create_optimizers(self):
        super()._create_optimizers()
        # dedicated AdamW for the in-encoder LipVQ (JAX icl.py:999-1007)
        self.optimizers["vq_tokenizer"] = torch.optim.AdamW(
            self._lipvq().parameters(), lr=1e-3, weight_decay=1e-4
        )

    def _lipvq(self):
        return self.nets["policy"].net.encoder.action_network

    def _forward(self, batch, generator=None):
        """The training forward: the first half of the batch is the context
        (its observations and actions), the second half is supervised.
        Returns (log probs of the supervised actions, the LipVQ loss). The
        inputs take the networks' dtype, so that ``nets.double()`` runs the
        step in float64."""
        dtype = next(self.nets.parameters()).dtype
        obs = {k: v.to(dtype)
               for k, v in device_process_obs(batch["obs"], self.device).items()}
        actions = torch.as_tensor(batch["actions"]).to(
            self.device, torch.float32, non_blocking=True
        ).to(dtype)
        mid = actions.shape[0] // 2
        dist, vq_loss = self.nets["policy"].forward_train(
            {k: v[mid:] for k, v in obs.items()},
            {k: v[:mid] for k, v in obs.items()},
            actions[:mid], low_noise_eval=False, generator=generator,
        )
        target = actions[mid:]
        if not self.supervise_all_steps:
            dist, target = dist.index_time(-1), target[:, -1]
        return dist.log_prob(target), vq_loss

    def _train_step(self, batch):
        lp, vq_loss = self._forward(batch, self.generator)
        action_loss = -lp.mean()
        lipvq = list(self._lipvq().parameters())
        vq_grads = torch.autograd.grad(vq_loss, lipvq, retain_graph=True)
        params = list(self.nets["policy"].parameters())
        grads = torch.autograd.grad(action_loss, params, allow_unused=True)
        # the NLL gives LipVQ no gradient (the context tokens are the
        # detached codes); the policy optimizer still steps those parameters
        # with zeros, as optax does, which matters once L2 > 0
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        metrics = OrderedDict(
            log_probs=-action_loss.detach(), action_loss=action_loss.detach(),
            policy_grad_norms=global_norm(grads), vq_vae_loss=vq_loss.detach(),
        )
        # (1) the LipVQ loss steps its AdamW; (2) the policy optimizer then
        # applies the NLL gradients to the parameters AdamW has just moved
        self._step("vq_tokenizer", lipvq, vq_grads)
        if self.max_grad_norm is not None:
            clip_by_global_norm_(grads, self.max_grad_norm)
        self._step("policy", params, grads)
        return metrics

    def _validate_step(self, batch):
        lp, vq_loss = self._forward(batch)
        return OrderedDict(log_probs=lp.mean(), action_loss=-lp.mean(),
                           vq_vae_loss=vq_loss)

    def log_info(self, info):
        losses = info["losses"]
        log = OrderedDict(Loss=float(losses["action_loss"]),
                          Log_Likelihood=float(losses["log_probs"]))
        if "policy_grad_norms" in losses:
            log["Policy_Grad_Norms"] = float(losses["policy_grad_norms"])
        return log

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
