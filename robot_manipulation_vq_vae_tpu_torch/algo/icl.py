"""In-context imitation learning (counterpart of the JAX package's
``algo/icl.py``:55-104, 645-975, 978-1244): the flagship
``ICLTransformerHVQVAE``, registered as ``icl`` (with the JAX routing) and
``icl_hvqvae``, and the paper's LipVQ path, ``ICLTransformer_GMM``,
registered as ``icl_gmm_paper``.

``ICLTransformerHVQVAE.train_on_batch`` (JAX ``:736-866``) runs the
hierarchical VQ-VAE over the batch's actions (its training forward updates
the codebooks), the transformer policy over the observation window, and one
backward of 0.1 vqvae_loss + 1.0 action_loss; each network's gradients are
clipped to ``train.max_grad_norm`` by their own global norm and step their
own optimizer. With ``train.mixed_precision`` the policy runs as the JAX
step runs it (``:746-797``): its fp32 parameters and BatchNorm statistics
are cast to bf16 inside the step and the observations too, so the gradients
come back fp32 through the casts; the HVQVAE and the losses stay fp32. The
cast is not ``torch.autocast``: which layers then compute in bf16 follows
JAX's type promotion (see ``_policy_forward``). ``get_action`` feeds the
policy the HVQVAE-reconstructed context actions, which the policy ignores
(JAX ``:946-972``; XLA drops that dead forward from the jitted call, the
port runs it).

``ICLTransformer_GMM.get_action`` embeds the query observations, the context
observations and the context actions (tokenized by LipVQ-VAE inside the
encoder; the tokens are the detached quantized codes), runs the GPT over the
3T interleaved tokens, and samples the GMM of the last step. Its
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
from robot_manipulation_vq_vae_tpu_torch.models.obs_core import VisualCore
from robot_manipulation_vq_vae_tpu_torch.models.tokenizers.hvqvae import (
    HierarchicalVQVAE,
    compute_vqvae_loss,
    get_codebook_usage,
)
from robot_manipulation_vq_vae_tpu_torch.utils import loss_utils as LossUtils
from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils as ObsUtils
from robot_manipulation_vq_vae_tpu_torch.utils import optim_utils as OptimUtils
from robot_manipulation_vq_vae_tpu_torch.utils.optim_utils import (
    clip_by_global_norm_,
    global_norm,
)


def _not_ported(name):
    raise NotImplementedError(f"{name} is not ported yet (ROADMAP.md Queue 1)")


@register_algo_factory_func("icl_hvqvae")
def algo_config_to_class_hvqvae(algo_config):
    return ICLTransformerHVQVAE, {}


@register_algo_factory_func("icl")
def algo_config_to_class(algo_config):
    """The JAX package's routing (its ``icl.py:61-93``): every
    transformer-enabled branch goes to ICLTransformerHVQVAE; the branches to
    classes that are not ported raise."""
    gaussian = "gaussian" in algo_config and algo_config.gaussian.enabled
    gmm = "gmm" in algo_config and algo_config.gmm.enabled
    vae = "vae" in algo_config and algo_config.vae.enabled
    rnn = algo_config.rnn.enabled
    transformer = algo_config.transformer.enabled
    if gaussian:
        if rnn or transformer:
            raise NotImplementedError("a Gaussian ICL policy has no RNN or transformer")
        _not_ported("ICLGaussian")
    if gmm:
        if rnn:
            _not_ported("ICLRNN_GMM")
        if transformer:
            return ICLTransformerHVQVAE, {}
        _not_ported("ICLGMM")
    if vae:
        if rnn and not transformer:
            raise NotImplementedError("a VAE ICL policy has no RNN")
        return ICLTransformerHVQVAE, {}
    if rnn:
        _not_ported("ICLRNN")
    if transformer:
        return ICLTransformerHVQVAE, {}
    _not_ported("ICL")


@register_algo_factory_func("icl_gmm_paper")
def algo_config_to_class_gmm_paper(algo_config):
    return ICLTransformer_GMM, {}


class ICLTransformer(Algo):
    """Transformer-policy ICL: the TransformerActorNetwork over the
    observation window, trained on sequence prediction losses, with the
    HVQVAE's loss added where a subclass has one (JAX ``:736-866``)."""

    MIXED_PRECISION = True

    def _create_networks(self):
        self.nets["policy"] = PolicyNets.TransformerActorNetwork(
            obs_shapes=self.obs_shapes,
            goal_shapes=self.goal_shapes or None,
            ac_dim=self.ac_dim,
            encoder_kwargs=ObsUtils.obs_encoder_kwargs_from_config(
                self.obs_config.encoder
            ),
            **self._policy_transformer_args(),
        )
        self._set_params_from_config()
        self.mixed_precision = bool(self.global_config.train.get("mixed_precision",
                                                                 False))
        # the parameters that meet bf16 activations under mixed precision:
        # the visual cores' trunks and keypoint convolutions
        self._bf16_prefixes = tuple(
            f"{name}.{child}." for name, m in self.nets["policy"].named_modules()
            if isinstance(m, VisualCore) for child in ("backbone", "pool")
        )

    def _policy_transformer_args(self):
        args = BaseNets.transformer_args_from_config(self.algo_config.transformer)
        # the transformer actor takes no tokenizer flags
        for k in ("transformer_fast_enabled", "transformer_bin_enabled",
                  "transformer_vq_vae_enabled", "transformer_ln_act_enabled"):
            args.pop(k, None)
        return args

    def _set_params_from_config(self):
        tc = self.algo_config.transformer
        if not tc.enabled:
            raise ValueError(f"{type(self).__name__} needs algo.transformer enabled")
        self.context_length = tc.context_length
        self.supervise_all_steps = tc.supervise_all_steps
        self.pred_future_acs = tc.pred_future_acs
        self.vq_vae_enabled = tc.get("vq_vae_enabled", False)
        if self.pred_future_acs and not self.supervise_all_steps:
            raise ValueError("pred_future_acs needs supervise_all_steps")

    def process_batch_for_training(self, batch):
        """The first context_length observation steps and the supervised
        action window: actions [h - 1, 2h - 1) with ``pred_future_acs``,
        [0, h) otherwise, or the action at h - 1 without
        ``supervise_all_steps``."""
        h = self.context_length
        out = {"obs": {k: v[:, :h] for k, v in batch["obs"].items()},
               "goal_obs": batch.get("goal_obs", None)}
        actions = batch["actions"]
        if self.supervise_all_steps:
            start = h - 1 if self.pred_future_acs else 0
            out["actions"] = actions[:, start:start + h]
            if self.pred_future_acs and out["actions"].shape[1] != h:
                raise ValueError(f"the batch has too few action steps for {h} "
                                 "future actions")
        else:
            out["actions"] = actions[:, h - 1]
        return out

    def _select_output(self, output):
        """The rollout action from the predicted sequence."""
        if self.supervise_all_steps and self.pred_future_acs:
            return output[:, 0]
        return output[:, -1]

    def _action_losses(self, acts, target):
        """l2, smooth-l1 and (first 3 dims) cosine losses, and their
        weighted sum ``action_loss``."""
        loss_cfg = self.algo_config.get("loss", {})
        weights = (float(loss_cfg.get("l2_weight", 1.0)),
                   float(loss_cfg.get("l1_weight", 0.0)),
                   float(loss_cfg.get("cos_weight", 0.0)))
        losses = OrderedDict()
        losses["l2_loss"] = ((acts - target) ** 2).mean()
        losses["l1_loss"] = LossUtils.smooth_l1_loss(acts, target)
        losses["cos_loss"] = (LossUtils.cosine_loss(acts[..., :3], target[..., :3])
                              if acts.shape[-1] >= 3 else acts.new_zeros(()))
        losses["action_loss"] = sum(w * losses[k] for w, k in
                                    zip(weights, ("l2_loss", "l1_loss", "cos_loss")))
        return losses

    def _device_batch(self, batch):
        """(observations, actions) on the device, in the networks' dtype
        (``nets.double()`` runs the step in float64)."""
        dtype = next(self.nets.parameters()).dtype
        obs = {k: v.to(dtype)
               for k, v in device_process_obs(batch["obs"], self.device).items()}
        actions = torch.as_tensor(batch["actions"]).to(
            self.device, torch.float32, non_blocking=True).to(dtype)
        return obs, actions

    def _policy_forward(self, obs, action_inputs):
        """The policy's actions [B, T, A] (fp32). Under mixed precision the
        policy is called on bf16 copies of its parameters, as the JAX step
        casts them, and type promotion decides where each layer computes, as
        in JAX: the visual trunks and keypoint convolutions take the bf16
        images, and so compute in bf16 (BatchNorm reduces in fp32 and
        rounds its output once); the keypoints meet the fp32 keypoint grid
        and become fp32, so every later layer computes in fp32 with its bf16
        parameters lifted back to fp32. The copies are differentiable casts,
        so the gradients reach the fp32 parameters, rounded to bf16 as
        JAX's are."""
        policy = self.nets["policy"]
        generator = self.generator if policy.training else None
        if not self.mixed_precision:
            return policy(obs, actions=action_inputs, generator=generator)
        half = torch.bfloat16
        params = {
            name: (p.to(half) if name.startswith(self._bf16_prefixes)
                   else p.to(half).float())
            for name, p in policy.named_parameters()
        }
        obs = {k: v.to(half) for k, v in obs.items()}
        if action_inputs is not None:
            action_inputs = action_inputs.to(half)
        acts = torch.func.functional_call(
            policy, params, (obs,), {"actions": action_inputs, "generator": generator})
        return acts.float()

    def _losses(self, batch):
        """The step's losses (an OrderedDict of 0-d tensors) and the combined
        loss that the backward takes."""
        obs, actions = self._device_batch(batch)
        losses = OrderedDict()
        action_inputs = None
        if "vqvae" in self.nets:
            vq_out = self.nets["vqvae"](
                actions, self.generator if self.nets.training else None)
            losses.update(compute_vqvae_loss(vq_out, actions, commitment_cost=1.0,
                                             lambda_rec=self.vqvae_lambda_rec))
            action_inputs = vq_out["quantized_q"]
        acts = self._policy_forward(obs, action_inputs)
        if not self.supervise_all_steps:
            acts = acts[:, -1]
        losses.update(self._action_losses(acts, actions))
        combined = losses["action_loss"]
        if "vqvae" in self.nets:
            combined = 0.1 * losses["vqvae_loss"] + 1.0 * combined
        return losses, combined

    def _train_step(self, batch):
        losses, combined = self._losses(batch)
        nets = [n for n in ("policy", "vqvae") if n in self.nets]
        params = {n: list(self.nets[n].parameters()) for n in nets}
        flat = [p for n in nets for p in params[n]]
        grads = torch.autograd.grad(combined, flat, allow_unused=True)
        grads = iter([torch.zeros_like(p) if g is None else g
                      for p, g in zip(flat, grads)])
        grads = {n: [next(grads) for _ in params[n]] for n in nets}
        metrics = OrderedDict((k, v.detach()) for k, v in losses.items())
        for n in nets:
            metrics[f"{n}_grad_norms"] = global_norm(grads[n])
        for n in nets:
            if self.max_grad_norm is not None:
                clip_by_global_norm_(grads[n], self.max_grad_norm)
            self._step(n, params[n], grads[n])
        return metrics

    def _validate_step(self, batch):
        return self._losses(batch)[0]

    def get_action(self, obs_dict, context_batch, goal_dict=None):
        """The policy's action for one request: [B, ac_dim]. The context
        actions, reconstructed by the HVQVAE where there is one, are passed
        to the policy, which ignores them."""
        with torch.inference_mode():
            obs, actions = self._device_batch(
                {"obs": obs_dict, "actions": context_batch["actions"]})
            if "vqvae" in self.nets:
                actions = self.nets["vqvae"](actions)["reconstructed_actions"]
            return self._select_output(self.nets["policy"](obs, actions=actions))


class ICLTransformerHVQVAE(ICLTransformer):
    """ICL transformer + hierarchical VQ-VAE co-training, the shipped
    flagship (see the module docstring)."""

    def _create_networks(self):
        super()._create_networks()
        if self.vq_vae_enabled:
            vq_cfg = self.algo_config.transformer.vqvae
            self.nets["vqvae"] = HierarchicalVQVAE(
                action_dim=self.ac_dim,
                num_subclusters=vq_cfg.get("num_subclusters", 128),
                num_clusters=vq_cfg.get("num_clusters", 32),
                embed_dim=vq_cfg.get("embed_dim", self.algo_config.transformer.embed_dim),
                num_stages=vq_cfg.get("num_stages", 2),
                num_layers_per_stage=vq_cfg.get("num_layers_per_stage", 10),
                beta=vq_cfg.get("beta_ema", 0.8),
                dropout=vq_cfg.get("dropout", 0.1),
                kmeans_init=True,
            )
            self.vqvae_lambda_rec = vq_cfg.get("lambda_rec", 1.0)

    def _create_optimizers(self):
        """The policy's and the HVQVAE's optimizers; the HVQVAE takes the
        policy's optimizer settings where ``optim_params`` has none."""
        super()._create_optimizers()
        if "vqvae" in self.nets and "vqvae" not in self.optimizers:
            self.optimizers["vqvae"], self.lr_schedulers["vqvae"] = (
                OptimUtils.optimizer_from_optim_params(
                    self.nets["vqvae"].parameters(),
                    self.algo_config.optim_params.get(
                        "vqvae", self.algo_config.optim_params["policy"]),
                )
            )

    def log_info(self, info):
        """Scalar logs, with the HVQVAE's losses and codebook telemetry."""
        losses = info["losses"]
        log = OrderedDict(Loss=float(losses["action_loss"]))
        for src, dst in (("l2_loss", "L2_Loss"), ("l1_loss", "L1_Loss"),
                         ("cos_loss", "Cosine_Loss"),
                         ("policy_grad_norms", "Policy_Grad_Norms")):
            if src in losses:
                log[dst] = float(losses[src])
        if "vqvae" in self.nets and "vqvae_loss" in losses:
            log["VQ-VAE/Total_Loss"] = float(losses["vqvae_loss"])
            log["VQ-VAE/Reconstruction_Loss"] = float(losses["L_rec"])
            log["VQ-VAE/Commitment_Z_Loss"] = float(losses["L_commit_z"])
            log["VQ-VAE/Commitment_Q_Loss"] = float(losses["L_commit_q"])
            if "vqvae_grad_norms" in losses:
                log["VQ-VAE/Grad_Norms"] = float(losses["vqvae_grad_norms"])
            usage = get_codebook_usage(self.nets["vqvae"])
            log["VQ-VAE/Z_Utilization_pct"] = usage["z_usage_pct"]
            log["VQ-VAE/Q_Utilization_pct"] = usage["q_usage_pct"]
            log["VQ-VAE/Z_Utilization"] = usage["z_used"]
            log["VQ-VAE/Q_Utilization"] = usage["q_used"]
            log["VQ-VAE/Z_Dead_Codes"] = usage["z_dead"]
            log["VQ-VAE/Q_Dead_Codes"] = usage["q_dead"]
        return log


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
