"""In-context imitation learning (counterpart of the JAX package's
``algo/icl.py``:55-590, 645-975, 978-1244): the flagship
``ICLTransformerHVQVAE``, registered as ``icl`` (with the JAX routing) and
``icl_hvqvae``; the paper's LipVQ path, ``ICLTransformer_GMM``, registered
as ``icl_gmm_paper``; and the rest of the family that ``icl`` routes to: the
MLP policies ``ICL``, ``ICLGaussian`` and ``ICLGMM``, trained on the first
step of each window, and the RNN policies ``ICLRNN`` and ``ICLRNN_GMM``,
trained on the whole window and served step by step with a carried hidden
state. ``ICLVAE`` is ``algo/bc.py``'s (``BC_VAE`` under the ICL name; ``icl``
never routes to it).

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
observations and the context actions (tokenized inside the encoder by the
configured modality: LipVQ-VAE, whose tokens are the detached quantized
codes; the adaptive bins; LN-act; FAST; or the default spectral-norm
encoder), runs the GPT over the 3T interleaved tokens, and samples the GMM
of the last step. FAST's frozen host stage (``set_fast_tokenizer``, or the
processor and CLIP directories in ``RMVQ_FAST_PROCESSOR_DIR`` /
``RMVQ_CLIP_DIR``) turns the context actions into CLIP latents on the host
before the upload. Its ``train_on_batch`` (JAX ``algo/icl.py``:1093-1216)
splits the batch into a context half and a supervised half and runs one
training forward; with LipVQ it takes two backward passes: the LipVQ loss
steps a dedicated AdamW (lr 1e-3, weight decay 1e-4) over the tokenizer's
parameters, then the GMM's negative log likelihood steps the policy
optimizer over all policy parameters. The other modalities have no AdamW of
their own and no ``vq_vae_loss`` metric: the NLL trains them with the
policy. With ``train.mixed_precision`` its training step runs in bf16 as
the JAX paper step does (see ``ICLTransformer_GMM``).
"""

import os
from collections import OrderedDict

import numpy as np
import torch

from robot_manipulation_vq_vae_tpu_torch.algo.algo import (
    PolicyAlgo,
    register_algo_factory_func,
    to_host,
)
from robot_manipulation_vq_vae_tpu_torch.models import base_nets as BaseNets
from robot_manipulation_vq_vae_tpu_torch.models import policy_nets as PolicyNets
from robot_manipulation_vq_vae_tpu_torch.models.tokenizers.fast import FastHostEncoder
from robot_manipulation_vq_vae_tpu_torch.models.tokenizers.hvqvae import (
    HierarchicalVQVAE,
    compute_vqvae_loss,
    get_codebook_usage,
)
from robot_manipulation_vq_vae_tpu_torch.utils import loss_utils as LossUtils
from robot_manipulation_vq_vae_tpu_torch.utils import optim_utils as OptimUtils
from robot_manipulation_vq_vae_tpu_torch.utils.optim_utils import (
    clip_by_global_norm_,
    global_norm,
)


@register_algo_factory_func("icl_hvqvae")
def algo_config_to_class_hvqvae(algo_config):
    return ICLTransformerHVQVAE, {}


@register_algo_factory_func("icl")
def algo_config_to_class(algo_config):
    """The JAX package's routing (its ``icl.py:61-93``): every
    transformer-enabled branch goes to ICLTransformerHVQVAE, and so does the
    VAE branch."""
    gaussian = "gaussian" in algo_config and algo_config.gaussian.enabled
    gmm = "gmm" in algo_config and algo_config.gmm.enabled
    vae = "vae" in algo_config and algo_config.vae.enabled
    rnn = algo_config.rnn.enabled
    transformer = algo_config.transformer.enabled
    if gaussian:
        if rnn or transformer:
            raise NotImplementedError("a Gaussian ICL policy has no RNN or transformer")
        return ICLGaussian, {}
    if gmm:
        if rnn:
            return ICLRNN_GMM, {}
        if transformer:
            return ICLTransformerHVQVAE, {}
        return ICLGMM, {}
    if vae:
        if rnn and not transformer:
            raise NotImplementedError("a VAE ICL policy has no RNN")
        return ICLTransformerHVQVAE, {}
    if rnn:
        return ICLRNN, {}
    if transformer:
        return ICLTransformerHVQVAE, {}
    return ICL, {}


@register_algo_factory_func("icl_gmm_paper")
def algo_config_to_class_gmm_paper(algo_config):
    return ICLTransformer_GMM, {}


def _repeat_first_step(v, n):
    """[B, T, ...] -> the first step repeated @n times: [B, n, ...]."""
    if isinstance(v, torch.Tensor):
        return v[:, :1].expand(-1, n, *v.shape[2:]).contiguous()
    return np.repeat(np.asarray(v)[:, :1], n, axis=1)


class ICL(PolicyAlgo):
    """MLP-actor ICL (JAX ``ICL``, ``:147-288``): the first step of each
    window (observations [B, ...] -> action [B, A]), the l2, smooth-l1 and
    cosine losses weighted by ``algo.loss``. Its ``get_action`` takes no
    context window (``TAKES_CONTEXT``)."""

    def _create_networks(self):
        self.nets["policy"] = PolicyNets.ActorNetwork(
            obs_shapes=self.obs_shapes,
            goal_shapes=self.goal_shapes or None,
            ac_dim=self.ac_dim,
            mlp_layer_dims=tuple(self.algo_config.actor_layer_dims),
            encoder_kwargs=self._encoder_kwargs(),
        )

    def process_batch_for_training(self, batch):
        """The first step of each window."""
        return {"obs": {k: v[:, 0] for k, v in batch["obs"].items()},
                "goal_obs": batch.get("goal_obs", None),
                "actions": batch["actions"][:, 0]}

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

    def _losses(self, batch):
        """The step's losses; ``action_loss`` is the one the backward takes."""
        obs, actions = self._device_batch(batch)
        policy = self.nets["policy"]
        out = policy(obs, goal_dict=self._obs(batch.get("goal_obs") or None),
                     generator=self.generator if policy.training else None)
        return self._head_losses(out, actions)

    def _head_losses(self, acts, actions):
        return self._action_losses(acts, actions)

    def _train_step(self, batch):
        return self._policy_step(self._losses(batch))

    def _validate_step(self, batch):
        return self._losses(batch)

    def log_info(self, info):
        """Every loss as a float, and ``Loss`` (the action loss)."""
        log = OrderedDict((k, float(v)) for k, v in info["losses"].items())
        log["Loss"] = float(info["losses"]["action_loss"])
        return log

    @torch.inference_mode()
    def get_action(self, obs_dict, goal_dict=None):
        """The action of one request: observations [B, ...] -> [B, A]. Under
        data parallelism the request is this rank's shards, and every rank
        returns the global batch's actions."""
        self._check_obs_request(obs_dict, goal_dict)
        return self._gather_rows(
            self.nets["policy"](self._obs(obs_dict), goal_dict=self._obs(goal_dict)))


class ICLGaussian(ICL):
    """Gaussian-head ICL (JAX ``ICLGaussian``, ``:291-377``): trained on the
    negative log likelihood of the first step's action; ``get_action``
    serves the mean (in eval the scale is 1e-4 with ``low_noise_eval``)."""

    def _create_networks(self):
        g = self.algo_config.gaussian
        self.nets["policy"] = PolicyNets.GaussianActorNetwork(
            obs_shapes=self.obs_shapes,
            goal_shapes=self.goal_shapes or None,
            ac_dim=self.ac_dim,
            mlp_layer_dims=tuple(self.algo_config.actor_layer_dims),
            fixed_std=g.fixed_std, init_std=g.init_std, min_std=g.min_std,
            std_activation=g.std_activation, low_noise_eval=g.low_noise_eval,
            encoder_kwargs=self._encoder_kwargs(),
        )

    def _head_losses(self, dist, actions):
        lp = dist.log_prob(actions)
        return OrderedDict(log_probs=lp.mean(), action_loss=-lp.mean())

    @torch.inference_mode()
    def action_distribution(self, obs_dict, goal_dict=None):
        """The policy's distribution over a request's actions [B, A] (under
        data parallelism, over this rank's rows)."""
        self._check_obs_request(obs_dict, goal_dict)
        return self.nets["policy"](self._obs(obs_dict), goal_dict=self._obs(goal_dict))

    def get_action(self, obs_dict, goal_dict=None):
        return self._gather_rows(self.action_distribution(obs_dict, goal_dict).mean)


class ICLGMM(ICLGaussian):
    """GMM-head ICL (JAX ``ICLGMM``, ``:380-410``): trained as ICLGaussian;
    ``get_action`` samples the GMM (its scales 1e-4 in eval with
    ``low_noise_eval``) with the algo's generator."""

    def _create_networks(self):
        g = self.algo_config.gmm
        self.nets["policy"] = PolicyNets.GMMActorNetwork(
            obs_shapes=self.obs_shapes,
            goal_shapes=self.goal_shapes or None,
            ac_dim=self.ac_dim,
            mlp_layer_dims=tuple(self.algo_config.actor_layer_dims),
            num_modes=g.num_modes, min_std=g.min_std,
            std_activation=g.std_activation, low_noise_eval=g.low_noise_eval,
            encoder_kwargs=self._encoder_kwargs(),
        )

    def get_action(self, obs_dict, goal_dict=None):
        """A sample of the GMM; under data parallelism the global batch's,
        drawn on every rank (``_gather_dist``)."""
        with torch.inference_mode():
            return self._gather_dist(
                self.action_distribution(obs_dict, goal_dict)).sample(self.generator)


class ICLRNN(ICL):
    """RNN ICL (JAX ``ICLRNN``, ``:413-506``): an LSTM or GRU over the
    observation window [B, T, ...], trained on every step's action with
    ICL's losses (with ``rnn.open_loop`` every step sees the first step's
    observations). ``get_action`` is stepwise: it takes observations
    [B, ...], runs one step from the hidden state it carries across calls,
    and starts from zeros on the first call, every ``rnn.horizon`` calls and
    after ``reset()``."""

    def _create_networks(self):
        rnn = self.algo_config.rnn
        self.nets["policy"] = PolicyNets.RNNActorNetwork(
            obs_shapes=self.obs_shapes,
            goal_shapes=self.goal_shapes or None,
            ac_dim=self.ac_dim,
            mlp_layer_dims=tuple(self.algo_config.actor_layer_dims),
            rnn_hidden_dim=rnn.hidden_dim, rnn_num_layers=rnn.num_layers,
            rnn_type=rnn.rnn_type, encoder_kwargs=self._encoder_kwargs(),
        )
        self._setup_rnn_rollout()

    def _setup_rnn_rollout(self):
        self._rnn_horizon = self.algo_config.rnn.horizon
        self._rnn_is_open_loop = self.algo_config.rnn.get("open_loop", False)
        self.reset()

    def reset(self):
        """Start a new episode: the next call starts from a zero state.
        Under data parallelism each rank carries its own rows' state."""
        self._rnn_hidden_state = None
        self._rnn_counter = 0
        self._open_loop_obs = None

    def process_batch_for_training(self, batch):
        obs = batch["obs"]
        if self._rnn_is_open_loop:
            n = batch["actions"].shape[1]
            obs = {k: _repeat_first_step(v, n) for k, v in obs.items()}
        return {"obs": dict(obs), "goal_obs": batch.get("goal_obs", None),
                "actions": batch["actions"]}

    @torch.inference_mode()
    def _rnn_step(self, obs_dict, goal_dict):
        """The policy's output at one step of an episode (actions [B, A], or
        the GMM over them), carrying the hidden state (this rank's rows under
        data parallelism)."""
        self._check_obs_request(obs_dict, goal_dict)
        if self._rnn_hidden_state is None or self._rnn_counter % self._rnn_horizon == 0:
            self._rnn_hidden_state = None
            if self._rnn_is_open_loop:
                self._open_loop_obs = {k: (v.clone() if isinstance(v, torch.Tensor)
                                           else np.array(v)) for k, v in obs_dict.items()}
        if self._rnn_is_open_loop:
            obs_dict = self._open_loop_obs
        self._rnn_counter += 1
        obs = {k: v[:, None] for k, v in self._obs(obs_dict).items()}   # T = 1
        out, self._rnn_hidden_state = self.nets["policy"](
            obs, goal_dict=self._obs(goal_dict), initial_state=self._rnn_hidden_state,
            return_state=True)
        return out

    def get_action(self, obs_dict, goal_dict=None):
        return self._gather_rows(self._rnn_step(obs_dict, goal_dict)[:, 0])


class ICLRNN_GMM(ICLRNN):
    """RNN-GMM ICL (JAX ``ICLRNN_GMM``, ``:509-590``): trained on the
    negative log likelihood of every step's action; ``get_action`` samples
    the step's GMM."""

    def _create_networks(self):
        rnn, g = self.algo_config.rnn, self.algo_config.gmm
        self.nets["policy"] = PolicyNets.RNNGMMActorNetwork(
            obs_shapes=self.obs_shapes,
            goal_shapes=self.goal_shapes or None,
            ac_dim=self.ac_dim,
            rnn_hidden_dim=rnn.hidden_dim, rnn_num_layers=rnn.num_layers,
            rnn_type=rnn.rnn_type, num_modes=g.num_modes, min_std=g.min_std,
            std_activation=g.std_activation, low_noise_eval=g.low_noise_eval,
            encoder_kwargs=self._encoder_kwargs(),
        )
        self._setup_rnn_rollout()

    _head_losses = ICLGaussian._head_losses

    def action_distribution(self, obs_dict, goal_dict=None):
        """One step of an episode (see ``ICLRNN``): the GMM over its actions
        [B, A]."""
        return self._rnn_step(obs_dict, goal_dict).index_time(0)

    def get_action(self, obs_dict, goal_dict=None):
        with torch.inference_mode():
            return self._gather_dist(
                self.action_distribution(obs_dict, goal_dict)).sample(self.generator)


class ICLTransformer(ICL):
    """Transformer-policy ICL: the TransformerActorNetwork over the
    observation window, trained on sequence prediction losses, with the
    HVQVAE's loss added where a subclass has one (JAX ``:736-866``). Its
    hyper-parameters come from ``_tx_cfg()``, ``algo.transformer`` (the
    Mamba classes point it at ``algo.mamba``)."""

    MIXED_PRECISION = True
    TAKES_CONTEXT = True

    def _create_networks(self):
        self._set_params_from_config()
        self.nets["policy"] = PolicyNets.TransformerActorNetwork(
            obs_shapes=self.obs_shapes,
            goal_shapes=self.goal_shapes or None,
            ac_dim=self.ac_dim,
            encoder_kwargs=self._encoder_kwargs(),
            **self._policy_transformer_args(),
        )

    def _tx_cfg(self):
        """The config section of the sequence model."""
        return self.algo_config.transformer

    def _policy_transformer_args(self):
        args = BaseNets.transformer_args_from_config(self._tx_cfg())
        # the transformer actor takes no tokenizer flags
        for k in ("transformer_fast_enabled", "transformer_bin_enabled",
                  "transformer_vq_vae_enabled", "transformer_ln_act_enabled"):
            args.pop(k, None)
        return args

    def _set_params_from_config(self):
        tc = self._tx_cfg()
        if not tc.enabled:
            raise ValueError(f"{type(self).__name__} needs its sequence model's "
                             "config section (algo.transformer, algo.mamba) enabled")
        self.context_length = tc.context_length
        self.supervise_all_steps = tc.supervise_all_steps
        self.pred_future_acs = tc.pred_future_acs
        self.vq_vae_enabled = tc.get("vq_vae_enabled", False)
        self.fast_enabled = tc.get("fast_enabled", False)
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

    def _policy_forward(self, obs, action_inputs):
        """The policy's actions [B, T, A] (fp32). Under mixed precision
        (``PolicyAlgo._policy_call``) JAX's type promotion puts the visual
        trunks and keypoint convolutions in bf16 (they take the bf16 images;
        BatchNorm reduces in fp32 and rounds its output once); the keypoints
        meet the fp32 keypoint grid and become fp32, so every later layer
        computes in fp32 with its bf16 parameters lifted back to fp32."""
        generator = self.generator if self.nets["policy"].training else None
        return self._policy_call(obs, actions=action_inputs, generator=generator)

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
        grads = iter(self._sync_grads([torch.zeros_like(p) if g is None else g
                                    for p, g in zip(flat, grads)]))
        grads = {n: [next(grads) for _ in params[n]] for n in nets}
        metrics = OrderedDict((k, v.detach()) for k, v in losses.items())
        for n in nets:
            metrics[f"{n}_grad_norms"] = global_norm(grads[n], self.mp)
        for n in nets:
            if self.max_grad_norm is not None:
                clip_by_global_norm_(grads[n], self.max_grad_norm, self.mp)
            self._step(n, params[n], grads[n])
        return metrics

    def _validate_step(self, batch):
        return self._losses(batch)[0]

    def _check_request(self, obs_dict, context_batch, goal_dict):
        """Under data parallelism a request's observations, context (and
        goals) are this rank's ``shard_batch`` rows."""
        self._check_obs_request(obs_dict, goal_dict)
        self._check_shard(context_batch, what="context_batch")

    def get_action(self, obs_dict, context_batch, goal_dict=None):
        """The policy's action for one request: [B, ac_dim]. The context
        actions, reconstructed by the HVQVAE where there is one, are passed
        to the policy, which ignores them. Under data parallelism the
        request is this rank's shards, and every rank returns the global
        batch's actions."""
        self._check_request(obs_dict, context_batch, goal_dict)
        with torch.inference_mode():
            obs, actions = self._device_batch(
                {"obs": obs_dict, "actions": context_batch["actions"]})
            if "vqvae" in self.nets:
                actions = self.nets["vqvae"](actions)["reconstructed_actions"]
            return self._gather_rows(
                self._select_output(self.nets["policy"](obs, actions=actions)))


class ICLTransformerHVQVAE(ICLTransformer):
    """ICL transformer + hierarchical VQ-VAE co-training, the shipped
    flagship (see the module docstring)."""

    def _create_networks(self):
        super()._create_networks()
        if self.vq_vae_enabled:
            vq_cfg = self._tx_cfg().vqvae
            self.nets["vqvae"] = HierarchicalVQVAE(
                action_dim=self.ac_dim,
                num_subclusters=vq_cfg.get("num_subclusters", 128),
                num_clusters=vq_cfg.get("num_clusters", 32),
                embed_dim=vq_cfg.get("embed_dim", self._tx_cfg().embed_dim),
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
                    self._num_training_steps(),
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


class ICLTransformer_GMM(ICLTransformer):
    """Prompt-conditioned GMM transformer with an in-encoder action
    tokenizer: LipVQ, bin, LN-act, FAST or the default encoder.

    ``train.mixed_precision`` runs the training forward as the JAX paper
    step does (its ``algo/icl.py``:1106-1130, through
    ``PolicyAlgo._policy_call``): bf16 copies of the policy's parameters
    and state, bf16 context and supervised observations and context
    actions; the GMM and the LipVQ loss come back in fp32, and the
    log-probabilities, the losses and both optimizers are fp32. With LipVQ
    both backward passes (the NLL, and the LipVQ loss into the tokenizer's
    AdamW) go through that one bf16 forward. ``get_action`` stays fp32.

    Which layers compute in bf16 is JAX's type promotion, read off
    ``jax.make_jaxpr`` of the JAX bf16 step (each ``dot_general`` and
    ``conv`` operand's type):

    * bf16: the visual trunks (convolutions, FiLM projections) and the
      keypoint convolutions; LipVQ's encoder MLP; the bin tokenizer's
      statistics and MLP, LN-act's Mamba block and MLP, the default
      encoder's spectral-norm layers (power iteration included), attention
      layers and output, FAST's projection; the embedding of the context
      action tokens of those four; and, where the observations are only
      low-dimensional (bf16 features), the embedding of every token and the
      GPT's qkv projections;
    * bf16 operands, fp32 result: LipVQ's latent layer (so z_e is fp32)
      and the GPT's attention products;
    * fp32: the LipVQ codebook search (kernel 1's bf16 instance: fp32 z_e,
      the bf16 codebook upcast, z_q fp32 as the TPU kernel writes z's
      type; JAX's CPU fallback ``l2_nearest`` would round c_sq and z_q to
      bf16) and LipVQ's decoder; with image observations (keypoints fp32)
      the embedding and the whole GPT; the GMM heads.
    """

    BACKBONE = "gpt"
    # the step pairs context row i with supervised row B/2 + i
    DP_LAYOUT = "halves"

    def _create_networks(self):
        if not self.algo_config.gmm.enabled:
            raise ValueError(f"{type(self).__name__} needs algo.gmm enabled")
        self._set_params_from_config()
        self._fast_tokenizer = None
        self.nets["policy"] = PolicyNets.ICLTransformerGMMActorNetwork(
            obs_shapes=self.obs_shapes,
            goal_shapes=self.goal_shapes or None,
            ac_dim=self.ac_dim,
            num_modes=self.algo_config.gmm.num_modes,
            min_std=self.algo_config.gmm.min_std,
            std_activation=self.algo_config.gmm.std_activation,
            low_noise_eval=self.algo_config.gmm.low_noise_eval,
            encoder_kwargs=self._encoder_kwargs(),
            action_input_shape=self.ac_dim,
            backbone_type=self.BACKBONE,
            use_kernels=self.use_kernels,
            **BaseNets.transformer_args_from_config(self._tx_cfg()),
        )

    def _create_optimizers(self):
        super()._create_optimizers()
        if self.vq_vae_enabled:
            # dedicated AdamW for the in-encoder LipVQ (JAX icl.py:999-1007)
            self.optimizers["vq_tokenizer"] = torch.optim.AdamW(
                self._lipvq().parameters(), lr=1e-3, weight_decay=1e-4
            )

    def _lipvq(self):
        return self.nets["policy"].net.encoder.action_network

    # --- the FAST modality's host stage (JAX icl.py:1015-1049) -----------
    def set_fast_tokenizer(self, host_encoder):
        """Inject the FAST host stage: a ``FastHostEncoder`` (or anything
        with its ``encode_batch``)."""
        self._fast_tokenizer = host_encoder

    def _get_fast_tokenizer(self):
        if self._fast_tokenizer is None:
            proc_dir = os.environ.get("RMVQ_FAST_PROCESSOR_DIR")
            if not proc_dir:
                raise RuntimeError(
                    "fast_enabled=True requires a FAST processor: set "
                    "RMVQ_FAST_PROCESSOR_DIR (and RMVQ_CLIP_DIR) or call "
                    "set_fast_tokenizer()"
                )
            self._fast_tokenizer = FastHostEncoder(
                proc_dir, os.environ.get("RMVQ_CLIP_DIR"))
        return self._fast_tokenizer

    def _context_actions(self, ctx_act):
        """The context actions [B, T, A] (numpy or a tensor) as the encoder
        takes them, on the device in the networks' dtype: with FAST, their
        CLIP latents [B, context_length, 512], encoded on the host before the
        upload."""
        if self.fast_enabled:
            ctx_act = self._get_fast_tokenizer().encode_batch(
                np.asarray(to_host(ctx_act), np.float32), seq_len=self.context_length)
        return torch.as_tensor(ctx_act).to(
            self.device, torch.float32, non_blocking=True).to(self._dtype())

    def _forward(self, batch, generator=None):
        """The training forward: the first half of the batch is the context
        (its observations and actions), the second half is supervised.
        Returns (log probs of the supervised actions, the LipVQ loss or
        None). The inputs take the networks' dtype, so that ``nets.double()``
        runs the step in float64."""
        obs = self._obs(batch["obs"])
        actions = batch["actions"]
        mid = len(actions) // 2
        dist, vq_loss = self._policy_call(
            {k: v[mid:] for k, v in obs.items()},
            {k: v[:mid] for k, v in obs.items()},
            self._context_actions(actions[:mid]),
            low_noise_eval=False, generator=generator,
        )
        target = torch.as_tensor(actions[mid:]).to(
            self.device, torch.float32, non_blocking=True).to(self._dtype())
        if not self.supervise_all_steps:
            dist, target = dist.index_time(-1), target[:, -1]
        return dist.log_prob(target), vq_loss

    def _train_step(self, batch):
        lp, vq_loss = self._forward(batch, self.generator)
        action_loss = -lp.mean()
        if self.vq_vae_enabled:
            lipvq = list(self._lipvq().parameters())
            vq_grads = self._sync_grads(list(torch.autograd.grad(vq_loss, lipvq,
                                                              retain_graph=True)))
        params = list(self.nets["policy"].parameters())
        grads = torch.autograd.grad(action_loss, params, allow_unused=True)
        # the NLL gives LipVQ no gradient (the context tokens are the
        # detached codes); the policy optimizer still steps those parameters
        # with zeros, as optax does, which matters once L2 > 0
        grads = self._sync_grads([torch.zeros_like(p) if g is None else g
                               for p, g in zip(params, grads)])
        metrics = OrderedDict(
            log_probs=-action_loss.detach(), action_loss=action_loss.detach(),
            policy_grad_norms=global_norm(grads, self.mp),
        )
        if self.vq_vae_enabled:
            metrics["vq_vae_loss"] = vq_loss.detach()
            # (1) the LipVQ loss steps its AdamW; (2) the policy optimizer
            # then applies the NLL gradients to the parameters AdamW has just
            # moved
            self._step("vq_tokenizer", lipvq, vq_grads)
        if self.max_grad_norm is not None:
            clip_by_global_norm_(grads, self.max_grad_norm, self.mp)
        self._step("policy", params, grads)
        return metrics

    def _validate_step(self, batch):
        lp, vq_loss = self._forward(batch)
        metrics = OrderedDict(log_probs=lp.mean(), action_loss=-lp.mean())
        if self.vq_vae_enabled:
            metrics["vq_vae_loss"] = vq_loss
        return metrics

    def log_info(self, info):
        losses = info["losses"]
        log = OrderedDict(Loss=float(losses["action_loss"]),
                          Log_Likelihood=float(losses["log_probs"]))
        if "policy_grad_norms" in losses:
            log["Policy_Grad_Norms"] = float(losses["policy_grad_norms"])
        return log

    @torch.inference_mode()
    def action_distribution(self, obs_dict, context_batch, goal_dict=None,
                            low_noise_eval=None):
        """The policy's GMM over [B, T] for a request (obs [B, T, ...],
        context obs [B, T, ...], context actions [B, T, A]), and the LipVQ
        loss of the context actions (None without LipVQ)."""
        policy = self.nets["policy"]
        goal = None
        if goal_dict is not None:
            goal = self._obs(goal_dict)
        return policy.forward_train(
            self._obs(obs_dict), self._obs(context_batch["obs"]),
            self._context_actions(context_batch["actions"]), goal_dict=goal,
            low_noise_eval=low_noise_eval,
        )

    def get_action(self, obs_dict, context_batch, goal_dict=None):
        """Sample the action of one request: [B, ac_dim] on ``self.device``.
        Under data parallelism the request is this rank's shards; the
        mixture's parameters are gathered and every rank samples the global
        batch from the replicated generator (``torch.multinomial``'s draw
        is not separable by rows), as the unsharded request does."""
        self._check_request(obs_dict, context_batch, goal_dict)
        dist, _ = self.action_distribution(obs_dict, context_batch, goal_dict)
        with torch.inference_mode():
            return self._select_output(self._gather_dist(dist).sample(self.generator))
