"""Behavioral cloning (counterpart of the JAX package's ``algo/bc.py``),
registered as ``bc`` with its routing: the context-free versions of the ICL
family, whose steps they share.

* ``BC``, ``BC_Gaussian``, ``BC_GMM``, ``BC_RNN`` and ``BC_RNN_GMM`` are the
  ICL MLP and RNN policies under the robomimic names;
* ``BC_VAE`` trains the conditional VAE actor (``models/vae_nets.py``) on
  the first step of each window with recons + ``vae.kl_weight`` KL, the
  categorical prior's temperature annealed by epoch; ``get_action`` decodes
  a prior sample. ``ICLVAE`` is the same algo under the ICL name (the JAX
  package's delegates every method to ``BC_VAE``; ``icl`` never routes to
  it);
* ``BC_Transformer`` and ``BC_Transformer_GMM`` run the transformer actor
  over the observation window (``ICLTransformer``'s batch slicing) and
  serve from observations alone: no context batch (``TAKES_CONTEXT``), so
  ``rollout_policy_class`` gives them ``RolloutPolicy``. The GMM variant
  trains on the negative log likelihood of the supervised actions (the last
  step's without ``transformer.supervise_all_steps``).

``BC_Transformer`` trains under ``train.mixed_precision`` with
``ICLTransformer``'s bf16 step (JAX ``algo/icl.py``:735-800, which the JAX
class inherits). The others raise: their JAX steps ignore the flag and
train fp32 under it, which the port does not copy (ROADMAP.md).
"""

from collections import OrderedDict

import torch

from robot_manipulation_vq_vae_tpu_torch.algo.algo import register_algo_factory_func
from robot_manipulation_vq_vae_tpu_torch.algo.icl import (
    ICL,
    ICLGMM,
    ICLRNN,
    ICLRNN_GMM,
    ICLGaussian,
    ICLTransformer,
)
from robot_manipulation_vq_vae_tpu_torch.models import policy_nets as PolicyNets
from robot_manipulation_vq_vae_tpu_torch.models import vae_nets as VAENets
from robot_manipulation_vq_vae_tpu_torch.utils.draws import keep_rows


@register_algo_factory_func("bc")
def algo_config_to_class(algo_config):
    """The JAX package's routing (its ``bc.py:39-66``)."""
    gaussian = "gaussian" in algo_config and algo_config.gaussian.enabled
    gmm = "gmm" in algo_config and algo_config.gmm.enabled
    vae = "vae" in algo_config and algo_config.vae.enabled
    rnn = algo_config.rnn.enabled
    transformer = algo_config.transformer.enabled
    if gaussian:
        if rnn or transformer:
            raise NotImplementedError("a Gaussian BC policy has no RNN or transformer")
        return BC_Gaussian, {}
    if gmm:
        if rnn:
            return BC_RNN_GMM, {}
        if transformer:
            return BC_Transformer_GMM, {}
        return BC_GMM, {}
    if vae:
        if rnn or transformer:
            raise NotImplementedError("a VAE BC policy has no RNN or transformer")
        return BC_VAE, {}
    if rnn:
        return BC_RNN, {}
    if transformer:
        return BC_Transformer, {}
    return BC, {}


class BC(ICL):
    """Vanilla BC: the ICL MLP policy."""


class BC_Gaussian(ICLGaussian):
    pass


class BC_GMM(ICLGMM):
    pass


class BC_RNN(ICLRNN):
    pass


class BC_RNN_GMM(ICLRNN_GMM):
    pass


class BC_VAE(ICL):
    """CVAE BC (see the module docstring). Its losses are ``recons_loss``,
    ``kl_loss`` and ``action_loss`` = recons + kl_weight KL.

    Seams for tests, as the JAX class's ``_noise_hook``: a zero-argument
    ``_noise_hook`` returns the training step's ``eps`` (see
    ``VAEActor.reparametrize``), and ``_prior_hook`` the prior draws of a
    ``get_action`` (``VAEActor.sample_prior``); otherwise both come from
    ``self.generator``. Under data parallelism both are taken at the global
    batch's shape (a hook's draws are the global batch's) and each rank
    keeps its rows."""

    _noise_hook = None
    _prior_hook = None

    def _create_networks(self):
        self.nets["policy"] = VAENets.VAEActor(
            obs_shapes=self.obs_shapes,
            goal_shapes=self.goal_shapes or None,
            ac_dim=self.ac_dim,
            encoder_kwargs=self._encoder_kwargs(),
            **VAENets.vae_args_from_config(self.algo_config.vae),
        )
        self._epoch = 0

    def _temperature(self, epoch):
        """The Gumbel-softmax temperature of @epoch: annealed linearly from
        ``categorical_init_temp`` to ``categorical_min_temp``; 1 without the
        categorical prior."""
        prior = self.algo_config.vae.prior
        if not prior.use_categorical:
            return 1.0
        t = prior.categorical_init_temp - epoch * prior.categorical_temp_anneal_step
        return max(t, prior.categorical_min_temp)

    def train_on_batch(self, batch, epoch, validate=False):
        self._epoch = epoch
        return super().train_on_batch(batch, epoch, validate)

    def _losses(self, batch):
        obs, actions = self._device_batch(batch)
        eps = (None if self._noise_hook is None
               else keep_rows(self._draw(self._noise_hook()), self.dp))
        out = self.nets["policy"].forward_train(
            actions, obs, goal_dict=self._obs(batch.get("goal_obs") or None),
            temperature=self._temperature(self._epoch), eps=eps,
            generator=self.generator)
        losses = OrderedDict(recons_loss=out["reconstruction_loss"],
                             kl_loss=out["kl_loss"])
        losses["action_loss"] = (losses["recons_loss"]
                                 + float(self.algo_config.vae.kl_weight) * losses["kl_loss"])
        return losses

    def log_info(self, info):
        losses = info["losses"]
        return OrderedDict(Loss=float(losses["action_loss"]),
                           KL_Loss=float(losses["kl_loss"]),
                           Reconstruction_Loss=float(losses["recons_loss"]))

    @torch.inference_mode()
    def get_action(self, obs_dict, goal_dict=None):
        """The decoding of a prior sample: observations [B, ...] -> [B, A];
        under data parallelism the global batch's, on every rank."""
        self._check_obs_request(obs_dict, goal_dict)
        draws = None if self._prior_hook is None else self._prior_hook()
        if isinstance(draws, tuple):
            draws = tuple(keep_rows(self._draw(d), self.dp) for d in draws)
        elif draws is not None:
            draws = keep_rows(self._draw(draws), self.dp)
        return self._gather_rows(self.nets["policy"](
            self._obs(obs_dict), goal_dict=self._obs(goal_dict), generator=self.generator,
            prior_draws=draws))


class ICLVAE(BC_VAE):
    """CVAE ICL: ``BC_VAE`` under the ICL name (JAX ``algo/icl.py``
    ``ICLVAE``; the ``icl`` factory never routes to it)."""


class BC_Transformer(ICLTransformer):
    """Transformer BC: ``ICLTransformer``'s step, bf16 under
    ``train.mixed_precision``. Its layer table, read off ``jax.make_jaxpr``
    of the JAX bf16 step: with image observations the trunks and keypoint
    convolutions bf16 and, from the fp32 keypoints on, the rest fp32 on
    bf16 parameters (see ``ICLTransformer._policy_forward``); with
    low-dimensional observations alone the token embedding and the first
    block's qkv projection bf16, its attention scores bf16 operands with an
    fp32 result, and from that attention's fp32 output on every layer fp32
    (the later blocks and the action head). ``get_action`` takes the
    observation window [B, T, ...] alone, in fp32, and returns the step
    that ``_select_output`` picks."""

    TAKES_CONTEXT = False

    @torch.inference_mode()
    def get_action(self, obs_dict, goal_dict=None):
        self._check_obs_request(obs_dict, goal_dict)
        return self._gather_rows(self._select_output(self.nets["policy"](
            self._obs(obs_dict), goal_dict=self._obs(goal_dict))))


class BC_Transformer_GMM(BC_Transformer):
    """Transformer-GMM BC: the negative log likelihood of the supervised
    actions; ``get_action`` samples the GMM with the algo's generator.
    ``train.mixed_precision`` raises: the JAX class's own step
    (``bc.py:268``) ignores it."""

    MIXED_PRECISION = False

    def _create_networks(self):
        if not self.algo_config.gmm.enabled:
            raise ValueError(f"{type(self).__name__} needs algo.gmm enabled")
        self._set_params_from_config()
        g = self.algo_config.gmm
        self.nets["policy"] = PolicyNets.TransformerGMMActorNetwork(
            obs_shapes=self.obs_shapes,
            goal_shapes=self.goal_shapes or None,
            ac_dim=self.ac_dim,
            num_modes=g.num_modes, min_std=g.min_std,
            std_activation=g.std_activation, low_noise_eval=g.low_noise_eval,
            encoder_kwargs=self._encoder_kwargs(),
            **self._policy_transformer_args(),
        )

    def _losses(self, batch):
        obs, actions = self._device_batch(batch)
        policy = self.nets["policy"]
        dist = policy(obs, goal_dict=self._obs(batch.get("goal_obs") or None),
                      generator=self.generator if policy.training else None)
        if not self.supervise_all_steps:
            dist = dist.index_time(-1)
        lp = dist.log_prob(actions)
        losses = OrderedDict(log_probs=lp.mean(), action_loss=-lp.mean())
        return losses, losses["action_loss"]

    def log_info(self, info):
        losses = info["losses"]
        return OrderedDict(Loss=float(losses["action_loss"]),
                           Log_Likelihood=float(losses["log_probs"]))

    @torch.inference_mode()
    def action_distribution(self, obs_dict, goal_dict=None):
        """The policy's GMM over a request's window [B, T] (this rank's rows
        under data parallelism)."""
        self._check_obs_request(obs_dict, goal_dict)
        return self.nets["policy"](self._obs(obs_dict), goal_dict=self._obs(goal_dict))

    def get_action(self, obs_dict, goal_dict=None):
        with torch.inference_mode():
            dist = self._gather_dist(self.action_distribution(obs_dict, goal_dict))
            return self._select_output(dist.sample(self.generator))
