"""Actor networks (counterpart of the JAX package's ``models/policy_nets.py``
:57-385, 388-501): the MLP actors (deterministic, Gaussian and GMM heads),
the RNN actors (deterministic and GMM), the transformer actor of the
flagship ICLTransformerHVQVAE and its GMM variant (``BC_Transformer_GMM``'s),
and the prompt-conditioned ICL transformer
actors (GPT or Mamba backbone). The ICL GMM actor is the paper's LipVQ
path. With ``low_noise_eval`` the stochastic heads' eval scales are 1e-4.
In training (``self.training``) the scales are the activated scale heads,
and a @generator draws the random crops."""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from robot_manipulation_vq_vae_tpu_torch.models import base_nets as BaseNets
from robot_manipulation_vq_vae_tpu_torch.models.distributions import (
    DiagGaussian,
    GMMActionDistribution,
)
from robot_manipulation_vq_vae_tpu_torch.models.obs_nets import (
    ICL_MIMO_Transformer,
    MIMO_MLP,
    MIMO_Transformer,
    ObservationDecoder,
    ObservationGroupEncoder,
)
from robot_manipulation_vq_vae_tpu_torch.utils import tensor_utils as TensorUtils

_STD_ACTIVATIONS = {"softplus": F.softplus, "exp": torch.exp}


def _groups(obs_shapes, goal_shapes):
    groups = [("obs", obs_shapes)]
    if goal_shapes:
        groups.append(("goal", goal_shapes))
    return groups


def _inputs(obs_dict, goal_dict, goal_shapes, over_time=True):
    """The observation groups of a forward: {"obs": ...} and, for a
    goal-conditioned policy, {"goal": ...}, each episode's goal tiled over
    the observations' time axis where @over_time."""
    inputs = {"obs": obs_dict}
    if goal_shapes:
        if goal_dict is None:
            raise ValueError("this policy is goal-conditioned: pass goal_dict")
        if over_time:
            t = next(iter(obs_dict.values())).shape[1]
            goal_dict = TensorUtils.unsqueeze_expand_at(goal_dict, size=t, dim=1)
        inputs["goal"] = goal_dict
    return inputs


def _gmm(out, min_std, std_activation, low_noise):
    """The GMM of the heads @out: tanh'd means; scales 1e-4 where
    @low_noise, else the activated scale head + @min_std."""
    means = torch.tanh(out["mean"])
    if low_noise:
        scales = torch.full_like(means, 1e-4)
    else:
        scales = _STD_ACTIVATIONS[std_activation](out["scale"]) + min_std
    return GMMActionDistribution(means=means, scales=scales, logits=out["logits"])


class ActorNetwork(nn.Module):
    """MIMO_MLP actor: observations [B, ...] -> actions [B, ac_dim],
    tanh-squashed."""

    JAX_NAMES = {"net": "net"}

    def __init__(self, obs_shapes, ac_dim, mlp_layer_dims=(1024, 1024),
                 goal_shapes=None, encoder_kwargs=None):
        super().__init__()
        self.ac_dim = ac_dim
        self.goal_shapes = goal_shapes
        self.net = MIMO_MLP(_groups(obs_shapes, goal_shapes), self._output_shapes(),
                            tuple(mlp_layer_dims), encoder_kwargs)

    def _output_shapes(self):
        return [("action", (self.ac_dim,))]

    def _heads(self, obs_dict, goal_dict, generator):
        return self.net(_inputs(obs_dict, goal_dict, self.goal_shapes, over_time=False),
                        generator)

    def forward(self, obs_dict, goal_dict=None, generator=None):
        return torch.tanh(self._heads(obs_dict, goal_dict, generator)["action"])


class GMMActorNetwork(ActorNetwork):
    """MIMO_MLP actor emitting a GMM over [B] actions."""

    def __init__(self, obs_shapes, ac_dim, mlp_layer_dims=(1024, 1024), num_modes=5,
                 min_std=0.01, std_activation="softplus", low_noise_eval=True,
                 goal_shapes=None, encoder_kwargs=None):
        self.num_modes = num_modes
        super().__init__(obs_shapes, ac_dim, mlp_layer_dims, goal_shapes, encoder_kwargs)
        self.min_std = min_std
        self.std_activation = std_activation
        self.low_noise_eval = low_noise_eval

    def _output_shapes(self):
        m, a = self.num_modes, self.ac_dim
        return [("mean", (m, a)), ("scale", (m, a)), ("logits", (m,))]

    def forward(self, obs_dict, goal_dict=None, generator=None):
        return _gmm(self._heads(obs_dict, goal_dict, generator), self.min_std,
                    self.std_activation, self.low_noise_eval and not self.training)


class GaussianActorNetwork(ActorNetwork):
    """MIMO_MLP actor emitting a diagonal Gaussian, with the reference's
    output transforms: the mean clamped to ``mean_limits`` and tanh'd; the
    scale ``softplus(x) * init_std / softplus(0)`` (or ``exp``, or the head
    itself; ``init_std`` alone with ``fixed_std``) clamped to
    ``(min_std or std_limits[0], std_limits[1])``; 1e-4 in low-noise eval.
    The tanh-wrapped distribution (``use_tanh``) is not ported: no ICL config
    sets it."""

    def __init__(self, obs_shapes, ac_dim, mlp_layer_dims=(1024, 1024),
                 fixed_std=False, init_std=0.3, min_std=None,
                 mean_limits=(-9.0, 9.0), std_limits=(0.007, 7.5),
                 std_activation="softplus", low_noise_eval=True, use_tanh=False,
                 goal_shapes=None, encoder_kwargs=None):
        if use_tanh:
            raise NotImplementedError("the tanh-wrapped Gaussian is not ported yet")
        super().__init__(obs_shapes, ac_dim, mlp_layer_dims, goal_shapes, encoder_kwargs)
        self.fixed_std = fixed_std
        self.init_std = init_std
        self.min_std = min_std
        self.mean_limits = mean_limits
        self.std_limits = std_limits
        self.std_activation = std_activation
        self.low_noise_eval = low_noise_eval

    def _output_shapes(self):
        return [("mean", (self.ac_dim,)), ("scale", (self.ac_dim,))]

    def forward(self, obs_dict, goal_dict=None, generator=None):
        out = self._heads(obs_dict, goal_dict, generator)
        mean = torch.tanh(out["mean"].clamp(*self.mean_limits))
        if self.low_noise_eval and not self.training:
            return DiagGaussian(mean=mean, scale=torch.full_like(mean, 1e-4))
        if self.fixed_std:
            scale = torch.full_like(mean, self.init_std)
        elif self.std_activation == "softplus":
            scale = F.softplus(out["scale"]) * (self.init_std / math.log(2.0))
        elif self.std_activation == "exp":
            scale = torch.exp(out["scale"])
        else:
            scale = out["scale"]
        lo = self.std_limits[0] if self.min_std is None else self.min_std
        return DiagGaussian(mean=mean, scale=scale.clamp(lo, self.std_limits[1]))


class RNNActorNetwork(nn.Module):
    """Observations [B, T, ...] -> per-step features (each core's through a
    ReLU) -> LSTM or GRU -> per-step actions [B, T, ac_dim], tanh-squashed.

    The per-step head is the reference's ``per_step_net``: the linear heads
    on the RNN's outputs, or with ``mlp_layer_dims`` an MLP (ReLU after
    every layer) and then the heads. ``forward`` takes and, with
    ``return_state``, returns the RNN's carries (``BaseNets.RNNBase``)."""

    def __init__(self, obs_shapes, ac_dim, mlp_layer_dims=(), rnn_hidden_dim=400,
                 rnn_num_layers=2, rnn_type="LSTM", goal_shapes=None,
                 encoder_kwargs=None):
        super().__init__()
        self.ac_dim = ac_dim
        self.goal_shapes = goal_shapes
        self.encoder = ObservationGroupEncoder(_groups(obs_shapes, goal_shapes),
                                               encoder_kwargs, feature_activation="relu")
        self.rnn = BaseNets.RNNBase(self.encoder.output_dim, rnn_hidden_dim,
                                    rnn_num_layers, rnn_type)
        self.per_step_net, self._head_names = self._per_step_net(
            tuple(mlp_layer_dims), rnn_hidden_dim)

    def _per_step_net(self, mlp_layer_dims, dim):
        """(the per-step head, the JAX names of its layers)."""
        decode = [("action", (self.ac_dim,))]
        if not mlp_layer_dims:
            return ObservationDecoder(decode, dim), {"head": {"out": "per_step_net.nets.action"}}
        mlp = BaseNets.MLP(dim, mlp_layer_dims[-1], mlp_layer_dims[:-1],
                           output_activation=nn.ReLU)
        names = {f"fc{i}": f"per_step_net.0._model.{2 * i}"
                 for i in range(len(mlp_layer_dims))}
        names["out"] = "per_step_net.1.nets.action"
        return (nn.Sequential(mlp, ObservationDecoder(decode, mlp_layer_dims[-1])),
                {"head": names})

    def jax_names(self):
        return {"encoder": "encoder", "rnn": "rnn", **self._head_names}

    def _hidden(self, obs_dict, goal_dict, initial_state, generator):
        folded, b, t = TensorUtils.fold_time(_inputs(obs_dict, goal_dict, self.goal_shapes))
        seq = self.encoder(folded, generator).reshape(b, t, -1)
        return self.rnn(seq, initial_state)

    def forward(self, obs_dict, goal_dict=None, initial_state=None, return_state=False,
                generator=None):
        hidden, state = self._hidden(obs_dict, goal_dict, initial_state, generator)
        actions = torch.tanh(self.per_step_net(hidden)["action"])
        return (actions, state) if return_state else actions


class RNNGMMActorNetwork(RNNActorNetwork):
    """The RNN actor emitting a GMM over [B, T] actions; its per-step heads
    read the RNN's outputs directly."""

    def __init__(self, obs_shapes, ac_dim, rnn_hidden_dim=400, rnn_num_layers=2,
                 rnn_type="LSTM", num_modes=5, min_std=0.01, std_activation="softplus",
                 low_noise_eval=True, goal_shapes=None, encoder_kwargs=None):
        self.num_modes = num_modes
        super().__init__(obs_shapes, ac_dim, (), rnn_hidden_dim, rnn_num_layers,
                         rnn_type, goal_shapes, encoder_kwargs)
        self.min_std = min_std
        self.std_activation = std_activation
        self.low_noise_eval = low_noise_eval

    def _per_step_net(self, mlp_layer_dims, dim):
        m, a = self.num_modes, self.ac_dim
        heads = [("mean", (m, a)), ("scale", (m, a)), ("logits", (m,))]
        names = {f"{h}_head" if h != "logits" else "logit_head":
                 {"out": f"per_step_net.nets.{h}"} for h, _ in heads}
        return ObservationDecoder(heads, dim), names

    def forward(self, obs_dict, goal_dict=None, initial_state=None, return_state=False,
                generator=None):
        hidden, state = self._hidden(obs_dict, goal_dict, initial_state, generator)
        dist = _gmm(self.per_step_net(hidden), self.min_std, self.std_activation,
                    self.low_noise_eval and not self.training)
        return (dist, state) if return_state else dist


class TransformerActorNetwork(nn.Module):
    """MIMO_Transformer actor over the observation window: [B, T, ac_dim]
    actions, tanh-squashed. ``actions`` is accepted and ignored, as in the
    reference forward that ICLTransformerHVQVAE calls."""

    JAX_NAMES = {"net": "net"}

    def __init__(self, obs_shapes, ac_dim, transformer_embed_dim,
                 transformer_num_layers, transformer_num_heads,
                 transformer_context_length, goal_shapes=None,
                 encoder_kwargs=None, **transformer_kwargs):
        super().__init__()
        self.ac_dim = ac_dim
        self.goal_shapes = goal_shapes
        self.net = MIMO_Transformer(
            input_obs_group_shapes=_groups(obs_shapes, goal_shapes),
            output_shapes=self._output_shapes(),
            transformer_embed_dim=transformer_embed_dim,
            transformer_num_layers=transformer_num_layers,
            transformer_num_heads=transformer_num_heads,
            transformer_context_length=transformer_context_length,
            encoder_kwargs=encoder_kwargs,
            **transformer_kwargs,
        )

    def _output_shapes(self):
        return [("action", (self.ac_dim,))]

    def _heads(self, obs_dict, goal_dict, generator):
        return self.net(generator=generator,
                        **_inputs(obs_dict, goal_dict, self.goal_shapes))

    def forward(self, obs_dict, actions=None, goal_dict=None, generator=None):
        """obs [B, T, ...] -> actions [B, T, ac_dim]; @generator draws the
        random crops in training."""
        return torch.tanh(self._heads(obs_dict, goal_dict, generator)["action"])


class TransformerGMMActorNetwork(TransformerActorNetwork):
    """The transformer actor emitting a GMM over [B, T] actions (JAX
    ``TransformerGMMActorNetwork``): tanh'd means; in eval with
    ``low_noise_eval`` the scales are 1e-4."""

    def __init__(self, *args, num_modes=5, min_std=0.01, std_activation="softplus",
                 low_noise_eval=True, **kwargs):
        self.num_modes = num_modes
        super().__init__(*args, **kwargs)
        self.min_std = min_std
        self.std_activation = std_activation
        self.low_noise_eval = low_noise_eval

    def _output_shapes(self):
        m, a = self.num_modes, self.ac_dim
        return [("mean", (m, a)), ("scale", (m, a)), ("logits", (m,))]

    def forward(self, obs_dict, actions=None, goal_dict=None, generator=None):
        return _gmm(self._heads(obs_dict, goal_dict, generator), self.min_std,
                    self.std_activation, self.low_noise_eval and not self.training)


class ICLTransformerActorNetwork(nn.Module):
    """ICL_MIMO_Transformer actor: prompt-conditioned, tanh-squashed."""

    JAX_NAMES = {"net": "net"}

    def __init__(self, obs_shapes, ac_dim, transformer_embed_dim,
                 transformer_num_layers, transformer_num_heads,
                 transformer_context_length, goal_shapes=None,
                 encoder_kwargs=None, action_input_shape=12,
                 backbone_type="gpt", use_kernels=True, **transformer_kwargs):
        super().__init__()
        self.ac_dim = ac_dim
        self.goal_shapes = goal_shapes
        self.net = ICL_MIMO_Transformer(
            input_obs_group_shapes=_groups(obs_shapes, goal_shapes),
            output_shapes=self._output_shapes(),
            transformer_embed_dim=transformer_embed_dim,
            transformer_num_layers=transformer_num_layers,
            transformer_num_heads=transformer_num_heads,
            transformer_context_length=transformer_context_length,
            action_input_shape=action_input_shape,
            backbone_type=backbone_type,
            encoder_kwargs=encoder_kwargs,
            use_kernels=use_kernels,
            **transformer_kwargs,
        )

    def _output_shapes(self):
        return [("action", (self.ac_dim,))]

    def _forward_raw(self, obs_dict, context_obs, actions, goal_dict=None,
                     generator=None):
        inputs = _inputs(obs_dict, goal_dict, self.goal_shapes)
        inputs["prompt"] = {"obs": context_obs, "action": actions}
        return self.net(generator=generator, **inputs)


class ICLTransformerGMMActorNetwork(ICLTransformerActorNetwork):
    """Prompt-conditioned GMM actor: the paper's LipVQ path."""

    def __init__(self, *args, num_modes=5, min_std=0.01,
                 std_activation="softplus", low_noise_eval=True,
                 use_tanh=False, **kwargs):
        self.num_modes = num_modes
        if use_tanh:
            raise NotImplementedError("the tanh-wrapped GMM is not ported yet")
        super().__init__(*args, **kwargs)
        self.min_std = min_std
        self.std_activation = std_activation
        self.low_noise_eval = low_noise_eval

    def _output_shapes(self):
        m, a = self.num_modes, self.ac_dim
        return [("mean", (m, a)), ("scale", (m, a)), ("logits", (m,))]

    def forward_train(self, obs_dict, context_obs, actions=None, goal_dict=None,
                      low_noise_eval=None, generator=None):
        """Returns (GMM distribution over [B, T], vq_vae_loss). In training
        (``self.training``) the scales are always softplus(scale) + min_std,
        and @generator draws the random crops."""
        out = self._forward_raw(obs_dict, context_obs, actions, goal_dict,
                                generator)
        lne = self.low_noise_eval if low_noise_eval is None else low_noise_eval
        return (_gmm(out, self.min_std, self.std_activation, lne and not self.training),
                out["vq_vae_loss"])

    forward = forward_train
