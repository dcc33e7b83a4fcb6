"""Actor networks (counterpart of the JAX package's ``models/policy_nets.py``
:300-359, 388-501): the transformer actor of the flagship
ICLTransformerHVQVAE, and the prompt-conditioned ICL transformer actors. The
GMM actor is the paper's LipVQ path; with ``low_noise_eval`` its eval scales
are 1e-4."""

import torch
import torch.nn as nn
import torch.nn.functional as F

from robot_manipulation_vq_vae_tpu_torch.models.distributions import (
    GMMActionDistribution,
)
from robot_manipulation_vq_vae_tpu_torch.models.obs_nets import (
    ICL_MIMO_Transformer,
    MIMO_Transformer,
)
from robot_manipulation_vq_vae_tpu_torch.utils import tensor_utils as TensorUtils

_STD_ACTIVATIONS = {"softplus": F.softplus, "exp": torch.exp}


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
        groups = [("obs", obs_shapes)]
        if goal_shapes:
            groups.append(("goal", goal_shapes))
        self.net = MIMO_Transformer(
            input_obs_group_shapes=groups,
            output_shapes=[("action", (ac_dim,))],
            transformer_embed_dim=transformer_embed_dim,
            transformer_num_layers=transformer_num_layers,
            transformer_num_heads=transformer_num_heads,
            transformer_context_length=transformer_context_length,
            encoder_kwargs=encoder_kwargs,
            **transformer_kwargs,
        )

    def forward(self, obs_dict, actions=None, goal_dict=None, generator=None):
        """obs [B, T, ...] -> actions [B, T, ac_dim]; @generator draws the
        random crops in training."""
        kwargs = {"obs": obs_dict}
        if self.goal_shapes:
            if goal_dict is None:
                raise ValueError("this policy is goal-conditioned: pass goal_dict")
            t = next(iter(obs_dict.values())).shape[1]
            kwargs["goal"] = TensorUtils.unsqueeze_expand_at(goal_dict, size=t, dim=1)
        return torch.tanh(self.net(generator=generator, **kwargs)["action"])


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
        groups = [("obs", obs_shapes)]
        if goal_shapes:
            groups.append(("goal", goal_shapes))
        self.net = ICL_MIMO_Transformer(
            input_obs_group_shapes=groups,
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
        kwargs = {"obs": obs_dict}
        if self.goal_shapes:
            if goal_dict is None:
                raise ValueError("this policy is goal-conditioned: pass goal_dict")
            t = next(iter(obs_dict.values())).shape[1]
            kwargs["goal"] = TensorUtils.unsqueeze_expand_at(goal_dict, size=t, dim=1)
        kwargs["prompt"] = {"obs": context_obs, "action": actions}
        return self.net(generator=generator, **kwargs)


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
        means = torch.tanh(out["mean"])
        lne = self.low_noise_eval if low_noise_eval is None else low_noise_eval
        if lne and not self.training:
            scales = torch.full_like(means, 1e-4)
        else:
            scales = _STD_ACTIVATIONS[self.std_activation](out["scale"]) + self.min_std
        dist = GMMActionDistribution(means=means, scales=scales, logits=out["logits"])
        return dist, out["vq_vae_loss"]

    forward = forward_train
