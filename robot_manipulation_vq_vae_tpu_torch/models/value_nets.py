"""Value networks (counterpart of the JAX package's ``models/value_nets.py``):
the state value V(s), the action value Q(s, a), and the categorical
distributional Q over a fixed grid of value atoms (C51).

Each network has its own ``ObservationGroupEncoder`` (each core's feature
through a ReLU), so on image observations each one runs its own trunks and
stem pools. Q reads the actions concatenated after the encoder's features.
The layers sit in the reference's layout: ``nets.encoder``, the hidden
layers at ``nets.mlp._model.{0, 2, ...}`` and the output at
``nets.decoder.nets.value`` (``log_probs`` for the distributional Q).

``features`` and ``head`` split a forward in two, so that a caller can run
the encoder once and the head over several action sets, or over the
features tiled to candidates (in inference mode the encoder treats each row
alone, so encoding tiled observations is tiling their features).
"""

import torch
import torch.nn as nn

from robot_manipulation_vq_vae_tpu_torch.models import base_nets as BaseNets
from robot_manipulation_vq_vae_tpu_torch.models.obs_nets import (
    ObservationDecoder,
    ObservationGroupEncoder,
)
from robot_manipulation_vq_vae_tpu_torch.models.policy_nets import _groups, _inputs


class ValueNetwork(nn.Module):
    """V(s) [B, 1]; with @value_bounds (lo, hi) the output is squashed into
    them as lo + (hi - lo) / 2 (tanh(v) + 1)."""

    HEAD = "value"

    def __init__(self, obs_shapes, mlp_layer_dims=(300, 400), value_bounds=None,
                 goal_shapes=None, encoder_kwargs=None, ac_dim=0):
        super().__init__()
        self.goal_shapes = goal_shapes
        self.value_bounds = tuple(value_bounds) if value_bounds is not None else None
        self.ac_dim = ac_dim
        encoder = ObservationGroupEncoder(_groups(obs_shapes, goal_shapes), encoder_kwargs,
                                          feature_activation="relu")
        layer_dims = tuple(mlp_layer_dims)
        dim = encoder.output_dim + ac_dim
        nets = {"encoder": encoder}
        if layer_dims:
            nets["mlp"] = BaseNets.MLP(dim, layer_dims[-1], layer_dims[:-1],
                                       output_activation=nn.ReLU)
            dim = layer_dims[-1]
        nets["decoder"] = ObservationDecoder([(self.HEAD, (self._output_dim(),))], dim)
        self.nets = nn.ModuleDict(nets)
        # the JAX module's MLP (fc0, fc1, ..., out) spans the hidden layers
        # and the decoder's head
        mlp = {f"fc{i}": f"nets.mlp._model.{2 * i}" for i in range(len(layer_dims))}
        mlp["out"] = f"nets.decoder.nets.{self.HEAD}"
        self.JAX_NAMES = {"encoder": "nets.encoder", "mlp": mlp}

    def _output_dim(self):
        return 1

    def features(self, obs_dict, goal_dict=None, generator=None):
        """The encoder's features [B, F]."""
        return self.nets["encoder"](
            _inputs(obs_dict, goal_dict, self.goal_shapes, over_time=False), generator)

    def _raw(self, feats, acts=None):
        if acts is not None:
            feats = torch.cat([feats, acts], dim=-1)
        if "mlp" in self.nets:
            feats = self.nets["mlp"](feats)
        return self.nets["decoder"](feats)[self.HEAD]

    def _squash(self, v):
        if self.value_bounds is None:
            return v
        lo, hi = self.value_bounds
        return lo + (hi - lo) * 0.5 * (torch.tanh(v) + 1.0)

    def head(self, feats, acts=None):
        """The value of features @feats [B, F] (and actions @acts [B, A])."""
        return self._squash(self._raw(feats, acts))

    def forward(self, obs_dict, goal_dict=None, generator=None):
        return self.head(self.features(obs_dict, goal_dict, generator))


class ActionValueNetwork(ValueNetwork):
    """Q(s, a) [B, 1]: the actions [B, A] concatenated after the
    observations' features."""

    def __init__(self, obs_shapes, ac_dim, mlp_layer_dims=(300, 400), value_bounds=None,
                 goal_shapes=None, encoder_kwargs=None):
        super().__init__(obs_shapes, mlp_layer_dims, value_bounds, goal_shapes,
                         encoder_kwargs, ac_dim=ac_dim)

    def forward(self, obs_dict, acts, goal_dict=None, generator=None):
        return self.head(self.features(obs_dict, goal_dict, generator), acts)


class DistributionalActionValueNetwork(ActionValueNetwork):
    """A categorical distribution over @num_atoms values evenly spaced over
    @value_bounds: ``forward_train`` gives its log probabilities [B, atoms]
    and the atoms, ``forward`` its mean [B, 1]."""

    HEAD = "log_probs"

    def __init__(self, obs_shapes, ac_dim, mlp_layer_dims=(300, 400), value_bounds=None,
                 num_atoms=51, goal_shapes=None, encoder_kwargs=None):
        if value_bounds is None:
            raise ValueError("the distributional critic needs value_bounds")
        self.num_atoms = num_atoms
        super().__init__(obs_shapes, ac_dim, mlp_layer_dims, value_bounds, goal_shapes,
                         encoder_kwargs)

    def _output_dim(self):
        return self.num_atoms

    def atoms(self, like):
        """The value atoms, on @like's device and in its dtype."""
        lo, hi = self.value_bounds
        return torch.linspace(lo, hi, self.num_atoms, device=like.device, dtype=like.dtype)

    def head_train(self, feats, acts):
        logits = self._raw(feats, acts)
        return torch.log_softmax(logits, dim=-1), self.atoms(logits)

    def head(self, feats, acts=None):
        log_probs, atoms = self.head_train(feats, acts)
        return (log_probs.exp() * atoms).sum(-1, keepdim=True)

    def forward_train(self, obs_dict, acts, goal_dict=None, generator=None):
        return self.head_train(self.features(obs_dict, goal_dict, generator), acts)
