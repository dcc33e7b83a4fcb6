"""Base network blocks (counterpart of the JAX package's ``models/base_nets.py``
:153-221, 293-335, 720-785): the FiLM ResNet-18 trunk and SpatialSoftmax.

Images reach the port channels-last ([B, H, W, C]) as in the JAX package;
``VisualCore`` permutes them to NCHW once, and everything here runs NCHW.
Parameters keep the reference torch layout and key names
(``_base_block``, ``_conv_blocks``, ``_film_layers``, torchvision's
``conv1``/``bn1``/``downsample``), so reference checkpoints map one to one.

Each module's ``JAX_NAMES`` maps the JAX child names to torch submodule
paths; ``utils/jax_weights.py`` reads it to carry JAX weights across.
"""

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

# Flax's BatchNorm epsilon, the same as torch's default.
BN_EPS = 1e-5


def transformer_args_from_config(transformer_config):
    """Map ``algo.transformer.*`` config keys to network kwargs."""
    args = dict(
        transformer_context_length=transformer_config.context_length,
        transformer_embed_dim=transformer_config.embed_dim,
        transformer_num_heads=transformer_config.num_heads,
        transformer_emb_dropout=transformer_config.emb_dropout,
        transformer_attn_dropout=transformer_config.attn_dropout,
        transformer_block_output_dropout=transformer_config.block_output_dropout,
        transformer_sinusoidal_embedding=transformer_config.sinusoidal_embedding,
        transformer_activation=transformer_config.activation,
        transformer_nn_parameter_for_timesteps=transformer_config.nn_parameter_for_timesteps,
        transformer_num_layers=transformer_config.num_layers,
        transformer_fast_enabled=transformer_config.fast_enabled,
        transformer_bin_enabled=transformer_config.bin_enabled,
        transformer_vq_vae_enabled=transformer_config.vq_vae_enabled,
        transformer_ln_act_enabled=transformer_config.ln_act_enabled,
    )
    if "causal" in transformer_config:
        args["transformer_causal"] = transformer_config.causal
    return args


def _conv(cin, cout, k, stride=1, padding=0, bias=False):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=padding, bias=bias)


class BasicBlock(nn.Module):
    """torchvision BasicBlock: 3x3-BN-ReLU-3x3-BN + skip, final ReLU."""

    JAX_NAMES = {"conv1": "conv1", "bn1": "bn1", "conv2": "conv2", "bn2": "bn2",
                 "down_conv": "downsample.0", "down_bn": "downsample.1"}

    def __init__(self, cin, features, stride=1):
        super().__init__()
        self.conv1 = _conv(cin, features, 3, stride, 1)
        self.bn1 = nn.BatchNorm2d(features, eps=BN_EPS)
        self.conv2 = _conv(features, features, 3, 1, 1)
        self.bn2 = nn.BatchNorm2d(features, eps=BN_EPS)
        self.downsample = None
        if stride != 1 or cin != features:
            self.downsample = nn.Sequential(
                _conv(cin, features, 1, stride),
                nn.BatchNorm2d(features, eps=BN_EPS),
            )

    def jax_names(self):
        if self.downsample is None:
            return {k: v for k, v in self.JAX_NAMES.items()
                    if not v.startswith("downsample")}
        return self.JAX_NAMES

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(h + identity)


class _ResNet18Stem(nn.Sequential):
    """conv7x7/2 + BN + ReLU + maxpool3x3/2 (torchvision stem); the reference
    names it ``_base_block``."""

    JAX_NAMES = {"conv1": "0", "bn1": "1"}

    def __init__(self, cin=3):
        super().__init__(
            _conv(cin, 64, 7, 2, 3),
            nn.BatchNorm2d(64, eps=BN_EPS),
            nn.ReLU(),
            nn.MaxPool2d(3, 2, 1),
        )


# (features, stride) of the eight BasicBlocks of ResNet-18
_RESNET18_PLAN = [(64, 1), (64, 1), (128, 2), (128, 1),
                  (256, 2), (256, 1), (512, 2), (512, 1)]


class FiLMLayer(nn.Module):
    """Feature-wise linear modulation by a language embedding:
    x -> relu((1 + gamma) x + beta)."""

    JAX_NAMES = {"lang_proj": "lang_proj"}

    def __init__(self, channels, lang_emb_dim):
        super().__init__()
        self.lang_proj = nn.Linear(lang_emb_dim, 2 * channels)

    def forward(self, x, lang_emb):
        beta, gamma = self.lang_proj(lang_emb).chunk(2, dim=-1)
        return F.relu((1.0 + gamma[:, :, None, None]) * x + beta[:, :, None, None])


class ResNet18ConvFiLM(nn.Module):
    """ResNet-18 trunk with a FiLM layer after every BasicBlock. Input
    [B, 3, H, W]; output [B, 512, ceil(H/32), ceil(W/32)]."""

    def __init__(self, lang_emb_dim=768, input_coord_conv=False, pretrained=False):
        super().__init__()
        if input_coord_conv:
            raise NotImplementedError("input_coord_conv is not ported yet")
        self._base_block = _ResNet18Stem()
        blocks, films, cin = [], [], 64
        for feat, stride in _RESNET18_PLAN:
            blocks.append(BasicBlock(cin, feat, stride))
            films.append(FiLMLayer(feat, lang_emb_dim))
            cin = feat
        self._conv_blocks = nn.ModuleList(blocks)
        self._film_layers = nn.ModuleList(films)

    def jax_names(self):
        names = {"stem": "_base_block"}
        for i in range(len(self._conv_blocks)):
            names[f"block{i}"] = f"_conv_blocks.{i}"
            names[f"film{i}"] = f"_film_layers.{i}"
        return names

    def forward(self, x, lang_emb):
        x = self._base_block(x)
        for block, film in zip(self._conv_blocks, self._film_layers):
            x = film(block(x), lang_emb)
        return x

    @staticmethod
    def output_shape(input_shape):
        h, w, _ = input_shape
        return [int(math.ceil(h / 32.0)), int(math.ceil(w / 32.0)), 512]


class SpatialSoftmax(nn.Module):
    """Spatial-softmax keypoint pooling: [B, C, H, W] -> keypoints [B, K, 2].
    The softmax runs over the h-major flattened H*W positions, the order of
    the JAX package's [B, H, W, K] -> [B, K, H*W] transpose."""

    JAX_NAMES = {"kp_conv": "nets"}

    def __init__(self, input_shape, num_kp=32, temperature=1.0,
                 learnable_temperature=False, output_variance=False,
                 noise_std=0.0):
        super().__init__()
        if learnable_temperature or output_variance:
            raise NotImplementedError(
                "learnable_temperature / output_variance are not ported yet"
            )
        h, w, c = input_shape
        self.num_kp = num_kp if num_kp is not None else c
        self.nets = nn.Conv2d(c, num_kp, 1) if num_kp is not None else None
        self.temperature = temperature
        pos_x, pos_y = np.meshgrid(np.linspace(-1.0, 1.0, w), np.linspace(-1.0, 1.0, h))
        self.register_buffer(
            "pos", torch.tensor(np.stack([pos_x.reshape(-1), pos_y.reshape(-1)], -1),
                                dtype=torch.float32),
            persistent=False,
        )

    def forward(self, feature):
        if self.nets is not None:
            feature = self.nets(feature)
        b, k, h, w = feature.shape
        attention = torch.softmax(feature.reshape(b * k, h * w) / self.temperature, -1)
        return (attention @ self.pos).reshape(b, k, 2)

    @staticmethod
    def static_output_shape(input_shape, num_kp=32):
        return [num_kp if num_kp is not None else input_shape[-1], 2]
