"""Base network blocks (counterpart of the JAX package's ``models/base_nets.py``
:153-221, 270-335, 720-785): the ResNet-18 trunk, its FiLM variant and
SpatialSoftmax.

Images reach the port channels-last ([B, H, W, C]) as in the JAX package;
``VisualCore`` permutes them to contiguous NCHW once, and everything here
runs NCHW. BatchNorm follows Flax's ``nn.BatchNorm`` in training (momentum
0.99, the biased batch variance in the running update), not torch's
defaults. The stem's max pool is ``F.max_pool2d`` unless
``set_stem_pool`` selects the recorded-argmax kernels (``train.pallas_pool``).
Two opt-in training modes are set per model, never process-wide:
``set_frozen_batch_norm`` (``train.frozen_batch_norm``) and
``set_pool_free_stem`` (``train.pool_free_stem``).
Parameters keep the reference torch layout and key names
(``_base_block``, ``_conv_blocks``, ``_film_layers``, torchvision's
``conv1``/``bn1``/``downsample``; ``nets.0`` ... ``nets.7`` for the plain
trunk), so reference checkpoints map one to one. Under mixed precision the
trunks take bf16 activations and bf16 copies of their weights (see
``BatchNorm2d`` and ``SpatialSoftmax``).

Each module's ``JAX_NAMES`` maps the JAX child names to torch submodule
paths; ``utils/jax_weights.py`` reads it to carry JAX weights across.
"""

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from robot_manipulation_vq_vae_tpu_torch.ops.stem_pool import max_pool_3x3_s2

# Flax's BatchNorm epsilon, the same as torch's default.
BN_EPS = 1e-5
# Flax's BatchNorm momentum: running = 0.99 running + 0.01 batch. (The torch
# reference robomimic keeps torch's 0.1; the JAX package, and so the port,
# follows Flax.)
FLAX_BN_MOMENTUM = 0.99
# ... and that momentum as a bf16 value, 0.98828125 (mixed precision)
FLAX_BN_MOMENTUM_BF16 = float(torch.tensor(FLAX_BN_MOMENTUM, dtype=torch.bfloat16))


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


def flax_batch_norm(x, running_mean, running_var, weight, bias, use_batch,
                    eps=BN_EPS):
    """Flax's BatchNorm over the channels of @x [N, C, H, W] (see
    ``BatchNorm2d``). With @use_batch, @x is normalized by its own mean and
    biased variance and @running_mean / @running_var move towards them in
    place; else by the running statistics, which stay as they are, but for
    a bf16 @x, where they are rounded to bf16 in place."""
    half = x.dtype == torch.bfloat16
    if half:   # fp32 arithmetic on the bf16 values, the output in bf16
        weight, bias = weight.float(), bias.float()
    if not use_batch:
        if half:   # the step's bf16 copies of the statistics, written back
            mean16, var16 = running_mean.bfloat16().float(), running_var.bfloat16().float()
            with torch.no_grad():
                running_mean.copy_(mean16)
                running_var.copy_(var16)
            running_mean, running_var = mean16, var16
        return F.batch_norm(x, running_mean, running_var, weight, bias, False, 0.0,
                            eps)
    with torch.no_grad():
        var, mean = torch.var_mean(x.float() if half else x, dim=(0, 2, 3),
                                   unbiased=False)
        if half:
            for running, stat in ((running_mean, mean), (running_var, var)):
                running.copy_(running.bfloat16().float() * FLAX_BN_MOMENTUM_BF16
                              + (1.0 - FLAX_BN_MOMENTUM) * stat)
        else:
            running_mean.lerp_(mean, 1.0 - FLAX_BN_MOMENTUM)
            running_var.lerp_(var, 1.0 - FLAX_BN_MOMENTUM)
    return F.batch_norm(x, None, None, weight, bias, True, 0.0, eps)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with Flax's training semantics: the batch is
    normalized by its own mean and biased variance, as in torch, but the
    running statistics move by 1 - 0.99 towards the batch mean and the
    biased batch variance (torch would use the unbiased one).

    A bf16 input (mixed precision, where the weights arrive as bf16 copies)
    is normalized in training as Flax does: statistics and arithmetic in
    fp32, the output rounded once to bf16. The running statistics stay fp32
    buffers, but the JAX step casts them to bf16 with the rest of ``aux``
    before Flax updates them, so the update is reproduced with that
    rounding: ``bf16(running) * bf16(0.99) + 0.01 * batch_stat`` in fp32,
    where ``bf16(0.99)`` is 0.98828125 (the weakly typed 0.99 takes bf16).
    Flax's product is a bf16 one, but inside the jitted step XLA keeps it in
    fp32 (excess precision; it is exact there), and the port follows the
    jitted step. Where the running statistics normalize a bf16 input (eval,
    or frozen in training) they are those bf16 copies too, and the copies
    are written back: the JAX step returns its whole bf16 ``aux``, cast to
    fp32, as the new state.

    ``frozen`` (``train.frozen_batch_norm``, set by
    ``set_frozen_batch_norm``): training normalizes with the running
    statistics and leaves them unchanged, as the JAX package's ``_bn_train``
    does (rounded once to bf16 by a mixed-precision step, as above)."""

    def __init__(self, num_features):
        super().__init__(num_features, eps=BN_EPS, momentum=1.0 - FLAX_BN_MOMENTUM)
        self.frozen = False

    def forward(self, x):
        return flax_batch_norm(x, self.running_mean, self.running_var, self.weight,
                               self.bias, self.training and not self.frozen, self.eps)


def set_frozen_batch_norm(module, frozen):
    """Freeze (or unfreeze) the statistics of every BatchNorm under
    @module (see ``BatchNorm2d``)."""
    for m in module.modules():
        if isinstance(m, BatchNorm2d):
            m.frozen = bool(frozen)


class BasicBlock(nn.Module):
    """torchvision BasicBlock: 3x3-BN-ReLU-3x3-BN + skip, final ReLU."""

    JAX_NAMES = {"conv1": "conv1", "bn1": "bn1", "conv2": "conv2", "bn2": "bn2",
                 "down_conv": "downsample.0", "down_bn": "downsample.1"}

    def __init__(self, cin, features, stride=1):
        super().__init__()
        self.conv1 = _conv(cin, features, 3, stride, 1)
        self.bn1 = BatchNorm2d(features)
        self.conv2 = _conv(features, features, 3, 1, 1)
        self.bn2 = BatchNorm2d(features)
        self.downsample = None
        if stride != 1 or cin != features:
            self.downsample = nn.Sequential(
                _conv(cin, features, 1, stride),
                BatchNorm2d(features),
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


class StemConv(nn.Conv2d):
    """The stem's 7x7 convolution, stride 2, padding 3, no bias; stride 4
    with ``pool_free`` (``train.pool_free_stem``), which lands on the pooled
    grid, floor((H - 1) / 4) + 1, with the same parameters."""

    def __init__(self, cin=3):
        super().__init__(cin, 64, 7, stride=2, padding=3, bias=False)
        self.pool_free = False

    def forward(self, x):
        return F.conv2d(x, self.weight, None, 4 if self.pool_free else 2, 3)


class StemMaxPool(nn.Module):
    """The stem's 3x3 / stride-2 / pad-1 max pool. ``recorded_argmax`` False
    (the default, as the JAX stem's ``nn.max_pool``): ``F.max_pool2d``. True
    (``train.pallas_pool``): the recorded-argmax pair of
    ``ops/stem_pool.py``, kernels 3 and 4 when ``use_kernel``, else their
    plain versions; the same values, and on ties the gradient goes to the
    same cell. With ``pool_free`` (``train.pool_free_stem``) there is no
    pool: the stride-4 ``StemConv`` already gives the pooled shape, and no
    kernel launches."""

    def __init__(self):
        super().__init__()
        self.recorded_argmax = False
        self.use_kernel = True
        self.pool_free = False

    def forward(self, x):
        if self.pool_free:
            return x
        if self.recorded_argmax:
            return max_pool_3x3_s2(x, self.use_kernel)
        return F.max_pool2d(x, 3, 2, 1)


def set_stem_pool(module, recorded_argmax, use_kernel=True):
    """Select the pool of every ResNet stem under @module (see
    ``StemMaxPool``)."""
    for m in module.modules():
        if isinstance(m, StemMaxPool):
            m.recorded_argmax = bool(recorded_argmax)
            m.use_kernel = bool(use_kernel)


def set_pool_free_stem(module, pool_free):
    """Make every ResNet stem under @module pool-free (a stride-4
    convolution, no pool) or give it back its pool (see ``StemConv``)."""
    for m in module.modules():
        if isinstance(m, (StemConv, StemMaxPool)):
            m.pool_free = bool(pool_free)


class _ResNet18Stem(nn.Sequential):
    """conv7x7/2 + BN + ReLU + maxpool3x3/2 (torchvision stem); the reference
    names it ``_base_block``."""

    JAX_NAMES = {"conv1": "0", "bn1": "1"}

    def __init__(self, cin=3):
        super().__init__(
            StemConv(cin),
            BatchNorm2d(64),
            nn.ReLU(),
            StemMaxPool(),
        )


# (features, stride) of the eight BasicBlocks of ResNet-18
_RESNET18_PLAN = [(64, 1), (64, 1), (128, 2), (128, 1),
                  (256, 2), (256, 1), (512, 2), (512, 1)]


def _resnet18_output_shape(input_shape):
    h, w, _ = input_shape
    return [int(math.ceil(h / 32.0)), int(math.ceil(w / 32.0)), 512]


class ResNet18Conv(nn.Module):
    """ResNet-18 trunk with the classifier removed. Input [B, 3, H, W]; output
    [B, 512, ceil(H/32), ceil(W/32)]. The reference's layout: ``nets`` holds
    torchvision's children conv1, bn1, relu, maxpool and layer1 to layer4 as
    ``nets.0`` to ``nets.7``."""

    def __init__(self, input_coord_conv=False, pretrained=False):
        super().__init__()
        if input_coord_conv:
            raise NotImplementedError("input_coord_conv is not ported yet")
        blocks, cin = [], 64
        for feat, stride in _RESNET18_PLAN:
            blocks.append(BasicBlock(cin, feat, stride))
            cin = feat
        self.nets = nn.Sequential(
            *_ResNet18Stem(),
            *(nn.Sequential(*blocks[i:i + 2]) for i in range(0, 8, 2)),
        )

    def jax_names(self):
        names = {"stem": {"conv1": "nets.0", "bn1": "nets.1"}}
        for i in range(len(_RESNET18_PLAN)):
            names[f"block{i}"] = f"nets.{4 + i // 2}.{i % 2}"
        return names

    def forward(self, x):
        return self.nets(x)

    output_shape = staticmethod(_resnet18_output_shape)


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

    output_shape = staticmethod(_resnet18_output_shape)


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
        # a bf16 attention meets the fp32 keypoint grid as in JAX: the
        # product promotes, so the keypoints (and what follows) are fp32
        dtype = torch.promote_types(attention.dtype, self.pos.dtype)
        return (attention.to(dtype) @ self.pos.to(dtype)).reshape(b, k, 2)

    @staticmethod
    def static_output_shape(input_shape, num_kp=32):
        return [num_kp if num_kp is not None else input_shape[-1], 2]
