"""Base network blocks (counterpart of the JAX package's ``models/base_nets.py``
:46-64, 122-500, 703-797, 802-865): the MLP, the ResNet trunks (18, 34 and
50, each plain or with FiLM after every block, and ResNet-18 FiLM with the
language cross-attention) with batch or group norm and optional
coord-conv, ShallowConv, SpatialSoftmax (and its learnable temperature,
keypoint noise and variance), SpatialMeanPool, and the recurrent base of
the RNN policies. The pretrained cores (R3M, MVP's ViT) are in
``pretrained_nets.py``.

Images reach the port channels-last ([B, H, W, C]) as in the JAX package;
``VisualCore`` permutes them to contiguous NCHW once, and everything here
runs NCHW. BatchNorm follows Flax's ``nn.BatchNorm`` in training (momentum
0.99, the biased batch variance in the running update), not torch's
defaults. The stem's max pool is ``F.max_pool2d`` unless
``set_stem_pool`` selects the recorded-argmax kernels (``train.pallas_pool``).
Two opt-in training modes are set per model, never process-wide:
``set_frozen_batch_norm`` (``train.frozen_batch_norm``) and
``set_pool_free_stem`` (``train.pool_free_stem``); each reaches every stem
and BatchNorm under the model, in every trunk.
Parameters keep the reference torch layout and key names
(``_base_block``, ``_conv_blocks``, ``_film_layers``, torchvision's
``conv1``/``bn1``/``downsample``; ``nets.0`` ... ``nets.7`` for the plain
trunk), so reference checkpoints map one to one. Under mixed precision the
trunks take bf16 copies of their weights and compute in the type JAX's
promotion gives them: bf16 on a bf16 image, fp32 behind the colour jitter
or the Gaussian noise (see ``BatchNorm2d``, ``GroupNorm`` and
``SpatialSoftmax``); tests/test_torch_bf16_trunks*.py and
tests/test_torch_bf16_cores.py hold each against the JAX module on bf16
casts.

Each module's ``JAX_NAMES`` maps the JAX child names to torch submodule
paths; ``utils/jax_weights.py`` reads it to carry JAX weights across.
"""

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from robot_manipulation_vq_vae_tpu_torch.ops.stem_pool import max_pool_3x3_s2
from robot_manipulation_vq_vae_tpu_torch.utils.draws import global_draw

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
    # bf16 parameters (mixed precision) with a bf16 or an fp32 @x: fp32
    # arithmetic, the output in @x's type
    half = torch.bfloat16 in (x.dtype, weight.dtype)
    if half:
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
    _move_running(running_mean, running_var, mean, var, half)
    return F.batch_norm(x, None, None, weight, bias, True, 0.0, eps)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with Flax's training semantics: the batch is
    normalized by its own mean and biased variance, as in torch, but the
    running statistics move by 1 - 0.99 towards the batch mean and the
    biased batch variance (torch would use the unbiased one).

    A bf16 input (mixed precision, where the weights arrive as bf16 copies)
    is normalized in training as Flax does: statistics and arithmetic in
    fp32, the output rounded once to bf16. An fp32 input on those bf16
    weights (a trunk behind the colour jitter or the Gaussian noise, whose
    fp32 draws lift the image to fp32) is normalized in fp32 and stays
    fp32; its statistics are rounded as below all the same. The running
    statistics stay fp32 buffers, but the JAX step casts them to bf16 with
    the rest of ``aux`` before Flax updates them, so the update is
    reproduced with that rounding: ``bf16(running) * bf16(0.99) + 0.01 *
    batch_stat`` in fp32,
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

    # the data-parallel axis (``parallel.AxisComm``) whose global batch a
    # training forward normalizes by, set by ``parallel.shard_state``
    dp = None

    def __init__(self, num_features):
        super().__init__(num_features, eps=BN_EPS, momentum=1.0 - FLAX_BN_MOMENTUM)
        self.frozen = False

    def forward(self, x):
        use_batch = self.training and not self.frozen
        if use_batch and self.dp is not None:
            return global_batch_norm(x, self.running_mean, self.running_var, self.weight,
                                     self.bias, self.eps, self.dp)
        return flax_batch_norm(x, self.running_mean, self.running_var, self.weight,
                               self.bias, use_batch, self.eps)


def _move_running(running_mean, running_var, mean, var, half):
    """Flax's running update towards the batch @mean / @var, in place: with
    @half (mixed precision) from the bf16 copies of the statistics, as
    ``BatchNorm2d`` describes."""
    with torch.no_grad():
        if half:
            for running, stat in ((running_mean, mean), (running_var, var)):
                running.copy_(running.bfloat16().float() * FLAX_BN_MOMENTUM_BF16
                              + (1.0 - FLAX_BN_MOMENTUM) * stat)
        else:
            running_mean.lerp_(mean, 1.0 - FLAX_BN_MOMENTUM)
            running_var.lerp_(var, 1.0 - FLAX_BN_MOMENTUM)


def global_batch_norm(x, running_mean, running_var, weight, bias, eps, dp):
    """Training BatchNorm over the global batch of a data-parallel step: the
    mean and biased variance of the channels over every rank's equal shard,
    from an all-reduce of their sums and sums of squares (Flax's one-pass
    statistics, E[x^2] - E[x]^2, floored at 0), differentiable across the
    ranks; the running statistics move towards them as in
    ``flax_batch_norm``. Under mixed precision (a bf16 @x or bf16 weights)
    it follows ``flax_batch_norm``'s bf16 path: the sums in fp32, the
    running update from the statistics' bf16 copies, the fp32 arithmetic
    on the bf16-rounded weights and the output rounded once to @x's
    type."""
    half = torch.bfloat16 in (x.dtype, weight.dtype)
    xf = x.float() if half else x
    n = x.numel() // x.shape[1] * dp.size
    stats = dp.sum(torch.cat([xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3))])) / n
    mean, mean2 = stats.chunk(2)
    var = (mean2 - mean * mean).clamp_min(0.0)
    _move_running(running_mean, running_var, mean, var, half)
    if half:
        weight, bias = weight.float(), bias.float()
    scale = torch.rsqrt(var + eps) * weight
    y = (xf - mean[None, :, None, None]) * scale[None, :, None, None] + bias[None, :, None, None]
    return y.to(x.dtype)


def set_frozen_batch_norm(module, frozen):
    """Freeze (or unfreeze) the statistics of every BatchNorm under
    @module (see ``BatchNorm2d``)."""
    for m in module.modules():
        if isinstance(m, BatchNorm2d):
            m.frozen = bool(frozen)


class GroupNorm(nn.GroupNorm):
    """The trunks' ``norm="group"`` (JAX ``_trunk_norm``): GroupNorm of
    C // 16 groups, eps 1e-5, as the reference diffusion policy's
    ``replace_bn_with_gn``. Stateless, so ``set_frozen_batch_norm`` leaves
    it alone. (Flax takes the variance as E[x^2] - E[x]^2, torch as the mean
    of squared deviations: equal in float64, a rounding apart in float32.)

    Under mixed precision Flax takes a bf16 input's mean and variance in
    fp32 and forms (x - mean) * rsqrt(var + eps) * scale + bias in fp32 with
    the bf16-rounded scale and bias, then rounds once to bf16. torch's
    ``group_norm`` does the same on a bf16 input with bf16 weights, on the
    CPU (its bf16 kernel accumulates and normalizes in fp32) and on CUDA
    (the scale and shift are formed in fp32, the output rounded once): the
    two differ by where fp32 rounds, not by a bf16 step. An fp32 input on
    bf16 weights computes in fp32 (``JaxPromotion`` lifts the weights)."""

    def __init__(self, channels):
        super().__init__(channels // 16, channels, eps=BN_EPS)


def trunk_norm(channels, norm):
    """The normalization layer of a trunk: ``"batch"`` (Flax-semantics
    BatchNorm) or ``"group"``."""
    if norm == "group":
        return GroupNorm(channels)
    if norm != "batch":
        raise ValueError(f"norm {norm} is neither batch nor group")
    return BatchNorm2d(channels)


def add_coord_channels(x):
    """CoordConv (JAX ``add_coord_channels``): NCHW @x with two channels
    appended after its own, y then x, each a ``linspace(-1, 1)`` over its
    axis, taken in at least fp32 and cast to @x's type (a bf16 image gets
    bf16 coordinates, as JAX's ``astype(x.dtype)`` gives them)."""
    n, _, h, w = x.shape
    dtype = torch.promote_types(x.dtype, torch.float32)
    ys = torch.linspace(-1.0, 1.0, h, dtype=dtype, device=x.device)
    xs = torch.linspace(-1.0, 1.0, w, dtype=dtype, device=x.device)
    coords = torch.stack([ys[:, None].expand(h, w), xs[None, :].expand(h, w)]).to(x.dtype)
    return torch.cat([x, coords.expand(n, 2, h, w)], dim=1)


class _Block(nn.Module):
    """A residual block in torchvision's layout (``conv1``, ``bn1``, ...,
    ``downsample.0`` / ``.1`` where the skip needs a projection)."""

    JAX_NAMES = {"conv1": "conv1", "bn1": "bn1", "conv2": "conv2", "bn2": "bn2",
                 "down_conv": "downsample.0", "down_bn": "downsample.1"}

    def jax_names(self):
        if self.downsample is None:
            return {k: v for k, v in self.JAX_NAMES.items()
                    if not v.startswith("downsample")}
        return self.JAX_NAMES


class BasicBlock(_Block):
    """torchvision BasicBlock: 3x3-norm-ReLU-3x3-norm + skip, final ReLU."""

    expansion = 1

    def __init__(self, cin, features, stride=1, norm="batch"):
        super().__init__()
        self.conv1 = _conv(cin, features, 3, stride, 1)
        self.bn1 = trunk_norm(features, norm)
        self.conv2 = _conv(features, features, 3, 1, 1)
        self.bn2 = trunk_norm(features, norm)
        self.downsample = _downsample(cin, features, stride, norm)

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(h + identity)


class Bottleneck(_Block):
    """torchvision Bottleneck (JAX ``Bottleneck``): 1x1 -> 3x3 (the stride)
    -> 1x1 to 4 x @features, each normalized, + skip, final ReLU."""

    JAX_NAMES = {**_Block.JAX_NAMES, "conv3": "conv3", "bn3": "bn3"}
    expansion = 4

    def __init__(self, cin, features, stride=1, norm="batch"):
        super().__init__()
        out = features * self.expansion
        self.conv1 = _conv(cin, features, 1)
        self.bn1 = trunk_norm(features, norm)
        self.conv2 = _conv(features, features, 3, stride, 1)
        self.bn2 = trunk_norm(features, norm)
        self.conv3 = _conv(features, out, 1)
        self.bn3 = trunk_norm(out, norm)
        self.downsample = _downsample(cin, out, stride, norm)

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(h + identity)


def _downsample(cin, cout, stride, norm):
    if stride == 1 and cin == cout:
        return None
    return nn.Sequential(_conv(cin, cout, 1, stride), trunk_norm(cout, norm))


class StemConv(nn.Conv2d):
    """The stem's 7x7 convolution, stride 2, padding 3, no bias; stride 4
    with ``pool_free`` (``train.pool_free_stem``), which lands on the pooled
    grid, floor((H - 1) / 4) + 1, with the same parameters. With
    @coord_conv (``input_coord_conv``) it takes the image's channels and
    the two of ``add_coord_channels``."""

    def __init__(self, cin=3, coord_conv=False):
        super().__init__(cin + 2 * coord_conv, 64, 7, stride=2, padding=3, bias=False)
        self.coord_conv = coord_conv
        self.pool_free = False

    def forward(self, x):
        if self.coord_conv:
            x = add_coord_channels(x)
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
    """conv7x7/2 + norm + ReLU + maxpool3x3/2 (torchvision stem), the stem of
    every ResNet trunk; the reference names it ``_base_block``."""

    JAX_NAMES = {"conv1": "0", "bn1": "1"}

    def __init__(self, cin=3, coord_conv=False, norm="batch"):
        super().__init__(
            StemConv(cin, coord_conv),
            trunk_norm(64, norm),
            nn.ReLU(),
            StemMaxPool(),
        )


def _resnet_plan(blocks_per_stage):
    """(features, stride) of each block, stage by stage (JAX
    ``_resnet_plan``): the first block of stages 2-4 strides 2."""
    return [(feat, 2 if stage > 0 and b == 0 else 1)
            for stage, (feat, n) in enumerate(zip((64, 128, 256, 512), blocks_per_stage))
            for b in range(n)]


_RESNET18_STAGES, _RESNET34_STAGES = (2, 2, 2, 2), (3, 4, 6, 3)


class _ResNetTrunk(nn.Module):
    """A ResNet trunk with the classifier removed: the stem, then the
    ``STAGES`` blocks of class ``BLOCK``. Input [B, 3, H, W]; output
    [B, 512 x expansion, ceil(H/32), ceil(W/32)]. ``norm`` "group" puts
    ``GroupNorm`` where BatchNorm was; ``input_coord_conv`` appends the
    coordinate channels before the stem's convolution. Subclasses lay the
    layers out (see ``_ResNetConv`` and ``_ResNetConvFiLM``)."""

    STAGES = _RESNET18_STAGES
    BLOCK = BasicBlock

    def _blocks(self, norm):
        blocks, cin = [], 64
        for feat, stride in _resnet_plan(self.STAGES):
            blocks.append(self.BLOCK(cin, feat, stride, norm))
            cin = feat * self.BLOCK.expansion
        return blocks

    @classmethod
    def output_shape(cls, input_shape):
        h, w, _ = input_shape
        return [int(math.ceil(h / 32.0)), int(math.ceil(w / 32.0)),
                512 * cls.BLOCK.expansion]


class _ResNetConv(_ResNetTrunk):
    """The reference's layout: ``nets`` holds torchvision's children conv1,
    bn1, relu, maxpool and layer1 to layer4 as ``nets.0`` to ``nets.7``."""

    def __init__(self, input_coord_conv=False, pretrained=False, norm="batch"):
        super().__init__()
        blocks, layers, i = self._blocks(norm), [], 0
        for n in self.STAGES:
            layers.append(nn.Sequential(*blocks[i:i + n]))
            i += n
        self.nets = nn.Sequential(
            *_ResNet18Stem(coord_conv=input_coord_conv, norm=norm), *layers)

    def jax_names(self):
        names = {"stem": {"conv1": "nets.0", "bn1": "nets.1"}}
        i = 0
        for stage, n in enumerate(self.STAGES):
            for j in range(n):
                names[f"block{i}"] = f"nets.{4 + stage}.{j}"
                i += 1
        return names

    def forward(self, x):
        return self.nets(x)


class ResNet18Conv(_ResNetConv):
    """ResNet-18 trunk (JAX ``ResNet18Conv``)."""


class ResNet34Conv(_ResNetConv):
    """ResNet-34 trunk (JAX ``ResNet34Conv``)."""

    STAGES = _RESNET34_STAGES


class ResNet50Conv(_ResNetConv):
    """ResNet-50 trunk of Bottlenecks, 2048 output channels (JAX
    ``ResNet50Conv``; also MCR's encoder)."""

    STAGES = _RESNET34_STAGES
    BLOCK = Bottleneck


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


class _ResNetConvFiLM(_ResNetTrunk):
    """A trunk with a FiLM layer after every block, each as wide as its
    block's output; the reference's layout ``_base_block`` (the stem),
    ``_conv_blocks``, ``_film_layers``."""

    def __init__(self, lang_emb_dim=768, input_coord_conv=False, pretrained=False,
                 norm="batch"):
        super().__init__()
        self._base_block = _ResNet18Stem(coord_conv=input_coord_conv, norm=norm)
        self._conv_blocks = nn.ModuleList(self._blocks(norm))
        self._film_layers = nn.ModuleList([
            FiLMLayer(feat * self.BLOCK.expansion, lang_emb_dim)
            for feat, _ in _resnet_plan(self.STAGES)])

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


class ResNet18ConvFiLM(_ResNetConvFiLM):
    """ResNet-18 with FiLM after every BasicBlock (JAX ``ResNet18ConvFiLM``)."""


class ResNet34ConvFiLM(_ResNetConvFiLM):
    """ResNet-34 with FiLM after every BasicBlock (JAX ``ResNet34ConvFiLM``)."""

    STAGES = _RESNET34_STAGES


class ResNet50ConvFiLM(_ResNetConvFiLM):
    """ResNet-50 with FiLM after every Bottleneck, 4 x the block's width
    (JAX ``ResNet50ConvFiLM``)."""

    STAGES = _RESNET34_STAGES
    BLOCK = Bottleneck


class ResNet18ConvFiLMCrossAttn(_ResNetConvFiLM):
    """ResNet-18 FiLM trunk, then the spatial tokens attend to the language
    embedding (JAX ``ResNet18ConvFiLMCrossAttn``): tokens + attn_out(softmax(
    q k^T / sqrt(C)) v), with k and v from the one token lang_kv(lang). A
    softmax over one key is exactly 1, so the attended value is v for every
    token and computed so; ``q`` and ``k`` are kept (and carried from JAX)
    but get zero gradients, as they do in JAX (@num_heads is unused there
    too)."""

    JAX_NAMES = {n: n for n in ("lang_kv", "q", "k", "v", "attn_out")}

    def __init__(self, lang_emb_dim=768, input_coord_conv=False, pretrained=False,
                 num_heads=8, norm="batch"):
        super().__init__(lang_emb_dim, input_coord_conv, pretrained, norm)
        c = 512
        self.lang_kv = nn.Linear(lang_emb_dim, c)
        for name in ("q", "k", "v", "attn_out"):
            self.add_module(name, nn.Linear(c, c))

    def jax_names(self):
        return {**super().jax_names(), **self.JAX_NAMES}

    def forward(self, x, lang_emb):
        x = super().forward(x, lang_emb)
        attended = self.attn_out(self.v(self.lang_kv(lang_emb)))
        return x + attended[:, :, None, None]


class ShallowConv(nn.Module):
    """The DSAE paper's shallow encoder (JAX ``ShallowConv``): conv 7x7/2 (64)
    - ReLU - conv 1x1 (32) - ReLU - conv 3x3 (32) - ReLU - conv 3x3
    (@output_channel), all with biases, in the reference's ``nets.0`` ...
    ``nets.6`` (Flax's ``Conv_0`` ... ``Conv_3``). Output [B, C, H/2, W/2]."""

    JAX_NAMES = {f"Conv_{i}": f"nets.{2 * i}" for i in range(4)}

    def __init__(self, input_channel=3, output_channel=32):
        super().__init__()
        self.input_channel, self.output_channel = input_channel, output_channel
        self.nets = nn.Sequential(
            _conv(input_channel, 64, 7, 2, 3, bias=True), nn.ReLU(),
            _conv(64, 32, 1, bias=True), nn.ReLU(),
            _conv(32, 32, 3, 1, 1, bias=True), nn.ReLU(),
            _conv(32, output_channel, 3, 1, 1, bias=True),
        )

    def forward(self, x):
        if x.shape[1] != self.input_channel:
            raise ValueError(f"ShallowConv takes {self.input_channel} channels, "
                             f"got {x.shape[1]}")
        return self.nets(x)

    def output_shape(self, input_shape):
        if len(input_shape) != 3 or input_shape[-1] != self.input_channel:
            raise ValueError(f"ShallowConv cannot take {input_shape}")
        return [input_shape[0] // 2, input_shape[1] // 2, self.output_channel]


class SpatialSoftmax(nn.Module):
    """Spatial-softmax keypoint pooling: [B, C, H, W] -> keypoints [B, K, 2].
    The softmax runs over the h-major flattened H*W positions, the order of
    the JAX package's [B, H, W, K] -> [B, K, H*W] transpose.

    ``learnable_temperature``: the temperature is a parameter of shape (1,).
    ``noise_std`` > 0: in training, ``noise_std`` x N(0, 1) is added to the
    keypoints, drawn from the caller's @generator (JAX draws it from its
    ``dropout`` stream) at the global batch's shape under data parallelism
    (``dp``, ``utils.draws.global_draw``), or given as @noise; never in eval.
    ``output_variance``: returns (keypoints, cov [B, K, 2, 2])."""

    JAX_NAMES = {"kp_conv": "nets"}
    # the data-parallel axis (``Algo.set_data_parallel``)
    dp = None

    def __init__(self, input_shape, num_kp=32, temperature=1.0,
                 learnable_temperature=False, output_variance=False,
                 noise_std=0.0):
        super().__init__()
        h, w, c = input_shape
        self.num_kp = num_kp if num_kp is not None else c
        self.nets = nn.Conv2d(c, num_kp, 1) if num_kp is not None else None
        if learnable_temperature:
            self.temperature = nn.Parameter(torch.full((1,), float(temperature)))
            self.JAX_PARAMS = ("temperature",)
        else:
            self.temperature = temperature
        self.output_variance = output_variance
        self.noise_std = noise_std
        pos_x, pos_y = np.meshgrid(np.linspace(-1.0, 1.0, w), np.linspace(-1.0, 1.0, h))
        self.register_buffer(
            "pos", torch.tensor(np.stack([pos_x.reshape(-1), pos_y.reshape(-1)], -1),
                                dtype=torch.float32),
            persistent=False,
        )

    def forward(self, feature, generator=None, noise=None):
        if self.nets is not None:
            feature = self.nets(feature)
        b, k, h, w = feature.shape
        attention = torch.softmax(feature.reshape(b * k, h * w) / self.temperature, -1)
        # a bf16 attention meets the fp32 keypoint grid as in JAX: the
        # product promotes, so the keypoints (and what follows) are fp32
        dtype = torch.promote_types(attention.dtype, self.pos.dtype)
        attention, pos = attention.to(dtype), self.pos.to(dtype)
        mean = attention @ pos                                   # [B*K, 2]
        keypoints = mean.reshape(b, k, 2)
        if self.training and self.noise_std > 0:
            if noise is None:
                if generator is None:
                    raise ValueError("SpatialSoftmax's noise needs a generator in training")
                noise = global_draw(
                    lambda shape: torch.randn(shape, generator=generator,
                                              device=generator.device, dtype=dtype),
                    keypoints.shape, self.dp)
            keypoints = keypoints + self.noise_std * noise.to(keypoints.device, dtype)
        if not self.output_variance:
            return keypoints
        # the squares and product of the fp32 grid are fp32, as JAX's are
        px, py = self.pos.float().unbind(-1)
        second = attention @ torch.stack([px * px, px * py, py * py], -1).to(dtype)
        ex, ey = mean[:, 0], mean[:, 1]
        var_x, var_xy, var_y = (second[:, 0] - ex * ex, second[:, 1] - ex * ey,
                                second[:, 2] - ey * ey)
        cov = torch.stack([var_x, var_xy, var_xy, var_y], -1).reshape(b, k, 2, 2)
        return keypoints, cov

    @staticmethod
    def static_output_shape(input_shape, num_kp=32):
        return [num_kp if num_kp is not None else input_shape[-1], 2]


class SpatialMeanPool(nn.Module):
    """The mean over the spatial dims (JAX ``SpatialMeanPool``):
    [B, C, H, W] -> [B, C]."""

    def __init__(self, input_shape=None):
        super().__init__()

    def forward(self, x, generator=None):
        return x.mean(dim=(-2, -1))

    @staticmethod
    def static_output_shape(input_shape):
        return [input_shape[-1]]


class Dropout(nn.Module):
    """Dropout with Flax's semantics and an explicit draw: in training each
    element is kept with probability 1 - p and scaled by 1 / (1 - p). The
    keep mask is drawn from ``generator`` (``Algo`` hands every Dropout of
    its networks its own generator; without one, the global generator) at
    the global batch's shape under data parallelism (``dp``,
    ``utils.draws.global_draw``), so that the ranks together draw the
    unsharded step's mask. @shape and @index draw the mask at @shape and
    apply its [@index] (the GPT's attention under mp: every head's mask,
    this rank's heads applied). With @whole the input is the same whole
    tensor on every rank (the default action encoder's global sequence), so
    the mask is drawn at its own shape whatever ``dp``."""

    dp = None

    def __init__(self, p=0.1, whole=False):
        super().__init__()
        self.p = float(p)
        self.whole = whole
        self.generator = None

    def extra_repr(self):
        return f"p={self.p}"

    def forward(self, x, shape=None, index=None):
        if not self.training or self.p == 0.0:
            return x
        gen = self.generator
        device = x.device if gen is None else gen.device
        keep = global_draw(
            lambda s: torch.rand(s, generator=gen, device=device) < 1.0 - self.p,
            x.shape if shape is None else shape, None if self.whole else self.dp)
        if index is not None:
            keep = keep[index]
        return _dropped(x, keep, self.p)


def _dropped(x, keep, p):
    """@x where @keep, scaled by 1 / (1 - @p); 0 elsewhere."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.where(keep.to(x.device), x / (1.0 - p), zero)


class MLP(nn.Module):
    """Linear layers of @layer_dims, each followed by @activation (and by
    dropout where @dropouts gives one), then a Linear to @output_dim and the
    optional @output_activation (JAX ``MLP``). The layers form the
    reference's ``_model`` Sequential, so without dropout its Linear layers
    sit at ``_model.0``, ``_model.2``, ... Biases start at 0, as Flax's."""

    def __init__(self, input_dim, output_dim, layer_dims=(), activation=nn.ReLU,
                 output_activation=None, dropouts=None):
        super().__init__()
        layers, names, dim = [], {}, input_dim
        for i, width in enumerate(layer_dims):
            names[f"fc{i}"] = f"_model.{len(layers)}"
            layers += [nn.Linear(dim, width), activation()]
            if dropouts is not None and dropouts[i] > 0:
                layers.append(Dropout(dropouts[i]))
            dim = width
        names["out"] = f"_model.{len(layers)}"
        layers.append(nn.Linear(dim, output_dim))
        if output_activation is not None:
            layers.append(output_activation())
        for layer in layers:
            if isinstance(layer, nn.Linear):
                nn.init.zeros_(layer.bias)
        self._model = nn.Sequential(*layers)
        self.JAX_NAMES = names
        self.output_dim = output_dim

    def forward(self, x):
        return self._model(x)


class FlaxGRUCell(nn.Module):
    """A GRU cell in Flax's ``nn.GRUCell`` layout: input projections ``ir``,
    ``iz``, ``in`` with biases, hidden projections ``hr``, ``hz`` without and
    ``hn`` with one. (``nn.GRU`` has all six biases, and Adam would move the
    two that Flax lacks.)"""

    JAX_NAMES = {n: n for n in ("ir", "iz", "in", "hr", "hz", "hn")}

    def __init__(self, input_dim, hidden_dim):
        super().__init__()
        for name in ("ir", "iz", "in"):
            self.add_module(name, nn.Linear(input_dim, hidden_dim))
        for name in ("hr", "hz", "hn"):
            self.add_module(name, nn.Linear(hidden_dim, hidden_dim, bias=name == "hn"))

    def forward(self, x, h):
        m = self._modules
        r = torch.sigmoid(m["ir"](x) + m["hr"](h))
        z = torch.sigmoid(m["iz"](x) + m["hz"](h))
        n = torch.tanh(m["in"](x) + r * m["hn"](h))
        return (1.0 - z) * n + z * h


class RNNBase(nn.Module):
    """A multi-layer LSTM or GRU over [B, T, D] sequences (JAX ``RNNBase``):
    returns the last layer's outputs [B, T, H] and the carries, per layer in
    JAX's form, (c, h) for the LSTM and h for the GRU; ``initial_state``
    takes the same form (None: zeros).

    The LSTM is ``nn.LSTM`` (cuDNN on the card). Its stacked
    ``weight_ih_l{k}`` / ``weight_hh_l{k}`` / ``bias_ih_l{k}`` /
    ``bias_hh_l{k}``, gates in i, f, g, o order, hold the eight denses of
    JAX's ``TorchLSTMCell`` (``ii``, ``if``, ``ig``, ``io`` and ``hi``,
    ``hf``, ``hg``, ``ho``), both biases kept as the JAX cell keeps them, so
    that Adam moves each as torch's does. The GRU is a loop over T of
    ``FlaxGRUCell``s (``cells.{k}``)."""

    def __init__(self, input_dim, hidden_dim, num_layers=2, rnn_type="LSTM"):
        super().__init__()
        if rnn_type not in ("LSTM", "GRU"):
            raise ValueError(f"rnn_type {rnn_type} is neither LSTM nor GRU")
        self.rnn_type = rnn_type
        self.hidden_dim = hidden_dim
        self.num_layers = num_layers
        if rnn_type == "LSTM":
            self.nets = nn.LSTM(input_dim, hidden_dim, num_layers, batch_first=True)
        else:
            self.cells = nn.ModuleList([
                FlaxGRUCell(input_dim if k == 0 else hidden_dim, hidden_dim)
                for k in range(num_layers)
            ])

    def jax_names(self):
        if self.rnn_type == "GRU":
            return {f"gru{k}": f"cells.{k}" for k in range(self.num_layers)}
        return {}

    def jax_stacked(self):
        """{torch tensor: (JAX leaves, in stacking order; their stacking)}:
        each of the LSTM's stacked tensors from its four gate denses."""
        if self.rnn_type != "LSTM":
            return {}
        weights = lambda arrays: np.concatenate([a.T for a in arrays], 0)  # noqa: E731
        biases = lambda arrays: np.concatenate(arrays, 0)  # noqa: E731
        out = {}
        for k in range(self.num_layers):
            for side, name in (("i", "ih"), ("h", "hh")):
                denses = [f"lstm{k}/{side}{gate}" for gate in "ifgo"]
                out[f"nets.weight_{name}_l{k}"] = ([f"{d}/kernel" for d in denses], weights)
                out[f"nets.bias_{name}_l{k}"] = ([f"{d}/bias" for d in denses], biases)
        return out

    def forward(self, x, initial_state=None):
        if self.rnn_type == "LSTM":
            hx = None
            if initial_state is not None:
                hx = (torch.stack([h for _, h in initial_state]),
                      torch.stack([c for c, _ in initial_state]))
            out, (h_n, c_n) = self.nets(x, hx)
            return out, [(c_n[k], h_n[k]) for k in range(self.num_layers)]
        carries = []
        for k, cell in enumerate(self.cells):
            h = (x.new_zeros(x.shape[0], self.hidden_dim) if initial_state is None
                 else initial_state[k])
            steps = []
            for t in range(x.shape[1]):
                h = cell(x[:, t], h)
                steps.append(h)
            x = torch.stack(steps, dim=1)
            carries.append(h)
        return x, carries
