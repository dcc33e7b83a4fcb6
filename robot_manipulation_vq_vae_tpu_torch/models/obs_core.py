"""Encoder cores and observation randomizers (counterpart of the JAX package's
``models/obs_core.py``): ``VisualCore`` on any of the JAX package's
backbones (``_BACKBONE_CLASSES``) with a SpatialSoftmax, a SpatialMeanPool
or no pool, ``VisualCoreLanguageConditioned`` (the FiLM backbones),
``ScanCore``, and the randomizers ``CropRandomizer`` (random crops in
training, the center crop in eval), ``ColorRandomizer`` and
``GaussianNoiseRandomizer``. Images are channels-last at the public
functions.

Each randomizer draws what it needs from the caller's ``torch.Generator``
in ``draw`` and applies it with a function of its draws (``crop_at``,
``color_jitter``, ``add_noise``), so that a test can hand the JAX package
the same draws.
"""

import inspect
import itertools
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from robot_manipulation_vq_vae_tpu_torch.models import base_nets as BaseNets
from robot_manipulation_vq_vae_tpu_torch.models import pretrained_nets as PretrainedNets
from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils as ObsUtils
from robot_manipulation_vq_vae_tpu_torch.utils.draws import global_draw

_POOL_CLASSES = {
    "SpatialSoftmax": BaseNets.SpatialSoftmax,
    "SpatialMeanPool": BaseNets.SpatialMeanPool,
}

_BACKBONE_CLASSES = {
    "ShallowConv": BaseNets.ShallowConv,
    "ResNet18Conv": BaseNets.ResNet18Conv,
    "ResNet18ConvFiLM": BaseNets.ResNet18ConvFiLM,
    "ResNet34Conv": BaseNets.ResNet34Conv,
    "ResNet34ConvFiLM": BaseNets.ResNet34ConvFiLM,
    "ResNet50Conv": BaseNets.ResNet50Conv,
    "ResNet50ConvFiLM": BaseNets.ResNet50ConvFiLM,
    "ResNet18ConvFiLMCrossAttn": BaseNets.ResNet18ConvFiLMCrossAttn,
    "R3MConv": PretrainedNets.R3MConv,
    "MVPConv": PretrainedNets.MVPConv,
}

# backbones that take a language embedding
_FILM_BACKBONES = {
    "ResNet18ConvFiLM", "ResNet34ConvFiLM", "ResNet50ConvFiLM",
    "ResNet18ConvFiLMCrossAttn",
}


def _filter_kwargs(cls, kwargs):
    """The entries of @kwargs that @cls's constructor, or a base class's
    that it passes them on to, takes by name (JAX's ``_filter_kwargs``
    keeps a Flax module's fields, its bases' included)."""
    allowed = set()
    for base in cls.__mro__:
        if base in (nn.Module, object) or "__init__" not in vars(base):
            continue
        allowed.update(name for name, p in inspect.signature(base.__init__).parameters.items()
                       if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD))
    return {k: v for k, v in (kwargs or {}).items() if k in allowed}


@ObsUtils.register_encoder_core
class VisualCore(nn.Module):
    """Backbone -> pool -> flatten -> linear (JAX ``VisualCore``). Input
    [B, H, W, C] with input_shape (H, W, C). ``pool_class`` None keeps the
    backbone's features, channels-last as JAX's; ``flatten`` makes them
    [B, -1]; ``feature_dimension`` (None: no projection) projects the flat
    features. A SpatialSoftmax with ``output_variance`` returns a tuple,
    which JAX's core cannot flatten: with ``flatten`` the port refuses it
    here."""

    JAX_NAMES = {"backbone": "backbone", "pool": "pool", "proj": "proj"}

    def __init__(self, input_shape, backbone_class="ResNet18Conv",
                 pool_class="SpatialSoftmax", backbone_kwargs=None,
                 pool_kwargs=None, flatten=True, feature_dimension=64,
                 lang_emb_dim=None):
        super().__init__()
        bcls = _BACKBONE_CLASSES[backbone_class]
        bkw = _filter_kwargs(bcls, backbone_kwargs)
        self.film = backbone_class in _FILM_BACKBONES
        if self.film:
            bkw["lang_emb_dim"] = lang_emb_dim
        self.backbone = bcls(**bkw)
        shape = list(self.backbone.output_shape(tuple(input_shape)))
        self.pool = None
        if pool_class is not None:
            pcls = _POOL_CLASSES[pool_class]
            pkw = _filter_kwargs(pcls, pool_kwargs)
            pkw.pop("input_shape", None)
            if pkw.get("output_variance") and flatten:
                raise ValueError("a VisualCore cannot flatten SpatialSoftmax's "
                                 "(keypoints, variance) pair (neither can JAX's)")
            self.pool = pcls(input_shape=shape, **pkw)
            shape = (pcls.static_output_shape(shape, pkw.get("num_kp", 32))
                     if pcls is BaseNets.SpatialSoftmax else pcls.static_output_shape(shape))
        self.flatten = flatten
        if flatten:
            shape = [int(np.prod(shape))]
        self.proj = None
        if feature_dimension is not None:
            if not flatten:
                raise ValueError("feature_dimension needs flatten")
            self.proj = nn.Linear(shape[0], feature_dimension)
            shape = [feature_dimension]
        self._output_shape = shape

    def jax_names(self):
        return {k: v for k, v in self.JAX_NAMES.items() if getattr(self, v) is not None}

    def output_shape(self, input_shape=None):
        return list(self._output_shape)

    def forward(self, x, lang_emb=None, generator=None):
        # contiguous NCHW: the trunk, and the stem pool's kernel, run NCHW
        x = x.permute(0, 3, 1, 2).contiguous()
        if self.film:
            if lang_emb is None:
                raise ValueError("a FiLM backbone needs lang_emb")
            x = self.backbone(x, lang_emb)
        else:
            x = self.backbone(x)
        return self.head(x, generator)

    def head(self, features, generator=None):
        """The core past its backbone: pool -> flatten -> linear, on the
        backbone's features (NCHW, or [B, D] from MVP); @generator draws
        SpatialSoftmax's keypoint noise in training."""
        if self.pool is not None:
            x = self.pool(features, generator)
        elif features.dim() == 4:
            x = features.permute(0, 2, 3, 1)   # channels-last, as JAX flattens
        else:
            x = features
        if self.flatten:
            x = x.reshape(x.shape[0], -1)
        return x if self.proj is None else self.proj(x)


@ObsUtils.register_encoder_core
class VisualCoreLanguageConditioned(VisualCore):
    """VisualCore whose backbone is FiLM-conditioned on a language embedding."""

    def __init__(self, input_shape, backbone_class="ResNet18ConvFiLM", **kwargs):
        super().__init__(input_shape, backbone_class=backbone_class, **kwargs)


@ObsUtils.register_encoder_core
class ScanCore(nn.Module):
    """A Conv1d ladder -> flatten -> linear (JAX ``ScanCore``) over a scan
    [B, L], [B, L, C] or the reference's [B, 1, L]. ``conv_kwargs`` gives
    ``out_channels``, ``kernel_size`` and ``stride`` (defaults (32, 64,
    64), (8, 4, 2), (4, 2, 1)), unpadded, each followed by a ReLU when
    ``conv_activation`` is "relu". Features flatten length-major
    (channels-last, as JAX's). ``pool_class`` / ``pool_kwargs`` are
    accepted and unused, as in JAX."""

    DEFAULT_CHANNELS = (32, 64, 64)
    DEFAULT_KERNELS = (8, 4, 2)
    DEFAULT_STRIDES = (4, 2, 1)

    def __init__(self, input_shape, conv_kwargs=None, conv_activation="relu",
                 pool_class=None, pool_kwargs=None, flatten=True,
                 feature_dimension=None):
        super().__init__()
        kw = dict(conv_kwargs or {})
        chans = kw.get("out_channels", self.DEFAULT_CHANNELS)
        kernels = kw.get("kernel_size", self.DEFAULT_KERNELS)
        strides = kw.get("stride", self.DEFAULT_STRIDES)
        input_shape = tuple(input_shape)
        ref_layout = len(input_shape) == 2 and input_shape[0] == 1 and input_shape[1] != 1
        length = input_shape[-1] if input_shape[0] == 1 else input_shape[0]
        cin = 1 if len(input_shape) == 1 or ref_layout else input_shape[-1]
        convs = []
        for c, k, s in zip(chans, kernels, strides):
            convs.append(nn.Conv1d(cin, c, k, stride=s))
            cin, length = c, (length - k) // s + 1
        self.convs = nn.ModuleList(convs)
        self.relu = conv_activation == "relu"
        self.flatten = flatten
        shape = [length * cin] if flatten else [length, cin]
        self.proj = None
        if feature_dimension is not None:
            self.proj = nn.Linear(shape[-1], feature_dimension)
            shape = [feature_dimension]
        self._output_shape = shape

    def jax_names(self):
        names = {f"conv{i}": f"convs.{i}" for i in range(len(self.convs))}
        if self.proj is not None:
            names["proj"] = "proj"
        return names

    def output_shape(self, input_shape=None):
        return list(self._output_shape)

    def forward(self, x, generator=None):
        if x.dim() == 2:
            x = x[:, None, :]                 # [B, 1, L]
        elif x.shape[-2] == 1 and x.shape[-1] != 1:
            pass                              # the reference's [B, 1, L]
        else:
            x = x.transpose(1, 2)             # [B, L, C] -> [B, C, L]
        for conv in self.convs:
            x = conv(x)
            if self.relu:
                x = F.relu(x)
        x = x.transpose(1, 2)                 # [B, L', C'], as JAX's
        if self.flatten:
            x = x.reshape(x.shape[0], -1)
        return x if self.proj is None else self.proj(x)


# ---------------------------------------------------------------------------
# randomizers: forward_in before the core, forward_out after it
# ---------------------------------------------------------------------------

class Randomizer:
    """An augmentation around an encoder core (JAX ``Randomizer``):
    ``forward_in`` before the core (may expand B -> B * N in training),
    ``forward_out`` after it (the mean over the N samples). Under data
    parallelism (``dp``, which ``Algo.set_data_parallel`` hands over) a
    ``draw`` is taken at the global batch's shape and the rank keeps its
    rows (``utils.draws.global_draw``)."""

    num_samples = 1
    dp = None

    def output_shape_in(self, input_shape=None):
        return list(self.input_shape if input_shape is None else input_shape)

    def output_shape_out(self, input_shape):
        return list(input_shape)

    def forward_out(self, x):
        if x.shape[0] % self.num_samples != 0:
            return x
        b = x.shape[0] // self.num_samples
        return x.reshape((b, self.num_samples) + tuple(x.shape[1:])).mean(1)


def crop_at(images, hy, wx, crop_h, crop_w):
    """Crops of @images [B, H, W, C] at the top-left corners (@hy, @wx), each
    [B, N] int: [B, N, crop_h, crop_w, C], one batched gather. The offsets
    are an argument so that a test can give the JAX package's
    ``random_crop_hwc`` the same ones."""
    b = images.shape[0]
    rows = hy[..., None] + torch.arange(crop_h, device=images.device)   # [B, N, h]
    cols = wx[..., None] + torch.arange(crop_w, device=images.device)   # [B, N, w]
    batch = torch.arange(b, device=images.device)[:, None, None, None]
    return images[batch, rows[..., :, None], cols[..., None, :]]


@ObsUtils.register_randomizer
class CropRandomizer(Randomizer):
    """Crops of the image, pooled back after the core: in training @num_crops
    random crops per image, their top-left corners drawn uniformly from
    [0, H - crop_h] x [0, W - crop_w] with the caller's ``torch.Generator``;
    in eval the center crop. input_shape is (H, W, C)."""

    def __init__(self, input_shape, crop_height=76, crop_width=76, num_crops=1,
                 pos_enc=False):
        if len(input_shape) != 3 or not (
                crop_height < input_shape[0] and crop_width < input_shape[1]):
            raise ValueError(
                f"crop {crop_height}x{crop_width} does not fit {input_shape}"
            )
        if pos_enc:
            raise NotImplementedError("pos_enc is not supported")
        self.input_shape = tuple(input_shape)
        self.crop_height = crop_height
        self.crop_width = crop_width
        self.num_crops = self.num_samples = num_crops

    def output_shape_in(self, input_shape=None):
        return [self.crop_height, self.crop_width, self.input_shape[2]]

    def draw(self, x, generator):
        """The crops' top-left corners (hy, wx), each [B, num_crops]."""
        b, h, w = x.shape[:3]

        def corners(high):
            return global_draw(lambda shape: torch.randint(
                0, high, shape, generator=generator, device=generator.device),
                (b, self.num_crops), self.dp).to(x.device)

        return corners(h - self.crop_height + 1), corners(w - self.crop_width + 1)

    def forward_in(self, x, generator=None, train=False):
        """[B, H, W, C] -> [B * num_crops, crop_h, crop_w, C] in training
        (@generator required), [B, crop_h, crop_w, C] in eval."""
        if train:
            if generator is None:
                raise ValueError("CropRandomizer needs a generator in training")
            out = crop_at(x, *self.draw(x, generator), self.crop_height, self.crop_width)
            return out.reshape((-1,) + tuple(out.shape[2:]))
        ch = (x.shape[-3] - self.crop_height) // 2
        cw = (x.shape[-2] - self.crop_width) // 2
        return x[..., ch:ch + self.crop_height, cw:cw + self.crop_width, :]


def rgb_to_hsv(rgb):
    """[..., 3] in [0, 1] -> HSV (JAX ``rgb_to_hsv``: colorsys semantics,
    branch-free)."""
    r, g, b = rgb.unbind(-1)
    maxc, minc = rgb.amax(-1), rgb.amin(-1)
    rangec = maxc - minc
    s = torch.where(maxc > 0, rangec / torch.where(maxc > 0, maxc, 1.0), 0.0)
    safe_range = torch.where(rangec > 0, rangec, 1.0)
    rc, gc, bc = (maxc - r) / safe_range, (maxc - g) / safe_range, (maxc - b) / safe_range
    h = torch.where(r == maxc, bc - gc,
                    torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(rangec > 0, (h / 6.0) % 1.0, 0.0)   # % is a floor mod
    return torch.stack([h, s, maxc], dim=-1)


def hsv_to_rgb(hsv):
    """HSV [..., 3] -> RGB (JAX ``hsv_to_rgb``: colorsys semantics,
    branch-free)."""
    h, s, v = hsv.unbind(-1)
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p, q, t = v * (1.0 - s), v * (1.0 - s * f), v * (1.0 - s * (1.0 - f))
    i = i.to(torch.int32) % 6

    def select(values, default):
        out = default
        for k in reversed(range(5)):
            out = torch.where(i == k, values[k], out)
        return out

    return torch.stack([select((v, q, p, p, t), v), select((t, v, v, q, p), p),
                        select((p, p, t, v, v), q)], dim=-1)


def adjust_hue(x, factor):
    """Shift the hue of RGB @x [..., 3] by @factor turns, wrapping mod 1."""
    hsv = rgb_to_hsv(x)
    h = (hsv[..., 0:1] + factor) % 1.0
    return hsv_to_rgb(torch.cat([h, hsv[..., 1:]], dim=-1))


_JITTERS = ("brightness", "contrast", "saturation", "hue")


def color_jitter(x, factors, order):
    """The color jitters of @factors ({name: [N, 1, 1, 1]}, the enabled
    ones among brightness, contrast, saturation and hue) on @x
    [N, H, W, 3], in the @order-th of their permutations (in
    ``itertools.permutations`` order), then clipped to [0, 1] (JAX
    ``ColorRandomizer``): contrast blends with the image's mean over H, W
    and C, saturation with the mean over C, hue shifts the clipped image."""
    transforms = {
        "brightness": lambda im, f: im * f,
        "contrast": lambda im, f: _blend(im, im.mean(dim=(-3, -2, -1), keepdim=True), f),
        "saturation": lambda im, f: _blend(im, im.mean(dim=-1, keepdim=True), f),
        "hue": lambda im, f: adjust_hue(im.clamp(0.0, 1.0), f),
    }
    names = [n for n in _JITTERS if n in factors]
    perm = list(itertools.permutations(range(len(names))))[order] if names else ()
    for i in perm:
        x = transforms[names[i]](x, factors[names[i]])
    return x.clamp(0.0, 1.0)


def _blend(im, base, f):
    return base + (im - base) * f


@ObsUtils.register_randomizer
class ColorRandomizer(Randomizer):
    """Brightness, contrast, saturation and hue jitter in training (JAX
    ``ColorRandomizer``; its semantics, not torchvision's ``ColorJitter``):
    each enabled jitter's factor drawn per image, uniform in
    [max(0, 1 - b), 1 + b] (hue: [-h, h]), one application order drawn for
    the whole call; the input repeated @num_samples times first."""

    def __init__(self, input_shape, brightness=0.3, contrast=0.3, saturation=0.3,
                 hue=0.3, num_samples=1):
        self.input_shape = tuple(input_shape)
        self.ranges = {}
        for name, amount in zip(_JITTERS, (brightness, contrast, saturation, hue)):
            if amount > 0:
                self.ranges[name] = ((-amount, amount) if name == "hue"
                                     else (max(0.0, 1.0 - amount), 1.0 + amount))
        self.num_samples = num_samples

    def draw(self, x, generator):
        """({jitter: factor [N, 1, 1, 1]}, the order's index) for the
        repeated batch @x [N, H, W, C]."""
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        factors = {}
        for name, (lo, hi) in self.ranges.items():
            u = global_draw(lambda s: torch.rand(s, generator=generator,
                                                 device=generator.device), shape, self.dp)
            # at least fp32, as JAX draws them: a bf16 image becomes fp32
            factors[name] = (lo + (hi - lo) * u).to(
                x.device, torch.promote_types(x.dtype, torch.float32))
        # one order for the whole global batch: every rank takes the same
        # draw, which keeps the generators in step
        n_orders = math.factorial(len(self.ranges))
        order = int(torch.randint(0, n_orders, (), generator=generator,
                                  device=generator.device))
        return factors, order

    def forward_in(self, x, generator=None, train=False):
        if not train:
            return x
        if generator is None:
            raise ValueError("ColorRandomizer needs a generator in training")
        x = x.repeat_interleave(self.num_samples, dim=0)
        if not self.ranges:
            return x
        return color_jitter(x, *self.draw(x, generator))


def add_noise(x, noise, std, mean, limits=None):
    """@x + @std x @noise + @mean (@noise ~ N(0, 1), x's shape), clipped to
    @limits if given."""
    x = x + (std * noise + mean)
    return x if limits is None else x.clamp(limits[0], limits[1])


@ObsUtils.register_randomizer
class GaussianNoiseRandomizer(Randomizer):
    """Additive Gaussian noise in training (JAX
    ``GaussianNoiseRandomizer``): the input repeated @num_samples times,
    plus ``noise_std`` x N(0, 1) + ``noise_mean``, clipped to @limits. The
    reference draws uniform noise here; the JAX package draws Gaussian
    noise, as the name says, and the port follows it."""

    def __init__(self, input_shape, noise_mean=0.0, noise_std=0.3, limits=None,
                 num_samples=1):
        self.input_shape = tuple(input_shape)
        self.noise_mean = noise_mean
        self.noise_std = noise_std
        self.limits = limits
        self.num_samples = num_samples

    def draw(self, x, generator):
        # at least fp32, as JAX draws it: a bf16 image becomes fp32
        noise = global_draw(lambda shape: torch.randn(shape, generator=generator,
                                                      device=generator.device),
                            x.shape, self.dp)
        return noise.to(x.device, torch.promote_types(x.dtype, torch.float32))

    def forward_in(self, x, generator=None, train=False):
        if not train:
            return x
        if generator is None:
            raise ValueError("GaussianNoiseRandomizer needs a generator in training")
        x = x.repeat_interleave(self.num_samples, dim=0)
        return add_noise(x, self.draw(x, generator), self.noise_std, self.noise_mean,
                         self.limits)
