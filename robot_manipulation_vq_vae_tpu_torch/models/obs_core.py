"""Encoder cores and observation randomizers (counterpart of the JAX package's
``models/obs_core.py``:57-143, 233-286): ``VisualCore`` (on ``ResNet18Conv``
or the FiLM ``ResNet18ConvFiLM``), ``VisualCoreLanguageConditioned`` and
``CropRandomizer`` (random crops in training, the center crop in eval).
Images are channels-last at the public functions.
"""

import torch
import torch.nn as nn

from robot_manipulation_vq_vae_tpu_torch.models import base_nets as BaseNets
from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils as ObsUtils

_BACKBONE_CLASSES = {"ResNet18Conv": BaseNets.ResNet18Conv,
                     "ResNet18ConvFiLM": BaseNets.ResNet18ConvFiLM}
# backbones that take a language embedding
_FILM_BACKBONES = {"ResNet18ConvFiLM"}
_POOL_CLASSES = {"SpatialSoftmax": BaseNets.SpatialSoftmax}


def _filter_kwargs(allowed, kwargs):
    return {k: v for k, v in (kwargs or {}).items() if k in allowed}


@ObsUtils.register_encoder_core
class VisualCore(nn.Module):
    """Backbone -> pool -> flatten -> linear. Input [B, H, W, C] with
    input_shape (H, W, C); output [B, feature_dimension]."""

    JAX_NAMES = {"backbone": "backbone", "pool": "pool", "proj": "proj"}

    def __init__(self, input_shape, backbone_class="ResNet18Conv",
                 pool_class="SpatialSoftmax", backbone_kwargs=None,
                 pool_kwargs=None, flatten=True, feature_dimension=64,
                 lang_emb_dim=None):
        super().__init__()
        if backbone_class not in _BACKBONE_CLASSES:
            raise NotImplementedError(f"backbone {backbone_class} is not ported yet")
        if pool_class not in _POOL_CLASSES or not flatten or feature_dimension is None:
            raise NotImplementedError(
                "only SpatialSoftmax pooling with a flattened linear projection "
                "is ported yet"
            )
        bkw = _filter_kwargs({"input_coord_conv", "pretrained"}, backbone_kwargs)
        self.film = backbone_class in _FILM_BACKBONES
        if self.film:
            bkw["lang_emb_dim"] = lang_emb_dim
        self.backbone = _BACKBONE_CLASSES[backbone_class](**bkw)
        feat_shape = self.backbone.output_shape(input_shape)
        pkw = _filter_kwargs(
            {"num_kp", "temperature", "learnable_temperature", "output_variance",
             "noise_std"}, pool_kwargs,
        )
        self.pool = _POOL_CLASSES[pool_class](input_shape=feat_shape, **pkw)
        pooled = BaseNets.SpatialSoftmax.static_output_shape(
            feat_shape, pkw.get("num_kp", 32)
        )
        self.proj = nn.Linear(pooled[0] * pooled[1], feature_dimension)

    def forward(self, x, lang_emb=None):
        # contiguous NCHW: the trunk, and the stem pool's kernel, run NCHW
        x = x.permute(0, 3, 1, 2).contiguous()
        if self.film:
            if lang_emb is None:
                raise ValueError("a FiLM backbone needs lang_emb")
            x = self.backbone(x, lang_emb)
        else:
            x = self.backbone(x)
        return self.head(x)

    def head(self, features):
        """The core past its backbone: pool -> flatten -> linear, on the
        trunk's features [B, 512, h, w]."""
        return self.proj(self.pool(features).flatten(1))


@ObsUtils.register_encoder_core
class VisualCoreLanguageConditioned(VisualCore):
    """VisualCore whose backbone is FiLM-conditioned on a language embedding."""

    def __init__(self, input_shape, backbone_class="ResNet18ConvFiLM", **kwargs):
        super().__init__(input_shape, backbone_class=backbone_class, **kwargs)


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
class CropRandomizer:
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
        self.num_crops = num_crops

    def output_shape_in(self, input_shape=None):
        return [self.crop_height, self.crop_width, self.input_shape[2]]

    def forward_in(self, x, generator=None, train=False):
        """[B, H, W, C] -> [B * num_crops, crop_h, crop_w, C] in training
        (@generator required), [B, crop_h, crop_w, C] in eval."""
        if train:
            if generator is None:
                raise ValueError("CropRandomizer needs a generator in training")
            b, h, w = x.shape[:3]
            shape = (b, self.num_crops)
            hy = torch.randint(0, h - self.crop_height + 1, shape,
                               generator=generator, device=generator.device)
            wx = torch.randint(0, w - self.crop_width + 1, shape,
                               generator=generator, device=generator.device)
            out = crop_at(x, hy.to(x.device), wx.to(x.device),
                          self.crop_height, self.crop_width)
            return out.reshape((-1,) + tuple(out.shape[2:]))
        ch = (x.shape[-3] - self.crop_height) // 2
        cw = (x.shape[-2] - self.crop_width) // 2
        return x[..., ch:ch + self.crop_height, cw:cw + self.crop_width, :]

    def forward_out(self, x):
        if x.shape[0] % self.num_crops != 0:
            return x
        b = x.shape[0] // self.num_crops
        return x.reshape((b, self.num_crops) + tuple(x.shape[1:])).mean(1)
