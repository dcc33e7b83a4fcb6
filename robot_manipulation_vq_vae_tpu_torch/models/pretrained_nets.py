"""The pretrained visual cores (counterpart of the JAX package's
``models/base_nets.py``:502-700): R3M (its preprocessing, a ResNet trunk and
a spatial mean) and MVP (a MAE-style ViT on the resized image), both frozen
by default. NCHW in, as every backbone of the port.

The weights are external torch artifacts that the repository does not hold;
``load_r3m_state_dict`` and ``load_mvp_state_dict`` read R3M's and MVP's own
state dicts straight into the trunks (the counterparts of the JAX package's
``load_r3m_variables`` / ``ckpt_conversion.convert_mvp_vit``). The ViT keeps
the timm / MAE layout (``patch_embed.proj``, ``cls_token``, ``pos_embed``,
``blocks.N.{norm1, attn.qkv, attn.proj, norm2, mlp.fc1, mlp.fc2}``,
``norm``), so that its state dict is an MVP checkpoint's. Its attention is
plain matrix products, as JAX's einsums are (no kernel on either side).

A frozen trunk runs under ``no_grad`` (JAX stops the gradient at its
output; its parameters get zero gradients on both sides, and the policy's
optimizer steps them as optax does) and, for R3M, with its BatchNorm on the
running statistics whatever mode the policy is set to.
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from robot_manipulation_vq_vae_tpu_torch.models.base_nets import (
    ResNet18Conv,
    ResNet34Conv,
    ResNet50Conv,
)
from robot_manipulation_vq_vae_tpu_torch.utils import tensor_parallel as TP

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# Flax's LayerNorm epsilon (the ViT's)
VIT_LN_EPS = 1e-6


def resize_bilinear(x, h, w):
    """NCHW @x resized to @h x @w as ``jax.image.resize(..., "bilinear")``
    does it: half-pixel centers, a triangle filter widened by the scale
    where it shrinks (antialiasing), weights renormalized at the border. A
    bf16 @x (mixed precision) is resized in fp32 and rounded once to bf16:
    torch's CPU build has no bf16 antialiased resize."""
    if x.dtype == torch.bfloat16:
        return resize_bilinear(x.float(), h, w).to(x.dtype)
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False,
                         antialias=True)


def r3m_preprocess(x):
    """R3M's input pipeline (JAX ``r3m_preprocess``) on NCHW @x in [0, 1]:
    the shortest side resized to 256 (the long side truncated, as
    torchvision's ``Resize(int)``), the center 224 x 224 (offsets rounded as
    Python's ``round``), ImageNet normalization."""
    h, w = x.shape[-2:]
    nh, nw = (256, int(256 * w / h)) if h <= w else (int(256 * h / w), 256)
    x = resize_bilinear(x, nh, nw)
    top, left = int(round((nh - 224) / 2.0)), int(round((nw - 224) / 2.0))
    x = x[..., top:top + 224, left:left + 224]
    mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device)[:, None, None]
    std = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device)[:, None, None]
    return (x - mean) / std


_R3M_TRUNKS = {"resnet18": ResNet18Conv, "resnet34": ResNet34Conv,
               "resnet50": ResNet50Conv}


class R3MConv(nn.Module):
    """R3M's visual encoder (JAX ``R3MConv``): ``r3m_preprocess``, a ResNet
    trunk (``r3m_model_class``), the spatial mean; output [B, D, 1, 1], D
    2048 for resnet50, else 512. With @freeze (the default) the trunk runs
    without gradient and in eval mode (``train`` cannot switch it)."""

    JAX_NAMES = {"trunk": "trunk"}

    def __init__(self, r3m_model_class="resnet18", freeze=True):
        super().__init__()
        self.r3m_model_class = r3m_model_class
        self.freeze = freeze
        self.trunk = _R3M_TRUNKS[r3m_model_class]()

    def train(self, mode=True):
        super().train(mode)
        if self.freeze:
            self.trunk.eval()
        return self

    def forward(self, x):
        with torch.set_grad_enabled(torch.is_grad_enabled() and not self.freeze):
            feats = self.trunk(r3m_preprocess(x))
            return feats.mean(dim=(-2, -1), keepdim=True)

    def output_shape(self, input_shape=None):
        return [1, 1, 2048 if self.r3m_model_class == "resnet50" else 512]


def load_r3m_state_dict(core, state_dict):
    """Fill @core's (an ``R3MConv``) trunk from R3M's own torch state dict
    (``module.convnet.*``: only those keys are read) or a plain torchvision
    ResNet one; ``fc.*`` is dropped. Every trunk tensor must be given."""
    sd = dict(state_dict)
    if any("convnet." in k for k in sd):
        sd = {k[k.index("convnet.") + len("convnet."):]: v for k, v in sd.items()
              if "convnet." in k}
    own = core.trunk.state_dict()
    mapped = {}
    for key, value in sd.items():
        head, _, rest = key.partition(".")
        if head == "fc":
            continue
        if head in ("conv1", "bn1"):
            name = f"nets.{0 if head == 'conv1' else 1}.{rest}"
        elif head.startswith("layer"):
            name = f"nets.{3 + int(head[len('layer'):])}.{rest}"
        else:
            raise KeyError(f"{key} is not a ResNet trunk tensor")
        mapped[name] = torch.as_tensor(value)
    for k, v in own.items():   # a checkpoint may leave out the BN counters
        if k.endswith("num_batches_tracked"):
            mapped.setdefault(k, v)
    core.trunk.load_state_dict(mapped)


class _ViTAttention(nn.Module):
    # the tensor-parallel axis (``parallel.shard_params``): the qkv weight is
    # sharded over it as JAX's ``_param_spec`` shards it, and gathered here
    mp = None

    def __init__(self, dim, num_heads):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, n, d = x.shape
        hd = d // self.num_heads
        qkv = F.linear(x, TP.gathered(self.qkv.weight, self.mp, 0), self.qkv.bias)
        q, k, v = qkv.reshape(b, n, 3, self.num_heads, hd).permute(2, 0, 3, 1, 4)
        att = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd), dim=-1)
        return self.proj((att @ v).transpose(1, 2).reshape(b, n, d))


class _ViTMlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))   # exact (erf) GELU, as JAX's


class ViTBlock(nn.Module):
    """Pre-LN encoder block (JAX ``ViTBlock``): x + attn(norm1(x)), then
    x + mlp(norm2(x)) with an exact GELU; LayerNorm eps 1e-6."""

    JAX_NAMES = {"norm1": "norm1", "qkv": "attn.qkv", "proj": "attn.proj",
                 "norm2": "norm2", "fc1": "mlp.fc1", "fc2": "mlp.fc2"}

    def __init__(self, embed_dim, num_heads, mlp_ratio=4):
        super().__init__()
        self.norm1 = nn.LayerNorm(embed_dim, eps=VIT_LN_EPS)
        self.attn = _ViTAttention(embed_dim, num_heads)
        self.norm2 = nn.LayerNorm(embed_dim, eps=VIT_LN_EPS)
        self.mlp = _ViTMlp(embed_dim, mlp_ratio * embed_dim)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class _PatchEmbed(nn.Module):
    def __init__(self, patch_size, embed_dim):
        super().__init__()
        self.proj = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)

    def forward(self, x):
        return self.proj(x).flatten(2).transpose(1, 2)   # [B, N, D], h-major


class VisionTransformer(nn.Module):
    """MAE-style ViT trunk (JAX ``VisionTransformer``): patch embedding,
    the class token, learned position embeddings, pre-LN blocks, a final
    LayerNorm; returns the normed class token [B, D]. Input NCHW,
    @img_size square."""

    JAX_PARAMS = ("cls_token", "pos_embed")

    def __init__(self, embed_dim=768, depth=12, num_heads=12, patch_size=16, img_size=224):
        super().__init__()
        n = (img_size // patch_size) ** 2
        self.patch_embed = _PatchEmbed(patch_size, embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(0.02 * torch.randn(1, n + 1, embed_dim))
        self.blocks = nn.ModuleList([ViTBlock(embed_dim, num_heads) for _ in range(depth)])
        self.norm = nn.LayerNorm(embed_dim, eps=VIT_LN_EPS)

    def jax_names(self):
        names = {"patch_embed": "patch_embed.proj", "norm": "norm"}
        names.update({f"block{i}": f"blocks.{i}" for i in range(len(self.blocks))})
        return names

    def forward(self, x):
        x = self.patch_embed(x)
        cls = self.cls_token.expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed
        for block in self.blocks:
            x = block(x)
        return self.norm(x)[:, 0]


# model_class -> (embed_dim, depth, heads, img_size, patch_size)
MVP_VARIANTS = {
    "vits-mae-hoi": (384, 12, 6, 224, 16),
    "vits-mae-in": (384, 12, 6, 224, 16),
    "vits-sup-in": (384, 12, 6, 224, 16),
    "vitb-mae-egosoup": (768, 12, 12, 224, 16),
    "vitl-256-mae-egosoup": (1024, 24, 16, 256, 16),
}


class MVPConv(nn.Module):
    """MVP's (masked visual pretraining) encoder (JAX ``MVPConv``): the image
    resized to the variant's size (no normalization), then its ViT; output
    [B, D]. With @freeze (the default) the trunk runs without gradient."""

    JAX_NAMES = {"trunk": "trunk"}

    def __init__(self, mvp_model_class="vitb-mae-egosoup", freeze=True):
        super().__init__()
        dim, depth, heads, img_size, patch = MVP_VARIANTS[mvp_model_class]
        self.mvp_model_class = mvp_model_class
        self.freeze = freeze
        self.img_size = img_size
        self.trunk = VisionTransformer(dim, depth, heads, patch, img_size)

    def forward(self, x):
        if tuple(x.shape[-2:]) != (self.img_size, self.img_size):
            x = resize_bilinear(x, self.img_size, self.img_size)
        with torch.set_grad_enabled(torch.is_grad_enabled() and not self.freeze):
            return self.trunk(x)

    def output_shape(self, input_shape=None):
        return [MVP_VARIANTS[self.mvp_model_class][0]]


def load_mvp_state_dict(core, state_dict):
    """Fill @core's (an ``MVPConv``) trunk from an MVP / MAE checkpoint in
    the timm layout, a ``module.`` or ``model.`` prefix stripped; keys
    outside the trunk (a decoder, a head) are dropped. Every trunk tensor
    must be given."""
    own = core.trunk.state_dict()
    sd = {}
    for key, value in state_dict.items():
        for prefix in ("module.", "model."):
            if key.startswith(prefix):
                key = key[len(prefix):]
        if key in own:
            sd[key] = torch.as_tensor(value)
    core.trunk.load_state_dict(sd)
