"""The port's pretrained cores, R3M and MVP, against the JAX package's, in
float32. The pretrained weights are not in the repository: synthetic state
dicts in R3M's and MVP's own published layouts stand for them, and each goes
through the JAX package's converter into JAX's module and through the
port's loader into the port's.

* R3M: a torchvision-layout ResNet-18 under R3M's ``module.convnet.``
  prefix (with keys of R3M's other heads and the classifier, which are
  dropped) through ``convert_r3m_trunk`` and ``load_r3m_state_dict``:
  outputs within 1e-5 of the largest on 116 x 116 images. The
  preprocessing in both resize directions: 116 -> 256 (upsampling) within
  1e-6 (measured 7.7e-7, normalized values), and 480 x 640 -> 256 x 341
  (downsampling) within 2e-6 (measured 1.1e-6): JAX's resize antialiases
  there, as ``F.interpolate(antialias=True)`` does (without it the gap is
  2.2); the center crop's offsets rounded as Python rounds (341: 58.5 ->
  58). The trunk is frozen: no gradient reaches it and its BatchNorm stays
  on the running statistics however the policy's mode is set. The port's loader
  also reads ResNet-34 / 50 dicts (JAX's converter takes ResNet-18 only).
* MVP: a narrow ``VisionTransformer`` (width 32, 2 blocks) from a
  timm-layout state dict through ``convert_mvp_vit`` and
  ``load_mvp_state_dict``, within 1e-5; the port's own state dict is such
  a dict (the converter reads it unchanged); ``MVPConv("vits-mae-in")`` at
  B = 1 on a 116 x 116 image (resized to 224), within 1e-4 of the largest
  (12 blocks of float32)."""

import numpy as np
import pytest
import torch

import jax

from robot_manipulation_vq_vae_tpu.models import base_nets as JaxBaseNets
from robot_manipulation_vq_vae_tpu.utils import ckpt_conversion as Conv

from robot_manipulation_vq_vae_tpu_torch.models import base_nets as PortBaseNets
from robot_manipulation_vq_vae_tpu_torch.models import obs_core as PortObsCore
from robot_manipulation_vq_vae_tpu_torch.models import pretrained_nets as PortPretrained
from robot_manipulation_vq_vae_tpu_torch.utils.jax_weights import load_jax_variables
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 1)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _torchvision_dict(trunk, seed):
    """A torchvision-layout state dict (``conv1``, ``bn1``, ``layerK.i.*``,
    ``fc``) of random values for the port trunk class @trunk."""
    rng = np.random.RandomState(seed)
    names = {"nets.0": "conv1", "nets.1": "bn1"}
    names.update({f"nets.{3 + k}": f"layer{k}" for k in range(1, 5)})
    sd = {}
    for key, value in trunk().state_dict().items():
        head, rest = key.split(".", 2)[:2], key.split(".", 2)[2]
        name = f"{names['.'.join(head)]}.{rest}"
        if key.endswith("num_batches_tracked"):
            sd[name] = torch.tensor(7)
        elif key.endswith("running_var"):
            sd[name] = torch.from_numpy(rng.uniform(0.5, 1.5, value.shape).astype(np.float32))
        elif value.dim() == 4:   # He-scaled, so that 18 layers keep the scale
            fan_in = value[0].numel()
            sd[name] = torch.from_numpy(
                (rng.randn(*value.shape) * np.sqrt(2.0 / fan_in)).astype(np.float32))
        else:
            sd[name] = torch.from_numpy((rng.randn(*value.shape) * 0.2
                                         + (1.0 if key.endswith("weight") else 0.0)
                                         ).astype(np.float32))
    sd["fc.weight"], sd["fc.bias"] = torch.zeros(1000, 512), torch.zeros(1000)
    return sd


def _r3m_checkpoint(seed=0):
    """R3M's own layout: the trunk under ``module.convnet.``, beside its
    language heads."""
    sd = {f"module.convnet.{k}": v for k, v in _torchvision_dict(
        PortBaseNets.ResNet18Conv, seed).items()}
    sd["module.lang_enc.weight"] = torch.zeros(3, 3)
    sd["module.lang_rew.0.bias"] = torch.zeros(3)
    return sd


@pytest.fixture(scope="module")
def r3m_pair():
    sd = _r3m_checkpoint()
    variables = Conv.convert_r3m_trunk({k: v.numpy() for k, v in sd.items()})
    port = PortPretrained.R3MConv("resnet18")
    PortPretrained.load_r3m_state_dict(port, sd)
    return JaxBaseNets.R3MConv(r3m_model_class="resnet18"), variables, port


def test_r3m_matches_jax_on_a_converted_checkpoint(r3m_pair):
    jax_core, variables, port = r3m_pair
    x = np.random.RandomState(1).rand(2, 116, 116, 3).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, im: jax_core.apply(v, im))(variables, x))
    got = port.eval()(_nchw(x))
    assert got.shape == (2, 512, 1, 1) and want.shape == (2, 1, 1, 512)
    np.testing.assert_allclose(_nhwc(got), want, atol=1e-5 * np.abs(want).max(), rtol=0)
    # the same weights carried from the JAX variables
    carried = PortPretrained.R3MConv("resnet18")
    load_jax_variables(carried, Conv.flatten_variables(variables))
    for (k, a), (_, b) in zip(carried.state_dict().items(), port.state_dict().items()):
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(a, b), k


@pytest.mark.parametrize("shape,tol", [((2, 116, 116, 3), 1e-6), ((1, 480, 640, 3), 2e-6)],
                         ids=["upsample_116", "downsample_480x640"])
def test_r3m_preprocess_matches_jax(shape, tol):
    x = np.random.RandomState(2).rand(*shape).astype(np.float32)
    want = np.asarray(jax.jit(JaxBaseNets.r3m_preprocess)(x))
    got = _nhwc(PortPretrained.r3m_preprocess(_nchw(x)))
    assert got.shape == want.shape == (shape[0], 224, 224, 3)
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def test_r3m_trunk_is_frozen(r3m_pair):
    _, _, port = r3m_pair
    core = PortObsCore.VisualCore((116, 116, 3), backbone_class="R3MConv",
                                  backbone_kwargs={"r3m_model_class": "resnet18"},
                                  pool_class=None, feature_dimension=8)
    core.backbone.load_state_dict(port.state_dict())
    before = {k: v.clone() for k, v in core.state_dict().items()}
    core.train()
    assert core.backbone.training and not core.backbone.trunk.training
    assert not any(m.training for m in core.backbone.trunk.modules())
    out = core(torch.rand(3, 116, 116, 3))
    out.sum().backward()
    assert all(p.grad is None for p in core.backbone.parameters())
    assert core.proj.weight.grad is not None
    for k, v in core.state_dict().items():
        assert torch.equal(v, before[k]), k


@pytest.mark.parametrize("trunk,model_class", [(PortBaseNets.ResNet34Conv, "resnet34"),
                                               (PortBaseNets.ResNet50Conv, "resnet50")])
def test_r3m_loader_reads_the_larger_trunks(trunk, model_class):
    sd = _torchvision_dict(trunk, 3)
    port = PortPretrained.R3MConv(model_class)
    PortPretrained.load_r3m_state_dict(port, sd)
    assert port.output_shape() == [1, 1, 2048 if model_class == "resnet50" else 512]
    assert torch.equal(port.trunk.nets[7][-1].conv2.weight, sd["layer4.2.conv2.weight"])
    with pytest.raises(RuntimeError, match="Missing"):
        PortPretrained.load_r3m_state_dict(port, {k: v for k, v in sd.items()
                                                  if not k.startswith("layer4")})


def _timm_vit_dict(vit, seed):
    """A timm / MAE layout state dict of random values for @vit's shapes,
    under MVP's ``module.`` prefix, with a decoder key to drop."""
    rng = np.random.RandomState(seed)
    sd = {}
    for key, value in vit.state_dict().items():
        scale = 0.3 if value.dim() > 1 else 0.1
        base = 1.0 if key.endswith("weight") and "norm" in key else 0.0
        sd[f"module.{key}"] = torch.from_numpy(
            (rng.randn(*value.shape) * scale + base).astype(np.float32))
    sd["module.decoder_embed.weight"] = torch.zeros(2, 2)
    return sd


def test_vision_transformer_matches_jax_on_a_converted_checkpoint():
    dims = dict(embed_dim=32, depth=2, num_heads=4, patch_size=8, img_size=32)
    port = PortPretrained.VisionTransformer(**dims)
    sd = _timm_vit_dict(port, 4)
    variables = Conv.convert_mvp_vit({k: v.numpy() for k, v in sd.items()}, depth=2)
    PortPretrained.load_mvp_state_dict(type("Core", (), {"trunk": port})(), sd)
    x = np.random.RandomState(5).rand(3, 32, 32, 3).astype(np.float32)
    jax_vit = JaxBaseNets.VisionTransformer(**dims)
    want = np.asarray(jax.jit(lambda v, im: jax_vit.apply(v, im))(
        {"params": variables["params"]["trunk"]}, x))
    got = port(_nchw(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)
    # the port's state dict is an MVP checkpoint: the converter reads it as is
    again = Conv.convert_mvp_vit({k: v.numpy() for k, v in port.state_dict().items()},
                                 depth=2)
    for a, b in zip(jax.tree_util.tree_leaves(again), jax.tree_util.tree_leaves(variables)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_mvp_core_matches_jax():
    jax_core = JaxBaseNets.MVPConv(mvp_model_class="vits-mae-in")
    port = PortPretrained.MVPConv("vits-mae-in")
    sd = _timm_vit_dict(port.trunk, 6)
    PortPretrained.load_mvp_state_dict(port, sd)
    variables = Conv.convert_mvp_vit({k: v.numpy() for k, v in sd.items()})
    x = np.random.RandomState(7).rand(1, 116, 116, 3).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, im: jax_core.apply(v, im))(variables, x))
    got = port.train()(_nchw(x))
    assert got.shape == (1, 384) and port.output_shape() == [384]
    assert not got.requires_grad   # frozen
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4 * np.abs(want).max(), rtol=0)
    carried = PortPretrained.MVPConv("vits-mae-in")
    load_jax_variables(carried, Conv.flatten_variables(variables))
    for (k, a), (_, b) in zip(carried.state_dict().items(), port.state_dict().items()):
        assert torch.equal(a, b), k
