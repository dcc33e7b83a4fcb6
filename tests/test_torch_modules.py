"""Module-level parity of the PyTorch port with the JAX package: the FiLM
ResNet-18 + SpatialSoftmax visual core (channels-last images in, keypoint
order h-major, BatchNorm on running statistics) and the GPT backbone
(LayerNorm epsilon 1e-6, causal mask), with the JAX weights carried across.
Tolerance 1e-4: XLA and torch sum convolutions in different orders on the
CPU. The state-dict round trips show the port keeps the reference torch
layout and key names."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robot_manipulation_vq_vae_tpu.models import obs_core as JaxObsCore
from robot_manipulation_vq_vae_tpu.models.transformers import (
    GPT_Backbone as JaxGPT,
)
from robot_manipulation_vq_vae_tpu.utils.ckpt_conversion import (
    convert_gpt_backbone,
    convert_resnet18_film,
)

from robot_manipulation_vq_vae_tpu_torch.models.obs_core import (
    VisualCoreLanguageConditioned,
)
from robot_manipulation_vq_vae_tpu_torch.models.transformers import GPT_Backbone
from robot_manipulation_vq_vae_tpu_torch.utils.jax_weights import (
    load_jax_variables,
)
from torch_port_helpers import perturbed_variables
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

IMG, LANG = (96, 96, 3), 16
CORE_KW = dict(
    backbone_kwargs={"pretrained": False, "input_coord_conv": False},
    pool_kwargs={"num_kp": 32, "learnable_temperature": False,
                 "temperature": 1.0, "noise_std": 0.0},
    feature_dimension=64,
)
EMBED, HEADS, LAYERS, CTX = 32, 4, 2, 12


def _tree_equal(got, want):
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.fixture(scope="module")
def visual_pair():
    jax_core = JaxObsCore.VisualCoreLanguageConditioned(input_shape=IMG, **CORE_KW)
    rng = np.random.RandomState(0)
    x = rng.uniform(0, 1, (3,) + IMG).astype(np.float32)
    lang = rng.randn(3, LANG).astype(np.float32)
    variables = jax_core.init(jax.random.PRNGKey(0), jnp.asarray(x),
                              lang_emb=jnp.asarray(lang), train=False)
    variables, flat = perturbed_variables(variables, 1)
    port = VisualCoreLanguageConditioned(IMG, lang_emb_dim=LANG, **CORE_KW).eval()
    load_jax_variables(port, flat)
    return jax_core, variables, port, x, lang


def test_visual_core_matches_jax(visual_pair):
    jax_core, variables, port, x, lang = visual_pair
    want = jax_core.apply(variables, jnp.asarray(x), lang_emb=jnp.asarray(lang),
                          train=False)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(lang))
    assert got.shape == (3, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_spatial_softmax_keypoint_order_matches_jax(visual_pair):
    """Keypoints straight out of the pool, before the projection: [B, K, 2]
    in the JAX package's order."""
    jax_core, variables, port, x, lang = visual_pair
    p, s = variables["params"], variables["batch_stats"]
    bb = jax_core.backbone_class
    jax_bb = JaxObsCore._BACKBONE_CLASSES[bb]()
    feat = jax_bb.apply({"params": p["backbone"], "batch_stats": s["backbone"]},
                        jnp.asarray(x), jnp.asarray(lang), train=False)
    jax_pool = JaxObsCore._POOL_CLASSES["SpatialSoftmax"](
        input_shape=tuple(feat.shape[1:]), num_kp=32)
    want = jax_pool.apply({"params": p["pool"]}, feat)
    with torch.no_grad():
        got = port.pool(port.backbone(torch.from_numpy(x).permute(0, 3, 1, 2),
                                      torch.from_numpy(lang)))
    assert got.shape == (3, 32, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_resnet18_film_state_dict_keeps_reference_layout(visual_pair):
    _, variables, port, _, _ = visual_pair
    sd = {k: v.numpy() for k, v in port.backbone.state_dict().items()}
    params, stats = convert_resnet18_film(sd)
    _tree_equal(params, variables["params"]["backbone"])
    _tree_equal(stats, variables["batch_stats"]["backbone"])


def _gpt_pair(causal, seed):
    jax_gpt = JaxGPT(embed_dim=EMBED, context_length=CTX, causal=causal,
                     num_layers=LAYERS, num_heads=HEADS)
    variables = jax_gpt.init(jax.random.PRNGKey(seed), jnp.zeros((2, CTX, EMBED)))
    # weights ~N(0, 0.2^2) instead of 0.02^2, so that attention is not
    # uniform and the GELU form matters
    variables, flat = perturbed_variables(variables, seed, kernel_scale=10.0)
    port = GPT_Backbone(EMBED, CTX, causal=causal, num_layers=LAYERS,
                        num_heads=HEADS).eval()
    load_jax_variables(port, flat)
    return jax_gpt, variables, port


@pytest.mark.parametrize(
    "causal,scale",
    [(True, 1.0), (False, 1.0),
     # inputs of variance 1e-6: a LayerNorm epsilon of 1e-5 (torch's default)
     # instead of Flax's 1e-6 moves the output far past the tolerance
     (True, 1e-3)],
)
def test_gpt_backbone_matches_jax(causal, scale):
    jax_gpt, variables, port = _gpt_pair(causal, 2)
    x = (scale * np.random.RandomState(3).randn(2, CTX, EMBED)).astype(np.float32)
    want = jax_gpt.apply(variables, jnp.asarray(x), deterministic=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_gpt_state_dict_keeps_reference_layout():
    _, variables, port = _gpt_pair(True, 4)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    _tree_equal(convert_gpt_backbone(sd, num_layers=LAYERS), variables["params"])
