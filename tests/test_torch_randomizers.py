"""The port's observation randomizers and ScanCore against the JAX
package's. The JAX randomizers draw from ``jax.random``; the tests pin those
draws (``PinnedJaxRandom`` stands for the ``jax`` module inside the JAX
package's ``obs_core``) and hand the same values to the port's ``draw``
(``port_draws``), as the training tests pin crops.

* ``rgb_to_hsv`` / ``hsv_to_rgb`` against ``colorsys`` (float64, within
  1e-12, grays, blacks and ties between channels included), and the round
  trip.
* ``ColorRandomizer`` (JAX applied eagerly, see ``_jax_randomize``): all
  four jitters in four of the 24 application orders (each jitter first
  once), in float64 within
  1e-12 and in float32 within 2e-6 (``TOLS`` says why not 1e-6); a single
  jitter (no order drawn) in float32 within 1e-6; two samples an image and
  ``forward_out``'s mean; eval passes the image through.
* ``GaussianNoiseRandomizer`` in float32 (within 1e-6): Gaussian noise (not
  the reference's uniform), clipped to its limits, three samples.
* An ``ObservationEncoder`` with a crop (two crops an image) then a color
  jitter (two samples) on a camera and Gaussian noise on a low-dim key, in
  training, float64, within 1e-9: ``forward_out`` runs in list order on
  both sides.
* ``ScanCore`` in float64 (within 1e-9, gradients too) on [B, L], [B, L, 1]
  and [B, 1, L], with and without the projection and unflattened; its
  output shape as JAX's ``_core_output_shape``."""

import colorsys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robot_manipulation_vq_vae_tpu.config import config_factory as jax_config_factory
from robot_manipulation_vq_vae_tpu.models import obs_core as JaxObsCore
from robot_manipulation_vq_vae_tpu.models import obs_nets as JaxObsNets
from robot_manipulation_vq_vae_tpu.utils import obs_utils as JaxObsUtils
from robot_manipulation_vq_vae_tpu.utils.ckpt_conversion import flatten_variables

from robot_manipulation_vq_vae_tpu_torch.config import config_factory
from robot_manipulation_vq_vae_tpu_torch.models import obs_core as PortObsCore
from robot_manipulation_vq_vae_tpu_torch.models.obs_nets import ObservationEncoder
from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils as PortObsUtils
from robot_manipulation_vq_vae_tpu_torch.utils.jax_weights import load_jax_variables
from torch_port_helpers import PinnedJaxRandom, perturbed_variables, port_draws
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)


def _pixels():
    rng = np.random.RandomState(0)
    rgb = rng.rand(400, 3)
    rgb[:20] = rgb[:20, :1]                      # grays
    rgb[20:30] = 0.0                             # black
    rgb[30:40, 1] = rgb[30:40, 0]                # r == g ties
    rgb[40:50, 2] = rgb[40:50, 1]                # g == b ties
    rgb[50:60] = np.round(rgb[50:60] * 4) / 4    # coarse values: more ties
    return rgb


def test_hsv_matches_colorsys():
    rgb = _pixels()
    hsv = PortObsCore.rgb_to_hsv(torch.from_numpy(rgb)).numpy()
    want = np.array([colorsys.rgb_to_hsv(*p) for p in rgb])
    np.testing.assert_allclose(hsv, want, atol=1e-12, rtol=0)
    back = PortObsCore.hsv_to_rgb(torch.from_numpy(want)).numpy()
    np.testing.assert_allclose(back, np.array([colorsys.hsv_to_rgb(*p) for p in want]),
                               atol=1e-12, rtol=0)
    np.testing.assert_allclose(back, rgb, atol=1e-12, rtol=0)


def _images(shape=(4, 12, 10, 3), seed=1):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _jax_randomize(rand, x, shim, monkeypatch):
    """JAX's randomizer applied eagerly: op by op its float32 arithmetic is
    the port's to the bit, while under jit XLA rewrites the HSV arithmetic
    (9.4e-7 apart from the eager values on 20,000 pixels)."""
    monkeypatch.setattr(JaxObsCore, "jax", shim)
    out = rand.forward_in(jnp.asarray(x), rng=jax.random.PRNGKey(0), train=True)
    monkeypatch.setattr(JaxObsCore, "jax", jax)
    return np.asarray(out)


# float32: the image means of contrast and saturation sum in another order on
# each side (an ulp), and the hue's floor(6 h) turns an ulp of h into 6
# (measured: 1.10e-6 at most); float64 shows the semantics are the same
TOLS = {np.float32: 2e-6, np.float64: 1e-12}


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["fp32", "fp64"])
@pytest.mark.parametrize("order", [0, 7, 14, 23])
def test_color_randomizer_matches_jax_in_its_orders(order, dtype, monkeypatch):
    x = _images().astype(dtype)
    kw = dict(brightness=0.3, contrast=0.4, saturation=0.5, hue=0.3, num_samples=2)
    shim = PinnedJaxRandom(order, fixed={"randint": order})
    with jax.enable_x64(dtype == np.float64):
        want = _jax_randomize(JaxObsCore.ColorRandomizer(x.shape[1:], **kw), x, shim,
                              monkeypatch)
    assert [n for n, _ in shim.log] == ["uniform"] * 4 + ["randint"]
    port_draws(monkeypatch, shim.log, PortObsCore)
    rand = PortObsCore.ColorRandomizer(x.shape[1:], **kw)
    got = rand.forward_in(torch.from_numpy(x), torch.Generator(), train=True)
    assert got.shape == (8,) + x.shape[1:] and got.numpy().dtype == want.dtype == dtype
    np.testing.assert_allclose(got.numpy(), want, atol=TOLS[dtype], rtol=0)
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0
    feats = got.reshape(8, -1)[:, :5]
    np.testing.assert_allclose(rand.forward_out(feats).numpy(),
                               feats.numpy().reshape(4, 2, 5).mean(1), atol=1e-7)


@pytest.mark.parametrize("jitter", ["brightness", "contrast", "saturation", "hue"])
def test_a_single_color_jitter_matches_jax(jitter, monkeypatch):
    x = _images(seed=2)
    kw = {n: (0.4 if n == jitter else 0.0) for n in ("brightness", "contrast",
                                                       "saturation", "hue")}
    shim = PinnedJaxRandom(3)
    want = _jax_randomize(JaxObsCore.ColorRandomizer(x.shape[1:], **kw), x, shim, monkeypatch)
    # JAX draws no order for one jitter; the port draws one and uses none
    port_draws(monkeypatch, shim.log + [("randint", np.array(0, np.int32))], PortObsCore)
    rand = PortObsCore.ColorRandomizer(x.shape[1:], **kw)
    got = rand.forward_in(torch.from_numpy(x), torch.Generator(), train=True)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    assert torch.equal(rand.forward_in(torch.from_numpy(x), train=False), torch.from_numpy(x))


def test_gaussian_noise_randomizer_matches_jax(monkeypatch):
    x = _images((5, 9), seed=4)
    kw = dict(noise_mean=0.1, noise_std=0.5, limits=(0.0, 0.9), num_samples=3)
    shim = PinnedJaxRandom(5)
    want = _jax_randomize(JaxObsCore.GaussianNoiseRandomizer(x.shape[1:], **kw), x, shim,
                          monkeypatch)
    port_draws(monkeypatch, shim.log, PortObsCore)
    rand = PortObsCore.GaussianNoiseRandomizer(x.shape[1:], **kw)
    got = rand.forward_in(torch.from_numpy(x), torch.Generator(), train=True)
    assert got.shape == (15, 9)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    assert 0.0 < float((got == 0.9).float().mean()) < 0.5   # clipped, not all
    np.testing.assert_allclose(rand.forward_out(got).numpy(), want.reshape(5, 3, 9).mean(1),
                               atol=1e-6, rtol=0)
    monkeypatch.undo()   # the port's own draw from the generator
    rand = PortObsCore.GaussianNoiseRandomizer((1,), noise_std=1.0)
    z = rand.forward_in(torch.zeros(20000, 1), torch.Generator().manual_seed(0), True)
    assert abs(float(z.mean())) < 0.03 and abs(float(z.std()) - 1.0) < 0.03
    assert float(z.abs().max()) > 3.0   # Gaussian tails; a uniform draw has none


LANG = 8
CAM, LOW = "agentview_image", "eef_pos"
SPEC = [(LOW, (3,)), (CAM, (20, 20, 3))]


def _configure(cfg):
    with cfg.values_unlocked():
        cfg.observation.modalities.obs.low_dim = [LOW]
        cfg.observation.modalities.obs.rgb = [CAM]
        cfg.observation.encoder.rgb.core_class = "VisualCore"
        cfg.observation.encoder.rgb.core_kwargs = {
            "backbone_class": "ShallowConv", "pool_class": "SpatialSoftmax",
            "pool_kwargs": {"num_kp": 4}, "feature_dimension": 6}
        cfg.observation.encoder.rgb.obs_randomizer_class = ["CropRandomizer",
                                                            "ColorRandomizer"]
        cfg.observation.encoder.rgb.obs_randomizer_kwargs = [
            {"crop_height": 16, "crop_width": 16, "num_crops": 2},
            {"num_samples": 2}]
        cfg.observation.encoder.low_dim.obs_randomizer_class = "GaussianNoiseRandomizer"
        cfg.observation.encoder.low_dim.obs_randomizer_kwargs = {"noise_std": 0.2}
    return cfg


def test_randomizers_in_an_encoder_match_jax(monkeypatch):
    cfg = _configure(jax_config_factory("icl"))
    JaxObsUtils.initialize_obs_utils_with_config(cfg)
    enc = JaxObsNets.obs_encoder_factory(
        SPEC, feature_activation=None,
        encoder_kwargs=JaxObsUtils.obs_encoder_kwargs_from_config(cfg.observation.encoder))
    rng = np.random.RandomState(6)
    obs = {LOW: rng.randn(3, 3), CAM: rng.rand(3, 20, 20, 3)}
    variables = enc.init({"params": jax.random.PRNGKey(0)},
                         {k: jnp.asarray(v, jnp.float32) for k, v in obs.items()})
    nested, flat = perturbed_variables(variables, 7)
    shim = PinnedJaxRandom(8)
    monkeypatch.setattr(JaxObsCore, "jax", shim)
    with jax.enable_x64():
        want = jax.jit(lambda v, o: enc.apply(v, o, train=True, rngs={
            "randomizer": jax.random.PRNGKey(1)}))(
            jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), nested),
            {k: jnp.asarray(v) for k, v in obs.items()})
    monkeypatch.setattr(JaxObsCore, "jax", jax)
    assert [n for n, _ in shim.log] == ["normal", "randint", "randint"] + ["uniform"] * 4 + [
        "randint"]
    state = port_draws(monkeypatch, shim.log, PortObsCore)
    port_cfg = _configure(config_factory("icl"))
    PortObsUtils.initialize_obs_utils_with_config(port_cfg)
    port = ObservationEncoder(SPEC, PortObsUtils.obs_encoder_kwargs_from_config(
        port_cfg.observation.encoder)).double().train()
    load_jax_variables(port, flat)
    got = port({k: torch.from_numpy(v) for k, v in obs.items()}, torch.Generator())
    assert state["i"] == len(shim.log) and got.shape == (3, 3 + 6) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-9, rtol=0)


SCANS = {
    "flat_b_l": ((64,), {}),
    "b_l_1_projected": ((64, 1), {"feature_dimension": 10}),
    "reference_b_1_l": ((1, 64), {"conv_kwargs": {"out_channels": (8, 6),
                                                  "kernel_size": (5, 3),
                                                  "stride": (2, 1)}}),
    "unflattened": ((64,), {"flatten": False}),
}


@pytest.mark.parametrize("name", list(SCANS))
def test_scan_core_matches_jax(name):
    shape, kw = SCANS[name]
    x = np.random.RandomState(9).randn(3, *shape)
    core = JaxObsCore.ScanCore(input_shape=shape, **kw)
    with jax.enable_x64():
        variables = core.init(jax.random.PRNGKey(0), jnp.asarray(x, jnp.float32))
        nested, flat = perturbed_variables(variables, 10)
        nested = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), nested)
        out_shape = jax.eval_shape(lambda: core.apply(nested, x)).shape
        ct = np.random.RandomState(11).randn(*out_shape)
        out_j = jax.jit(core.apply)(nested, jnp.asarray(x))
        grads = jax.jit(jax.grad(lambda p: jnp.sum(core.apply({"params": p}, x) * ct)))(
            nested["params"])
    port = PortObsCore.ScanCore(shape, **kw).double()
    load_jax_variables(port, flat)
    out = port(torch.from_numpy(x))
    assert tuple(out.shape) == tuple(out_shape)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), atol=1e-9, rtol=0)
    (out * torch.from_numpy(ct)).sum().backward()
    holder = PortObsCore.ScanCore(shape, **kw).double()
    load_jax_variables(holder, flatten_variables({"params": grads}))
    want = dict(holder.named_parameters())
    for n, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[n].detach().numpy(),
                                   atol=1e-9 * float(want[n].abs().max()), rtol=0, err_msg=n)
    if kw.get("flatten", True):
        assert port.output_shape() == list(JaxObsNets._core_output_shape("ScanCore", kw, shape))
