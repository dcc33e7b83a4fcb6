"""``train.packed_rgb_encoders``: the port's packed per-camera FiLM trunks
(``models/packed_film.py``, ``ObservationEncoder.set_packed``) against the
JAX package's, at a small size (3 cameras of 64x64, B = 2; at 64x64 the
trunk's output is 2x2, so the keypoints pass gradient back into it).

* The packed trunk and the packed ``ObservationEncoder`` against JAX's in
  float64 (``jax.enable_x64``; ``.double()``), in eval and in train mode:
  outputs within 1e-9, the BatchNorm statistics within 1e-9, and the
  gradients of a fixed projection of the output, the JAX packed gradients
  mapped back per camera with the port's own layout converter, within 1e-9
  of the largest. The JAX weights arrive as a ``packed_backbone`` tree,
  which ``utils/jax_weights.py`` unpacks.
* Packed against unpacked port encoders with the same weights, float64:
  outputs, statistics and gradients within 1e-12.
* The port's layout converters against the JAX package's, both ways, to the
  bit; a key list in another order than the tree's is refused.
* A packed flagship's ``.pth`` is in the reference per-camera layout: it
  loads into an unpacked algo and back, Adam moments included, and the JAX
  package's ``convert_flagship_checkpoint`` reads it.
* One packed flagship ``train.mixed_precision`` step against the packed JAX
  algo's (tests/test_torch_icl_hvqvae.py's configuration, two FiLM cameras)
  at the flagship bf16 test's tolerances, the running statistics within
  that test's 1e-3.
"""

import copy
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robot_manipulation_vq_vae_tpu.config import config_factory as jax_config_factory
from robot_manipulation_vq_vae_tpu.models import obs_nets as JaxObsNets
from robot_manipulation_vq_vae_tpu.models import packed_film as JaxPacked
from robot_manipulation_vq_vae_tpu.models.base_nets import set_pallas_pool
from robot_manipulation_vq_vae_tpu.utils import ckpt_conversion as Conv
from robot_manipulation_vq_vae_tpu.utils import file_utils as JaxFileUtils
from robot_manipulation_vq_vae_tpu.utils import obs_utils as JaxObsUtils
from robot_manipulation_vq_vae_tpu.utils.ckpt_conversion import flatten_variables

import robot_manipulation_vq_vae_tpu_torch.algo as PortAlgo
from robot_manipulation_vq_vae_tpu_torch.config import config_factory
from robot_manipulation_vq_vae_tpu_torch.models import packed_film as PortPacked
from robot_manipulation_vq_vae_tpu_torch.models.base_nets import ResNet18ConvFiLM
from robot_manipulation_vq_vae_tpu_torch.models.obs_nets import ObservationEncoder
from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils as PortObsUtils
from robot_manipulation_vq_vae_tpu_torch.utils import train_utils as TrainUtils
from robot_manipulation_vq_vae_tpu_torch.utils.jax_weights import load_jax_variables
import test_torch_icl_hvqvae as Flagship
from torch_port_helpers import perturbed_variables

CAMS = ["agentview_image", "eye_in_hand_image", "wrist_image"]
B, IMG, LANG, G = 2, 64, 16, 3


def _configure(cfg, packed=False):
    with cfg.values_unlocked():
        cfg.observation.modalities.obs.low_dim = ["eef_pos", "lang_emb"]
        cfg.observation.modalities.obs.rgb = list(CAMS)
        cfg.observation.encoder.rgb.core_class = "VisualCoreLanguageConditioned"
        cfg.observation.encoder.rgb.core_kwargs = {
            "feature_dimension": 16, "backbone_class": "ResNet18ConvFiLM",
            "backbone_kwargs": {"pretrained": False, "input_coord_conv": False},
            "pool_class": "SpatialSoftmax",
            "pool_kwargs": {"num_kp": 8, "learnable_temperature": False,
                            "temperature": 1.0, "noise_std": 0.0},
        }
        cfg.observation.encoder.rgb.obs_randomizer_class = None
        cfg.train.packed_rgb_encoders = packed
    return cfg


SPEC = [("eef_pos", (3,)), ("lang_emb", (LANG,))] + [(c, (IMG, IMG, 3)) for c in CAMS]


def _obs(seed=0, dtype=np.float64):
    rng = np.random.RandomState(seed)
    obs = {"eef_pos": rng.randn(B, 3), "lang_emb": rng.randn(B, LANG)}
    for c in CAMS:
        obs[c] = rng.randint(0, 256, (B, IMG, IMG, 3)) / 255.0
    return {k: v.astype(dtype) for k, v in obs.items()}


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)


@pytest.fixture
def jax_packed_mode():
    """The JAX package's process-wide packing flag, on inside the test."""
    JaxObsNets.set_packed_rgb_encoders(True)
    yield
    JaxObsNets.set_packed_rgb_encoders(False)


def _jax_encoder():
    cfg = _configure(jax_config_factory("icl"))
    JaxObsUtils.initialize_obs_utils_with_config(cfg)
    kwargs = JaxObsUtils.obs_encoder_kwargs_from_config(cfg.observation.encoder)
    # the ICL encoders' features take no activation (JAX ICL_MIMO_Transformer)
    return JaxObsNets.obs_encoder_factory(SPEC, feature_activation=None,
                                          encoder_kwargs=kwargs)


def _port_encoder(packed):
    cfg = _configure(config_factory("icl"))
    PortObsUtils.initialize_obs_utils_with_config(cfg)
    kwargs = PortObsUtils.obs_encoder_kwargs_from_config(cfg.observation.encoder)
    enc = ObservationEncoder(SPEC, kwargs)
    enc.set_packed(packed)
    return enc.double()


def _torch_obs(obs):
    return {k: torch.from_numpy(v) for k, v in obs.items()}


def _projection(shape, seed=7):
    return np.random.RandomState(seed).randn(*shape)


def _grad_holder(module, flat_grads, flat_stats):
    """A copy of @module whose parameters hold the JAX gradients @flat_grads
    (mapped by ``load_jax_variables``, which also unpacks them)."""
    holder = copy.deepcopy(module)
    load_jax_variables(holder, {**flat_grads, **flat_stats})
    return holder


def _assert_grads(module, holder, rtol):
    """Each gradient within @rtol of its tensor's largest, or of the largest
    of all where a tensor's is 0 in exact arithmetic (the keypoint bias:
    the softmax does not see a constant shift)."""
    want = {n: p.detach().numpy() for n, p in holder.named_parameters()}
    top = max(np.abs(w).max() for w in want.values())
    for name, p in module.named_parameters():
        scale = max(np.abs(want[name]).max(), 1e-6 * top)
        np.testing.assert_allclose(p.grad.numpy(), want[name], atol=rtol * scale, rtol=0,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# the packed trunk alone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_packed_trunk_matches_jax(train):
    rng = np.random.RandomState(1)
    x = rng.rand(B, IMG, IMG, 3 * G)
    lang = rng.randn(B, LANG)
    trunk = JaxPacked.PackedResNet18ConvFiLM(groups=G, lang_emb_dim=LANG)
    with jax.enable_x64():
        variables = trunk.init(jax.random.PRNGKey(0), jnp.asarray(x, jnp.float32),
                               jnp.asarray(lang, jnp.float32))
        nested, _ = perturbed_variables(variables, 3)
        nested = _f64(nested)
        proj = _projection((B, 2, 2, 512 * G))

        def loss(params):
            out, upd = trunk.apply({"params": params, "batch_stats": nested["batch_stats"]},
                                   jnp.asarray(x), jnp.asarray(lang), train=train,
                                   mutable=["batch_stats"])
            return jnp.sum(out * proj), (out, upd)

        (_, (out_j, upd)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            nested["params"])
    cams = PortPacked.unpack_film_resnet18_params(nested, G)
    trunks = []
    for cam in cams:
        t = ResNet18ConvFiLM(lang_emb_dim=LANG).double()
        load_jax_variables(t, flatten_variables(cam))
        trunks.append(t)
    packed = PortPacked.PackedResNet18ConvFiLM(trunks).train(train)
    out = packed(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(), torch.from_numpy(lang))
    np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(), np.asarray(out_j),
                               atol=1e-9, rtol=0)
    (out * torch.from_numpy(proj).permute(0, 3, 1, 2)).sum().backward()
    want_stats = PortPacked.unpack_film_resnet18_params(
        {"params": nested["params"], "batch_stats": upd["batch_stats"]}, G)
    want_grads = PortPacked.unpack_film_resnet18_params(
        {"params": grads, "batch_stats": upd["batch_stats"]}, G)
    for t, stats, g in zip(trunks, want_stats, want_grads):
        holder = ResNet18ConvFiLM(lang_emb_dim=LANG).double()
        load_jax_variables(holder, flatten_variables(stats))
        for name, buf in t.named_buffers():
            if "running" in name:
                np.testing.assert_allclose(buf.numpy(), dict(holder.named_buffers())[name].numpy(),
                                           atol=1e-9, rtol=0, err_msg=name)
        load_jax_variables(holder, flatten_variables(g))
        _assert_grads(t, holder, 1e-9)
    if not train:   # eval leaves the statistics alone
        for t, cam in zip(trunks, cams):
            ref = ResNet18ConvFiLM(lang_emb_dim=LANG).double()
            load_jax_variables(ref, flatten_variables(cam))
            for (n, a), (_, b) in zip(t.named_buffers(), ref.named_buffers()):
                assert torch.equal(a, b), n


# ---------------------------------------------------------------------------
# the packed ObservationEncoder
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_variables():
    """The JAX encoder's default-layout variables, perturbed, float32."""
    enc = _jax_encoder()
    obs = {k: jnp.asarray(v, jnp.float32) for k, v in _obs().items()}
    variables = enc.init({"params": jax.random.PRNGKey(0)}, obs, train=False)
    return perturbed_variables(variables, 4)[0]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_packed_encoder_matches_jax(jax_variables, jax_packed_mode, train):
    enc = _jax_encoder()
    obs = _obs()
    with jax.enable_x64():
        packed_vars = _f64(JaxPacked.convert_variables_default_to_packed(jax_variables, CAMS))
        proj = _projection((B, 3 + LANG + 16 * G))

        def loss(params):
            out, upd = enc.apply({"params": params,
                                  "batch_stats": packed_vars["batch_stats"]},
                                 {k: jnp.asarray(v) for k, v in obs.items()},
                                 train=train, mutable=["batch_stats"])
            return jnp.sum(out * proj), (out, upd)

        (_, (out_j, upd)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            packed_vars["params"])
    flat_packed = flatten_variables(packed_vars)
    assert any("/packed_backbone/" in k for k in flat_packed)
    port = _port_encoder(packed=True).train(train)
    assert port.packed_keys == CAMS
    load_jax_variables(port, flat_packed)
    out = port(_torch_obs(obs))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), atol=1e-9, rtol=0)
    (out * torch.from_numpy(proj)).sum().backward()
    stats = flatten_variables({"batch_stats": upd["batch_stats"]})
    holder = _grad_holder(port, flatten_variables({"params": packed_vars["params"]}), stats)
    for name, buf in port.named_buffers():
        np.testing.assert_allclose(buf.numpy(), dict(holder.named_buffers())[name].numpy(),
                                   atol=1e-9, rtol=0, err_msg=name)
    holder = _grad_holder(port, flatten_variables({"params": grads}), stats)
    _assert_grads(port, holder, 1e-9)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_packed_encoder_matches_unpacked_port(jax_variables, train):
    flat = flatten_variables(jax_variables)
    encs = [_port_encoder(packed) for packed in (True, False)]
    outs = []
    for enc in encs:
        load_jax_variables(enc, flat)
        enc.train(train)
        out = enc(_torch_obs(_obs()))
        (out * torch.from_numpy(_projection(out.shape))).sum().backward()
        outs.append(out.detach())
    torch.testing.assert_close(outs[0], outs[1], atol=1e-12, rtol=0)
    for name, buf in encs[0].named_buffers():
        torch.testing.assert_close(buf, dict(encs[1].named_buffers())[name], atol=1e-12,
                                   rtol=0)
    params = dict(encs[1].named_parameters())
    for name, p in encs[0].named_parameters():
        torch.testing.assert_close(p.grad, params[name].grad, atol=1e-12, rtol=0)


def test_layout_converters_match_jax(jax_variables):
    want = JaxPacked.convert_variables_default_to_packed(jax_variables, CAMS)
    got = PortPacked.convert_variables_default_to_packed(jax_variables, CAMS)
    fw, fg = flatten_variables(want), flatten_variables(got)
    assert sorted(fw) == sorted(fg)
    for k in fw:
        np.testing.assert_array_equal(fg[k], fw[k], err_msg=k)
    back = flatten_variables(PortPacked.convert_variables_packed_to_default(got, CAMS))
    orig = flatten_variables(jax_variables)
    assert sorted(back) == sorted(orig)
    for k in orig:
        np.testing.assert_array_equal(back[k], orig[k], err_msg=k)


def test_converter_rejects_reordered_keys(jax_variables):
    swapped = list(reversed(CAMS))
    with pytest.raises(ValueError, match="spec order"):
        PortPacked.convert_variables_default_to_packed(jax_variables, swapped)
    packed = PortPacked.convert_variables_default_to_packed(jax_variables, CAMS)
    with pytest.raises(ValueError, match="spec order"):
        PortPacked.convert_variables_packed_to_default(packed, swapped)


# ---------------------------------------------------------------------------
# checkpoints of a packed flagship
# ---------------------------------------------------------------------------

T, A = 3, 12
SHAPES = {"eef_pos": (3,), **{c: (32, 32, 3) for c in CAMS[:2]}, "lang_emb": (768,)}


def _flagship_cfg(packed):
    cfg = config_factory("icl")
    with cfg.values_unlocked():
        cfg.experiment.rollout.enabled = False
        cfg.observation.modalities.obs.low_dim = ["eef_pos", "lang_emb"]
        cfg.observation.modalities.obs.rgb = CAMS[:2]
        cfg.observation.encoder.rgb.core_class = "VisualCoreLanguageConditioned"
        cfg.observation.encoder.rgb.core_kwargs = {
            "feature_dimension": 16, "backbone_class": "ResNet18ConvFiLM",
            "backbone_kwargs": {"pretrained": False, "input_coord_conv": False},
            "pool_class": "SpatialSoftmax",
            "pool_kwargs": {"num_kp": 8, "learnable_temperature": False,
                            "temperature": 1.0, "noise_std": 0.0}}
        cfg.observation.encoder.rgb.obs_randomizer_class = "CropRandomizer"
        cfg.observation.encoder.rgb.obs_randomizer_kwargs = {
            "crop_height": 28, "crop_width": 28, "num_crops": 1, "pos_enc": False}
        tc = cfg.algo.transformer
        tc.enabled, tc.context_length, tc.embed_dim = True, T, 32
        tc.num_layers, tc.num_heads, tc.causal = 1, 4, False
        tc.supervise_all_steps = tc.pred_future_acs = True
        vq = tc.vqvae
        vq.embed_dim, vq.num_subclusters, vq.num_clusters = 32, 16, 8
        vq.num_stages, vq.num_layers_per_stage = 1, 2
        cfg.train.packed_rgb_encoders = packed
        cfg.train.seed = 3
        cfg.experiment.save.include_optimizer = True
    PortObsUtils.initialize_obs_utils_with_config(cfg)
    return cfg


def _flagship(packed):
    return PortAlgo.algo_factory("icl", _flagship_cfg(packed), SHAPES, A, device="cpu")


def _flagship_batch(seed, b=4):
    rng = np.random.RandomState(seed)
    obs = {"eef_pos": rng.randn(b, 2 * T - 1, 3).astype(np.float32),
           "lang_emb": rng.randn(b, 2 * T - 1, 768).astype(np.float32)}
    for c in CAMS[:2]:
        obs[c] = rng.randint(0, 256, (b, 2 * T - 1, 32, 32, 3)).astype(np.uint8)
    return {"obs": obs, "actions": rng.uniform(-1, 1, (b, 2 * T - 1, A)).astype(np.float32)}


@pytest.fixture(scope="module")
def packed_checkpoint(tmp_path_factory):
    algo = _flagship(packed=True)
    assert algo.nets["policy"].net.encoder.nets["obs"].packed_keys == CAMS[:2]
    for seed in (0, 1):
        algo.train_on_batch(algo.process_batch_for_training(_flagship_batch(seed)), epoch=1)
    path = str(tmp_path_factory.mktemp("packed") / "model_epoch_1.pth")
    shape_meta = {"all_shapes": {k: list(v) for k, v in SHAPES.items()},
                  "all_obs_keys": sorted(SHAPES), "ac_dim": A, "use_images": True}
    TrainUtils.save_model(algo, _flagship_cfg(True), {"env_name": "Fake"}, shape_meta, path)
    return algo, path


def _request():
    batch = _flagship_batch(9, b=2)
    obs = {k: v[:, :T] for k, v in batch["obs"].items()}
    return obs, {"actions": batch["actions"][:, :T]}


def test_packed_checkpoint_loads_unpacked_and_back(packed_checkpoint):
    algo, path = packed_checkpoint
    ckpt = torch.load(path, map_location="cpu", weights_only=False)["model"]
    cam = f"policy.nets.encoder.nets.obs.obs_nets.{CAMS[1]}.backbone._base_block.0.weight"
    assert cam in ckpt and not any("packed" in k for k in ckpt)
    unpacked = _flagship(packed=False)
    unpacked.deserialize(ckpt)
    repacked = _flagship(packed=True)
    repacked.deserialize(unpacked.serialize(include_optimizer=True))
    for other in (unpacked, repacked):
        for k, v in algo.nets.state_dict().items():
            assert torch.equal(other.nets.state_dict()[k], v), k
        for n, opt in algo.optimizers.items():
            mine, theirs = opt.state_dict()["state"], other.optimizers[n].state_dict()["state"]
            assert set(mine) == set(theirs)
            for i in mine:
                for key in ("exp_avg", "exp_avg_sq"):
                    assert torch.equal(mine[i][key], theirs[i][key]), (n, i, key)
    obs, ctx = _request()
    torch.testing.assert_close(unpacked.get_action(obs, ctx), algo.get_action(obs, ctx),
                               atol=1e-5, rtol=0)
    assert torch.equal(repacked.get_action(obs, ctx), algo.get_action(obs, ctx))


def test_jax_package_reads_the_packed_checkpoint(packed_checkpoint):
    """The JAX converter reads the per-camera file; the JAX policy is built
    unpacked from it (the JAX package's loader traces a packed tree from a
    packed config and has no load-time packing)."""
    algo, path = packed_checkpoint
    ckpt = Conv.convert_flagship_checkpoint(JaxFileUtils.load_reference_torch_checkpoint(path))
    cfg = json.loads(ckpt["config"])
    assert cfg["train"]["packed_rgb_encoders"]
    cfg["train"]["packed_rgb_encoders"] = False
    ckpt["config"] = json.dumps(cfg)
    try:
        policy, _ = JaxFileUtils.policy_from_checkpoint(ckpt_dict=ckpt)
        obs, ctx = _request()
        want = np.asarray(policy.policy.get_action(obs, context_batch=ctx))
    finally:
        set_pallas_pool(False)
        JaxObsNets.set_packed_rgb_encoders(False)
    np.testing.assert_allclose(algo.get_action(obs, ctx).numpy(), want, atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# a packed flagship step in mixed precision
# ---------------------------------------------------------------------------

def test_packed_bf16_flagship_step_matches_jax():
    """The packed trunks in a ``train.mixed_precision`` step: bf16 grouped
    convolutions and BatchNorm over the G * C channels with the bf16
    rounding of the statistics' update, against JAX's packed step."""
    want, got, algo, expected, stats0 = Flagship._mixed_step(packed_rgb_encoders=True)
    assert algo.nets["policy"].net.encoder.nets["obs"].packed_keys == Flagship.CAMS
    Flagship.assert_mixed_step_matches(want, got, algo)
    state, jax_state = algo.nets["policy"].state_dict(), expected.state_dict()
    worst = max(float((state[k] - jax_state[k]).abs().max()) for k in stats0)
    moved = sum(not torch.equal(state[k], v) for k, v in stats0.items())
    assert worst <= 1e-3 and moved == len(stats0)
