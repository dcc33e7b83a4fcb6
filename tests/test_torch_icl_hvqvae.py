"""The port's flagship slice as a whole: ``ICLTransformerHVQVAE`` against the
JAX package's, at a small size (2 layers, width 32, 4 heads, T = 4; HVQVAE
embed 32, 16 Z and 8 Q codes, 2 stages of 2 layers; two 64x64 cameras), with
the same carried-over weights and numpy inputs.

* ``get_action`` in fp32 on the serving configuration (``VisualCore`` +
  ``ResNet18Conv``, no language, center crop) and on the training one (FiLM
  ResNet-18 + language embedding), within 1e-5.
* 3 ``train_on_batch`` steps with ``train.pallas_pool``, dropout 0 and no
  crop randomizer, both sides in float64 as in
  tests/test_torch_icl_gmm_train.py (whose docstring says why: Flax
  BatchNorm's one-pass variance and Adam's sign-like first steps). The EMA
  codebooks start initialized with counts of at least 2, so no code dies in
  3 steps and no random draw enters. Metrics within 1e-4; weights,
  BatchNorm statistics and the HVQVAE's ``vq`` buffers held in bulk.
* One ``train.mixed_precision`` step in float32, where the trunks run in
  bf16: the HVQVAE's losses (fp32 on both sides) within 1e-5, the action
  losses and the gradient norm within 2 % (bf16 keeps 8 bits; the two sides
  round the convolutions' sums differently), and the BatchNorm running
  statistics with the bf16 rounding of the JAX update. ``_mixed_step``
  also runs it with other ``train`` modes on
  (tests/test_torch_train_modes.py, tests/test_torch_packed_film.py).

Also: the JAX ``icl`` routing, and the ``train`` speed modes build."""

import copy
import functools

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

import robot_manipulation_vq_vae_tpu.algo as JaxAlgo
from robot_manipulation_vq_vae_tpu.config import config_factory as jax_config_factory
from robot_manipulation_vq_vae_tpu.models import base_nets as JaxBaseNets
from robot_manipulation_vq_vae_tpu.models import obs_nets as JaxObsNets
from robot_manipulation_vq_vae_tpu.models.base_nets import set_pallas_pool
from robot_manipulation_vq_vae_tpu.utils import obs_utils as JaxObsUtils
from robot_manipulation_vq_vae_tpu.utils.ckpt_conversion import flatten_variables

import robot_manipulation_vq_vae_tpu_torch.algo as PortAlgo
from robot_manipulation_vq_vae_tpu_torch.config import config_factory
from robot_manipulation_vq_vae_tpu_torch.models.base_nets import BatchNorm2d
from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils as PortObsUtils
from robot_manipulation_vq_vae_tpu_torch.utils.jax_weights import load_jax_variables
from torch_port_helpers import assert_mostly_close, perturbed_variables

B, T, A, LANG, IMG, STEPS, LR = 4, 4, 12, 16, 64, 3, 1e-4
E, KZ, KQ = 32, 16, 8
CAMS = ["agentview_image", "eye_in_hand_image"]
LOW_DIM = {"eef_pos": (3,), "eef_quat": (4,), "gripper_qpos": (2,)}
VQ_METRICS = ("vqvae_loss", "L_rec", "L_commit_z", "L_commit_q")
METRICS = VQ_METRICS + ("l2_loss", "l1_loss", "cos_loss", "action_loss",
                        "policy_grad_norms", "vqvae_grad_norms")


def _configure(cfg, film, train=False, mixed_precision=False, **modes):
    """bench_train.py's (@film) or bench_infer.py's configuration, shrunk,
    with the ``train`` options @modes."""
    with cfg.values_unlocked():
        cfg.observation.modalities.obs.low_dim = list(LOW_DIM) + (["lang_emb"] if film else [])
        cfg.observation.modalities.obs.rgb = CAMS
        cfg.observation.encoder.rgb.core_class = (
            "VisualCoreLanguageConditioned" if film else "VisualCore")
        cfg.observation.encoder.rgb.core_kwargs = {
            "feature_dimension": 64,
            "backbone_class": "ResNet18ConvFiLM" if film else "ResNet18Conv",
            "backbone_kwargs": {"pretrained": False, "input_coord_conv": False},
            "pool_class": "SpatialSoftmax",
            "pool_kwargs": {"num_kp": 32, "learnable_temperature": False,
                            "temperature": 1.0, "noise_std": 0.0},
        }
        if train:
            cfg.observation.encoder.rgb.obs_randomizer_class = None
        else:
            cfg.observation.encoder.rgb.obs_randomizer_class = "CropRandomizer"
            cfg.observation.encoder.rgb.obs_randomizer_kwargs = {
                "crop_height": 52, "crop_width": 52, "num_crops": 1, "pos_enc": False}
        tc = cfg.algo.transformer
        tc.enabled, tc.context_length, tc.causal = True, T, False
        tc.supervise_all_steps = tc.pred_future_acs = True
        tc.embed_dim, tc.num_layers, tc.num_heads = 32, 2, 4
        tc.emb_dropout = tc.attn_dropout = tc.block_output_dropout = 0.0
        vq = tc.vqvae
        vq.embed_dim, vq.num_subclusters, vq.num_clusters = E, KZ, KQ
        vq.num_stages, vq.num_layers_per_stage, vq.dropout = 2, 2, 0.0
        lr = cfg.algo.optim_params.policy.learning_rate
        lr.initial, lr.scheduler_type = LR, None
        # a clip limit below the gradient norms exercises the clipping
        cfg.train.max_grad_norm = 1.0
        cfg.train.pallas_pool = True
        cfg.train.mixed_precision = mixed_precision
        for k, v in modes.items():
            cfg.train[k] = v
    return cfg


def _shapes(film):
    shapes = {**LOW_DIM, **{c: (IMG, IMG, 3) for c in CAMS}}
    if film:
        shapes["lang_emb"] = (LANG,)
    return shapes


def _batch(rng, film):
    obs = {k: rng.randn(B, T, *s).astype(np.float32) for k, s in LOW_DIM.items()}
    obs.update({c: rng.randint(0, 256, (B, T, IMG, IMG, 3)).astype(np.uint8)
                for c in CAMS})
    if film:
        obs["lang_emb"] = rng.randn(B, T, LANG).astype(np.float32)
    return {"obs": obs, "actions": rng.uniform(-1, 1, (B, T, A)).astype(np.float32)}


def _vq_state():
    rng = np.random.RandomState(4)

    def unit(k):
        cb = rng.randn(k, E)
        return (cb / np.linalg.norm(cb, axis=-1, keepdims=True)).astype(np.float32)

    return {"codebook_z": unit(KZ), "codebook_q": unit(KQ),
            "cluster_size_z": rng.uniform(2, 5, KZ).astype(np.float32),
            "cluster_size_q": rng.uniform(2, 5, KQ).astype(np.float32),
            "embed_avg_z": rng.randn(KZ, E).astype(np.float32),
            "embed_avg_q": rng.randn(KQ, E).astype(np.float32),
            "initialized": np.asarray(True)}


def _f32_embed_sums(state):
    """The JAX HVQVAE's EMA sums in float32: its assignment sums are float32
    whatever the input (``preferred_element_type``), and its ``lax.cond``
    wants the state in that type, so in float64 the test rounds them back
    after each step (dead-code replacement would make them float64)."""
    vq = dict(state.aux["vqvae"]["vq"])
    for k in ("embed_avg_z", "embed_avg_q"):
        vq[k] = vq[k].astype(jnp.float32)
    return state.replace(aux={**state.aux, "vqvae": {"vq": vq}})


def _pair(film, train=False, mixed_precision=False, x64=False, **modes):
    """The JAX algo with perturbed weights and an initialized ``vq`` state,
    and the port's algo on the CPU with the same weights (the ``train``
    options @modes on both)."""
    rng = np.random.RandomState(0)
    batch = _batch(rng, film)
    jax_cfg = _configure(jax_config_factory("icl"), film, train, mixed_precision, **modes)
    JaxObsUtils.initialize_obs_utils_with_config(jax_cfg)
    jax_algo = JaxAlgo.algo_factory("icl", jax_cfg, _shapes(film), A)
    assert type(jax_algo).__name__ == "ICLTransformerHVQVAE"
    jax_algo.ensure_state(batch)
    pol, pol_flat = perturbed_variables(
        {"params": jax_algo.state.params["policy"], **jax_algo.state.aux["policy"]},
        5, kernel_scale=10.0, scale_under="net/transformer/")
    vq, vq_flat = perturbed_variables({"params": jax_algo.state.params["vqvae"]}, 6)
    vq["vq"] = _vq_state()
    vq_flat.update({f"vq/{k}": v for k, v in vq["vq"].items()})
    with jax.enable_x64(x64):
        dtype = jnp.float64 if x64 else jnp.float32
        cast = lambda a: jnp.asarray(a, dtype) if a.dtype == np.float32 else jnp.asarray(a)  # noqa: E731
        pol, vq = jax.tree_util.tree_map(cast, pol), jax.tree_util.tree_map(cast, vq)
        params = {"policy": pol.pop("params"), "vqvae": vq.pop("params")}
        jax_algo.state = _f32_embed_sums(jax_algo.state.replace(
            params=params, aux={"policy": pol, "vqvae": vq},
            opt_states={n: jax_algo.optimizers[n].init(params[n]) for n in params}))

    port_cfg = _configure(config_factory("icl"), film, train, mixed_precision, **modes)
    PortObsUtils.initialize_obs_utils_with_config(port_cfg)
    algo = PortAlgo.algo_factory("icl", port_cfg, _shapes(film), A, device="cpu")
    assert type(algo).__name__ == "ICLTransformerHVQVAE"
    if x64:
        algo.nets.double()
    load_jax_variables(algo.nets["policy"], pol_flat)
    load_jax_variables(algo.nets["vqvae"], vq_flat)
    return jax_algo, algo


@pytest.fixture(scope="module")
def served():
    """(film, JAX action, port action) for both configurations."""
    out = []
    try:
        for film in (False, True):
            jax_algo, algo = _pair(film)
            obs = _batch(np.random.RandomState(1), film)
            ctx = {"actions": obs["actions"]}
            want = np.asarray(jax_algo.get_action(obs["obs"], context_batch=ctx))
            out.append((film, want, algo.get_action(obs["obs"], ctx), algo))
    finally:
        set_pallas_pool(False)   # Algo.__init__ set the JAX package's flag
    return out


@pytest.mark.parametrize("config", [0, 1], ids=["serving_resnet18", "film_lang"])
def test_get_action_matches_jax(served, config):
    film, want, got, algo = served[config]
    assert got.shape == (B, A) and got.dtype == torch.float32
    assert not algo.nets.training
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_serving_backbone_is_resnet18_without_film(served):
    _, _, _, algo = served[0]
    core = algo.nets["policy"].net.encoder.nets["obs"].obs_nets[CAMS[0]]
    assert type(core.backbone).__name__ == "ResNet18Conv" and not core.film
    # the reference's layout: torchvision's children under nets.0 ... nets.7
    assert "nets.7.1.bn2.running_var" in core.backbone.state_dict()


def _state_pairs(got_module, want_module, buffers):
    got, want = got_module.state_dict(), want_module.state_dict()
    for k in got:
        is_buffer = k.endswith(("running_mean", "running_var")) or "." not in k
        if not k.endswith("num_batches_tracked") and is_buffer == buffers:
            yield k, got[k].double().numpy(), want[k].double().numpy()


@pytest.fixture(scope="module")
def trained():
    """Both algos through the same 3 batches in float64; then one validate
    call on the port."""
    rng = np.random.RandomState(2)
    batches = [_batch(rng, True) for _ in range(STEPS + 1)]
    try:
        jax_algo, algo = _pair(True, train=True, x64=True)
        metrics = []
        for batch in batches[:STEPS]:
            with jax.enable_x64():
                want = jax_algo.train_on_batch(batch, epoch=0)["losses"]
                jax_algo.state = _f32_embed_sums(jax_algo.state)
            got = algo.train_on_batch(batch, epoch=0)["losses"]
            metrics.append(({k: float(want[k]) for k in METRICS},
                            {k: float(got[k]) for k in METRICS}))
        expected = copy.deepcopy(algo.nets)
        state = jax_algo.state
        load_jax_variables(expected["policy"], flatten_variables(
            {"params": state.params["policy"], **state.aux["policy"]}))
        load_jax_variables(expected["vqvae"], flatten_variables(
            {"params": state.params["vqvae"], **state.aux["vqvae"]}))
        before = {k: v.clone() for k, v in algo.nets.state_dict().items()}
        validate = algo.train_on_batch(batches[STEPS], epoch=0, validate=True)
        log = algo.log_info({"losses": got})
    finally:
        set_pallas_pool(False)
    return dict(metrics=metrics, port=algo, expected=expected, log=log,
                validate=(before, algo.nets.state_dict(), validate["losses"]))


@pytest.mark.parametrize("step", range(STEPS))
def test_step_metrics_match_jax(trained, step):
    want, got = trained["metrics"][step]
    for k in METRICS:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("net", ["policy", "vqvae"])
def test_parameters_after_three_steps_match_jax(trained, net):
    pairs = list(_state_pairs(trained["port"].nets[net], trained["expected"][net],
                              buffers=False))
    assert len(pairs) == sum(1 for _ in trained["port"].nets[net].parameters())
    for k, got, want in pairs:
        assert_mostly_close(got, want, atol=1e-5, frac=0.99,
                            max_abs=2 * LR * STEPS, msg=f"{net}.{k}")


def test_batch_norm_statistics_after_three_steps_match_jax(trained):
    pairs = list(_state_pairs(trained["port"].nets["policy"],
                              trained["expected"]["policy"], buffers=True))
    assert len(pairs) == 2 * len(CAMS) * 20   # 20 BatchNorms per ResNet-18
    for k, got, want in pairs:
        assert_mostly_close(got, want, atol=1e-5, frac=0.95, max_abs=1e-4, msg=k)


def test_codebook_buffers_after_three_steps_match_jax(trained):
    """The EMA steps ran on identical assignments: the buffers agree to the
    JAX package's float32 similarity and assignment-sum products."""
    got = trained["port"].nets["vqvae"]
    want = trained["expected"]["vqvae"]
    assert got._initialized
    for k, v in want.named_buffers():
        np.testing.assert_allclose(getattr(got, k).double().numpy(),
                                   v.double().numpy(), atol=1e-5, rtol=1e-5, err_msg=k)


def test_validate_updates_nothing_and_logs_telemetry(trained):
    before, after, losses = trained["validate"]
    for k in before:
        assert torch.equal(before[k], after[k]), k
    assert not trained["port"].nets.training
    assert "policy_grad_norms" not in losses
    assert all(np.isfinite(float(v)) for v in losses.values())
    log = trained["log"]
    assert log["VQ-VAE/Z_Utilization"] == KZ and log["VQ-VAE/Z_Dead_Codes"] == 0
    assert log["Loss"] == log["L2_Loss"]


def reset_jax_modes():
    """The JAX package's process-wide ``train`` mode flags back to off."""
    set_pallas_pool(False)
    JaxBaseNets.set_frozen_batch_norm(False)
    JaxBaseNets.set_pool_free_stem(False)
    JaxObsNets.set_packed_rgb_encoders(False)


def _mixed_step(**modes):
    """One ``train.mixed_precision`` step of the FiLM flagship on both sides,
    with the ``train`` options @modes: (JAX losses, port losses, the port
    algo, a copy of its policy holding JAX's updated variables, the port's
    running statistics before the step)."""
    batch = _batch(np.random.RandomState(3), True)
    try:
        jax_algo, algo = _pair(True, train=True, mixed_precision=True, **modes)
        stats0 = {k: v.clone() for k, v in algo.nets["policy"].state_dict().items()
                  if k.endswith(("running_mean", "running_var"))}
        want = jax_algo.train_on_batch(batch, epoch=0)["losses"]
        got = algo.train_on_batch(batch, epoch=0)["losses"]
        expected = copy.deepcopy(algo.nets["policy"])
        state = jax_algo.state
        load_jax_variables(expected, flatten_variables(
            {"params": state.params["policy"], **state.aux["policy"]}))
    finally:
        reset_jax_modes()
    return want, got, algo, expected, stats0


@pytest.fixture(scope="module")
def mixed():
    return _mixed_step()


def assert_mixed_step_matches(want, got, algo):
    """A mixed-precision step's metrics against JAX's at the tolerances of
    the module docstring; the masters and their gradients fp32."""
    assert algo.mixed_precision
    for k in VQ_METRICS:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    for k in ("l2_loss", "action_loss", "policy_grad_norms"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=2e-2, err_msg=k)
    # the master weights and their gradients stay fp32
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in algo.nets.parameters())


def test_mixed_precision_step_matches_jax(mixed):
    want, got, algo, _, _ = mixed
    assert_mixed_step_matches(want, got, algo)


def test_mixed_precision_batch_norm_statistics_carry_the_bf16_rounding(mixed):
    """The JAX step casts the running statistics to bf16 before Flax updates
    them, so the update keeps 0.98828125 bf16(r) where an fp32 update would
    keep 0.99 r. The port's statistics agree with JAX's to the batch
    statistics' bf16 noise; the fp32 update misses by far more."""
    _, _, algo, expected, stats0 = mixed
    got, want = algo.nets["policy"].state_dict(), expected.state_dict()
    worst_port, worst_fp32 = 0.0, 0.0
    for k, r0 in stats0.items():
        # the batch statistic implied by the port's update, put into the
        # update an fp32 step would make
        kept = r0.bfloat16().float() * 0.98828125
        batch_stat = (got[k] - kept) / (1.0 - 0.99)
        fp32_update = 0.99 * r0 + (1.0 - 0.99) * batch_stat
        worst_port = max(worst_port, float((got[k] - want[k]).abs().max()))
        worst_fp32 = max(worst_fp32, float((fp32_update - want[k]).abs().max()))
    assert worst_port <= 1e-3
    assert worst_fp32 >= 5 * worst_port


@pytest.mark.parametrize("shape", [(8, 10, 10, 16), (32, 6, 6, 8)])
def test_batch_norm_bf16_matches_flax_with_bf16_statistics(shape):
    """Module level: a train-mode step on a bf16 input with bf16 weights, the
    running statistics arriving as bf16 (as the JAX step casts them), Flax
    under ``jax.jit`` as in the JAX train step: the output within one bf16
    rounding, the new fp32 statistics within 1e-6. (Run op by op, Flax would
    also round the product 0.98828125 bf16(r) to bf16; compiled, XLA keeps
    it in fp32.)"""
    n, hw, _, c = shape
    rng = np.random.RandomState(7)
    x = jnp.asarray(rng.randn(n, hw, hw, c) * 2 + 0.5, jnp.bfloat16)
    scale, bias = rng.uniform(0.5, 1.5, c), rng.randn(c)
    mean, var = rng.randn(c), rng.uniform(0.5, 2.0, c)
    half = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    variables = {"params": {"scale": half(scale), "bias": half(bias)},
                 "batch_stats": {"mean": half(mean), "var": half(var)}}
    y_j, upd = jax.jit(functools.partial(
        fnn.BatchNorm(use_running_average=False).apply, mutable=["batch_stats"]))(
        variables, x)
    port = BatchNorm2d(c).train()
    with torch.no_grad():
        port.running_mean.copy_(torch.from_numpy(mean))
        port.running_var.copy_(torch.from_numpy(var))
    xt = torch.from_numpy(np.asarray(x.astype(jnp.float32))).permute(0, 3, 1, 2).bfloat16()
    y_t = torch.func.functional_call(
        port, {"weight": torch.from_numpy(scale).bfloat16(),
               "bias": torch.from_numpy(bias).bfloat16()}, (xt,))
    assert y_t.dtype == torch.bfloat16 and port.running_mean.dtype == torch.float32
    y_t = y_t.float().permute(0, 2, 3, 1).numpy()
    y_j = np.asarray(y_j, np.float32)
    np.testing.assert_allclose(y_t, y_j, rtol=2 ** -7, atol=2 ** -7)
    for buf, key in ((port.running_mean, "mean"), (port.running_var, "var")):
        np.testing.assert_allclose(buf.numpy(), np.asarray(upd["batch_stats"][key]),
                                   atol=1e-6, rtol=1e-6)


def test_icl_routing_and_options_not_ported():
    """The JAX ``icl`` routing; the ``train`` speed modes, ported since,
    build and are applied to the algo's own modules (see
    tests/test_torch_train_modes.py and tests/test_torch_packed_film.py)."""
    cfg = _configure(config_factory("icl"), True)
    PortObsUtils.initialize_obs_utils_with_config(cfg)
    applied = {
        "frozen_batch_norm": lambda m: getattr(m, "frozen", False),
        "pool_free_stem": lambda m: getattr(m, "pool_free", False),
        "packed_rgb_encoders": lambda m: getattr(m, "packed", None) is not None,
    }
    for option, is_set in applied.items():
        on = copy.deepcopy(cfg)
        with on.values_unlocked():
            on.train[option] = True
        algo = PortAlgo.algo_factory("icl", on, _shapes(True), A, device="cpu")
        assert any(is_set(m) for m in algo.nets.modules()), option
    gmm = config_factory("icl_gmm_paper")
    with gmm.values_unlocked():
        gmm.observation.modalities.obs.low_dim = list(LOW_DIM)
        gmm.observation.modalities.obs.rgb = []
        gmm.train.mixed_precision = True
    PortObsUtils.initialize_obs_utils_with_config(gmm)
    assert PortAlgo.algo_factory("icl_gmm_paper", gmm, dict(LOW_DIM), A,
                                 device="cpu").mixed_precision
    routed = copy.deepcopy(cfg)
    with routed.values_unlocked():
        routed.algo.transformer.enabled = False
    with pytest.raises(NotImplementedError, match="ICL is not ported"):
        PortAlgo.algo_factory("icl", routed, _shapes(True), A, device="cpu")
    assert PortAlgo.REGISTERED_ALGOS["icl_hvqvae"](cfg.algo)[0].__name__ == \
        "ICLTransformerHVQVAE"


@pytest.mark.parametrize("supervise_all_steps,pred_future_acs",
                         [(True, True), (True, False), (False, False)])
def test_process_batch_for_training_matches_jax(served, supervise_all_steps,
                                                pred_future_acs):
    """The training window: the first T observation steps and the supervised
    actions, from a batch of 2T - 1 steps."""
    algo = served[0][3]
    jax_cfg = _configure(jax_config_factory("icl"), False)
    JaxObsUtils.initialize_obs_utils_with_config(jax_cfg)
    try:
        jax_algo = JaxAlgo.algo_factory("icl", jax_cfg, _shapes(False), A)
    finally:
        set_pallas_pool(False)
    rng = np.random.RandomState(8)
    batch = {"obs": {"eef_pos": rng.randn(B, 2 * T - 1, 3)},
             "actions": rng.randn(B, 2 * T - 1, A)}
    for a in (algo, jax_algo):
        a.supervise_all_steps, a.pred_future_acs = supervise_all_steps, pred_future_acs
    want = jax_algo.process_batch_for_training(batch)
    got = algo.process_batch_for_training(batch)
    np.testing.assert_array_equal(got["obs"]["eef_pos"], want["obs"]["eef_pos"])
    np.testing.assert_array_equal(got["actions"], want["actions"])
    algo.supervise_all_steps = algo.pred_future_acs = True
