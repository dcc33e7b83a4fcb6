"""The shared run of the ``test_torch_icl_modalities_*.py`` files:
``icl_gmm_paper`` (``ICLTransformer_GMM``) with one of the four other action
tokenizers (bin, LN-act, the default encoder, FAST; LipVQ off), the JAX
package's algo and the port's from the same carried-over weights through the
same 3 numpy batches, in float64 on both sides (``jax.enable_x64``;
``nets.double()``), as ``test_torch_icl_gmm_train.py`` runs the LipVQ path.

Small size: low-dimensional observations only (9 features, so the default
encoder runs one head), 2 layers, width 32, 4 heads, T = 4, B = 8 (4 context
sequences, 4 supervised). The transformer's dropouts are 0; the default
encoder's fixed 0.1 dropout is switched off on both sides inside the run
only (the JAX layer class is replaced in its module's namespace by one with
dropout 0, the port's dropouts get p = 0), and
``test_torch_tokenizer_modalities.py`` shows that the port applies it. FAST
runs both packages' host encoders on ``chip_smoke.py``'s deterministic
stand-ins for the FAST processor and CLIP.

Tolerances, in float64: metrics within 1e-6 relative (the JAX GPT computes
its attention products with ``preferred_element_type=float32``, so its
float64 losses carry float32 rounding: measured up to 2.5e-8 relative);
parameters after 3 Adam steps at lr 1e-4 with at least 99 % of each tensor
within 1e-9 and every element within 2 lr per step (a weight whose gradient
lies within rounding of 0 may move the other way); the bin statistics equal
to the bit, the spectral vectors within 1e-9; the served GMM's parameters
within 1e-4."""

import copy
import io

import numpy as np
import torch

import jax
import jax.numpy as jnp

from robot_manipulation_vq_vae_tpu.algo.algo import device_process_obs
from robot_manipulation_vq_vae_tpu.config import config_factory as jax_config_factory
from robot_manipulation_vq_vae_tpu.models.tokenizers import default_encoder as JaxDefault
from robot_manipulation_vq_vae_tpu.models.tokenizers import fast as JaxFast
from robot_manipulation_vq_vae_tpu.utils import obs_utils as JaxObsUtils
from robot_manipulation_vq_vae_tpu.utils.ckpt_conversion import flatten_variables

import robot_manipulation_vq_vae_tpu_torch.algo as PortAlgo
from robot_manipulation_vq_vae_tpu_torch.config import config_factory
from robot_manipulation_vq_vae_tpu_torch.models.base_nets import Dropout
from robot_manipulation_vq_vae_tpu_torch.models.tokenizers import fast as PortFast
from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils as PortObsUtils
from robot_manipulation_vq_vae_tpu_torch.utils.jax_weights import (
    load_jax_variables,
)
from chip_smoke import SmokeFastProcessor, smoke_clip_encode
from torch_port_helpers import assert_mostly_close, jax_algo_jit_init, perturbed_variables

B, T, A, STEPS, LR = 8, 4, 12, 3, 1e-4
LOW_DIM = {"eef_pos": (3,), "eef_quat": (4,), "gripper_qpos": (2,)}
FLAGS = {"bin": "bin_enabled", "ln_act": "ln_act_enabled", "fast": "fast_enabled",
         "default": None}
METRICS = ("log_probs", "action_loss", "policy_grad_norms")


def configure(cfg, modality):
    """@cfg at the small size with @modality's tokenizer and LipVQ off."""
    with cfg.values_unlocked():
        cfg.observation.modalities.obs.low_dim = list(LOW_DIM)
        cfg.observation.modalities.obs.rgb = []
        tc = cfg.algo.transformer
        tc.context_length, tc.embed_dim, tc.num_layers, tc.num_heads = T, 32, 2, 4
        tc.emb_dropout = tc.attn_dropout = tc.block_output_dropout = 0.0
        for flag in FLAGS.values():
            if flag:
                tc[flag] = False
        tc.vq_vae_enabled = False
        if FLAGS[modality]:
            tc[FLAGS[modality]] = True
        lr = cfg.algo.optim_params.policy.learning_rate
        lr.initial, lr.scheduler_type = LR, None
        cfg.algo.optim_params.policy.regularization.L2 = 1e-2
        cfg.train.max_grad_norm = 1.0
    return cfg


def stand_in(cls):
    """A FastHostEncoder of class @cls (either package's) on the stand-ins."""
    return cls.from_components(SmokeFastProcessor(), smoke_clip_encode)


class _JaxLayerWithoutDropout(JaxDefault.TorchTransformerEncoderLayer):
    dropout: float = 0.0


def port_algo(modality):
    cfg = configure(config_factory("icl_gmm_paper"), modality)
    PortObsUtils.initialize_obs_utils_with_config(cfg)
    algo = PortAlgo.algo_factory("icl_gmm_paper", cfg, dict(LOW_DIM), A, device="cpu")
    if modality == "fast":
        algo.set_fast_tokenizer(stand_in(PortFast.FastHostEncoder))
    for m in algo.nets.modules():
        if isinstance(m, Dropout) and m.whole:   # the default encoder's
            m.p = 0.0
    return algo


def batch(rng, b=B):
    obs = {k: rng.randn(b, T, *s).astype(np.float32) for k, s in LOW_DIM.items()}
    return {"obs": obs, "actions": rng.uniform(-1, 1, (b, T, A)).astype(np.float32)}


def _float64(tree):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.int32 if np.issubdtype(np.asarray(a).dtype, np.integer)
                              else jnp.float64), tree)


def run_modality(modality, monkeypatch):
    """Both algos through 3 training steps, then what the checks compare:
    the metrics of each step, the port algo, a copy of its policy holding
    JAX's state, the served GMMs of a B = 2 request, and a validate call."""
    monkeypatch.setattr(JaxDefault, "TorchTransformerEncoderLayer",
                        _JaxLayerWithoutDropout)
    rng = np.random.RandomState(0)
    batches = [batch(rng) for _ in range(STEPS + 1)]

    jax_cfg = configure(jax_config_factory("icl_gmm_paper"), modality)
    JaxObsUtils.initialize_obs_utils_with_config(jax_cfg)
    jax_algo = jax_algo_jit_init("icl_gmm_paper", jax_cfg, dict(LOW_DIM), A)
    if modality == "fast":
        jax_algo.set_fast_tokenizer(JaxFast.FastActionTokenizer(
            output_dim=0, seq_len=T,
            host_encoder=stand_in(JaxFast.FastHostEncoder)))
    jax_algo.ensure_state(batches[0])
    assert set(jax_algo.state.opt_states) == {"policy"}
    variables = {"params": jax_algo.state.params["policy"], **jax_algo.state.aux["policy"]}
    nested, flat = perturbed_variables(variables, 5, kernel_scale=10.0,
                                       scale_under="net/transformer/")
    with jax.enable_x64():
        nested = _float64(nested)
        if modality == "bin":   # perturbed_variables made every leaf float32
            stats = nested["bin_stats"]["net"]["encoder"]["action_network"]
            stats["num_step"] = jnp.asarray(stats["num_step"], jnp.int32)
        params = nested.pop("params")
        jax_algo.state = jax_algo.state.replace(
            params={"policy": params}, aux={"policy": nested},
            opt_states={"policy": jax_algo.optimizers["policy"].init(params)})

    algo = port_algo(modality)
    algo.nets.double()
    load_jax_variables(algo.nets["policy"], flat)
    assert set(algo.optimizers) == {"policy"}

    metrics = []
    for b in batches[:STEPS]:
        with jax.enable_x64():
            want = jax_algo.train_on_batch(b, epoch=0)["losses"]
        got = algo.train_on_batch(b, epoch=0)["losses"]
        metrics.append(({k: float(v) for k, v in want.items()},
                        {k: float(v) for k, v in got.items()}))
    expected = copy.deepcopy(algo.nets["policy"])
    load_jax_variables(expected, flatten_variables(
        {"params": jax_algo.state.params["policy"], **jax_algo.state.aux["policy"]}))

    request = batch(np.random.RandomState(1), b=2)
    ctx = batch(np.random.RandomState(2), b=2)
    policy = jax_algo.nets["policy"]
    jobs = lambda o: device_process_obs({k: jnp.asarray(v) for k, v in o.items()})  # noqa: E731
    with jax.enable_x64():
        dist_j, _ = policy.apply(
            {"params": jax_algo.state.params["policy"], **jax_algo.state.aux["policy"]},
            jobs(request["obs"]), jobs(ctx["obs"]),
            jax_algo._maybe_fast_latents(jnp.asarray(ctx["actions"])),
            train=False, method=policy.forward_train)
        dist_j = {n: np.asarray(getattr(dist_j, n)) for n in ("means", "scales", "logits")}
    dist_t, vq_loss = algo.action_distribution(request["obs"], ctx)

    before = {k: v.clone() for k, v in algo.nets.state_dict().items()}
    validate = algo.train_on_batch(batches[STEPS], epoch=0, validate=True)["losses"]
    with jax.enable_x64():
        jax_validate = jax_algo._train_step_jit(jax_algo.state, jax_algo_batch(batches[STEPS]),
                                                True)[1]
    return dict(modality=modality, metrics=metrics, port=algo, expected=expected,
                gmm=(dist_j, dist_t, vq_loss), request=(request, ctx),
                validate=(before, algo.nets.state_dict(), validate,
                          {k: float(v) for k, v in jax_validate.items()}))


def jax_algo_batch(b):
    return {"obs": {k: jnp.asarray(v) for k, v in b["obs"].items()},
            "actions": jnp.asarray(b["actions"])}


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------

def check_step_metrics(run, step):
    want, got = run["metrics"][step]
    assert set(got) == set(METRICS) == set(want), (sorted(got), sorted(want))
    for k in METRICS:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)


def _pairs(run):
    got = run["port"].nets["policy"].state_dict()
    want = run["expected"].state_dict()
    assert set(got) == set(want)
    return [(k, got[k].numpy(), want[k].numpy()) for k in got]


def check_parameters(run):
    names = {n for n, _ in run["port"].nets["policy"].named_parameters()}
    pairs = [p for p in _pairs(run) if p[0] in names]
    assert len(pairs) == len(names)
    for k, got, want in pairs:
        assert_mostly_close(got, want, atol=1e-9, frac=0.99, max_abs=2 * LR * STEPS, msg=k)
    # the tokenizer trained: the NLL reached its parameters
    tokenizer = run["port"].nets["policy"].net.encoder.action_network
    assert all(bool(p.grad.abs().max() > 0) for p in tokenizer.parameters())


def check_buffers(run):
    """The bin statistics to the bit (3 forwards counted); the spectral
    vectors within 1e-9 (each moved by every training forward)."""
    names = {n for n, _ in run["port"].nets["policy"].named_buffers()}
    pairs = [p for p in _pairs(run) if p[0] in names]
    if run["modality"] == "bin":
        assert sorted(k.rsplit(".", 1)[-1] for k, _, _ in pairs) == [
            "num_step", "running_max", "running_min"]
        for k, got, want in pairs:
            np.testing.assert_array_equal(got, want, err_msg=k)
            if k.endswith("num_step"):
                assert int(got) == STEPS
    elif run["modality"] == "default":
        assert len(pairs) == 3 and all(k.endswith(".u") for k, _, _ in pairs)
        for k, got, want in pairs:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-9, err_msg=k)
    else:
        assert not pairs


def check_gmm(run):
    dist_j, dist_t, vq_loss = run["gmm"]
    assert vq_loss is None
    for name in ("means", "scales", "logits"):
        np.testing.assert_allclose(getattr(dist_t, name).numpy(), dist_j[name],
                                   atol=1e-4, rtol=1e-4, err_msg=name)


def check_validate(run):
    before, after, losses, jax_losses = run["validate"]
    for k in before:
        assert torch.equal(before[k], after[k]), k
    assert set(losses) == {"log_probs", "action_loss"}
    for k in losses:
        np.testing.assert_allclose(float(losses[k]), jax_losses[k], rtol=1e-6, err_msg=k)


def check_round_trip(run):
    """serialize -> a .pth in memory -> a fresh algo: every tensor (the
    tokenizer's buffers included) and the served GMM equal to the bit."""
    algo = run["port"]
    buf = io.BytesIO()
    torch.save(algo.serialize(include_optimizer=True), buf)
    buf.seek(0)
    fresh = port_algo(run["modality"])
    fresh.nets.double()
    fresh.deserialize(torch.load(buf, weights_only=False))
    got, want = fresh.nets.state_dict(), algo.nets.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    request, ctx = run["request"]
    d1, _ = fresh.action_distribution(request["obs"], ctx)
    d2, _ = algo.action_distribution(request["obs"], ctx)
    for name in ("means", "scales", "logits"):
        assert torch.equal(getattr(d1, name), getattr(d2, name)), name
