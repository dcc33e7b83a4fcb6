"""``icl_mamba`` under ``train.mixed_precision``: the port's bf16 modules and
steps against the JAX package's, from the same carried-over weights (every
leaf made random) and the same seeded numpy inputs.

* Modules: ``MambaBlock`` and ``Mamba_Backbone`` (3 layers of width 32 over
  12 tokens) through ``half_call`` against the JAX modules applied to bf16
  casts of the variables and inputs: the output's type and every value
  within 2e-2 of the output's largest |value|. JAX pairs the scan's
  multiply-adds by ``lax.associative_scan``'s odd/even tree and the port
  loops over T, so in bf16 each side rounds other partial products (the
  port's C . h is one product, as JAX's einsum is; measured 4e-3 to 9e-3).
* ``ICLMamba_GMM`` with LipVQ (2 Mamba layers of width 32, T = 4, B = 8 as
  4 context and 4 supervised sequences, low-dimensional observations): 3
  bf16 steps against the JAX algo's (its bf16 step is the paper step the
  JAX class inherits), the JAX LipVQ pinned to the TPU kernel's semantics
  (``l2_nearest_pallas(..., interpret=True)``, ``monkeypatch`` inside the
  fixture; see tests/test_torch_icl_gmm_bf16.py). The log-probabilities,
  the action loss and the gradient norm within 2 %, the LipVQ loss (fp32
  from the latent layer on) within 1e-5; the masters stay fp32 and move,
  and ``get_action`` is the fp32 algo's to the bit from the same weights.
* ``ICLMambaHVQVAE``: one bf16 step (the flagship's bf16 step) with the
  HVQVAE's draws pinned as tests/test_torch_icl_mamba.py pins them: the
  policy's metrics within 2 %, the HVQVAE's (fp32) within 1e-5.
"""

import copy

import numpy as np
import pytest
import torch

import jax

from robot_manipulation_vq_vae_tpu.config import config_factory as jax_config_factory
from robot_manipulation_vq_vae_tpu.models import obs_nets as JaxObsNets
from robot_manipulation_vq_vae_tpu.models.tokenizers import ln_act as JaxLnAct
from robot_manipulation_vq_vae_tpu.ops import quantize as JaxQ
from robot_manipulation_vq_vae_tpu.ops.pallas.lipvq_kernel import l2_nearest_pallas

import robot_manipulation_vq_vae_tpu_torch.algo as PortAlgo
from robot_manipulation_vq_vae_tpu_torch.config import config_factory
from robot_manipulation_vq_vae_tpu_torch.models import obs_nets as PortObsNets
from robot_manipulation_vq_vae_tpu_torch.models.tokenizers import ln_act as PortLnAct
from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils as PortObsUtils
from robot_manipulation_vq_vae_tpu_torch.utils.jax_weights import load_jax_variables
from test_torch_icl_hvqvae import _f32_embed_sums, _vq_state
from test_torch_icl_mamba import LOW_DIM, POLICY_METRICS, VQ_METRICS, A, T, _batch, \
    _configure, _port_encoding
from torch_bf16_helpers import assert_half_close, init_pair, jax_half_apply, \
    port_half_apply
from torch_bf16_helpers import one_torch_thread  # noqa: F401 (autouse)
from torch_port_helpers import jax_algo_jit_init, perturbed_variables, set_jax_state

GMM_METRICS = ("log_probs", "action_loss", "policy_grad_norms")
STEPS = 3


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layers", [None, 3], ids=["block", "backbone"])
def test_mamba_bf16_matches_jax(layers):
    x = np.random.RandomState(0).randn(3, 3 * T, 32)
    if layers is None:
        jax_m, port = JaxLnAct.MambaBlock(d_model=32, d_state=16), PortLnAct.MambaBlock(32, 16)
    else:
        jax_m = JaxObsNets.Mamba_Backbone(embed_dim=32, num_layers=layers)
        port = PortObsNets.Mamba_Backbone(32, layers)
    nested = init_pair(jax_m, port, [x])
    want = jax_half_apply(jax_m, nested, [x])
    got = port_half_apply(port, [x])
    assert got.dtype == torch.bfloat16
    assert_half_close(got, want, msg="mamba")


# ---------------------------------------------------------------------------
# the algos
# ---------------------------------------------------------------------------

def _mixed(cfg, layers=2):
    with cfg.values_unlocked():
        cfg.train.mixed_precision = True
        cfg.algo.mamba.num_layers = layers
    return cfg


def _pinned_pallas(z, codebook):
    return l2_nearest_pallas(z, codebook, 512, True)


@pytest.fixture(scope="module")
def mamba_gmm():
    """ICLMamba_GMM with LipVQ: 3 bf16 steps on both sides."""
    mp = pytest.MonkeyPatch()
    mp.setattr(JaxQ, "l2_nearest", _pinned_pallas)
    try:
        rng = np.random.RandomState(0)
        batches = [_batch(rng) for _ in range(STEPS)]
        jax_algo = jax_algo_jit_init(
            "icl_mamba", _mixed(_configure(jax_config_factory("icl_mamba"), gmm=True)),
            dict(LOW_DIM), A)
        jax_algo.ensure_state(jax_algo.process_batch_for_training(batches[0]))
        nested, flat = perturbed_variables({"params": jax_algo.state.params["policy"]}, 5)
        set_jax_state(jax_algo, {"policy": nested})
        jax_algo.state = jax_algo.state.replace(opt_states={
            **jax_algo.state.opt_states,
            "vq_tokenizer": jax.jit(jax_algo.optimizers["vq_tokenizer"].init)(
                jax_algo.state.params["policy"]["net"]["encoder"]["action_network"])})
        cfg = _mixed(_configure(config_factory("icl_mamba"), gmm=True))
        PortObsUtils.initialize_obs_utils_with_config(cfg)
        algo = PortAlgo.algo_factory("icl_mamba", cfg, dict(LOW_DIM), A, device="cpu")
        load_jax_variables(algo.nets["policy"], flat)
        plain = _configure(config_factory("icl_mamba"), gmm=True)
        with plain.values_unlocked():
            plain.algo.mamba.num_layers = 2
        fp32 = PortAlgo.algo_factory("icl_mamba", plain, dict(LOW_DIM), A, device="cpu")
        start = copy.deepcopy(algo.nets.state_dict())
        metrics = []
        for b in batches:
            want = jax_algo.train_on_batch(jax_algo.process_batch_for_training(b),
                                           epoch=0)["losses"]
            got = algo.train_on_batch(algo.process_batch_for_training(b), epoch=0)["losses"]
            metrics.append(({k: float(v) for k, v in want.items()},
                            {k: float(v) for k, v in got.items()}))
    finally:
        mp.undo()
    return dict(port=algo, fp32=fp32, start=start, metrics=metrics)


@pytest.mark.parametrize("step", range(STEPS))
def test_mamba_gmm_bf16_step_matches_jax(mamba_gmm, step):
    want, got = mamba_gmm["metrics"][step]
    assert set(got) == set(want)
    for k in GMM_METRICS:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-2, err_msg=k)
    np.testing.assert_allclose(got["vq_vae_loss"], want["vq_vae_loss"], rtol=1e-5)


def test_mamba_gmm_bf16_keeps_fp32_masters_and_moves_them(mamba_gmm):
    algo = mamba_gmm["port"]
    assert algo.mixed_precision and isinstance(algo, PortAlgo.ICLMamba_GMM)
    assert all(p.dtype == torch.float32 for p in algo.nets.parameters())
    moved = [not torch.equal(p, mamba_gmm["start"][n])
             for n, p in algo.nets.state_dict().items()]
    assert sum(moved) > 0.9 * len(moved)


def test_mamba_gmm_get_action_stays_fp32(mamba_gmm):
    algo, fp32 = mamba_gmm["port"], mamba_gmm["fp32"]
    fp32.nets.load_state_dict(algo.nets.state_dict())
    req, ctx = _batch(np.random.RandomState(1), b=2), _batch(np.random.RandomState(2), b=2)
    d1, _ = algo.action_distribution(req["obs"], ctx)
    d2, _ = fp32.action_distribution(req["obs"], ctx)
    for name in ("means", "scales", "logits"):
        t = getattr(d1, name)
        assert t.dtype == torch.float32 and torch.equal(t, getattr(d2, name)), name


def test_mamba_hvqvae_bf16_step_matches_jax(monkeypatch):
    monkeypatch.setattr(JaxObsNets, "sinusoidal_positional_encoding", _port_encoding)
    batch = _batch(np.random.RandomState(3), t=2 * T - 1)
    jax_algo = jax_algo_jit_init(
        "icl_mamba", _mixed(_configure(jax_config_factory("icl_mamba"), gmm=False), 1),
        dict(LOW_DIM), A)
    jax_algo.ensure_state(jax_algo.process_batch_for_training(batch))
    pol, pol_flat = perturbed_variables({"params": jax_algo.state.params["policy"]}, 5,
                                        kernel_scale=10.0, scale_under="net/transformer/")
    vq, vq_flat = perturbed_variables({"params": jax_algo.state.params["vqvae"]}, 6)
    vq["vq"] = _vq_state()
    vq_flat.update({f"vq/{k}": v for k, v in vq["vq"].items()})
    set_jax_state(jax_algo, {"policy": pol, "vqvae": vq})
    jax_algo.state = _f32_embed_sums(jax_algo.state)
    cfg = _mixed(_configure(config_factory("icl_mamba"), gmm=False), 1)
    PortObsUtils.initialize_obs_utils_with_config(cfg)
    algo = PortAlgo.algo_factory("icl_mamba", cfg, dict(LOW_DIM), A, device="cpu")
    assert isinstance(algo, PortAlgo.ICLMambaHVQVAE) and algo.mixed_precision
    load_jax_variables(algo.nets["policy"], pol_flat)
    load_jax_variables(algo.nets["vqvae"], vq_flat)
    want = jax_algo.train_on_batch(jax_algo.process_batch_for_training(batch),
                                   epoch=0)["losses"]
    got = algo.train_on_batch(algo.process_batch_for_training(batch), epoch=0)["losses"]
    for k in VQ_METRICS:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    for k in POLICY_METRICS:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=2e-2, err_msg=k)
    assert all(p.dtype == torch.float32 for p in algo.nets.parameters())
