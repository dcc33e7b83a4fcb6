"""``icl_gmm_paper`` under ``train.mixed_precision``: the port's bf16 paper
step and kernel 1's bf16 semantics against the JAX package's.

* The plain bf16 assign (``l2_nearest_plain`` on a bf16 codebook, z in fp32
  or bf16) against the TPU kernel run in interpret mode
  (``l2_nearest_pallas(..., interpret=True)``): the codes bit for bit, z_q
  in z's type. The codebook's gradient through ``l2_nearest`` against the
  TPU kernel's VJP, ``jax.ops.segment_sum``, to the bit; ``l2_nearest``
  refuses a bf16 z, which no model path gives it.
* 3 bf16 steps of the LipVQ paper policy (the configuration of
  tests/test_torch_icl_gmm_train.py: two 64x64 FiLM cameras, low-dim keys,
  a language embedding, ``train.pallas_pool``, 2 layers of width 32, T = 4,
  B = 8) against the JAX algo's from the same weights and batches. On the
  CPU the JAX LipVQ would take ``ops/quantize.py::l2_nearest`` (Pallas only
  on a TPU), which forms c_sq in bf16 and gathers z_q in bf16; the port
  follows the TPU kernel, so the JAX quantizer is pinned to
  ``l2_nearest_pallas(..., interpret=True)`` with ``monkeypatch`` inside the
  test (nothing in the JAX package changes). Tolerances, the flagship bf16
  test's (tests/test_torch_icl_hvqvae.py): the action loss, the
  log-probabilities and the gradient norm within 2 % (bf16 keeps 8 bits, and
  the two sides round the convolutions' and the MLPs' sums differently;
  measured 5.3e-4 to 1.2e-2); the LipVQ loss, fp32 from the latent layer's
  fp32 product on, within 1e-5 (measured 1.1e-6). The masters stay fp32 and
  move, ``get_action`` stays fp32 and unchanged by the mode.
* One bf16 step of each of the other four tokenizers (bin, LN-act, the
  default encoder, FAST) through tests/torch_icl_modality_harness.py's
  low-dimensional configuration, the metrics within 2 %, and the bin
  statistics to the bit: they round-trip through bf16. The JAX bf16 step of
  these four raises (its ``forward`` casts the absent LipVQ loss with
  ``jnp.asarray(None)``), so the JAX module's ``jnp`` is given a
  ``None``-safe ``asarray`` with ``monkeypatch`` inside the run; a fault of
  the JAX package that the port does not copy (ROADMAP.md Queue 3).
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import ml_dtypes

import robot_manipulation_vq_vae_tpu.algo as JaxAlgo
import robot_manipulation_vq_vae_tpu.algo.icl as JaxIcl
from robot_manipulation_vq_vae_tpu.config import config_factory as jax_config_factory
from robot_manipulation_vq_vae_tpu.models.base_nets import set_pallas_pool
from robot_manipulation_vq_vae_tpu.models.tokenizers import fast as JaxFast
from robot_manipulation_vq_vae_tpu.ops import quantize as JaxQ
from robot_manipulation_vq_vae_tpu.ops.pallas.lipvq_kernel import l2_nearest_pallas
from robot_manipulation_vq_vae_tpu.utils import obs_utils as JaxObsUtils

import robot_manipulation_vq_vae_tpu_torch.algo as PortAlgo
from robot_manipulation_vq_vae_tpu_torch.config import config_factory
from robot_manipulation_vq_vae_tpu_torch.ops import lipvq_kernel as K
from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils as PortObsUtils
from robot_manipulation_vq_vae_tpu_torch.utils.jax_weights import load_jax_variables
import test_torch_icl_gmm_train as Paper
import torch_icl_modality_harness as H
from torch_port_helpers import perturbed_variables

METRICS = ("log_probs", "action_loss", "policy_grad_norms", "vq_vae_loss")
STEPS = 3


# ---------------------------------------------------------------------------
# kernel 1's bf16 semantics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("z_type", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d,k", [(256, 976, 1024), (100, 37, 300)])
def test_plain_bf16_assign_matches_the_pallas_kernel(z_type, n, d, k):
    rng = np.random.RandomState(3)
    z = rng.rand(n, d).astype(np.float32)
    cb = rng.uniform(-0.5, 1.5, (k, d)).astype(ml_dtypes.bfloat16)
    z_j = jnp.asarray(z).astype(z_type)
    idx_x, zq_x = l2_nearest_pallas(z_j, jnp.asarray(cb), 512, True)
    z_t = torch.from_numpy(z).to(getattr(torch, z_type))
    cb_t = torch.from_numpy(cb.astype(np.float32)).bfloat16()
    idx, z_q = K.l2_nearest_plain(z_t, cb_t)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_x))
    assert z_q.dtype == z_t.dtype and str(zq_x.dtype) == z_type
    np.testing.assert_array_equal(z_q.float().numpy(), np.asarray(zq_x, np.float32))
    # the wrapper takes the plain version on CPU tensors
    idx_w, zq_w = K.l2_nearest_cuda(z_t, cb_t)
    assert torch.equal(idx_w, idx) and torch.equal(zq_w, z_q)


def test_assign_backward_sums_as_jax_does():
    """The codebook gradient through ``l2_nearest``: the JAX kernel's custom
    VJP, ``segment_sum`` of the cotangent in its type, to the bit; many rows
    per code, so that the order of the sums shows."""
    rng = np.random.RandomState(4)
    g = rng.randn(300, 8).astype(np.float32)
    z = torch.from_numpy(rng.rand(300, 8).astype(np.float32))
    cb = torch.from_numpy(rng.rand(7, 8).astype(np.float32)).requires_grad_(True)
    idx, z_q = K.l2_nearest(z, cb)
    z_q.backward(torch.from_numpy(g))
    assert len(set(idx.tolist())) >= 5
    want = jax.ops.segment_sum(jnp.asarray(g), jnp.asarray(idx.numpy()), num_segments=7)
    np.testing.assert_array_equal(cb.grad.numpy(), np.asarray(want))


def test_l2_nearest_refuses_a_bf16_z():
    """LipVQ's latent stays fp32 under mixed precision, so no path gives the
    differentiable assignment a bf16 z; it refuses one rather than sum a
    bf16 cotangent in another order than JAX's."""
    with pytest.raises(TypeError, match="bf16"):
        K.l2_nearest(torch.rand(4, 6, dtype=torch.bfloat16),
                     torch.rand(9, 6, dtype=torch.bfloat16))


def test_assign_backward_through_l2_nearest_takes_the_cotangent_type():
    z = torch.rand(40, 6)
    cb = torch.rand(9, 6, dtype=torch.bfloat16, requires_grad=True)
    idx, z_q = K.l2_nearest(z, cb)
    assert z_q.dtype == torch.float32
    (z_q * torch.arange(6.0)).sum().backward()
    want = torch.zeros(9, 6).index_add_(0, idx.long(), torch.arange(6.0).expand(40, 6))
    assert cb.grad.dtype == torch.bfloat16
    assert torch.equal(cb.grad, want.bfloat16())


# ---------------------------------------------------------------------------
# the whole bf16 paper step with LipVQ
# ---------------------------------------------------------------------------

def _pinned_pallas(z, codebook):
    return l2_nearest_pallas(z, codebook, 512, True)


def _jax_paper(cfg, shapes, batch0, modality=None):
    """The JAX algo with perturbed float32 weights; (algo, flat weights)."""
    JaxObsUtils.initialize_obs_utils_with_config(cfg)
    jax_algo = JaxAlgo.algo_factory("icl_gmm_paper", cfg, shapes, Paper.A)
    if modality == "fast":
        jax_algo.set_fast_tokenizer(JaxFast.FastActionTokenizer(
            output_dim=0, seq_len=H.T, host_encoder=H.stand_in(JaxFast.FastHostEncoder)))
    jax_algo.ensure_state(batch0)
    variables = {"params": jax_algo.state.params["policy"], **jax_algo.state.aux["policy"]}
    nested, flat = perturbed_variables(variables, 5, kernel_scale=10.0,
                                       scale_under="net/transformer/")
    if modality == "bin":
        stats = nested["bin_stats"]["net"]["encoder"]["action_network"]
        stats["num_step"] = np.asarray(stats["num_step"], np.int32)
    params = jax.tree_util.tree_map(jnp.asarray, nested.pop("params"))
    opt_states = {"policy": jax_algo.optimizers["policy"].init(params)}
    if "vq_tokenizer" in jax_algo.optimizers:
        opt_states["vq_tokenizer"] = jax_algo.optimizers["vq_tokenizer"].init(
            params["net"]["encoder"]["action_network"])
    jax_algo.state = jax_algo.state.replace(
        params={"policy": params}, aux={"policy": jax.tree_util.tree_map(jnp.asarray, nested)},
        opt_states=opt_states)
    return jax_algo, flat


def _mixed(cfg):
    with cfg.values_unlocked():
        cfg.train.mixed_precision = True
    return cfg


@pytest.fixture(scope="module")
def paper():
    mp = pytest.MonkeyPatch()
    mp.setattr(JaxQ, "l2_nearest", _pinned_pallas)
    try:
        rng = np.random.RandomState(0)
        batches = [Paper._batch(rng) for _ in range(STEPS)]
        jax_algo, flat = _jax_paper(_mixed(Paper._configure(
            jax_config_factory("icl_gmm_paper"))), Paper.OBS_KEY_SHAPES, batches[0])
        cfg = _mixed(Paper._configure(config_factory("icl_gmm_paper")))
        PortObsUtils.initialize_obs_utils_with_config(cfg)
        algo = PortAlgo.algo_factory("icl_gmm_paper", cfg, Paper.OBS_KEY_SHAPES,
                                     Paper.A, device="cpu")
        load_jax_variables(algo.nets["policy"], flat)
        plain_cfg = Paper._configure(config_factory("icl_gmm_paper"))
        fp32 = PortAlgo.algo_factory("icl_gmm_paper", plain_cfg, Paper.OBS_KEY_SHAPES,
                                     Paper.A, device="cpu")
        load_jax_variables(fp32.nets["policy"], flat)
        start = copy.deepcopy(algo.nets.state_dict())
        metrics = []
        for b in batches:
            want = jax_algo.train_on_batch(b, epoch=0)["losses"]
            got = algo.train_on_batch(b, epoch=0)["losses"]
            metrics.append(({k: float(want[k]) for k in METRICS},
                            {k: float(got[k]) for k in METRICS}))
    finally:
        mp.undo()
        set_pallas_pool(False)
    return dict(metrics=metrics, port=algo, fp32=fp32, start=start, batches=batches)


@pytest.mark.parametrize("step", range(STEPS))
def test_bf16_paper_step_matches_jax(paper, step):
    want, got = paper["metrics"][step]
    for k in METRICS:
        rtol = 1e-5 if k == "vq_vae_loss" else 2e-2
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=k)


def test_bf16_paper_step_keeps_fp32_masters_and_moves_them(paper):
    algo = paper["port"]
    assert algo.mixed_precision
    for name, p in algo.nets.named_parameters():
        assert p.dtype == torch.float32, name
    for name, buf in algo.nets.named_buffers():
        assert buf.dtype in (torch.float32, torch.int32, torch.int64), name
    moved = [not torch.equal(p, paper["start"][n])
             for n, p in algo.nets.state_dict().items() if "num_batches" not in n]
    assert sum(moved) > 0.9 * len(moved)


def test_get_action_stays_fp32_under_mixed_precision(paper):
    """``get_action`` ignores the mode: the same weights served by an fp32
    algo give the same GMM to the bit."""
    algo, fp32 = paper["port"], paper["fp32"]
    fp32.nets.load_state_dict(algo.nets.state_dict())
    b = paper["batches"][0]
    half = len(b["actions"]) // 2
    obs = {k: v[:half] for k, v in b["obs"].items()}
    ctx = {"obs": {k: v[half:] for k, v in b["obs"].items()}, "actions": b["actions"][half:]}
    d1, _ = algo.action_distribution(obs, ctx)
    d2, _ = fp32.action_distribution(obs, ctx)
    for name in ("means", "scales", "logits"):
        t = getattr(d1, name)
        assert t.dtype == torch.float32 and torch.equal(t, getattr(d2, name)), name


# ---------------------------------------------------------------------------
# one bf16 step of each of the other tokenizers
# ---------------------------------------------------------------------------

class _NoneSafeJnp:
    """``jax.numpy`` whose ``asarray(None)`` is None (the JAX bf16 step casts
    the LipVQ loss whether or not there is one)."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def asarray(a, *args, **kwargs):
        return None if a is None else jnp.asarray(a, *args, **kwargs)


@pytest.mark.parametrize("modality", ["bin", "ln_act", "default", "fast"])
def test_bf16_step_of_each_other_tokenizer_matches_jax(modality, monkeypatch):
    monkeypatch.setattr(JaxIcl, "jnp", _NoneSafeJnp())
    monkeypatch.setattr(H.JaxDefault, "TorchTransformerEncoderLayer",
                        H._JaxLayerWithoutDropout)
    batch = H.batch(np.random.RandomState(0))
    jax_algo, flat = _jax_paper(_mixed(H.configure(jax_config_factory("icl_gmm_paper"),
                                                   modality)),
                                dict(H.LOW_DIM), batch, modality)
    cfg = _mixed(H.configure(config_factory("icl_gmm_paper"), modality))
    PortObsUtils.initialize_obs_utils_with_config(cfg)
    algo = PortAlgo.algo_factory("icl_gmm_paper", cfg, dict(H.LOW_DIM), H.A, device="cpu")
    if modality == "fast":
        algo.set_fast_tokenizer(H.stand_in(H.PortFast.FastHostEncoder))
    for m in algo.nets.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    load_jax_variables(algo.nets["policy"], flat)
    want = jax_algo.train_on_batch(batch, epoch=0)["losses"]
    got = algo.train_on_batch(batch, epoch=0)["losses"]
    assert set(got) == set(H.METRICS)
    for k in H.METRICS:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=2e-2, err_msg=k)
    if modality == "bin":
        stats = jax_algo.state.aux["policy"]["bin_stats"]["net"]["encoder"]["action_network"]
        net = algo.nets["policy"].net.encoder.action_network
        for name in ("running_min", "running_max"):
            got_s = getattr(net, name)
            assert got_s.dtype == torch.float32
            np.testing.assert_array_equal(got_s.numpy(), np.asarray(stats[name]))
            assert torch.equal(got_s, got_s.bfloat16().float()), name
