"""``icl_mamba`` and the model options it needs, the port's against the JAX
package's, in float64 on both sides (``jax.enable_x64``; ``nets.double()``)
from the same carried-over weights (every leaf made random) and the same
seeded numpy inputs.

* Modules: ``Mamba_Backbone`` within 1e-9 (JAX scans with
  ``lax.associative_scan``, the port loops over T: the products of
  ``exp(dt A)`` are taken in another order); ``RNNBase`` (the LSTM on
  ``nn.LSTM``'s stacked tensors, and the GRU in Flax's layout) from a given
  state, outputs, carries and gradients within 1e-10; ``GEGLU`` within
  1e-10, and a GPT block with it at JAX's parameter shapes (within the
  float32 rounding of JAX's attention products); the embedding with the
  sinusoidal encoding within 1e-10, the encoding itself being a float32
  constant on both sides that each framework's float32 ``exp`` / ``sin`` /
  ``cos`` round a little differently (held within t * 1e-7, and within
  float32 rounding of the float64 values).
* ``ICLMamba_GMM`` with LipVQ (a 2-layer backbone of width 32, T = 4, B = 8
  as 4 context and 4 supervised sequences, low-dimensional observations):
  3 steps, metrics within 1e-8 relative, parameters within 1e-8 of each
  tensor's largest; then the GMM of a request within 1e-10.
* ``ICLMambaHVQVAE``: the transformer actor read from ``algo.mamba``, here
  with GEGLU and the sinusoidal encoding (JAX's encoding replaced by the
  port's float32 one inside the run, see above), the HVQVAE's draws pinned
  as tests/test_torch_icl_hvqvae.py pins them (codebooks initialized with
  counts of at least 2: no k-means, no dead code): 2 steps. The policy's
  metrics and parameters are held as above; the HVQVAE's losses and
  parameters to the JAX HVQVAE's float32 (its assignment and EMA products
  are float32 whatever the input).

The image policy of the family, through the stem pool, is held in
tests/test_torch_icl_image.py.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import robot_manipulation_vq_vae_tpu.algo as JaxAlgo
from robot_manipulation_vq_vae_tpu.algo.algo import device_process_obs
from robot_manipulation_vq_vae_tpu.config import config_factory as jax_config_factory
from robot_manipulation_vq_vae_tpu.models import base_nets as JaxBaseNets
from robot_manipulation_vq_vae_tpu.models import obs_nets as JaxObsNets
from robot_manipulation_vq_vae_tpu.models import transformers as JaxTx
from robot_manipulation_vq_vae_tpu.utils.ckpt_conversion import flatten_variables

import robot_manipulation_vq_vae_tpu_torch.algo as PortAlgo
from robot_manipulation_vq_vae_tpu_torch.config import config_factory
from robot_manipulation_vq_vae_tpu_torch.models import base_nets as PortBaseNets
from robot_manipulation_vq_vae_tpu_torch.models import obs_nets as PortObsNets
from robot_manipulation_vq_vae_tpu_torch.models import transformers as PortTx
from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils as PortObsUtils
from robot_manipulation_vq_vae_tpu_torch.utils.jax_weights import load_jax_variables
from test_torch_icl_hvqvae import E, KQ, KZ, _f32_embed_sums, _vq_state
from torch_port_helpers import (
    check_parameters,
    check_step_metrics,
    float64_tree,
    jax_algo_jit_init,
    perturbed_variables,
)
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

B, T, A, LR = 8, 4, 12, 1e-4
LOW_DIM = {"eef_pos": (3,), "eef_quat": (4,), "gripper_qpos": (2,)}


def _module_pair(jax_module, port_module, x, seed=1, **apply_kw):
    """JAX's variables (made random) in both modules; JAX's float64 apply."""
    variables = jax.jit(jax_module.init)(jax.random.PRNGKey(0), jnp.asarray(x, jnp.float32),
                                         **apply_kw)
    nested, flat = perturbed_variables(variables, seed)
    load_jax_variables(port_module.double(), flat)
    return float64_tree(nested)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def test_mamba_backbone_matches_jax():
    x = np.random.RandomState(0).randn(3, 3 * T, 32)
    jax_m, port = JaxObsNets.Mamba_Backbone(embed_dim=32, num_layers=2), \
        PortObsNets.Mamba_Backbone(32, 2)
    with jax.enable_x64():
        variables = _module_pair(jax_m, port, x)
        want = np.asarray(jax.jit(jax_m.apply)(variables, jnp.asarray(x)))
    assert [b.d_state for b in port.mamba] == [16, 16]
    got = port(torch.tensor(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


@pytest.mark.parametrize("rnn_type", ["LSTM", "GRU"])
def test_rnn_base_matches_jax(rnn_type):
    """From a random initial state: the outputs, every layer's carry (JAX's
    (c, h) / h form) and the gradients of a loss on both."""
    rng = np.random.RandomState(2)
    x = rng.randn(6, 5, 7)
    state = [(rng.randn(6, 10), rng.randn(6, 10)) if rnn_type == "LSTM" else rng.randn(6, 10)
             for _ in range(2)]
    jax_m = JaxBaseNets.RNNBase(hidden_dim=10, num_layers=2, rnn_type=rnn_type)
    port = PortBaseNets.RNNBase(7, 10, 2, rnn_type)
    with jax.enable_x64():
        variables = _module_pair(jax_m, port, x)

        def loss(params):
            out, carries = jax_m.apply({"params": params}, jnp.asarray(x),
                                       initial_state=float64_tree(state))
            leaves = jax.tree_util.tree_leaves(carries)
            return jnp.sum(out ** 3) + sum(jnp.sum(c ** 2) for c in leaves), (out, carries)

        (_, (out, carries)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            variables["params"])
    tstate = [tuple(map(torch.tensor, s)) if rnn_type == "LSTM" else torch.tensor(s)
              for s in state]
    out_t, carries_t = port(torch.tensor(x), initial_state=tstate)
    loss_t = (out_t ** 3).sum() + sum((c ** 2).sum() for c in
                                      jax.tree_util.tree_leaves(carries_t))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out), atol=1e-10)
    for got, want in zip(jax.tree_util.tree_leaves(carries_t),
                         jax.tree_util.tree_leaves(carries)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-10)
    names = [n for n, _ in port.named_parameters()]
    got_grads = dict(zip(names, torch.autograd.grad(loss_t, list(port.parameters()))))
    want_grads = PortBaseNets.RNNBase(7, 10, 2, rnn_type).double()
    load_jax_variables(want_grads, flatten_variables({"params": grads}))
    for n, g in want_grads.named_parameters():
        np.testing.assert_allclose(got_grads[n].numpy(), g.detach().numpy(), rtol=0,
                                   atol=1e-10 * max(1.0, float(g.abs().max())), err_msg=n)


def test_geglu_matches_jax():
    x = np.random.RandomState(3).randn(4, 6, 16)
    with jax.enable_x64():
        want = np.asarray(JaxTx.GEGLU().apply({}, jnp.asarray(x)))
    got = PortTx.GEGLU()(torch.tensor(x)).numpy()
    assert got.shape == (4, 6, 8)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)


def test_gpt_with_geglu_matches_jax():
    """JAX's parameters fit the port's GEGLU blocks (the MLP's first layer
    [D, 8D]); the outputs agree within JAX's float32 attention products."""
    x = np.random.RandomState(4).randn(2, 6, 16)
    jax_m = JaxTx.GPT_Backbone(embed_dim=16, context_length=6, num_layers=2, num_heads=2,
                               attn_dropout=0.0, block_output_dropout=0.0,
                               activation="geglu")
    port = PortTx.GPT_Backbone(16, 6, num_layers=2, num_heads=2, attn_dropout=0.0,
                               block_output_dropout=0.0, activation="geglu").eval()
    with jax.enable_x64():
        variables = _module_pair(jax_m, port, x)
        want = np.asarray(jax_m.apply(variables, jnp.asarray(x)))
    assert port.nets["transformer"][0].nets["mlp"][0].weight.shape == (128, 16)
    np.testing.assert_allclose(port(torch.tensor(x)).detach().numpy(), want, atol=1e-5)
    with pytest.raises(NotImplementedError):
        PortTx.GPT_Backbone(16, 6, activation="relu")


@pytest.mark.parametrize("t, d", [(4, 32), (12, 64), (48, 512)])
def test_sinusoidal_encoding_matches_jax(t, d):
    with jax.enable_x64():
        pos = jnp.broadcast_to(jnp.arange(t, dtype=jnp.float32)[None], (1, t))
        want = np.asarray(JaxTx.sinusoidal_positional_encoding(pos, d))[0]
    got = PortTx.sinusoidal_positional_encoding(t, d).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7 * t)
    ang = np.arange(t)[:, None] * np.exp(np.arange(0, d, 2) * (-np.log(10000.0) / d))
    exact = np.stack([np.sin(ang), np.cos(ang)], -1).reshape(t, d)
    np.testing.assert_allclose(got, exact, rtol=0, atol=1e-7 * t)


def _port_encoding(positions, embed_dim):
    """JAX's encoding replaced by the port's float32 values."""
    pe = PortTx.sinusoidal_positional_encoding(positions.shape[-1], embed_dim).numpy()
    return jnp.broadcast_to(jnp.asarray(pe), positions.shape + (embed_dim,))


def test_embedding_with_sinusoidal_encoding_matches_jax(monkeypatch):
    monkeypatch.setattr(JaxObsNets, "sinusoidal_positional_encoding", _port_encoding)
    x = np.random.RandomState(5).randn(3, T, 9)
    jax_m = JaxObsNets._TransformerEmbedding(embed_dim=32, context_length=T, emb_dropout=0.0,
                                             sinusoidal=True)
    port = PortObsNets._TransformerEmbedding(9, 32, T, emb_dropout=0.0, sinusoidal=True)
    with jax.enable_x64():
        variables = _module_pair(jax_m, port, x)
        want = np.asarray(jax_m.apply(variables, jnp.asarray(x)))
    assert sorted(port.state_dict()) == ["embed_encoder.bias", "embed_encoder.weight",
                                         "embed_ln.bias", "embed_ln.weight"]
    np.testing.assert_allclose(port(torch.tensor(x)).detach().numpy(), want, rtol=0,
                               atol=1e-10)


# ---------------------------------------------------------------------------
# the algos
# ---------------------------------------------------------------------------

def _configure(cfg, gmm):
    """icl_mamba at the small size: ICLMamba_GMM with LipVQ (@gmm), else
    ICLMambaHVQVAE with a small HVQVAE, GEGLU and the sinusoidal encoding."""
    with cfg.values_unlocked():
        cfg.observation.modalities.obs.low_dim = list(LOW_DIM)
        cfg.observation.modalities.obs.rgb = []
        mc = cfg.algo.mamba
        mc.context_length, mc.embed_dim, mc.num_layers, mc.num_heads = T, 32, 1, 4
        mc.emb_dropout = mc.attn_dropout = mc.block_output_dropout = 0.0
        mc.vq_vae_enabled, mc.ln_act_enabled = True, False
        cfg.algo.gmm.enabled = gmm
        # the GMM path's context half needs the window's actions (with the
        # template's False, both packages' steps fail to fold them)
        mc.supervise_all_steps = True
        if not gmm:
            mc.pred_future_acs = True
            mc.causal, mc.activation, mc.sinusoidal_embedding = False, "geglu", True
            vq = mc.vqvae
            vq.embed_dim, vq.num_subclusters, vq.num_clusters = E, KZ, KQ
            vq.num_stages, vq.num_layers_per_stage, vq.dropout = 2, 2, 0.0
        lr = cfg.algo.optim_params.policy.learning_rate
        lr.initial, lr.scheduler_type = LR, None
        cfg.algo.optim_params.policy.regularization.L2 = 1e-2
        cfg.train.max_grad_norm = 1.0
    return cfg


def _batch(rng, b=B, t=T):
    """float32 values held as float64 (see tests/test_torch_icl_variants.py)."""
    obs = {k: rng.randn(b, t, *s).astype(np.float32).astype(np.float64)
           for k, s in LOW_DIM.items()}
    return {"obs": obs, "actions": rng.uniform(-1, 1, (b, t, A)).astype(np.float32).astype(
        np.float64)}


@pytest.fixture(scope="module")
def mamba_gmm():
    """ICLMamba_GMM with LipVQ: 3 steps on both sides, then one request."""
    rng = np.random.RandomState(0)
    batches = [_batch(rng) for _ in range(3)]
    jax_algo = jax_algo_jit_init(
        "icl_mamba", _configure(jax_config_factory("icl_mamba"), gmm=True), dict(LOW_DIM), A)
    jax_algo.ensure_state(jax_algo.process_batch_for_training(batches[0]))
    nested, flat = perturbed_variables({"params": jax_algo.state.params["policy"]}, 5)
    with jax.enable_x64():
        params = float64_tree(nested["params"])
        jax_algo.state = jax_algo.state.replace(
            params={"policy": params},
            opt_states={"policy": jax_algo.optimizers["policy"].init(params),
                        "vq_tokenizer": jax_algo.optimizers["vq_tokenizer"].init(
                            params["net"]["encoder"]["action_network"])})
    cfg = _configure(config_factory("icl_mamba"), gmm=True)
    PortObsUtils.initialize_obs_utils_with_config(cfg)
    algo = PortAlgo.algo_factory("icl_mamba", cfg, dict(LOW_DIM), A, device="cpu")
    algo.nets.double()
    load_jax_variables(algo.nets["policy"], flat)
    metrics = []
    for batch in batches:
        with jax.enable_x64():
            want = jax_algo.train_on_batch(jax_algo.process_batch_for_training(batch),
                                           epoch=0)["losses"]
        got = algo.train_on_batch(algo.process_batch_for_training(batch), epoch=0)["losses"]
        metrics.append(({k: float(v) for k, v in want.items()},
                        {k: float(v) for k, v in got.items()}))
    expected = copy.deepcopy(algo.nets["policy"])
    load_jax_variables(expected, flatten_variables({"params": jax_algo.state.params["policy"]}))

    req, ctx = _batch(np.random.RandomState(1), b=2), _batch(np.random.RandomState(2), b=2)
    policy = jax_algo.nets["policy"]
    jobs = lambda o: device_process_obs({k: jnp.asarray(v) for k, v in o.items()})  # noqa: E731
    with jax.enable_x64():
        apply = jax.jit(lambda *a: policy.apply(*a, train=False, method=policy.forward_train))
        dist_j, _ = apply({"params": jax_algo.state.params["policy"]}, jobs(req["obs"]),
                          jobs(ctx["obs"]), jnp.asarray(ctx["actions"]))
        dist_j = {n: np.asarray(getattr(dist_j, n)) for n in ("means", "scales", "logits")}
    dist_t, _ = algo.action_distribution(req["obs"], ctx)
    return dict(jax=jax_algo, port=algo, metrics=metrics, expected=expected,
                gmm=(dist_j, dist_t))


def test_icl_mamba_routes_as_jax():
    for gmm, mamba in ((True, True), (True, False), (False, True)):
        names = []
        for make, algo_mod in ((jax_config_factory, JaxAlgo), (config_factory, PortAlgo)):
            cfg = make("icl_mamba")
            with cfg.values_unlocked():
                cfg.algo.gmm.enabled, cfg.algo.mamba.enabled = gmm, mamba
            names.append(algo_mod.REGISTERED_ALGOS["icl_mamba"](cfg.algo)[0].__name__)
        assert names[0] == names[1] == ("ICLMamba_GMM" if gmm and mamba else "ICLMambaHVQVAE")


def test_mamba_gmm_structure(mamba_gmm):
    algo = mamba_gmm["port"]
    assert isinstance(algo, PortAlgo.ICLMamba_GMM) and algo.TAKES_CONTEXT
    assert type(algo.nets["policy"].net.transformer).__name__ == "Mamba_Backbone"
    assert type(algo._lipvq()).__name__ == "LipVQVAE"
    assert set(algo.optimizers) == {"policy", "vq_tokenizer"}


def test_mamba_gmm_steps_match_jax(mamba_gmm):
    check_step_metrics(mamba_gmm["metrics"],
                   ("log_probs", "action_loss", "policy_grad_norms", "vq_vae_loss"), 1e-8)
    # LipVQ's latent layer: JAX takes its product with
    # preferred_element_type=float32, so the tokenizer's AdamW steps carry
    # float32 rounding there
    check_parameters(mamba_gmm["port"].nets["policy"], mamba_gmm["expected"], 1e-8,
                      loose=("action_network.",), loose_tol=1e-6)


def test_mamba_gmm_request_matches_jax(mamba_gmm):
    dist_j, dist_t = mamba_gmm["gmm"]
    for name in ("means", "scales", "logits"):
        np.testing.assert_allclose(getattr(dist_t, name).numpy(), dist_j[name], rtol=0,
                                   atol=1e-10, err_msg=name)


def test_mamba_gmm_mixed_precision_raises():
    """It no longer does: the JAX class inherits the paper's bf16 step, and
    so does the port's (held against JAX's in
    tests/test_torch_bf16_mamba.py); the mode builds and takes a step on
    fp32 masters."""
    cfg = _configure(config_factory("icl_mamba"), gmm=True)
    with cfg.values_unlocked():
        cfg.train.mixed_precision = True
    PortObsUtils.initialize_obs_utils_with_config(cfg)
    algo = PortAlgo.algo_factory("icl_mamba", cfg, dict(LOW_DIM), A, device="cpu")
    assert isinstance(algo, PortAlgo.ICLMamba_GMM) and algo.mixed_precision
    losses = algo.train_on_batch(algo.process_batch_for_training(
        _batch(np.random.RandomState(1))), epoch=0)["losses"]
    assert all(np.isfinite(float(v)) for v in losses.values())
    assert all(p.dtype == torch.float32 for p in algo.nets.parameters())


POLICY_METRICS = ("l2_loss", "l1_loss", "cos_loss", "action_loss", "policy_grad_norms")
VQ_METRICS = ("vqvae_loss", "L_rec", "L_commit_z", "L_commit_q", "vqvae_grad_norms")


@pytest.fixture(scope="module")
def mamba_hvqvae(request):
    """ICLMambaHVQVAE: 2 steps on both sides."""
    patch = pytest.MonkeyPatch()
    patch.setattr(JaxObsNets, "sinusoidal_positional_encoding", _port_encoding)
    request.addfinalizer(patch.undo)
    rng = np.random.RandomState(3)
    batches = [_batch(rng, t=2 * T - 1) for _ in range(2)]
    jax_algo = jax_algo_jit_init(
        "icl_mamba", _configure(jax_config_factory("icl_mamba"), gmm=False), dict(LOW_DIM), A)
    jax_algo.ensure_state(jax_algo.process_batch_for_training(batches[0]))
    pol, pol_flat = perturbed_variables({"params": jax_algo.state.params["policy"]}, 5,
                                        kernel_scale=10.0, scale_under="net/transformer/")
    vq, vq_flat = perturbed_variables({"params": jax_algo.state.params["vqvae"]}, 6)
    vq["vq"] = _vq_state()
    vq_flat.update({f"vq/{k}": v for k, v in vq["vq"].items()})
    with jax.enable_x64():
        pol, vq = float64_tree(pol), float64_tree(vq)
        params = {"policy": pol.pop("params"), "vqvae": vq.pop("params")}
        jax_algo.state = _f32_embed_sums(jax_algo.state.replace(
            params=params, aux={"policy": {}, "vqvae": vq},
            opt_states={n: jax_algo.optimizers[n].init(params[n]) for n in params}))
    cfg = _configure(config_factory("icl_mamba"), gmm=False)
    PortObsUtils.initialize_obs_utils_with_config(cfg)
    algo = PortAlgo.algo_factory("icl_mamba", cfg, dict(LOW_DIM), A, device="cpu")
    algo.nets.double()
    load_jax_variables(algo.nets["policy"], pol_flat)
    load_jax_variables(algo.nets["vqvae"], vq_flat)
    metrics = []
    for batch in batches:
        with jax.enable_x64():
            want = jax_algo.train_on_batch(jax_algo.process_batch_for_training(batch),
                                           epoch=0)["losses"]
            jax_algo.state = _f32_embed_sums(jax_algo.state)
        got = algo.train_on_batch(algo.process_batch_for_training(batch), epoch=0)["losses"]
        metrics.append(({k: float(v) for k, v in want.items()},
                        {k: float(v) for k, v in got.items()}))
    expected = copy.deepcopy(algo.nets)
    state = jax_algo.state
    load_jax_variables(expected["policy"], flatten_variables({"params": state.params["policy"]}))
    load_jax_variables(expected["vqvae"], flatten_variables(
        {"params": state.params["vqvae"], **state.aux["vqvae"]}))
    return dict(port=algo, metrics=metrics, expected=expected)


def test_mamba_hvqvae_structure(mamba_hvqvae):
    algo = mamba_hvqvae["port"]
    assert isinstance(algo, PortAlgo.ICLMambaHVQVAE) and algo.context_length == T
    assert type(algo.nets["policy"]).__name__ == "TransformerActorNetwork"
    assert algo.nets["policy"].net.embedding.sinusoidal
    assert "vqvae" in algo.nets and set(algo.optimizers) == {"policy", "vqvae"}


def test_mamba_hvqvae_steps_match_jax(mamba_hvqvae):
    """The JAX GPT takes its attention products with
    preferred_element_type=float32: the policy within 1e-6 (measured 1e-8)."""
    check_step_metrics(mamba_hvqvae["metrics"], POLICY_METRICS, 1e-6)
    check_step_metrics(mamba_hvqvae["metrics"], VQ_METRICS, 1e-5)
    check_parameters(mamba_hvqvae["port"].nets["policy"],
                      mamba_hvqvae["expected"]["policy"], 1e-6)
    check_parameters(mamba_hvqvae["port"].nets["vqvae"],
                      mamba_hvqvae["expected"]["vqvae"], 1e-8)
