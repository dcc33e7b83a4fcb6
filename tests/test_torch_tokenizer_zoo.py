"""The port's tokenizer zoo (``models/tokenizers/vqvae.py``, ``hq_vae.py``,
``prise.py``) against the JAX package's, at a small size, with the JAX
variables (``params`` and the ``vq`` / ``spectral`` collections) carried
across by ``load_jax_variables``.

* Each of the six modules in float64: forward outputs and losses within
  1e-10, assignments equal; 3 Adam steps (training forwards, so the EMA
  buffers and the spectral-norm vectors move) within 1e-8 of JAX's
  parameters and buffers.
* The k-means initialization and the dead-code replacement with pinned
  draws: JAX's ``jax.random.randint`` and ``jax.random.categorical`` are
  patched with fixed functions (the categorical to its mode), and the port
  is given the same values as the ops' draw arguments. On a clustered batch
  the replacement fires for at least a quarter of the codes.
* The JAX quantization ops and the Lipschitz latent ask for float32 products
  (``preferred_element_type``); in float64 the test gives those products the
  input's type (``_f64_products``), which is what they compute at float32.
* ``LSTMVQVAE``'s bias: the port holds ``bias_ih`` at zero and frozen, and
  trains as JAX's one-bias cell does; with both biases trainable it would
  not.
* The ``hq_vae.py:133-137`` codebook formula, pinned.
* PRISE's BPE / WordPiece / Unigram ids and round trips equal to JAX's.
"""

import numpy as np
import optax
import pytest
import torch

import flax.linen
import jax
import jax.numpy as jnp

from robot_manipulation_vq_vae_tpu.models.tokenizers import hq_vae as JaxHq
from robot_manipulation_vq_vae_tpu.models.tokenizers import lipvq as JaxLipvq
from robot_manipulation_vq_vae_tpu.models.tokenizers import prise as JaxPrise
from robot_manipulation_vq_vae_tpu.models.tokenizers import vqvae as JaxVq
from robot_manipulation_vq_vae_tpu.ops import quantize as JaxQ
from robot_manipulation_vq_vae_tpu.utils.ckpt_conversion import flatten_variables

import robot_manipulation_vq_vae_tpu_torch.models.tokenizers as Zoo
from robot_manipulation_vq_vae_tpu_torch.utils.jax_weights import _entries, load_jax_variables
from torch_port_helpers import perturbed_variables
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

F_DIM, LATENT, K, N, LR, STEPS = 6, 16, 8, 48, 1e-3, 3
Z_DIM, Q_DIM, KZ, KQ, HIDDEN = 10, 6, 12, 8, 32


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _F64Jnp:
    """``jax.numpy`` whose ``dot`` keeps its operands' type: the float32
    ``preferred_element_type`` of the JAX quantization ops and Lipschitz
    latent dropped for the float64 comparison."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def dot(a, b, preferred_element_type=None):
        return jnp.dot(a, b)


def _fake_randint(key, shape, minval, maxval, dtype=jnp.int32):
    n = int(np.prod(shape))
    return ((jnp.arange(n) * 5 + 3) % maxval + minval).reshape(shape).astype(dtype)


def _fake_categorical(key, logits, axis=-1, **kwargs):
    return jnp.argmax(logits, axis=axis)


def _pinned(n, k):
    """The port's draws for JAX's patched ones over @n rows and @k codes."""
    return {"first": 3 % n, "noise": torch.zeros(k, n, dtype=torch.float64),
            "pick": (torch.arange(k) * 5 + 3) % n}


def _f64_carry(initialize_carry):
    """Flax's LSTM carry, zeros in float32 whatever the input, in float64:
    its jitted scan wants the carry in the float64 step's type."""
    def init(self, rng, input_shape):
        return jax.tree_util.tree_map(lambda a: a.astype(jnp.float64),
                                      initialize_carry(self, rng, input_shape))
    return init


@pytest.fixture
def f64(monkeypatch):
    monkeypatch.setattr(flax.linen.OptimizedLSTMCell, "initialize_carry",
                        _f64_carry(flax.linen.OptimizedLSTMCell.initialize_carry))
    monkeypatch.setattr(JaxQ, "jnp", _F64Jnp())
    monkeypatch.setattr(JaxLipvq, "jnp", _F64Jnp())
    monkeypatch.setattr(jax.random, "randint", _fake_randint)
    monkeypatch.setattr(jax.random, "categorical", _fake_categorical)
    with jax.enable_x64():
        yield


def _apply(model, **kw):
    """@model.apply jitted, with the keyword arguments @kw."""
    return jax.jit(lambda variables, x: model.apply(variables, x, **kw))


def _f64(tree):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float64) if np.asarray(a).dtype == np.float32
        else jnp.asarray(a), tree)


def _carry(jax_model, port, x, seed, **init_kw):
    """JAX variables (params perturbed, as float64) and the port module
    (float64) filled with them."""
    variables = jax_model.init(jax.random.PRNGKey(seed), jnp.asarray(x, jnp.float32),
                               **init_kw)
    params, flat = {}, {}
    if "params" in variables:
        params, flat = perturbed_variables({"params": variables["params"]}, seed)
    others = {k: v for k, v in variables.items() if k != "params"}
    flat.update(flatten_variables(others))
    port = port.double()
    load_jax_variables(port, flat)
    return _f64({**params, **others}), port


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               rtol=tol, atol=tol, err_msg=msg)


def _check_state(port, variables, tol, msg):
    """Every JAX variable against the port tensor it was carried into, in
    the JAX layout (the LSTM's stacked gates are held by their test).
    ``usage_ma`` within float32 rounding: JAX casts its usage mask to
    float32, so its 0.01 * mask is 0.01 rounded to float32."""
    state = port.state_dict()
    flat = flatten_variables(variables)
    seen = 0
    for jax_key, torch_key, _, inv in _entries(port, [], []):
        if isinstance(jax_key, tuple):
            continue
        got = inv(state[torch_key].detach().numpy())
        t = max(tol, 1e-7) if jax_key.endswith("usage_ma") else tol
        np.testing.assert_allclose(np.asarray(got, np.float64),
                                   np.asarray(flat[jax_key], np.float64),
                                   rtol=t, atol=t, err_msg=f"{msg}: {jax_key}")
        seen += 1
    assert seen


# --------------------------------------------------------------------------
# the modules' training steps: JAX (optax Adam) and the port (torch Adam)
# --------------------------------------------------------------------------

def _jax_steps(model, variables, batches, mutable, apply_kw):
    """@STEPS Adam steps (one jitted step); returns (variables, [loss per
    step])."""
    opt = optax.adam(LR)

    @jax.jit
    def step(params, state, rest, x):
        def loss_fn(p):
            (_, loss), mutated = model.apply({"params": p, **rest}, x,
                                             mutable=mutable, **apply_kw)
            return loss, mutated

        (loss, mutated), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, state = opt.update(grads, state, params)
        return optax.apply_updates(params, updates), state, {**rest, **mutated}, loss

    params = variables["params"]
    state = opt.init(params)
    rest = {k: v for k, v in variables.items() if k != "params"}
    losses = []
    for x in batches:
        params, state, rest, loss = step(params, state, rest, jnp.asarray(x))
        losses.append(float(loss))
    return {"params": params, **rest}, losses


def _port_steps(port, batches, forward=None):
    """@STEPS Adam steps of @forward(x, step) (default port(x)); returns the
    losses."""
    forward = forward or (lambda x, step: port(x))
    opt = torch.optim.Adam([p for p in port.parameters() if p.requires_grad], lr=LR)
    port.train()
    losses = []
    for step, x in enumerate(batches):
        _, loss = forward(torch.from_numpy(x), step)
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    return losses


def _batches(shape, seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return [scale * rng.randn(*shape) for _ in range(STEPS)]


# --------------------------------------------------------------------------
# VQVAE, LFQVAE, LSTMVQVAE
# --------------------------------------------------------------------------

def test_vqvae_forward_and_steps_match_jax(f64):
    jm = JaxVq.VQVAE(feature_dim=F_DIM, latent_dim=LATENT, num_embeddings=K)
    x = np.random.RandomState(0).randn(N, F_DIM)
    variables, port = _carry(jm, Zoo.VQVAE(F_DIM, LATENT, K), x, 0)
    port.eval()
    want_z, want_loss = _apply(jm)(variables, jnp.asarray(x))
    got_z, got_loss = port(torch.from_numpy(x))
    _close(got_z, want_z, 1e-10, "z_latent")
    _close(got_loss, want_loss, 1e-10, "loss")
    # the assignments
    h = torch.relu(port.enc2(torch.relu(port.enc1(torch.from_numpy(x)))))
    _, _, idx = port.quantize(torch.relu(port.enc3(h)))
    want_idx = _apply(jm, method=lambda m, x: m.quantize(
        jax.nn.relu(m.enc3(jax.nn.relu(m.enc2(jax.nn.relu(m.enc1(x)))))))[2])(
            variables, jnp.asarray(x))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    assert len(np.unique(np.asarray(want_idx))) > 1

    batches = _batches((N, F_DIM), 1)
    want, want_losses = _jax_steps(jm, variables, batches, [], {})
    got_losses = _port_steps(port, batches)
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-10, atol=1e-10)
    _check_state(port, want, 1e-8, "VQVAE after 3 Adam steps")
    # the codebook moved through the kernel's backward (index_add_)
    assert not np.allclose(np.asarray(want["params"]["codebook"]),
                           np.asarray(variables["params"]["codebook"]))


def test_lfqvae_forward_and_steps_match_jax(f64):
    jm = JaxVq.LFQVAE(feature_dim=F_DIM, latent_dim=LATENT)
    x = np.random.RandomState(2).randn(N, F_DIM)
    variables, port = _carry(jm, Zoo.LFQVAE(F_DIM, LATENT), x, 2)
    port.eval()
    want_z, want_loss = _apply(jm)(variables, jnp.asarray(x))
    got_z, got_loss = port(torch.from_numpy(x))
    _close(got_z, want_z, 1e-10, "z_latent")
    _close(got_loss, want_loss, 1e-10, "loss")
    u0 = port.enc1.u.clone()
    port(torch.from_numpy(x))
    assert torch.equal(port.enc1.u, u0), "an eval forward moved u"

    batches = _batches((N, F_DIM), 3)
    want, want_losses = _jax_steps(jm, variables, batches, ["spectral"],
                                   {"update_stats": True})
    got_losses = _port_steps(port, batches)
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-10, atol=1e-10)
    _check_state(port, want, 1e-8, "LFQVAE after 3 Adam steps")
    assert not torch.equal(port.enc1.u, u0), "training forwards left u"


def _lstm_pair(f64_seed=4):
    jm = JaxVq.LSTMVQVAE(feature_dim=F_DIM, latent_dim=LATENT, num_embeddings=K)
    x = np.random.RandomState(f64_seed).randn(4, 5, F_DIM)
    variables, port = _carry(jm, Zoo.LSTMVQVAE(F_DIM, LATENT, K), x, f64_seed)
    return jm, variables, port, x


def _gate_biases(params, prefix, layers=3):
    """JAX's per-layer bias [4H] (the h* denses' biases, gate by gate)."""
    return [np.concatenate([np.asarray(params[f"{prefix}{k}"]["cell"][f"h{g}"]["bias"])
                            for g in "ifgo"]) for k in range(layers)]


_LSTM_STEPS = {}


def _lstm_jax_steps(jm, variables):
    """JAX's 3 steps of the LSTM pair, taken once for both LSTM tests."""
    if not _LSTM_STEPS:
        _LSTM_STEPS["steps"] = _jax_steps(jm, variables, _batches((4, 5, F_DIM), 5), [], {})
    return _LSTM_STEPS["steps"]


def test_lstmvqvae_forward_and_steps_match_jax(f64):
    jm, variables, port, x = _lstm_pair()
    port.eval()
    want_z, want_loss = _apply(jm)(variables, jnp.asarray(x))
    got_z, got_loss = port(torch.from_numpy(x))
    assert got_z.shape == (20, LATENT)
    _close(got_z, want_z, 1e-10, "z_latent")
    _close(got_loss, want_loss, 1e-10, "loss")

    batches = _batches((4, 5, F_DIM), 5)
    want, want_losses = _lstm_jax_steps(jm, variables)
    got_losses = _port_steps(port, batches)
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-10, atol=1e-10)
    _check_state(port, want, 1e-8, "LSTMVQVAE after 3 Adam steps")
    for prefix, lstm in (("enc", port.encoder), ("dec", port.decoder)):
        for k, bias in enumerate(_gate_biases(want["params"], prefix)):
            _close(getattr(lstm, f"bias_hh_l{k}"), bias, 1e-8, f"{prefix}{k} bias")
            assert not getattr(lstm, f"bias_ih_l{k}").any()
        cell = want["params"][f"{prefix}0"]["cell"]
        _close(lstm.weight_ih_l0, np.concatenate([np.asarray(cell[f"i{g}"]["kernel"]).T
                                                  for g in "ifgo"]), 1e-8, "weight_ih")
        _close(lstm.weight_hh_l0, np.concatenate([np.asarray(cell[f"h{g}"]["kernel"]).T
                                                  for g in "ifgo"]), 1e-8, "weight_hh")


def test_lstmvqvae_two_trainable_biases_would_train_differently(f64):
    """The bias test: with ``bias_ih`` trainable as well, Adam moves both
    biases and their sum drifts about twice as far as JAX's one bias; the
    port's frozen ``bias_ih`` is what keeps the 3 steps equal."""
    jm, variables, port, x = _lstm_pair()
    batches = _batches((4, 5, F_DIM), 5)
    want, _ = _lstm_jax_steps(jm, variables)
    for k in range(3):
        port.encoder.get_parameter(f"bias_ih_l{k}").requires_grad_(True)
    _port_steps(port, batches)
    start = _gate_biases(variables["params"], "enc")[0]
    jax_move = np.abs(_gate_biases(want["params"], "enc")[0] - start)
    summed = (port.encoder.bias_ih_l0 + port.encoder.bias_hh_l0).detach().numpy()
    two_move = np.abs(summed - start)
    moving = jax_move > 0.5 * STEPS * LR
    assert moving.mean() > 0.5
    ratio = np.median(two_move[moving] / jax_move[moving])
    assert 1.8 < ratio < 2.2, ratio


# --------------------------------------------------------------------------
# the EMA quantizers and HierarchicalLFQHVQVAE
# --------------------------------------------------------------------------

def test_lfq_quantizer_ema_matches_jax(f64):
    jm = JaxHq.LFQQuantizerEMA(num_codes=K, code_dim=LATENT)
    rng = np.random.RandomState(6)
    x = rng.randn(N, LATENT)
    variables, port = _carry(jm, Zoo.LFQQuantizerEMA(K, LATENT), x, 6)
    port.eval()
    want_q, want_idx = _apply(jm)(variables, jnp.asarray(x))
    got_q, got_idx = port(torch.from_numpy(x))
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    _close(got_q, want_q, 1e-10, "z_q")
    port.train()
    for step in range(STEPS):
        x = rng.randn(N, LATENT)
        (want_q, want_idx), mutated = _apply(jm, training=True, mutable=["vq"])(
            variables, jnp.asarray(x))
        variables = {**variables, **mutated}
        got_q, got_idx = port(torch.from_numpy(x))
        np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
        _close(got_q, want_q, 1e-10, f"step {step} z_q")
        _check_state(port, {"vq": mutated["vq"]}, 1e-10, f"step {step}")
    assert float(port.ema_cluster_size.sum()) > 0


def _clustered(rng, n, dim, protos=2, scale=3.0):
    centers = scale * rng.randn(protos, dim)
    return centers[rng.randint(0, protos, n)] + 0.01 * rng.randn(n, dim)


def test_lfq_quantizer_ema_kmeans_init_and_replacement_match_jax(f64):
    """First training call: k-means init (pinned draws), then EMA steps
    with dead-code replacement (threshold 1). The first step's EMA mass,
    0.01 x its counts, is below 1 everywhere, so every code is replaced and
    counts 1; the second batch is clustered on 2 points, which starves the
    other codes (mass 0.99) and replaces them by its rows."""
    jm = JaxHq.LFQQuantizerEMA_KMeans(num_codes=K, code_dim=LATENT, dead_threshold=1.0,
                                      kmeans_iters=5)
    rng = np.random.RandomState(7)
    batches = [rng.randn(N, LATENT), _clustered(rng, N, LATENT), rng.randn(N, LATENT)]
    variables, port = _carry(jm, Zoo.LFQQuantizerEMA_KMeans(
        K, LATENT, dead_threshold=1.0, kmeans_iters=5), batches[0], 7)
    assert not port._initialized
    port.train()
    step_fn = _apply(jm, training=True, mutable=["vq"], rngs={"vq": jax.random.PRNGKey(0)})
    for step, x in enumerate(batches):
        cb_before = port.codebook.clone()
        (want_q, want_idx), mutated = step_fn(variables, jnp.asarray(x))
        variables = {**variables, **mutated}
        got_q, got_idx = port(torch.from_numpy(x), draws=_pinned(N, K))
        np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
        _close(got_q, want_q, 1e-10, f"step {step} z_q")
        _check_state(port, {"vq": mutated["vq"]}, 1e-10, f"step {step}")
        assert port._initialized and bool(port.initialized)
        if step == 0:
            # the EMA mass starts at 0 after the k-means init: every code is
            # below the threshold and replaced on the first step
            assert bool((port.ema_cluster_size == 1.0).all())
        if step == 1:
            replaced = port.ema_cluster_size == 1.0
            assert int(replaced.sum()) >= K // 4, port.ema_cluster_size
            samples = torch.from_numpy(x)
            for k in torch.nonzero(replaced).flatten():
                assert (samples == port.codebook[k]).all(-1).any()
                assert not torch.equal(port.codebook[k], cb_before[k])
    assert float(port.entropy_ma) > 0 and float(port.usage_counts.sum()) == STEPS * N


def test_kmeans_quantizer_codebook_formula_is_pinned(f64):
    """``hq_vae.py:133-137``: codebook = new_avg / ((size + eps) / (n + K eps)),
    with n the total EMA mass, on both sides; Laplace smoothing would
    multiply the share back by n (ROADMAP.md, Queue 3)."""
    rng = np.random.RandomState(8)
    x = rng.randn(N, LATENT)
    jm = JaxHq.LFQQuantizerEMA_KMeans(num_codes=K, code_dim=LATENT, dead_threshold=0.0)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    size, avg = rng.uniform(1.0, 4.0, K), rng.randn(K, LATENT)
    vq = {**variables["vq"], "ema_cluster_size": size, "ema_codebook": avg,
          "initialized": jnp.asarray(True)}
    variables = _f64({**variables, "vq": vq})
    port = Zoo.LFQQuantizerEMA_KMeans(K, LATENT, dead_threshold=0.0).double()
    load_jax_variables(port, flatten_variables(variables))
    port.train()
    (_, idx), mutated = _apply(jm, training=True, mutable=["vq"],
                               rngs={"vq": jax.random.PRNGKey(0)})(variables, jnp.asarray(x))
    port(torch.from_numpy(x))
    onehot = np.eye(K)[np.asarray(idx)]
    new_size = 0.99 * size + 0.01 * onehot.sum(0)
    new_avg = 0.99 * avg + 0.01 * onehot.T @ x
    eps = 1e-5
    pinned = new_avg / ((new_size + eps) / (new_size.sum() + K * eps))[:, None]
    _close(port.codebook, pinned, 1e-10, "port codebook")
    np.testing.assert_allclose(np.asarray(mutated["vq"]["codebook"]), pinned, rtol=1e-10,
                               atol=1e-10)
    laplace = new_avg / ((new_size + eps) / (new_size.sum() + K * eps)
                         * new_size.sum())[:, None]
    assert not np.allclose(pinned, laplace)


def _hier_pair(seed):
    jm = JaxHq.HierarchicalLFQHVQVAE(feature_dim=F_DIM, z_dim=Z_DIM, q_dim=Q_DIM,
                                     num_z_codes=KZ, num_q_codes=KQ, hidden_dim=HIDDEN)
    x = np.random.RandomState(seed).randn(N, F_DIM)
    variables, port = _carry(jm, Zoo.HierarchicalLFQHVQVAE(
        F_DIM, Z_DIM, Q_DIM, KZ, KQ, HIDDEN), x, seed)
    return jm, variables, port


def _hier_draws():
    return {"z_quantizer": _pinned(N, KZ), "q_quantizer": _pinned(N, KQ)}


def test_hierarchical_lfq_forward_and_steps_match_jax(f64):
    """Eval forward, then 3 Adam steps of training forwards from an
    uninitialized ``vq`` state: the first runs both k-means inits, every
    step the EMA updates and the dead-code replacement (thresholds 3 and 1:
    the EMA mass of a fresh codebook is below both, so every code is
    replaced on the first step); the third batch is clustered."""
    jm, variables, port = _hier_pair(9)
    port.eval()
    x = np.random.RandomState(10).randn(N, F_DIM)
    want_q, want_loss = _apply(jm)(variables, jnp.asarray(x))
    got_q, got_loss = port(torch.from_numpy(x))
    _close(got_q, want_q, 1e-10, "q_q")
    _close(got_loss, want_loss, 1e-10, "loss")

    rng = np.random.RandomState(11)
    batches = [rng.randn(N, F_DIM), rng.randn(N, F_DIM), _clustered(rng, N, F_DIM)]
    want, want_losses = _jax_steps(jm, variables, batches, ["vq"],
                                   {"training": True, "rngs": {"vq": jax.random.PRNGKey(1)}})
    got_losses = _port_steps(port, batches,
                             lambda x, step: port(x, draws=_hier_draws()))
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-10, atol=1e-10)
    _check_state(port, want, 1e-8, "HierarchicalLFQHVQVAE after 3 Adam steps")
    assert port.z_quantizer._initialized and port.q_quantizer._initialized
    usage = port.codebook_usage()
    assert usage["z_used"] == KZ and usage["q_utilization"] == 1.0
    # the clustered step replaced a quarter of the z codes or more
    assert int((port.z_quantizer.ema_cluster_size == 1.0).sum()) >= KZ // 4


def test_hierarchical_lfq_kernel_flag_and_eval_state():
    """``use_kernel=False`` is the plain search; an eval forward moves no
    buffer; ``load_state_dict`` sets the host mirror of ``initialized``."""
    torch.manual_seed(0)
    a = Zoo.HierarchicalLFQHVQVAE(F_DIM, Z_DIM, Q_DIM, KZ, KQ, HIDDEN)
    b = Zoo.HierarchicalLFQHVQVAE(F_DIM, Z_DIM, Q_DIM, KZ, KQ, HIDDEN, use_kernel=False)
    b.load_state_dict(a.state_dict())
    x = torch.randn(N, F_DIM)
    before = {k: v.clone() for k, v in a.state_dict().items()}
    a.eval(), b.eval()
    qa, la = a(x)
    qb, lb = b(x)
    assert torch.equal(qa, qb) and torch.equal(la, lb)
    for k, v in a.state_dict().items():
        assert torch.equal(v, before[k]), k
    a.train()
    a(x, generator=torch.Generator().manual_seed(0))
    assert a.z_quantizer._initialized
    c = Zoo.HierarchicalLFQHVQVAE(F_DIM, Z_DIM, Q_DIM, KZ, KQ, HIDDEN)
    assert not c.q_quantizer._initialized
    c.load_state_dict(a.state_dict())
    assert c.q_quantizer._initialized and c.z_quantizer._initialized


def test_zoo_exports_and_alias():
    assert Zoo.LLFQVAE_V4 is Zoo.LipVQVAE
    for name in ("VQVAE", "LFQVAE", "LSTMVQVAE", "LFQQuantizerEMA",
                 "LFQQuantizerEMA_KMeans", "HierarchicalLFQHVQVAE",
                 "PriseActionTokenizer"):
        assert hasattr(Zoo, name), name


# --------------------------------------------------------------------------
# PRISE
# --------------------------------------------------------------------------

@pytest.mark.parametrize("algo", ["bpe", "wordpiece", "unigram"])
def test_prise_matches_jax(algo):
    rng = np.random.RandomState(12)
    motifs = [list(rng.randint(0, 40, rng.randint(2, 6))) for _ in range(6)]
    corpus = []
    for _ in range(60):
        seq = sum((motifs[i] for i in rng.randint(0, 6, 4)), [])
        corpus.append([int(c) for c in seq])
    jt = JaxPrise.PriseActionTokenizer(algo=algo, vocab_size=120)
    pt = Zoo.PriseActionTokenizer(algo=algo, vocab_size=120)
    jt.train(corpus)
    pt.train(corpus)
    assert pt.vocab_size == jt.vocab_size
    for seq in corpus[:10]:
        ids = pt.encode(seq)
        assert ids == jt.encode(seq)
        assert pt.decode(ids) == jt.decode(ids) == seq


def test_prise_names_the_missing_package(monkeypatch):
    import builtins

    real = builtins.__import__

    def no_tokenizers(name, *args, **kwargs):
        if name == "tokenizers" or name.startswith("tokenizers."):
            raise ImportError("no tokenizers")
        return real(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_tokenizers)
    with pytest.raises(ImportError, match="tokenizers"):
        Zoo.PriseActionTokenizer()
