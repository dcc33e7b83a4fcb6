"""Parity of the port's hierarchical VQ-VAE (``models/tokenizers/hvqvae.py``)
and its quantization ops (``ops/quantize.py``) with the JAX package, at a
small size: actions [4, 8, 12], embed 32, codebooks of 16 (Z) and 8 (Q) codes,
2 MSTCN stages of 2 layers, dropout 0, the JAX weights carried across.

* Eval forward: codes equal, embeddings, quantized values and
  reconstructions within 1e-5; the losses and the tokenizer API too.
* Training forward from an uninitialized state: the k-means init, the EMA
  step and dead-code replacement. Randomness does not match across
  frameworks, so the draws are pinned on both sides: in JAX by patching
  ``jax.random.randint`` and ``jax.random.categorical`` (and nothing else)
  with fixed functions, in the port by passing the same values as the ops'
  draw arguments. Both run in float64, but the JAX package's similarity,
  distance and assignment-sum products keep float32 outputs
  (``preferred_element_type``), so buffers and outputs agree to float32
  rounding: within 1e-6 absolute and relative.
* The ops: ``ema_update``, and ``replace_dead_codes`` and ``kmeans`` with the
  draws JAX makes from its key handed to the port."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robot_manipulation_vq_vae_tpu.models.tokenizers.hvqvae import (
    HierarchicalVQVAE as JaxHVQVAE,
    compute_vqvae_loss as jax_vqvae_loss,
)
from robot_manipulation_vq_vae_tpu.ops import quantize as JaxQ
from robot_manipulation_vq_vae_tpu.utils.ckpt_conversion import (
    convert_hvqvae,
    flatten_variables,
)

from robot_manipulation_vq_vae_tpu_torch.models.tokenizers.hvqvae import (
    HierarchicalVQVAE,
    compute_vqvae_loss,
    get_codebook_usage,
)
from robot_manipulation_vq_vae_tpu_torch.ops import quantize as Q
from robot_manipulation_vq_vae_tpu_torch.utils.jax_weights import load_jax_variables
from torch_port_helpers import perturbed_variables
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

B, T, A, E, KZ, KQ, STAGES, LAYERS = 4, 8, 12, 32, 16, 8, 2, 2
SIZES = dict(action_dim=A, embed_dim=E, num_subclusters=KZ, num_clusters=KQ,
             num_stages=STAGES, num_layers_per_stage=LAYERS, dropout=0.0)


def _actions(seed):
    return np.random.RandomState(seed).uniform(-1, 1, (B, T, A)).astype(np.float32)


def _normalized(rng, k):
    cb = rng.randn(k, E)
    return (cb / np.linalg.norm(cb, axis=-1, keepdims=True)).astype(np.float32)


def _variables(initialized):
    """JAX variables with random biases and LayerNorm; the ``vq`` collection
    either initialized (random unit codebooks, EMA counts in [2, 5]) or as
    ``init`` leaves it. Returns (nested, flat)."""
    model = JaxHVQVAE(**SIZES)
    init = model.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(_actions(0)),
                      training=False)
    params, flat = perturbed_variables({"params": init["params"]}, 3)
    vq = {k: np.asarray(v) for k, v in init["vq"].items()}
    if initialized:
        rng = np.random.RandomState(4)
        vq.update(codebook_z=_normalized(rng, KZ), codebook_q=_normalized(rng, KQ),
                  cluster_size_z=rng.uniform(2, 5, KZ).astype(np.float32),
                  cluster_size_q=rng.uniform(2, 5, KQ).astype(np.float32),
                  embed_avg_z=rng.randn(KZ, E).astype(np.float32),
                  embed_avg_q=rng.randn(KQ, E).astype(np.float32),
                  initialized=np.asarray(True))
    flat.update({f"vq/{k}": v for k, v in vq.items()})
    return {**params, "vq": vq}, flat


def _port(flat):
    model = HierarchicalVQVAE(**SIZES).eval()
    load_jax_variables(model, flat)
    return model


@pytest.fixture(scope="module")
def pair():
    variables, flat = _variables(initialized=True)
    return JaxHVQVAE(**SIZES), variables, _port(flat)


def test_state_dict_keeps_the_reference_layout(pair):
    _, variables, port = pair
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    params, vq = convert_hvqvae(sd, num_stages=STAGES, num_layers_per_stage=LAYERS)
    got = flatten_variables({"params": params, "vq": vq})
    want = flatten_variables(variables)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert sd["encoder.stages.1.layers.1.conv.weight"].shape == (E, E, 3)
    assert port._initialized


def test_eval_forward_matches_jax(pair):
    model, variables, port = pair
    x = _actions(1)
    want = model.apply(variables, jnp.asarray(x), training=False)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    for k in ("z_indices", "q_indices"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    for k in ("embeddings", "quantized_z", "quantized_q", "reconstructed_actions",
              "z_distances", "q_distances"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5,
                                   rtol=0, err_msg=k)
    # eval leaves the codebooks alone
    assert not port.training


def test_losses_match_jax(pair):
    model, variables, port = pair
    x = _actions(2)
    want = jax_vqvae_loss(model.apply(variables, jnp.asarray(x), training=False),
                          jnp.asarray(x), commitment_cost=1.0, lambda_rec=0.002)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        got = compute_vqvae_loss(port(xt), xt, commitment_cost=1.0, lambda_rec=0.002)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), atol=1e-6, rtol=1e-5,
                                   err_msg=k)


def test_tokenizer_api_matches_jax(pair):
    model, variables, port = pair
    x = _actions(3)
    z_j, q_j = model.apply(variables, jnp.asarray(x), method=model.encode_indices)
    rec_j = model.apply(variables, q_j, method=model.decode_q_indices)
    with torch.no_grad():
        z_t, q_t = port.encode_indices(torch.from_numpy(x))
        rec_t = port.decode_q_indices(q_t)
    np.testing.assert_array_equal(z_t.numpy(), np.asarray(z_j))
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_allclose(rec_t.numpy(), np.asarray(rec_j), atol=1e-5, rtol=0)


def _fake_randint(key, shape, minval, maxval, dtype=jnp.int32):
    n = int(np.prod(shape))
    return ((jnp.arange(n) * 5 + 3) % maxval + minval).reshape(shape).astype(dtype)


def _fake_categorical(key, logits, axis=-1, **kwargs):
    return jnp.argmax(logits, axis=axis)


def test_training_forward_with_pinned_draws_matches_jax(monkeypatch):
    """Two training forwards from an uninitialized state: the first runs the
    k-means init (farthest-point seeding with the categorical draw pinned to
    its mode), both take an EMA step and replace dead codes (the k-means
    leaves codes with one or no sample, whose EMA count falls below 1)."""
    model = JaxHVQVAE(**SIZES)
    variables, flat = _variables(initialized=False)
    port = _port(flat).double().train()
    assert not port._initialized
    monkeypatch.setattr(jax.random, "randint", _fake_randint)
    monkeypatch.setattr(jax.random, "categorical", _fake_categorical)
    n = B * T
    kmeans, replace = Q.kmeans, Q.replace_dead_codes

    def pinned_kmeans(data, num_clusters, *args, **kwargs):
        noise = torch.zeros(num_clusters, n, dtype=data.dtype)
        return kmeans(data, num_clusters, *args, first=3 % n, noise=noise, **kwargs)

    def pinned_replace(codebook, *args, **kwargs):
        pick = (torch.arange(codebook.shape[0]) * 5 + 3) % n
        return replace(codebook, *args, pick=pick, **kwargs)

    monkeypatch.setattr(Q, "kmeans", pinned_kmeans)
    monkeypatch.setattr(Q, "replace_dead_codes", pinned_replace)
    with jax.enable_x64(), jax.disable_jit():
        variables = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64) if a.dtype == np.float32 else a,
            variables)
        for step in range(2):
            x = _actions(5 + step).astype(np.float64)
            want, mutated = model.apply(
                variables, jnp.asarray(x), training=True, mutable=["vq"],
                rngs={"dropout": jax.random.PRNGKey(0), "vq": jax.random.PRNGKey(1)})
            variables = {**variables, **mutated}
            with torch.no_grad():
                got = port(torch.from_numpy(x))
            for k in ("z_indices", "q_indices"):
                np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
            for k in ("embeddings", "quantized_q", "reconstructed_actions"):
                np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                           atol=1e-6, rtol=1e-6, err_msg=k)
            vq = mutated["vq"]
            for k, v in vq.items():
                buf = "codebooks_initialized" if k == "initialized" else k
                np.testing.assert_allclose(getattr(port, buf).numpy(), np.asarray(v),
                                           atol=1e-6, rtol=1e-6, err_msg=f"step {step} {k}")
    assert port._initialized and bool(port.codebooks_initialized)
    # some codes of the k-means came out dead and were replaced by batch
    # samples; the telemetry reads the counts
    usage = get_codebook_usage(port)
    assert usage["z_used"] == KZ and usage["z_dead"] < KZ


def test_ema_update_matches_jax():
    rng = np.random.RandomState(6)
    flat = rng.randn(64, E).astype(np.float32)
    idx = rng.randint(0, KZ, 64)
    size = rng.uniform(0, 3, KZ).astype(np.float32)
    avg = rng.randn(KZ, E).astype(np.float32)
    want = JaxQ.ema_update(jnp.asarray(flat), jnp.asarray(idx), jnp.asarray(size),
                           jnp.asarray(avg), 0.99, eps=1e-5, normalize=True)
    got = Q.ema_update(torch.from_numpy(flat), torch.from_numpy(idx),
                       torch.from_numpy(size), torch.from_numpy(avg), 0.99, eps=1e-5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=1e-6)


def test_replace_dead_codes_with_the_same_draws_matches_jax():
    rng = np.random.RandomState(7)
    cb, avg = rng.randn(KZ, E).astype(np.float32), rng.randn(KZ, E).astype(np.float32)
    size = rng.uniform(0, 2, KZ).astype(np.float32)
    samples = rng.randn(40, E).astype(np.float32)
    key = jax.random.PRNGKey(8)
    want = JaxQ.replace_dead_codes(key, jnp.asarray(cb), jnp.asarray(avg),
                                   jnp.asarray(size), jnp.asarray(samples), 1.0)
    pick = jax.random.randint(key, (KZ,), 0, 40)   # the draw JAX makes inside
    got = Q.replace_dead_codes(torch.from_numpy(cb), torch.from_numpy(avg),
                               torch.from_numpy(size), torch.from_numpy(samples), 1.0,
                               pick=torch.tensor(np.asarray(pick)))
    assert (size < 1).any() and (size >= 1).any()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0)


def test_kmeans_with_the_same_draws_matches_jax(monkeypatch):
    """k-means++ seeding and 25 Lloyd steps. JAX's categorical draw is
    patched to its Gumbel-max form (argmax of the logits plus Gumbel noise
    from its key); the port gets the same first index and noise."""
    rng = np.random.RandomState(9)
    centers = 4.0 * rng.randn(8, 16)
    data = np.concatenate([c + 0.5 * rng.randn(12, 16) for c in centers])
    key = jax.random.PRNGKey(10)
    n, k = data.shape[0], 12

    def gumbel_max(key, logits, axis=-1, **kwargs):
        return jnp.argmax(logits + jax.random.gumbel(key, logits.shape, logits.dtype),
                          axis=axis)

    monkeypatch.setattr(jax.random, "categorical", gumbel_max)
    with jax.enable_x64(), jax.disable_jit():
        want_c, want_a = JaxQ.kmeans(key, jnp.asarray(data), k, 25)
        first = int(jax.random.randint(jax.random.fold_in(key, 0), (), 0, n))
        noise = np.stack([np.zeros(n)] + [
            np.asarray(jax.random.gumbel(jax.random.fold_in(key, i), (n,), jnp.float64))
            for i in range(1, k)])
    got_c, got_a = Q.kmeans(torch.from_numpy(data), k, 25, first=first,
                            noise=torch.from_numpy(noise))
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    # JAX's assignment sums keep float32 outputs (preferred_element_type)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), atol=1e-6, rtol=1e-6)


def test_kmeans_draws_from_the_generator():
    data = torch.randn(50, 8, generator=torch.Generator().manual_seed(0))
    runs = [Q.kmeans(data, 6, 5, generator=torch.Generator().manual_seed(s))[0]
            for s in (1, 1, 2)]
    torch.testing.assert_close(runs[0], runs[1], rtol=0, atol=0)
    assert not torch.equal(runs[0], runs[2])
