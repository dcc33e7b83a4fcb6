"""Parity of the PyTorch port's LipVQ pieces with the JAX package: the
nearest-code search (plain version against ``Q.l2_nearest`` and the Pallas
assign kernel in interpret mode), the fused roundtrip's plain version against
the Pallas roundtrip kernel in interpret mode, and LipVQVAE's three call
modes, with the JAX weights carried across by ``load_jax_variables``. The
CUDA kernels themselves are held against their plain versions on the card
by tests/test_torch_kernels_cuda.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robot_manipulation_vq_vae_tpu.models.tokenizers.lipvq import (
    LipVQVAE as JaxLipVQVAE,
)
from robot_manipulation_vq_vae_tpu.ops import quantize as Q
from robot_manipulation_vq_vae_tpu.ops.pallas.lipvq_kernel import (
    l2_nearest_pallas,
    lipvq_roundtrip_pallas,
)
from robot_manipulation_vq_vae_tpu.utils.ckpt_conversion import (
    convert_lipvq,
    flatten_variables,
)

from robot_manipulation_vq_vae_tpu_torch.models.tokenizers.lipvq import LipVQVAE
from robot_manipulation_vq_vae_tpu_torch.ops import lipvq_kernel as K
from robot_manipulation_vq_vae_tpu_torch.ops import quantize as TQ
from robot_manipulation_vq_vae_tpu_torch.utils.jax_weights import (
    load_jax_variables,
)
from torch_port_helpers import assert_margin, perturbed_variables

FEATURE, LATENT, CODES = 12, 24, 64


def _near_code_inputs(seed, n, k, d):
    """Rows near random codes: far from every Voronoi boundary."""
    rng = np.random.RandomState(seed)
    cb = rng.randn(k, d).astype(np.float32)
    z = (cb[rng.randint(0, k, n)] + 0.1 * rng.randn(n, d)).astype(np.float32)
    return z, cb


@pytest.mark.parametrize("n,k,d", [(50, 64, 37), (130, 256, 210)])
def test_l2_nearest_plain_matches_jax_and_pallas(n, k, d):
    z, cb = _near_code_inputs(0, n, k, d)
    assert_margin(z, cb, 1e-4)
    idx_x, zq_x = Q.l2_nearest(jnp.asarray(z), jnp.asarray(cb))
    idx_p, zq_p = l2_nearest_pallas(jnp.asarray(z), jnp.asarray(cb), 64, True)
    for nearest in (K.l2_nearest_plain, TQ.l2_nearest, K.l2_nearest_cuda):
        idx_t, zq_t = nearest(torch.from_numpy(z), torch.from_numpy(cb))
        np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_x))
        np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_p))
        np.testing.assert_allclose(zq_t.numpy(), np.asarray(zq_p), atol=1e-6)
        np.testing.assert_allclose(zq_t.numpy(), np.asarray(zq_x), atol=1e-6)


def test_l2_nearest_ties_keep_the_first_index():
    """Duplicated codes tie exactly: every version keeps the lowest index,
    as jnp.argmin does."""
    rng = np.random.RandomState(1)
    base = rng.randn(8, 16).astype(np.float32)
    cb = np.concatenate([base, base, base])            # codes k, k+8, k+16 tie
    z = (base[rng.randint(0, 8, 40)] + 0.05 * rng.randn(40, 16)).astype(np.float32)
    idx_p, _ = l2_nearest_pallas(jnp.asarray(z), jnp.asarray(cb), 64, True)
    idx_t, _ = K.l2_nearest_plain(torch.from_numpy(z), torch.from_numpy(cb))
    assert int(np.asarray(idx_p).max()) < 8
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_p))


def _jax_lipvq(seed, feature=FEATURE, latent=LATENT, codes=CODES):
    model = JaxLipVQVAE(feature_dim=feature, latent_dim=latent, num_codes=codes,
                        use_pallas=False)
    variables = model.init(jax.random.PRNGKey(seed), jnp.zeros((4, feature)))
    # Dense kernels x4: pre-activations of order 1, where erf- and tanh-GELU
    # differ by more than the tolerance
    variables, flat = perturbed_variables(variables, seed, kernel_scale=4.0)
    port = LipVQVAE(feature, latent, num_codes=codes)
    load_jax_variables(port, flat)
    return model, variables, port


def test_lipvq_call_encode_decode_match_jax():
    model, variables, port = _jax_lipvq(0)
    x = np.random.RandomState(2).uniform(-1, 1, (3, 5, FEATURE)).astype(np.float32)
    z_j, loss_j = model.apply(variables, jnp.asarray(x))
    ze_j, idx_j = model.apply(variables, jnp.asarray(x), method=model.encode)
    rec_j = model.apply(variables, idx_j, method=model.decode_codes)
    with torch.no_grad():
        z_t, loss_t = port(torch.from_numpy(x))
        ze_t, idx_t = port.encode(torch.from_numpy(x))
        rec_t = port.decode_codes(idx_t)
    assert_margin(np.asarray(ze_j).reshape(-1, LATENT),
                  variables["params"]["quantizer"]["codebook"], 1e-4)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), atol=1e-5)
    np.testing.assert_allclose(float(loss_t), float(loss_j), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(ze_t.numpy(), np.asarray(ze_j), atol=1e-5)
    np.testing.assert_allclose(rec_t.numpy(), np.asarray(rec_j), atol=1e-5)


def _jax_fused_weights(p):
    W, ci = p["to_latent"]["W"], p["to_latent"]["ci"]
    absrowsum = jnp.sum(jnp.abs(W), axis=1, keepdims=True)
    wl = (W * jnp.minimum(1.0, jax.nn.softplus(ci)[:, None] / absrowsum)).T
    return dict(
        enc_w=((p["enc1"]["kernel"], p["enc1"]["bias"]),
               (p["enc2"]["kernel"], p["enc2"]["bias"])),
        lip_w=(wl, p["to_latent"]["b"]),
        codebook=p["quantizer"]["codebook"],
        dec_w=((p["dec1"]["kernel"], p["dec1"]["bias"]),
               (p["dec2"]["kernel"], p["dec2"]["bias"]),
               (p["to_output"]["kernel"], p["to_output"]["bias"])),
    )


def test_roundtrip_plain_matches_pallas_interpret():
    """The fused roundtrip at the tokenizer bench's latent width (210) and
    weights ~N(0, 0.5^2), as the tokenizer bench draws them. Its outputs
    reach ~100, so recon agrees to 1e-5 absolute or 1e-6 relative (fp32
    sums in another order)."""
    latent, codes = 210, 256
    model = JaxLipVQVAE(feature_dim=FEATURE, latent_dim=latent, num_codes=codes,
                        use_pallas=False)
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((4, FEATURE)))
    leaves, treedef = jax.tree_util.tree_flatten(variables)
    rng = np.random.RandomState(11)
    variables = jax.tree_util.tree_unflatten(
        treedef, [rng.normal(0, 0.5, l.shape).astype(np.float32) for l in leaves]
    )
    port = LipVQVAE(FEATURE, latent, num_codes=codes)
    load_jax_variables(port, flatten_variables(variables))
    x = np.random.RandomState(7).randn(96, FEATURE).astype(np.float32)
    rec_j, idx_j = lipvq_roundtrip_pallas(
        jnp.asarray(x), **_jax_fused_weights(variables["params"]),
        block_n=32, interpret=True,
    )
    rec_t, idx_t = port.roundtrip_fused(torch.from_numpy(x))
    z, _ = port.encode(torch.from_numpy(x))   # erf-GELU latents: margin check
    assert_margin(z.detach().numpy(), variables["params"]["quantizer"]["codebook"], 1e-4)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(rec_t.numpy(), np.asarray(rec_j), atol=1e-5, rtol=1e-6)


def test_lipvq_state_dict_keeps_reference_layout():
    """port state_dict -> the JAX package's reference-checkpoint converter ->
    exactly the original JAX params: the port keeps the reference torch key
    names and [out, in] layouts."""
    _, variables, port = _jax_lipvq(3)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    back = convert_lipvq(sd)
    want = jax.tree_util.tree_map(np.asarray, variables["params"])
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)


def test_load_rejects_missing_and_unused_keys():
    _, variables, port = _jax_lipvq(4)
    flat = flatten_variables(variables)
    missing = dict(flat)
    missing.pop("params/quantizer/codebook")
    with pytest.raises(KeyError, match="missing"):
        load_jax_variables(port, missing)
    with pytest.raises(KeyError, match="unused"):
        load_jax_variables(port, {**flat, "params/extra/kernel": np.zeros(3)})

