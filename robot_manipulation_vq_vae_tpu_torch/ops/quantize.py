"""Codebook distance math (counterpart of the JAX package's
``ops/quantize.py:30-55``): the pairwise search as matrix products instead of
the [N, K, D] difference tensor.

The reference quantizer's "sign mask" is a mathematical no-op (its entries are
+/-1 inside an L2 norm), so the LipVQ quantizer is a plain L2 nearest-neighbour
search. The fused assign kernel and its plain version live in
``ops/lipvq_kernel.py``.
"""


def l2_distance_sq(z, codebook):
    """Pairwise squared L2 distances via the expanded quadratic form.

    Args:
        z: [N, D] query vectors.
        codebook: [K, D] code vectors.
    Returns:
        [N, K] squared distances.
    """
    z_sq = (z * z).sum(-1, keepdim=True)
    c_sq = (codebook * codebook).sum(-1)
    return z_sq - 2.0 * (z @ codebook.t()) + c_sq[None, :]


def l2_nearest(z, codebook):
    """Nearest code under L2. Returns (indices [N] int64, z_q [N, D]); the
    first index wins a tie, as ``jnp.argmin`` does."""
    idx = l2_distance_sq(z, codebook).argmin(-1)
    return idx, codebook[idx]
