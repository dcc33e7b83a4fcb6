"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py):
the same seeded numpy inputs and weights go through the JAX package and the
port, with the JAX weights carried across by ``load_jax_variables``."""

import numpy as np

from robot_manipulation_vq_vae_tpu.utils.ckpt_conversion import (
    flatten_variables,
    unflatten_npz,
)


def perturbed_variables(variables, seed, kernel_scale=1.0, scale_under=""):
    """The JAX variables with every leaf that Flax initializes to a constant
    (biases, norm scales, batch statistics, zero timestep tables) made
    random, so that the parity tests see each of them. Dense and conv
    kernels whose path contains @scale_under are multiplied by
    @kernel_scale: at their small default scale, activation forms (erf vs
    tanh GELU) and token order would hide below the tolerance. Returns
    (nested numpy tree for JAX, flat dict for the port)."""
    rng = np.random.RandomState(seed)
    flat = {}
    for key, value in flatten_variables(variables).items():
        value = np.asarray(value, np.float32)
        leaf = key.rsplit("/", 1)[-1]
        if leaf == "kernel" and scale_under in key:
            value = value * kernel_scale
        if leaf == "var":
            value = rng.uniform(0.5, 1.5, value.shape)
        elif leaf == "mean":
            value = rng.normal(0.0, 0.2, value.shape)
        elif leaf in ("scale", "bias", "b", "ci", "embed_timestep"):
            value = value + rng.normal(0.0, 0.2, value.shape)
        flat[key] = value.astype(np.float32)
    return unflatten_npz(flat), flat


def assert_margin(z, codebook, min_margin):
    """The inputs are away from Voronoi boundaries: on every row, the second
    best squared distance exceeds the best by more than @min_margin
    (computed in float64), so two correct implementations must pick the
    same code."""
    z = np.asarray(z, np.float64)
    cb = np.asarray(codebook, np.float64)
    d = (z * z).sum(-1, keepdims=True) - 2.0 * z @ cb.T + (cb * cb).sum(-1)[None]
    part = np.partition(d, 1, axis=-1)
    margin = (part[:, 1] - part[:, 0]).min()
    assert margin > min_margin, f"inputs too close to a tie: margin {margin}"

