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



def assert_mostly_close(actual, desired, atol, frac, max_abs, msg=""):
    """At least @frac of the elements within @atol, and every element within
    @max_abs: after a few Adam steps a weight whose gradient lies within the
    two frameworks' rounding of 0 moves by up to the learning rate the other
    way, while the bulk must agree tightly."""
    diff = np.abs(np.asarray(actual, np.float64) - np.asarray(desired, np.float64))
    ok = float((diff <= atol).mean())
    assert ok >= frac, f"{msg}: {ok:.4f} of the elements within {atol} (need {frac})"
    assert diff.max() <= max_abs, f"{msg}: max |diff| {diff.max():.3g} > {max_abs}"


def write_demo_file(path, demo_lengths, with_images=True, seed=0, a=3):
    """A robomimic-format HDF5 demo file (a copy of tests/test_dataset.py's
    writer): demo i holds eef_pos[t] = [i, t, 0], seeded 8 x 8 uint8 images,
    actions arange(T * a) + 100 i, the language "task i", and the filter key
    ``first_only`` naming demo_0."""
    import json

    import h5py

    rng = np.random.RandomState(seed)
    with h5py.File(path, "w") as f:
        data = f.create_group("data")
        total = 0
        for i, t in enumerate(demo_lengths):
            ep = data.create_group(f"demo_{i}")
            ep.attrs["num_samples"] = t
            ep.attrs["ep_meta"] = json.dumps({"lang": f"task {i}"})
            obs = ep.create_group("obs")
            obs.create_dataset("eef_pos", data=np.stack(
                [np.full(t, i), np.arange(t), np.zeros(t)], axis=1).astype(np.float32))
            if with_images:
                obs.create_dataset("cam_image", data=rng.randint(
                    0, 255, size=(t, 8, 8, 3), dtype=np.uint8))
            ep.create_dataset("actions", data=np.arange(t * a).reshape(t, a).astype(
                np.float32) + 100 * i)
            total += t
        f.create_group("mask").create_dataset("first_only", data=np.array([b"demo_0"]))
        data.attrs["total"] = total
    return path


def assert_trees_equal(got, want, path=""):
    """Two nested dicts of arrays (numpy, torch or JAX) are equal to the bit,
    with the same keys, shapes and dtypes; None leaves match None."""
    if isinstance(want, dict):
        assert isinstance(got, dict), path
        assert set(got) == set(want), f"{path}: keys {sorted(got)} vs {sorted(want)}"
        for k in want:
            assert_trees_equal(got[k], want[k], f"{path}/{k}")
        return
    if want is None:
        assert got is None, path
        return
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype, f"{path}: dtype {got.dtype} vs {want.dtype}"
    assert got.shape == want.shape, f"{path}: shape {got.shape} vs {want.shape}"
    np.testing.assert_array_equal(got, want, err_msg=path)


def _np(a):
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def float64_tree(tree):
    """Every float32 leaf of @tree as a float64 JAX array (call under
    ``jax.enable_x64``); other leaves as JAX arrays."""
    import jax
    import jax.numpy as jnp

    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float64) if np.asarray(a).dtype == np.float32
        else jnp.asarray(a), tree)


def jax_algo_jit_init(name, cfg, shapes, ac_dim):
    """The JAX package's algo @name, its variables initialized under
    ``jax.jit`` (the same computation; eagerly each op of a Mamba scan
    compiles on its own, which takes tens of seconds)."""
    import jax

    import robot_manipulation_vq_vae_tpu.algo as JaxAlgo
    from robot_manipulation_vq_vae_tpu.utils import obs_utils as JaxObsUtils

    JaxObsUtils.initialize_obs_utils_with_config(cfg)
    algo = JaxAlgo.algo_factory(name, cfg, shapes, ac_dim)
    algo._init_variables = jax.jit(algo._init_variables)
    return algo


def check_step_metrics(metrics, keys, rtol):
    """[(JAX metrics, port metrics)] per step: @keys within @rtol relative."""
    for want, got in metrics:
        for k in keys:
            np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=1e-12, err_msg=k)


def check_parameters(got_module, want_module, tol, loose=(), loose_tol=None):
    """Each parameter of @got_module within @tol of the largest element of
    @want_module's; those whose names contain one of @loose within
    @loose_tol."""
    want = dict(want_module.named_parameters())
    assert set(want) == {n for n, _ in got_module.named_parameters()}
    for n, p in got_module.named_parameters():
        bound = loose_tol if any(s in n for s in loose) else tol
        err = float((p - want[n]).detach().abs().max()) / float(want[n].detach().abs().max())
        assert err <= bound, f"{n}: {err} of its largest"
