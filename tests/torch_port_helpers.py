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


class PinnedJaxRandom:
    """A stand-in for the ``jax`` module inside one JAX package module
    (monkeypatch that module's global ``jax`` with it): ``random.uniform``,
    ``randint`` and ``normal`` return values drawn from a seeded numpy
    RandomState (a uniform's already scaled to its range; @fixed {name:
    value} pins one outright), each logged as (name, value) in call order;
    everything else is JAX's. Under ``jit`` the values are constants of the
    trace. ``port_draws`` replays the log into the port's randomizers.

    A 0-d ``randint`` comes back as a numpy value, and ``lax.switch`` on
    such a constant index calls the branch ``lax.switch`` would take,
    clamped as it clamps, and traces no other: the color jitter's 24 orders
    cost the trace of one."""

    def __init__(self, seed, fixed=None):
        import types

        import jax

        self._jax = jax
        self.rng = np.random.RandomState(seed)
        self.fixed = dict(fixed or {})
        self.log = []
        self.random = types.SimpleNamespace(
            split=jax.random.split, PRNGKey=jax.random.PRNGKey,
            uniform=self._uniform, randint=self._randint, normal=self._normal)
        self.lax = _PinnedLax(jax.lax)

    def __getattr__(self, name):
        return getattr(self._jax, name)

    def _record(self, name, value, dtype):
        """Log numpy @value; return it as a JAX array of @dtype (a constant
        of the trace under jit)."""
        import jax.numpy as jnp

        value = np.asarray(value, dtype)
        self.log.append((name, value))
        return jnp.asarray(value)

    def _float(self):
        return self._jax.dtypes.canonicalize_dtype(np.float64)

    def _uniform(self, key, shape=(), dtype=None, minval=0.0, maxval=1.0):
        u = self.rng.rand(*shape)
        return self._record("uniform", minval + (maxval - minval) * u, self._float())

    def _randint(self, key, shape, minval, maxval, dtype=None):
        value = self.fixed.get("randint", self.rng.randint(minval, maxval, size=shape))
        out = self._record("randint", np.broadcast_to(value, shape),
                           self._jax.dtypes.canonicalize_dtype(np.int64))
        return self.log[-1][1] if not shape else out

    def _normal(self, key, shape=(), dtype=None):
        return self._record("normal", self.rng.randn(*shape), self._float())


class _PinnedLax:
    """``jax.lax`` with ``switch`` taking a constant index's branch alone."""

    def __init__(self, lax):
        self._lax = lax
        self.pinned = 0   # switches taken on a constant index

    def __getattr__(self, name):
        return getattr(self._lax, name)

    def switch(self, index, branches, *operands):
        try:
            i = int(index)
        except TypeError:   # a traced index
            return self._lax.switch(index, branches, *operands)
        self.pinned += 1
        return branches[min(max(i, 0), len(branches) - 1)](*operands)


def port_draws(monkeypatch, log, obs_core):
    """Make the port's randomizers in @obs_core draw the values of @log (a
    ``PinnedJaxRandom`` log) in order, from its start again once it is used
    up: a crop takes two randint entries, a color jitter a uniform per
    enabled jitter and a randint, the Gaussian noise a normal. Returns the
    replay's state ({"i": entries taken})."""
    import torch

    state = {"i": 0}

    def pop(kind):
        name, value = log[state["i"] % len(log)]
        state["i"] += 1
        assert name == kind, f"entry {state['i'] - 1}: {name}, expected {kind}"
        return torch.from_numpy(value)

    monkeypatch.setattr(obs_core.CropRandomizer, "draw", lambda self, x, gen: tuple(
        pop("randint").long().to(x.device) for _ in range(2)))
    monkeypatch.setattr(obs_core.ColorRandomizer, "draw", lambda self, x, gen: (
        {n: pop("uniform").to(x.device, x.dtype) for n in self.ranges},
        int(pop("randint"))))
    monkeypatch.setattr(obs_core.GaussianNoiseRandomizer, "draw",
                        lambda self, x, gen: pop("normal").to(x.device, x.dtype))
    return state
