"""Shared pieces of the bf16 parity tests (tests/test_torch_bf16_*.py): a
module of the port applied through ``utils/mixed_precision.half_call``
against the JAX module applied to bf16 casts of the same (perturbed)
variables and inputs, as the JAX package's bf16 steps apply it."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from robot_manipulation_vq_vae_tpu_torch.utils.jax_weights import load_jax_variables
from robot_manipulation_vq_vae_tpu_torch.utils.mixed_precision import half_call
# torch on one thread in each bf16 test module (imported by each of them)
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)
from torch_port_helpers import perturbed_variables

# the tolerance of a bf16 output: its largest |value| times this
REL = 2e-2


def half_tree(tree):
    """JAX's ``_cast_half``: every floating leaf to bf16."""
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(a).astype(jnp.bfloat16)
        if jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating) else jnp.asarray(a), tree)


def init_pair(jax_module, port_module, init_args, seed=1, init_kwargs=None, **perturb):
    """JAX's variables (every leaf made random) in both modules; the nested
    numpy tree for JAX."""
    variables = jax.jit(lambda *a: jax_module.init(jax.random.PRNGKey(0), *a,
                                                  **(init_kwargs or {})))(
        *[jnp.asarray(a, jnp.float32) if np.asarray(a).dtype.kind == "f" else jnp.asarray(a)
          for a in init_args])
    nested, flat = perturbed_variables(variables, seed, **perturb)
    load_jax_variables(port_module, flat)
    return nested


def jax_half_apply(jax_module, nested, args, mutable=False, rngs=None, cast_inputs=True,
                   **kwargs):
    """@jax_module applied (under jit) to bf16 casts of @nested and (with
    @cast_inputs) of the floating @args, else to @args as float32; returns
    the output (and the updated collections where @mutable)."""
    def apply(variables, *a):
        return jax_module.apply(variables, *a, mutable=mutable, rngs=rngs, **kwargs)

    args = [jnp.asarray(a, jnp.float32) if np.asarray(a).dtype.kind == "f" else jnp.asarray(a)
            for a in args]
    return jax.jit(apply)(half_tree(nested), *(half_tree(args) if cast_inputs else args))


def port_half_apply(port_module, args, cast_inputs=True, **kwargs):
    """@port_module through ``half_call``; without @cast_inputs its floating
    @args go in as fp32."""
    args = tuple(torch.as_tensor(np.asarray(a, np.float32) if np.asarray(a).dtype.kind == "f"
                                 else np.asarray(a)) for a in args)
    return half_call(port_module, args, kwargs, cast_inputs=cast_inputs)


def assert_half_close(got, want, rel=REL, msg="", fp32=None):
    """@got (torch) within @rel of @want's (JAX) largest |value|, in the same
    dtype; given @fp32, JAX's fp32 output, within twice JAX's own distance
    from it where that is larger (a quantity that bf16 rounding moves by
    more than @rel on JAX's side too). Returns the error as a fraction of
    that largest value."""
    want_dtype = str(jnp.asarray(want).dtype)
    assert str(got.dtype).replace("torch.", "") == want_dtype, (msg, got.dtype, want_dtype)
    w = np.asarray(jnp.asarray(want, jnp.float32))
    g = got.detach().float().numpy()
    assert g.shape == w.shape, (msg, g.shape, w.shape)
    top = float(np.abs(w).max())
    if fp32 is not None:
        rel = max(rel, 2 * float(np.abs(np.asarray(fp32, np.float32) - w).max()) / top)
    err = float(np.abs(g - w).max()) / max(top, 1e-30)
    assert err <= rel, f"{msg}: {err:.3g} of the largest |value| {top:.3g}"
    return err
