"""``models/diffusion_nets.py``, the port's against the JAX package's: the
noise schedule and the conditional 1-D UNet (``DiffusionPolicyUNet`` is held
in ``tests/test_torch_diffusion.py``).

* The schedule: its float32 tables and both inference grids equal to the
  bit; ``add_noise``, ``ddpm_step`` and ``ddim_step`` equal to the bit in
  float64 (the steps' coefficients are float32 scalars on both sides), at
  the chain's last step too, with ``clip_sample`` off and
  ``set_alpha_to_one`` off.
* The UNet's modules in float64 from JAX's weights through
  ``load_jax_variables``: Flax's ``ConvTranspose(4, 2, ((2, 2),),
  transpose_kernel=True)`` against ``ConvTranspose1d(4, 2, 1)``, the
  residual block with and without its 1x1 conv, and the UNet at down dims
  (8, 16, 32) (the unused shallowest skip), within 1e-10; its
  sequence-length rule raises. JAX computes the timestep embedding in
  float32 whatever x64 says: the port's (in the model's dtype) is held
  within 4e-6 of it, and the UNet test takes JAX's (``jax_embedding``).
* The port UNet's state dict is in the reference ``ConditionalUnet1D``'s
  layout: ``tests/test_diffusion_parity.py``'s mapping
  (``torch_port_helpers.torch_unet_to_flax``) reads it into the JAX UNet,
  which then gives the port's output.
"""

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from robot_manipulation_vq_vae_tpu.models import diffusion_nets as JaxDiff

from robot_manipulation_vq_vae_tpu_torch.models import diffusion_nets as PortDiff
from robot_manipulation_vq_vae_tpu_torch.utils.jax_weights import load_jax_variables
from torch_port_helpers import perturbed_variables, random_init, torch_unet_to_flax
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

B, A, TP = 6, 3, 8
DSED, GROUPS = 16, 4


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kwargs", [{}, {"clip_sample": False},
                                    {"set_alpha_to_one": False, "steps_offset": 1}],
                         ids=["default", "no_clip", "final_alpha_offset"])
def test_schedule_matches_jax_to_the_bit(kwargs):
    jax_s, port_s = JaxDiff.DiffusionSchedule(100, **kwargs), PortDiff.DiffusionSchedule(
        100, **kwargs)
    for name in ("betas", "alphas", "alphas_bar", "sqrt_ab", "sqrt_1mab"):
        want = np.asarray(getattr(jax_s, name))
        got = getattr(port_s, name)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want, err_msg=name)
    for n, ddim in ((100, False), (20, False), (10, True), (7, True)):
        np.testing.assert_array_equal(port_s.inference_timesteps(n, ddim),
                                      jax_s.inference_timesteps(n, ddim))
    rng = np.random.RandomState(0)
    x, eps, noise = (rng.randn(B, TP, A) * 1.5 for _ in range(3))
    tt = rng.randint(0, 100, B)
    with jax.enable_x64():
        np.testing.assert_array_equal(
            port_s.add_noise(torch.tensor(x), torch.tensor(noise), torch.tensor(tt)).numpy(),
            np.asarray(jax_s.add_noise(jnp.asarray(x), jnp.asarray(noise), jnp.asarray(tt))))
        for t, t_prev in ((99, 94), (50, 45), (4, -1), (0, -5)):
            got = port_s.ddim_step(torch.tensor(x), torch.tensor(eps), t, t_prev).numpy()
            np.testing.assert_array_equal(got, np.asarray(jax_s.ddim_step(
                jnp.asarray(x), jnp.asarray(eps), t, t_prev)), err_msg=f"ddim {t}")
            key = jax.random.PRNGKey(t)
            want = np.asarray(jax_s.ddpm_step(key, jnp.asarray(x), jnp.asarray(eps), t, t_prev))
            draw = np.asarray(jax.random.normal(key, x.shape))
            got = port_s.ddpm_step(torch.tensor(x), torch.tensor(eps), t, t_prev,
                                   torch.tensor(draw)).numpy()
            np.testing.assert_array_equal(got, want, err_msg=f"ddpm {t}")


# ---------------------------------------------------------------------------
# the UNet's modules
# ---------------------------------------------------------------------------

def test_timestep_embedding_matches_jax():
    """JAX computes the embedding in float32 whatever x64 says (the port in
    the model's dtype): within 4e-6 (measured 1.9e-6 at width 16 over
    timesteps 0-99: float32 sines of up to 99 radians, whose ulp is
    7.6e-6)."""
    tt = np.arange(100)
    with jax.enable_x64():
        want = np.asarray(JaxDiff.SinusoidalPosEmb(DSED).apply(
            {}, jnp.asarray(tt).astype(jnp.float32)))
    assert want.dtype == np.float32
    got = PortDiff.SinusoidalPosEmb(DSED)(torch.tensor(tt, dtype=torch.float64))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=4e-6)


def jax_embedding_forward(self, t):
    """JAX's float32 timestep embedding in the model's dtype: the UNet and
    algo tests take it in place of the port's, so that they hold the rest in
    float64."""
    with jax.enable_x64():
        emb = JaxDiff.SinusoidalPosEmb(self.dim).apply(
            {}, jnp.asarray(t.detach().numpy()).astype(jnp.float32))
    return torch.tensor(np.asarray(emb), dtype=t.dtype)


@pytest.fixture
def jax_embedding(monkeypatch):
    monkeypatch.setattr(PortDiff.SinusoidalPosEmb, "forward", jax_embedding_forward)


def _flax(module, *inputs, seed=0):
    """(variables as the port takes them, output) of a Flax @module in
    float64, every leaf made random."""
    with jax.enable_x64():
        inputs = [jnp.asarray(v) for v in inputs]
        variables = random_init(lambda rng, args: module.init(rng, *args))(
            jax.random.PRNGKey(seed), inputs)
        nested, flat = perturbed_variables(variables, seed + 1)
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), nested)
        return flat, np.asarray(jax.jit(module.apply)(params, *inputs))


def test_conv_transpose_matches_flax():
    x = np.random.RandomState(1).randn(B, 4, 5)
    flat, want = _flax(fnn.ConvTranspose(5, (4,), strides=(2,), padding=((2, 2),),
                                         transpose_kernel=True, name="up"), x)
    port = PortDiff.Upsample1d(5).double()
    load_jax_variables(port.conv, flat)
    got = port(torch.tensor(x).transpose(1, 2)).transpose(1, 2)
    assert got.shape == (B, 8, 5)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("c_in", [4, 8], ids=["res_conv", "identity"])
def test_residual_block_matches_jax(c_in):
    rng = np.random.RandomState(2)
    x, cond = rng.randn(B, TP, c_in), rng.randn(B, 7)
    flat, want = _flax(JaxDiff.ConditionalResBlock1d(8, 5, GROUPS), x, cond)
    port = PortDiff.ConditionalResidualBlock1D(c_in, 8, 7, 5, GROUPS).double()
    load_jax_variables(port, flat)
    got = port(torch.tensor(x).transpose(1, 2), torch.tensor(cond)).transpose(1, 2)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-10)


@pytest.mark.parametrize("down_dims", [(8, 16, 32)], ids=["3_levels"])
def test_unet_matches_jax(down_dims, jax_embedding):
    """Three levels, so that the shallowest skip goes unused (the algo tests
    run two)."""
    rng = np.random.RandomState(3)
    x, tt, cond = rng.randn(B, TP, A), rng.randint(0, 100, B), rng.randn(B, 7)
    jm = JaxDiff.ConditionalUnet1D(action_dim=A, down_dims=down_dims,
                                   diffusion_step_embed_dim=DSED, kernel_size=5,
                                   n_groups=GROUPS)
    flat, want = _flax(jm, x, tt, cond)
    port = PortDiff.ConditionalUnet1D(A, 7, DSED, down_dims, 5, GROUPS).double()
    load_jax_variables(port, flat)
    got = port(torch.tensor(x), torch.tensor(tt), torch.tensor(cond))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-10)
    with pytest.raises(ValueError, match="must divide"):
        port(torch.tensor(x[:, :TP - 1]), torch.tensor(tt), torch.tensor(cond))


def test_unet_state_dict_is_in_the_reference_layout(jax_embedding):
    """The port UNet's own state dict, read by the reference layout's
    mapping (``tests/test_diffusion_parity.py``'s ``torch_unet_to_flax``),
    drives the JAX UNet to the port's output: every key name and layout is
    the reference ``ConditionalUnet1D``'s."""
    down_dims = (8, 16, 32)
    torch.manual_seed(0)
    port = PortDiff.ConditionalUnet1D(A, 7, DSED, down_dims, 5, GROUPS).double()
    rng = np.random.RandomState(6)
    x, tt, cond = rng.randn(B, TP, A), rng.randint(0, 100, B), rng.randn(B, 7)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    jm = JaxDiff.ConditionalUnet1D(action_dim=A, down_dims=down_dims,
                                   diffusion_step_embed_dim=DSED, kernel_size=5,
                                   n_groups=GROUPS)
    with jax.enable_x64():
        want = np.asarray(jax.jit(jm.apply)({"params": torch_unet_to_flax(sd, down_dims)},
                                            jnp.asarray(x), jnp.asarray(tt), jnp.asarray(cond)))
    got = port(torch.tensor(x), torch.tensor(tt), torch.tensor(cond))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-10)
