"""The imitation baselines under ``train.mixed_precision``: the port's bf16
modules and steps against the JAX package's, from the same carried-over
weights (every leaf made random) and the same seeded numpy inputs, and the
classes whose JAX step ignores the flag.

* Modules, through ``half_call`` against the JAX modules applied to bf16
  casts of the variables (and of the inputs, or fp32 inputs where the
  layer meets them so): the trunks' ``GroupNorm`` on a bf16 and on an fp32
  input (Flax's statistics and normalization in fp32, one rounding), the
  UNet's ``Conv1dBlock`` (its ``nn.GroupNorm`` and Mish) and the 3-level
  conditional UNet with a bf16 condition (low-dimensional observations) and
  an fp32 one (keypoints): the output's type and every value within 2e-2
  of its largest |value|.
* ``BC_Transformer`` (tests/test_torch_bc.py's sizes: GPT 2 x 16, T 4,
  B 16) and ``DiffusionPolicyUNet`` (tests/test_torch_diffusion.py's: down
  dims (16, 32), To 2, Tp 8, EMA on; JAX's timesteps and noise replayed
  from its key): 3 bf16 steps against the JAX algo's, every metric within
  2 %; the masters (and the EMA shadows) stay fp32 and move; ``get_action``
  of the bf16-mode algo equals the fp32-mode algo's from the same weights
  (and, for the diffusion policy, the same draws) to the bit.
* Every class whose JAX step ignores the flag and trains fp32 under it
  raises ``NotImplementedError`` naming ``mixed_precision``.
"""

import copy

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from robot_manipulation_vq_vae_tpu.models import diffusion_nets as JaxDiff

import robot_manipulation_vq_vae_tpu_torch.algo as PortAlgo
from robot_manipulation_vq_vae_tpu_torch.config import config_factory
from robot_manipulation_vq_vae_tpu_torch.models import base_nets as PortBaseNets
from robot_manipulation_vq_vae_tpu_torch.models import diffusion_nets as PortDiff
from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils as PortObsUtils
from robot_manipulation_vq_vae_tpu_torch.utils.jax_weights import load_jax_variables
from robot_manipulation_vq_vae_tpu_torch.utils.mixed_precision import half_call
import test_torch_bc as BC
import test_torch_diffusion as DP
from torch_bf16_helpers import assert_half_close, half_tree, init_pair, jax_half_apply, \
    port_half_apply
from torch_bf16_helpers import one_torch_thread  # noqa: F401 (autouse)
from torch_port_helpers import perturbed_variables, set_jax_state

STEPS = 3


def _mixed(cfg):
    with cfg.values_unlocked():
        cfg.train.mixed_precision = True
    return cfg


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("half_input", [True, False], ids=["bf16_input", "fp32_input"])
def test_group_norm_bf16_matches_jax(half_input):
    x = np.random.RandomState(0).randn(2, 5, 6, 64) * 3.0 + 1.0
    jax_m, port = fnn.GroupNorm(num_groups=4, epsilon=1e-5), PortBaseNets.GroupNorm(64)
    nested = init_pair(jax_m, port, [x])
    want = jax_half_apply(jax_m, nested, [x], cast_inputs=half_input)
    got = port_half_apply(port, [np.moveaxis(x, -1, 1)], cast_inputs=half_input)
    assert got.dtype == (torch.bfloat16 if half_input else torch.float32)
    assert_half_close(got.permute(0, 2, 3, 1), want, msg="group_norm")


def test_unet_conv_block_bf16_matches_jax():
    x = np.random.RandomState(1).randn(3, 8, 12)
    jax_m, port = JaxDiff.Conv1dBlock(16, 5, 4), PortDiff.Conv1dBlock(12, 16, 5, 4)
    nested = init_pair(jax_m, port, [x])
    want = jax_half_apply(jax_m, nested, [x])
    got = port_half_apply(port, [np.moveaxis(x, -1, 1)])
    assert got.dtype == torch.bfloat16
    assert_half_close(got.transpose(1, 2), want, msg="conv_block")


@pytest.mark.parametrize("half_cond", [True, False], ids=["bf16_cond", "fp32_cond"])
def test_unet_bf16_matches_jax(half_cond):
    """The noisy actions bf16, the timesteps integers, the condition as the
    encoder gives it; the sinusoidal embedding is fp32 on both sides, so
    the output is fp32."""
    rng = np.random.RandomState(3)
    x, t, cond = rng.randn(2, 8, 5), rng.randint(0, 100, 2), rng.randn(2, 7)
    jax_m = JaxDiff.ConditionalUnet1D(action_dim=5, down_dims=(8, 16, 32),
                                      diffusion_step_embed_dim=16, kernel_size=5, n_groups=4)
    port = PortDiff.ConditionalUnet1D(5, 7, 16, (8, 16, 32), 5, 4)
    nested = init_pair(jax_m, port, [x, t, cond])
    cond_j = jnp.asarray(cond, jnp.float32)
    want = jax.jit(jax_m.apply)(half_tree(nested), half_tree(jnp.asarray(x, jnp.float32)),
                                jnp.asarray(t), half_tree(cond_j) if half_cond else cond_j)
    cond_t = torch.tensor(cond, dtype=torch.float32)
    got = half_call(port, (torch.tensor(x, dtype=torch.float32).bfloat16(), torch.tensor(t),
                           cond_t.bfloat16() if half_cond else cond_t), cast_inputs=False)
    assert got.dtype == torch.float32
    assert_half_close(got, want, msg="unet")


# ---------------------------------------------------------------------------
# BC_Transformer and DiffusionPolicyUNet: 3 bf16 steps each
# ---------------------------------------------------------------------------

def _jax_state(jax_algo, batch, seed):
    """@jax_algo's policy variables made random: (flat variables for the
    port, the nested tree)."""
    jax_algo.ensure_state(jax_algo.process_batch_for_training(batch))
    nested, flat = perturbed_variables({"params": jax_algo.state.params["policy"]}, seed)
    return nested, flat


@pytest.fixture(scope="module")
def bc_transformer():
    rng = np.random.RandomState(0)
    batches = [BC._batch(rng) for _ in range(STEPS)]
    jax_algo = BC._make("transformer", "jax")
    with jax_algo.global_config.values_unlocked():
        jax_algo.global_config.train.mixed_precision = True
    nested, flat = _jax_state(jax_algo, batches[0], 3)
    set_jax_state(jax_algo, {"policy": nested})
    cfg = _mixed(BC._tune(config_factory("bc"), "transformer"))
    PortObsUtils.initialize_obs_utils_with_config(cfg)
    algo = PortAlgo.algo_factory("bc", cfg, {"flat": (BC.O,)}, BC.A, device="cpu")
    assert type(algo).__name__ == "BC_Transformer" and algo.mixed_precision
    load_jax_variables(algo.nets["policy"], flat)
    fp32 = BC._make("transformer", "port")
    start = copy.deepcopy(algo.nets.state_dict())
    metrics = []
    for b in batches:
        want = jax_algo.train_on_batch(jax_algo.process_batch_for_training(b),
                                       epoch=0)["losses"]
        got = algo.train_on_batch(algo.process_batch_for_training(b), epoch=0)["losses"]
        metrics.append(({k: float(v) for k, v in want.items()},
                        {k: float(v) for k, v in got.items()}))
    return dict(port=algo, fp32=fp32, start=start, metrics=metrics)


@pytest.fixture(scope="module")
def diffusion():
    rng = np.random.RandomState(0)
    batches = [DP._batch(rng) for _ in range(STEPS)]
    jax_algo = DP._make("jax", False)
    with jax_algo.global_config.values_unlocked():
        jax_algo.global_config.train.mixed_precision = True
    nested, flat = _jax_state(jax_algo, batches[0], 3)
    set_jax_state(jax_algo, {"policy": nested, "obs_encoder": {"params": {}},
                             "policy_ema": nested, "obs_encoder_ema": {"params": {}}})
    cfg = _mixed(DP._tune(config_factory("diffusion_policy")))
    PortObsUtils.initialize_obs_utils_with_config(cfg)
    algo = PortAlgo.algo_factory("diffusion_policy", cfg, {"flat": (DP.O,)}, DP.A,
                                 device="cpu")
    assert algo.mixed_precision and algo.ema_enabled
    for name in ("policy", "policy_ema"):
        load_jax_variables(algo.nets[name], flat)
    fp32 = DP._make("port", False)
    start = copy.deepcopy(algo.nets.state_dict())
    metrics = []
    for b in batches:
        draws = DP._step_draws(jax_algo)
        want = jax_algo.train_on_batch(jax_algo.process_batch_for_training(b),
                                       epoch=0)["losses"]
        algo._noise_hook = lambda: draws
        got = algo.train_on_batch(algo.process_batch_for_training(b), epoch=0)["losses"]
        metrics.append(({k: float(v) for k, v in want.items()},
                        {k: float(v) for k, v in got.items()}))
    return dict(port=algo, fp32=fp32, start=start, metrics=metrics)


@pytest.mark.parametrize("name", ["bc_transformer", "diffusion"])
def test_bf16_steps_match_jax(name, request):
    run = request.getfixturevalue(name)
    for want, got in run["metrics"]:
        assert set(got) == set(want)
        for k in got:
            np.testing.assert_allclose(got[k], want[k], rtol=2e-2, err_msg=k)


@pytest.mark.parametrize("name", ["bc_transformer", "diffusion"])
def test_bf16_steps_keep_fp32_masters_and_move_them(name, request):
    run = request.getfixturevalue(name)
    algo = run["port"]
    assert all(p.dtype == torch.float32 for p in algo.nets.parameters())
    moved = [not torch.equal(p, run["start"][n]) for n, p in algo.nets.state_dict().items()]
    assert sum(moved) > 0.9 * len(moved)


def test_bc_transformer_get_action_stays_fp32(bc_transformer):
    algo, fp32 = bc_transformer["port"], bc_transformer["fp32"]
    fp32.nets.load_state_dict(algo.nets.state_dict())
    obs = {"flat": np.random.RandomState(4).randn(BC.B, BC.T, BC.O)}
    got, want = algo.get_action(obs), fp32.get_action(obs)
    assert got.dtype == torch.float32 and torch.equal(got, want)


def test_diffusion_get_action_stays_fp32(diffusion):
    algo, fp32 = diffusion["port"], diffusion["fp32"]
    fp32.nets.load_state_dict(algo.nets.state_dict())
    rng = np.random.RandomState(5)
    obs = {"flat": DP._f32(rng.randn(DP.B, DP.TO, DP.O))}
    shape = (DP.B, DP.TP, DP.A)
    sample = (rng.randn(*shape), rng.randn(2, *shape))
    for a in (algo, fp32):
        a._sample_hook = lambda: sample
    got, want = algo.get_action(obs), fp32.get_action(obs)
    assert got.dtype == torch.float32 and torch.equal(got, want)


# ---------------------------------------------------------------------------
# the classes whose JAX step ignores the flag
# ---------------------------------------------------------------------------

# class -> (factory, the algo switches that route to it)
REFUSED = {
    "BC_VAE": ("bc", {"vae": True}),
    "BC_Transformer_GMM": ("bc", {"transformer": True, "gmm": True}),
    "ACT": ("act", {}),
    "IQL": ("iql", {}),
    "TD3_BC": ("td3_bc", {}),
    "CQL": ("cql", {}),
    "BCQ": ("bcq", {}),
    "GL": ("gl", {"vae": False}),
    "HBC": ("hbc", {}),
    "IRIS": ("iris", {}),
    "MCR_GMM": ("mcr", {"gmm": True}),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_classes_whose_jax_step_ignores_the_flag_raise(name):
    """Their JAX steps train fp32 under ``train.mixed_precision``; the port
    refuses the flag rather than train something other than it says (HBC
    and IRIS raise through their planner, a GL)."""
    factory, switches = REFUSED[name]
    cfg = _mixed(config_factory(factory))
    with cfg.values_unlocked():
        for switch, on in switches.items():
            cfg.algo[switch].enabled = on
    PortObsUtils.initialize_obs_utils_with_config(cfg)
    assert PortAlgo.REGISTERED_ALGOS[factory](cfg.algo)[0].__name__ == name
    with pytest.raises(NotImplementedError, match="mixed_precision"):
        PortAlgo.algo_factory(factory, cfg, {"flat": (5,)}, 3, device="cpu")
