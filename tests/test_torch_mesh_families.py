"""The port's data-parallel step for the policy families on the CPU over
``gloo``: ranks spawned as in tests/test_torch_mesh.py
(``tests/torch_mesh_workers.py``, no JAX in the ranks), a 2-rank and a
4-rank group and one unsharded process at once, while this process runs
JAX's own sharded step.

Each leg of ``torch_mesh_workers.FAMILY_LEGS`` takes two steps under
``shard_state`` on ``shard_batch``'s shards and one request after them on
the shards (the stepwise RNN and ACT requests over several calls), against
the same algo from the same seed taking the same steps and request
unsharded:

* mixed precision: the tiny flagship with rgb (BatchNorm over the global
  batch in bf16), the same with two cameras in the packed trunks, the paper
  step with LipVQ, ``ICLMamba_GMM`` and the diffusion policy, in bf16;
* the paper's other tokenizers: bin (the running range over the global
  batch), LN-act, the default encoder (attention over the global sequence,
  its dropout 0.1 drawn from the algo's generator) and FAST;
* ``ICLMamba_GMM`` and ``ICLMambaHVQVAE``; the ICL MLP, Gaussian, GMM and RNN
  policies; ``BC_RNN_GMM``, ``BC_VAE`` under three priors (the draws at the
  global batch's shape, the mixture's component over the global weights),
  ``BC_Transformer`` and ``BC_Transformer_GMM``; the diffusion policy (DDIM
  requests, and a DDPM leg with every draw injected through its hooks at
  the global batch's shape) and ACT.

Bounds: fp32 as tests/test_torch_mesh.py's (losses 1e-5; weights, buffers
and Adam moments 1e-5; actions 1e-5); bf16 (``W.check_half_leg``) as the
bf16 step tests' and test_parallel.py's: metrics 1e-3 relative, each last
gradient within 1e-2 of its tensor's largest and all of them within 1e-2 of
their norm, weights and Adam moments within 5e-4 + 1e-2 |v| (the moments
also per tensor, the first within 1e-2 and the second within 2e-2 of the
tensor's largest), buffers 1e-4; actions 1e-3. Each rank's gradient of a
bf16 layer is a bf16 sum over its rows before the average, as under JAX's
sharded step, which makes three named exceptions, each measured:
``W.HALF_CANCELLING``, a tensor whose terms cancel, held at 1e-2 of the
network's largest gradient (``ICLMamba_GMM``'s embedding LayerNorm bias:
1.5 % of its own largest, 0.31 of the network's); ``W.HALF_SIGN_NOISE``,
LipVQ's output layer, where an element whose gradient is bf16 noise may move
by Adam's step either way (2 of 8,192 weights 1.0e-3 apart at AdamW's lr
1e-3), allowed only where every first moment of the element lies within
1e-2 of its tensor's largest (measured 1.3e-3); and BatchNorm's running
statistics, whose bf16 copy an fp32 difference of 1e-6 can round to
neighbouring values: at most 1 % of their elements beyond 1e-4, all within
5e-4 + 1e-2 |v| (measured: 1-3 of a 256-element tensor, of about 10,000 in
the trunks). Every rank holds the same state, to the bit.

The direct JAX oracle: JAX's own ``parallel.shard_state`` / ``shard_batch``
step of the tiny flagship with rgb in bf16 (``__graft_entry__._tiny_config``
draw-free, an initialized ``vq`` state) at dp = 2 over two of the 8 CPU
devices, from the port's initial weights, against the port's dp = 2 bf16
step at tests/test_parallel.py's tolerances (losses rtol 1e-4 / atol 1e-5,
parameters and Adam moments atol 5e-4 / rtol 1e-2, the ``vq`` rows as
test_parallel.py:278-305).
"""

import pytest
import torch

import jax.numpy as jnp

import robot_manipulation_vq_vae_tpu.algo as JaxAlgo
from robot_manipulation_vq_vae_tpu.config import config_factory as jax_config_factory
from robot_manipulation_vq_vae_tpu.models.base_nets import set_pallas_pool
from robot_manipulation_vq_vae_tpu.parallel import make_mesh as jax_make_mesh
from robot_manipulation_vq_vae_tpu.parallel import shard_batch as jax_shard_batch
from robot_manipulation_vq_vae_tpu.parallel import shard_state as jax_shard_state
from robot_manipulation_vq_vae_tpu.utils import obs_utils as JaxObsUtils
from robot_manipulation_vq_vae_tpu.utils.ckpt_conversion import flatten_variables

from robot_manipulation_vq_vae_tpu_torch.parallel import keep_rows
import torch_mesh_workers as W
from torch_port_helpers import set_jax_state
from test_torch_mesh import (
    _adam_moments,
    _check_against_jax,
    _check_losses,
    _check_nets_against_port,
    _check_opt_against_port,
    _close,
    _jax_variables,
)
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

WORLDS = (2, 4)
ORACLE = "flagship_bf16"


def _jax_dp2_bf16():
    """JAX's flagship (rgb, bf16, draw-free) from the port's initial weights
    @algo0 with its initialized ``vq`` state, two steps sharded over dp = 2:
    (losses, {net: flat variables}, {net: Adam moments})."""
    algo0 = W.family_algo(ORACLE)
    cfg = W.flagship_config(jax_config_factory("icl"), True)
    with cfg.values_unlocked():
        cfg.train.mixed_precision = True
    JaxObsUtils.initialize_obs_utils_with_config(cfg)
    try:
        algo = JaxAlgo.algo_factory("icl", cfg, W.shapes(True), W.A)
        batches = [algo.process_batch_for_training(b) for b in W.family_batches(ORACLE)]
        batches = [{"obs": {k: jnp.asarray(v) for k, v in b["obs"].items()},
                    "actions": jnp.asarray(b["actions"])} for b in batches]
        set_jax_state(algo, {n: _jax_variables(algo0.nets[n]) for n in algo0.nets})
        mesh = jax_make_mesh(n_devices=2, mp=1)
        losses = []
        with mesh:
            algo.state = jax_shard_state(mesh, algo.state)
            for batch in batches:
                info = algo.train_on_batch(jax_shard_batch(mesh, batch), epoch=0)
                losses.append({k: float(v) for k, v in info["losses"].items()})
        flat = {n: flatten_variables({"params": algo.state.params[n], **algo.state.aux[n]})
                for n in algo.state.params}
        moments = {n: tuple(flatten_variables({"params": m}) for m in _adam_moments(o))
                   for n, o in algo.state.opt_states.items()}
        return losses, flat, moments, algo0
    finally:
        set_pallas_pool(False)   # the JAX algo set the package's flag


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("mesh_families")
    started = {w: W.start_ranks(W.job_families, w, work / f"world{w}") for w in WORLDS}
    unsharded = W.start_ranks(W.job_families, 1, work / "unsharded", True)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        oracle = _jax_dp2_bf16()
    finally:
        torch.set_num_threads(threads)
        ranks = {w: results() for w, results in started.items()}
        ref = unsharded()[0]
    return ref, ranks, oracle


CASES = [(tag, w) for tag in W.FAMILY_LEGS for w in W.FAMILY_LEGS[tag][6]]


@pytest.mark.parametrize("tag,world", CASES, ids=[f"{t}-dp{w}" for t, w in CASES])
def test_dp_family_steps_match_unsharded(runs, tag, world):
    ref, ranks = runs[0][tag], runs[1][world]
    res = ranks[0][tag]
    msg = f"{tag} dp={world}"
    if W.FAMILY_LEGS[tag][7]:
        W.check_half_leg(res, ref, tag, msg)
    else:
        _check_losses(res["losses"], ref["losses"], 1e-5, 1e-6, msg)
        _check_nets_against_port(res["nets"], ref["nets"], msg)
        _check_opt_against_port(res["opt"], ref["opt"], msg)
    for other in ranks[1:]:
        _check_losses(other[tag]["losses"], res["losses"], 0, 0, "ranks agree")
        assert other[tag]["digest"] == W.digest(res), "ranks agree"


@pytest.mark.parametrize("tag,world", CASES, ids=[f"{t}-dp{w}" for t, w in CASES])
def test_dp_family_requests_return_the_global_batch(runs, tag, world):
    """Every rank returns the B rows of each unsharded call (the GMM, VAE,
    diffusion and ACT draws taken at the global request's shape)."""
    want = runs[0][tag]["action"]
    assert want.shape[1:] == (W.B, W.A)
    tol = 1e-3 if W.FAMILY_LEGS[tag][7] else 1e-5
    for rank, res in enumerate(runs[1][world]):
        _close(res[tag]["action"], want, tol, tol, f"{tag} dp={world} rank {rank}")


def test_dp2_bf16_flagship_step_matches_jax_sharded_step(runs):
    """The port's dp = 2 bf16 flagship step against JAX's sharded one."""
    losses, flat, moments, algo0 = runs[2]
    res = runs[1][2][0][ORACLE]
    _check_losses(res["losses"], losses, 1e-4, 1e-5, "dp=2 bf16 vs JAX dp=2")
    _check_against_jax(res["nets"], res["opt"], algo0, flat, moments, "dp=2 bf16")


class _Axis:
    def __init__(self, size, rank):
        self.size, self.rank = size, rank


def test_keep_rows_cuts_an_injected_global_draw():
    """A hook's draw at the global batch's shape: each rank's rows (of each
    half, or along another axis, as the DDPM noises' [n, B, ...]); the
    whole draw without dp."""
    full = torch.arange(24.0).reshape(8, 3)
    assert keep_rows(full) is full and keep_rows(full, _Axis(1, 0)) is full
    parts = [keep_rows(full, _Axis(4, r)) for r in range(4)]
    assert torch.equal(torch.cat(parts), full)
    halves = [keep_rows(full, _Axis(2, r), "halves") for r in range(2)]
    assert torch.equal(halves[1], full[[2, 3, 6, 7]])
    steps = full.reshape(2, 4, 3)
    assert torch.equal(keep_rows(steps, _Axis(2, 1), dim=1), steps[:, 2:])
