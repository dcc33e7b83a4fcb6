"""The port's tensor parallelism (mp > 1) under ``train.mixed_precision``
and ``train.packed_rgb_encoders`` on the CPU over ``gloo``: ranks spawned
as in tests/test_torch_mesh_mp_families.py, a 2-rank group at (dp, mp) =
(1, 2) and a 4-rank group at (2, 2) and (1, 4), and one unsharded process,
while this process runs JAX's own sharded bf16 step.

``half_call`` casts each DTensor parameter's local shard to bf16 in its
placement, so the GPT's sharded forwards compute on bf16 shards and the
gradients reach the fp32 DTensor parameters. The legs
(``torch_mesh_workers.MP_LEGS["bf16"]``): the tiny flagship with rgb in
bf16 (BatchNorm over the dp axis) and the same with two cameras in the
packed trunks (replicated over mp); the paper's LipVQ bf16 leg is
tests/test_torch_mesh_mp_families.py's.
Each takes two steps, ``serialize``, a request, and a reload under the
mesh, against the unsharded port (``torch_mesh_workers.check_half_leg``:
metrics 1e-3 relative, gradients, Adam moments, weights and buffers at
tests/test_torch_mesh_families.py's bf16 bounds; requests 1e-3, the
reloaded algo's to the bit, an unsharded algo from the checkpoint 1e-5),
the placements against JAX's ``_param_spec``, and the flagship's (1, 2)
steps against JAX's sharded bf16 step from the port's initial weights at
tests/test_parallel.py's tolerances (losses rtol 1e-4 / atol 1e-5;
parameters and Adam moments atol 5e-4 / rtol 1e-2; the ``vq`` rows as
test_parallel.py:278-305).
"""

import pytest
import torch

from robot_manipulation_vq_vae_tpu.models.base_nets import set_pallas_pool

import torch_mesh_workers as W
from test_torch_mesh import _check_against_jax, _check_losses, _close
from test_torch_mesh_mp_families import (
    MESHES,
    WORLDS,
    _check_placements,
    _jax_sharded,
    _ranks,
)
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

TABLE = W.MP_LEGS["bf16"]
ORACLE = "flagship_bf16"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("mesh_mp_bf16")
    started = {w: W.start_ranks(W.job_mp_families, w, work / f"world{w}", "bf16")
               for w in WORLDS}
    unsharded = W.start_ranks(W.job_mp_families, 1, work / "unsharded", "bf16", True)
    try:
        oracle = _jax_sharded(ORACLE, 1, 2, TABLE)
    finally:
        set_pallas_pool(False)   # the JAX algo set the package's flag
        ranks = {w: results() for w, results in started.items()}
        ref = unsharded()[0]
    return ref, ranks, oracle


CASES = [(tag, mesh) for tag in TABLE for mesh in MESHES]
IDS = [f"{t}-dp{d}mp{m}" for t, (d, m) in CASES]


@pytest.mark.parametrize("tag,mesh", CASES, ids=IDS)
def test_mp_bf16_steps_match_unsharded(runs, tag, mesh):
    ref = runs[0][tag]
    got = _ranks(runs, mesh, tag)
    msg = f"{tag} {mesh}"
    W.check_half_leg(got[0], ref, tag, msg)
    for other in got[1:]:
        _check_losses(other["losses"], got[0]["losses"], 0, 0, "ranks agree")
        assert other["digest"] == W.leg_digest(got[0]), f"{msg} ranks agree"


@pytest.mark.parametrize("tag,mesh", CASES, ids=IDS)
def test_mp_bf16_requests_and_checkpoints(runs, tag, mesh):
    ref = runs[0][tag]
    got = _ranks(runs, mesh, tag)
    msg = f"{tag} {mesh}"
    for rank, res in enumerate(got):
        _close(res["action"], ref["action"], 1e-3, 1e-3, f"{msg} rank {rank}")
        _close(res["reloaded"], res["action"], 0, 0, f"{msg} rank {rank} reloaded")
    ser = got[0]["serialized"]
    for k, v in ref["serialized"].items():
        if isinstance(v, torch.Tensor):
            assert type(ser[k]) is torch.Tensor and ser[k].shape == v.shape, (msg, k)
    _close(W.serve_checkpoint(tag, TABLE, ser), got[0]["action"], 1e-5, 1e-5,
           f"{msg} unsharded from the mp checkpoint")


@pytest.mark.parametrize("tag", list(TABLE))
def test_mp_bf16_placements_match_jax_param_spec(runs, tag):
    got = _ranks(runs, (1, 2), tag)[0]["placements"]
    algo = W.family_algo(tag)
    split = {}
    for net, module in algo.nets.items():
        split.update(_check_placements(module, got, f"{net}.", tag))
    assert split and split == {k: v for k, v in got.items() if v[0] == "Shard"}, tag


def test_mp_bf16_flagship_step_matches_jax_sharded_step(runs):
    losses, flat, moments, algo0 = runs[2]
    res = _ranks(runs, (1, 2), ORACLE)[0]
    _check_losses(res["losses"], losses, 1e-4, 1e-5, "mp=2 bf16 vs JAX mp=2")
    _check_against_jax(res["nets"], res["opt"], algo0, flat, moments, "mp=2 bf16")
