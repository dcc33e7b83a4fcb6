"""The port's mesh at mp > 1 for the families without attention blocks on
the CPU over ``gloo``: ranks spawned as in tests/test_torch_mesh_mp_families.py,
a 2-rank group at (dp, mp) = (1, 2) and a 4-rank group at (2, 2) and
(1, 4), and one unsharded process.

JAX's ``_param_spec`` splits no weight of these families, so ``shard_state``
keeps every parameter replicated over mp and runs the data-parallel step
over dp: the mp ranks of a dp shard take the same rows and the same draws
from the generator every rank holds in the same state, so they step
identically. The legs (``torch_mesh_workers.MP_LEGS["value"]``): the ICL
MLP policy and ``ICLRNN_GMM``, ``BC_VAE``, ``ICLMamba_GMM`` with LipVQ, the
diffusion policy (DDIM), IQL, TD3-BC, CQL, BCQ, GL_VAE, HBC and IRIS (their
planners and actors component by component), ``MCR_GMM``, and MCR
pretraining in float64. Each takes two steps on ``shard_batch``'s shards,
``serialize``, a request and a reload under the mesh (pretraining: an
evaluation step, no request):

* the steps equal the unsharded port's: losses 1e-5 relative (1e-6
  absolute), weights, buffers, targets and Adam moments 1e-5; every rank
  the same, to the bit;
* the request equals the unsharded one on every rank (1e-5; a planner's
  subgoals, the rank's dp rows), the reloaded algo's to the bit, and an
  unsharded algo from the mp checkpoint serves it (1e-5);
* every parameter is replicated, as JAX's ``_param_spec`` places these
  families' variables.
"""

import pytest
import torch

import torch_mesh_workers as W
from test_torch_mesh import _check_losses, _close
from test_torch_mesh_mp_families import MESHES, WORLDS, _check_placements, _ranks
from test_torch_mesh_value import check_states
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

TABLE = W.MP_LEGS["value"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("mesh_mp_value")
    started = {w: W.start_ranks(W.job_mp_families, w, work / f"world{w}", "value")
               for w in WORLDS}
    unsharded = W.start_ranks(W.job_mp_families, 1, work / "unsharded", "value", True)
    ranks = {w: results() for w, results in started.items()}
    return unsharded()[0], ranks


def _states(res):
    """{part path: {"nets", "opt"}} of a leg's result."""
    return res["states"] if "states" in res else {"": res}


def _request(res, dp, rank):
    """A leg's request: the global batch's actions, or a planner's subgoals
    of the dp @rank's rows (of @dp)."""
    req = res["request"] if "request" in res else res["action"]
    if isinstance(req, dict):
        m = W.B // dp
        return {k: v[rank * m:(rank + 1) * m] for k, v in req.items()}
    return req


def _close_request(got, want, tol, msg):
    if isinstance(want, dict):
        assert set(got) == set(want), msg
        for k in want:
            _close(got[k], want[k], tol, tol, f"{msg} {k}")
    else:
        _close(got, want, tol, tol, msg)


CASES = [(tag, mesh) for tag in TABLE for mesh in MESHES]
IDS = [f"{t}-dp{d}mp{m}" for t, (d, m) in CASES]


@pytest.mark.parametrize("tag,mesh", CASES, ids=IDS)
def test_mp_value_steps_match_unsharded(runs, tag, mesh):
    ref = runs[0][tag]
    got = _ranks(runs, mesh, tag)
    msg = f"{tag} {mesh}"
    _check_losses(got[0]["losses"], ref["losses"], 1e-5, 1e-6, msg)
    check_states(_states(got[0]), _states(ref), msg)
    for other in got[1:]:
        _check_losses(other["losses"], got[0]["losses"], 0, 0, "ranks agree")
        assert other["digest"] == W.leg_digest(got[0]), f"{msg} ranks agree"


REQUEST_CASES = [(tag, mesh) for tag, mesh in CASES if tag != "pretrain"]


@pytest.mark.parametrize("tag,mesh", REQUEST_CASES,
                         ids=[f"{t}-dp{d}mp{m}" for t, (d, m) in REQUEST_CASES])
def test_mp_value_requests_and_checkpoints(runs, tag, mesh):
    ref = runs[0][tag]
    got = _ranks(runs, mesh, tag)
    dp, mp = mesh
    msg = f"{tag} {mesh}"
    for rank, res in enumerate(got):
        dp_rank = rank // mp
        _close_request(_request(res, 1, 0), _request(ref, dp, dp_rank), 1e-5,
                       f"{msg} rank {rank}")
        _close_request(res["reloaded"], _request(res, 1, 0), 0, f"{msg} rank {rank} reloaded")
    ser, want = got[0]["serialized"], ref["serialized"]
    for part in (want if "planner" in want else {"": want}):
        a, b = (ser[part], want[part]) if part else (ser, want)
        assert set(a) == set(b), msg
        for k, v in b.items():
            if isinstance(v, torch.Tensor):
                assert type(a[k]) is torch.Tensor and a[k].shape == v.shape, (msg, part, k)
                _close(a[k], v, 1e-5, 1e-5, f"{msg} {part}{k}")
    if dp == 1:   # a planner's subgoals are the rank's rows
        _close_request(W.serve_checkpoint(tag, TABLE, ser), _request(got[0], 1, 0), 1e-5,
                       f"{msg} unsharded from the mp checkpoint")


@pytest.mark.parametrize("tag", [t for t in TABLE if t != "pretrain"])
def test_mp_value_parameters_stay_replicated(runs, tag):
    """No weight of these families is split (JAX's ``_param_spec`` splits
    none of their variables): every parameter is replicated."""
    got = _ranks(runs, (1, 2), tag)[0]["placements"]
    legs = TABLE[tag]
    family = legs is W.FAMILY_LEGS
    algo = W.family_algo(tag) if family else W.value_algo(tag, legs=legs)
    nets = algo.nets.items()
    for net, module in nets:
        assert _check_placements(module, got, f"{net}.", tag) == {}, tag
    assert all(v == ("Replicate", None) for v in got.values()), tag
