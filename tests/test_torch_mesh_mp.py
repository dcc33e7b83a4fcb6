"""The port's training and serving under tensor parallelism (mp > 1) on the
CPU over ``gloo``: ranks spawned as in tests/test_torch_mesh.py
(``tests/torch_mesh_workers.py``, no JAX in the ranks) at the meshes
(dp, mp) = (1, 2) (world 2), (2, 2) and (1, 4) (world 4), while this
process runs the unsharded port and JAX.

The GPT backbone's parameters are placed by ``shard_params`` (JAX's
``_param_spec``) and computed on their local shards, the collectives
through ``AxisComm``; the trunks and the HVQVAE stay replicated. For the
tiny flagship with rgb (``__graft_entry__._tiny_config``):

* two steps with the draws on (the crop, dropout 0.1, keypoint noise) equal
  the port's unsharded steps (losses 1e-5; weights, buffers and Adam
  moments 1e-5), and with the draws off also JAX's unsharded steps to
  ``tests/test_parallel.py``'s tolerances;
* ``get_action`` after them equals unsharded serving (1e-5) on every rank;
* the optimizers' steps issue no collective (``CommDebugMode``, which counts
  the request's);
* ``serialize`` under mp writes whole tensors in the unsharded layout: equal
  to the unsharded ``serialize`` (optimizer state included), read by the JAX
  package's ``ckpt_conversion``, served by an unsharded algo, and placed
  again by ``deserialize`` in a fresh mp algo;
* a DTensor given to each kernel wrapper raises ``TypeError``.
"""

import numpy as np
import pytest
import torch

from robot_manipulation_vq_vae_tpu.utils import ckpt_conversion as Conv
from robot_manipulation_vq_vae_tpu.utils.ckpt_conversion import flatten_variables

import torch_mesh_workers as W
from test_torch_mesh import (
    _check_against_jax,
    _check_losses,
    _check_nets_against_port,
    _check_opt_against_port,
    _close,
    _jax_leg,
)
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

MESHES = ((1, 2), (2, 2), (1, 4))


def _parent():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = {}
        for tag, leg in W.mp_legs().items():
            algo, res = W.run_leg(leg, None, None)
            out[tag] = {**res, "algo": algo,
                        "serialized": algo.serialize(include_optimizer=True)}
        algo0, _ = W.leg_algo("icl", "flagship", True, True)
        out["jax"] = _jax_leg("flagship_rgb", W.legs()["flagship_rgb"], algo0)
        return out
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("mesh_mp")
    started = {w: W.start_ranks(W.job_mp, w, work / f"world{w}") for w in (2, 4)}
    try:
        parent = _parent()
    finally:
        ranks = {w: results() for w, results in started.items()}
    return parent, ranks


def _ranks(ranks, mesh, tag):
    dp, mp = mesh
    return [res[(dp, mp, tag)] for res in ranks[dp * mp]]


def _state(serialized, algo):
    """An ``algo_state`` (port names) from what ``serialize`` wrote."""
    return {"nets": {k: serialized[ref] for k, ref in algo._reference_names().items()},
            "opt": serialized["training_state"]["optimizers"]}


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("tag", ["draws", "plain"])
def test_mp_steps_match_unsharded(runs, mesh, tag):
    parent, ranks = runs
    port = parent[tag]
    got = _ranks(ranks, mesh, tag)
    msg = f"{tag} {mesh}"
    state = _state(got[0]["serialized"], port["algo"])
    _check_nets_against_port(state["nets"], port["nets"], msg)
    _check_opt_against_port(state["opt"], port["opt"], msg)
    for rank, res in enumerate(got):
        _check_losses(res["losses"], port["losses"], 1e-5, 1e-6, f"{msg} rank {rank}")
        if rank:
            assert res["digest"] == W.digest(state), f"{msg} rank {rank} agrees"
    # the GPT's sharded weights are DTensors of JAX's placements; its
    # replicated parameters stay plain tensors
    placements = got[0]["placements"]
    assert placements["policy.net.transformer.nets.transformer.0.nets.mlp.0.weight"] == \
        ["Shard"]
    assert "policy.net.transformer.nets.output_ln.weight" not in placements
    # a CPU algo's mesh and every one of its parameters' shards stay on the CPU
    assert all(res["devices"] == ["cpu"] for res in got), msg


def test_shard_state_refuses_a_mesh_on_another_device():
    """A mesh whose DTensors would live on another device than the algo's
    (a "cuda" mesh for a CPU algo) is refused before anything is placed."""
    from types import SimpleNamespace

    from robot_manipulation_vq_vae_tpu_torch.parallel import shard_state

    class _Mesh:
        device_type = "cuda"
        mesh_dim_names = ("dp", "mp")

        def size(self, dim):
            return (1, 2)[dim]

    with pytest.raises(ValueError, match="'cuda' mesh for an algo on 'cpu'"):
        shard_state(_Mesh(), SimpleNamespace(device=torch.device("cpu")))


@pytest.mark.parametrize("mesh", MESHES)
def test_mp_steps_without_draws_match_jax(runs, mesh):
    parent, ranks = runs
    jax_losses, jax_flat, jax_opt = parent["jax"]
    res = _ranks(ranks, mesh, "plain")[0]
    algo = parent["plain"]["algo"]
    state = _state(res["serialized"], algo)
    _check_losses(res["losses"], jax_losses, 1e-4, 1e-5, f"{mesh} vs JAX")
    _check_against_jax(state["nets"], state["opt"], algo, jax_flat, jax_opt, f"{mesh}")


@pytest.mark.parametrize("mesh", MESHES)
def test_mp_get_action_matches_unsharded(runs, mesh):
    parent, ranks = runs
    for rank, res in enumerate(_ranks(ranks, mesh, "draws")):
        _close(res["action"], parent["draws"]["action"], 1e-5, 1e-5, f"{mesh} rank {rank}")


@pytest.mark.parametrize("mesh", MESHES)
def test_mp_optimizer_step_issues_no_collective(runs, mesh):
    _, ranks = runs
    for res in _ranks(ranks, mesh, "draws"):
        # two steps of the policy's Adam and the HVQVAE's AdamW
        assert res["opt_comms"] == [0, 0, 0, 0]
        assert res["serve_comms"] > 0
        # tensor by tensor: the foreach kernels (a card's default) refuse
        # the policy's DTensors beside its plain tensors
        assert res["foreach"] == [False]


def _numpy(sd):
    return {k: v.numpy() for k, v in sd.items() if isinstance(v, torch.Tensor)}


@pytest.mark.parametrize("mesh", MESHES)
def test_mp_serialize_is_the_unsharded_layout(runs, mesh):
    parent, ranks = runs
    want = parent["draws"]["serialized"]
    got = _ranks(ranks, mesh, "draws")[0]["serialized"]
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, torch.Tensor):
            assert got[k].shape == v.shape and not hasattr(got[k], "placements"), k
            _close(got[k], v, 1e-5, 1e-5, k)
    for name, sd in want["training_state"]["optimizers"].items():
        for i, state in sd["state"].items():
            for k, v in state.items():
                _close(got["training_state"]["optimizers"][name]["state"][i][k], v,
                       1e-5, 1e-5, f"{name}[{i}].{k}")
    # the JAX package's converter reads it as it reads the unsharded one
    cfg = {"algo": {"transformer": {"num_layers": 2}},
           "observation": {"modalities": {"obs": {"rgb": list(W.RGB_KEYS)}}}}
    a = flatten_variables(Conv.convert_transformer_actor(_numpy(got), cfg,
                                                         with_stats=False)[0])
    b = flatten_variables(Conv.convert_transformer_actor(_numpy(want), cfg,
                                                         with_stats=False)[0])
    assert set(a) == set(b) and any("transformer" in k for k in b)
    for k in b:
        _close(a[k], b[k], 1e-5, 1e-5, f"converted {k}")
    a, b = (flatten_variables(Conv.convert_hvqvae(_numpy(sd), prefix="vqvae.", num_stages=1,
                                                  num_layers_per_stage=2)[0])
            for sd in (got, want))
    assert set(a) == set(b)
    for k in b:
        _close(a[k], b[k], 1e-5, 1e-5, f"converted vqvae {k}")


@pytest.mark.parametrize("mesh", MESHES)
def test_mp_checkpoint_serves_unsharded_and_reloads_under_mp(runs, mesh):
    parent, ranks = runs
    res = _ranks(ranks, mesh, "draws")
    algo, _ = W.leg_algo("icl", "flagship", True, True, draws="crop")
    algo.deserialize(res[0]["serialized"])
    _close(W.serve(algo, True), res[0]["action"], 1e-5, 1e-5, f"{mesh} unsharded")
    for rank, r in enumerate(res):
        _close(r["reloaded"]["action"], r["action"], 0, 0, f"{mesh} rank {rank} reloaded")
        assert r["reloaded"]["gap"] == 0.0, (mesh, rank)


def test_kernel_wrappers_refuse_dtensors(runs):
    _, ranks = runs
    for res in ranks[2]:
        assert set(res["guards"]) == {"pool_fwd_cuda", "pool_bwd_cuda", "l2_nearest_cuda",
                                      "lipvq_roundtrip_cuda", "pool_route_cuda"}
        for name, err in res["guards"].items():
            assert err is not None and err.startswith(name) and "DTensor" in err, (name, err)
