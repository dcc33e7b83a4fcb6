"""The port's data-parallel step for the MCR policies and MCR representation
pretraining on the CPU over ``gloo``: ranks spawned as in
tests/test_torch_mesh.py (``tests/torch_mesh_workers.py``, no JAX in the
ranks), a 2-rank and a 4-rank group and one unsharded process at once,
while this process runs JAX's own sharded pretraining step.

* The MCR policies (``torch_mesh_workers.MCR_LEGS``): ``MCR_GMM`` on a
  camera (ResNet-18 behind a crop, BatchNorm over the global batch)
  warm-started from a pretrained trunk through ``RMVQ_MCR_CKPT``, and
  ``MCR_Transformer_GMM`` on low-dim keys: two steps and a request on the
  shards against the same algo taking them unsharded; ``shard_state``
  takes each of the six ``MCR*`` classes at dp = 2 and 4.
* ``MCRPretrainer`` (ResNet-18 on 32 x 32 frames, all three losses, B = 8
  quintuples): two ``update`` steps and an evaluation step on the shards
  through ``shard_state`` / ``shard_batch``, the negatives' permutations
  drawn over the global batch from the replicated generator and read from
  the all-gathered s0 / s2 embeddings (``AxisComm.gather``), against the
  unsharded trainer, in float64: in float32 Adam's steps turn the
  reduction noise of near-zero gradients (the ranks' sums over fewer rows)
  into up to 6e-5 of weight after two steps at the script's lr 1e-4.

Bounds: tests/test_torch_mesh.py's fp32 ones (losses 1e-5 relative, 1e-6
absolute; weights, BatchNorm statistics and Adam moments 1e-5; actions
1e-5); every rank holds the same state, to the bit.

The direct JAX oracle: JAX's ``MCRPretrainer`` step (its jitted
``_step_impl``) in float64 on a batch sharded over dp = 2 of the 8 CPU
devices, its state replicated, from the port's initial weights, against the
port's float64 dp = 2 steps with the same negatives (JAX's own ``jax.random.permutation`` draws
of each call, pinned through ``neg_perms``) at tests/test_parallel.py's
tolerances (metrics rtol 1e-4 / atol 1e-5; parameters, BatchNorm statistics
and Adam moments atol 5e-4 / rtol 1e-2). Under mp = 2 ``shard_state``
takes each MCR class and the pretrainer, their steps equal to the
unsharded runs'.
"""

import copy

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
from jax.sharding import NamedSharding, PartitionSpec

from robot_manipulation_vq_vae_tpu.algo import mcr_pretrain as JaxPretrain
from robot_manipulation_vq_vae_tpu.parallel import make_mesh as jax_make_mesh
from robot_manipulation_vq_vae_tpu.parallel import shard_batch as jax_shard_batch
from robot_manipulation_vq_vae_tpu.utils.ckpt_conversion import flatten_variables

from robot_manipulation_vq_vae_tpu_torch.utils.jax_weights import load_jax_variables
import torch_mesh_workers as W
from test_torch_mesh import _adam_moments, _close, _jax_variables
from test_torch_mesh_value import check_losses, check_request, check_states
from torch_port_helpers import float64_tree
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

WORLDS = (2, 4)
SEED = 1   # the JAX trainer's (and the port's) seed


def jax_perms(calls=3, seed=SEED):
    """The negatives JAX's trainer draws at each of @calls calls: perms of
    split(rng)[1], rng <- split(rng)[0], from split(PRNGKey(seed))[0]."""
    rng = jax.random.split(jax.random.PRNGKey(seed))[0]
    out = []
    model = JaxPretrain.MCRRepresentation(**_jax_kwargs())
    for _ in range(calls):
        rng, perm_rng = jax.random.split(rng)
        keys = jax.random.split(perm_rng, model.num_negatives)
        out.append(np.array(jax.vmap(lambda k: jax.random.permutation(k, W.B))(keys)))
    return out


def _jax_kwargs():
    return {k: v for k, v in W.PRETRAIN.items() if k != "state_dim"}


def _jax_dp2(port0):
    """JAX's trainer in float64 from @port0's weights, its three calls (2
    steps and an evaluation) on batches sharded over dp = 2: (metrics,
    trainer)."""
    model = JaxPretrain.MCRRepresentation(**_jax_kwargs())
    tr = object.__new__(JaxPretrain.MCRPretrainer)
    tr.model, tr.tx, tr.step = model, optax.adam(W.PRETRAIN_LR), 0
    mesh = jax_make_mesh(n_devices=2, mp=1)
    rep = NamedSharding(mesh, PartitionSpec())
    metrics = []
    with jax.enable_x64(), mesh:
        variables = float64_tree(_jax_variables(port0.model))
        tr.rng = jax.random.split(jax.random.PRNGKey(SEED))[0]
        tr.params = jax.device_put(variables["params"], rep)
        tr.batch_stats = jax.device_put(variables["batch_stats"], rep)
        tr.opt_state = jax.jit(tr.tx.init)(tr.params)
        tr._train_step = jax.jit(tr._step_impl, static_argnames="train")
        for i, batch in enumerate(W.pretrain_batches()):
            batch = jax_shard_batch(mesh, {k: jnp.asarray(v) for k, v in batch.items()})
            metrics.append(tr.update(batch, eval=i == 2))
    return metrics, tr


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("mesh_mcr")
    trunk = str(work / "trunk.pkl")
    W.pretrainer().export_trunk(trunk)
    perms = jax_perms()
    started = {w: W.start_ranks(W.job_mcr, w, work / f"world{w}", trunk, perms)
               for w in WORLDS}
    unsharded = W.start_ranks(W.job_mcr, 1, work / "unsharded", trunk, perms, True)
    try:
        oracle = _jax_dp2(W.pretrainer())
    finally:
        ranks = {w: results() for w, results in started.items()}
        ref = unsharded()[0]
    return ref, ranks, oracle


def _check_run(ranks, ref, tag, world, requests=True):
    res = ranks[0][tag]
    msg = f"{tag} dp={world}"
    check_losses(res["losses"], ref["losses"], msg)
    check_states(res["states"], ref["states"], msg)
    for rank, r in enumerate(ranks):
        if requests:
            check_request(r[tag]["request"], ref["request"], world, rank,
                          f"{msg} rank {rank} request")
        if rank:
            check_losses(r[tag]["losses"], res["losses"], "ranks agree", 0, 0)
            assert r[tag]["digests"] == {p: W.digest(s) for p, s in res["states"].items()}, \
                "ranks agree"


CASES = [(tag, w) for tag, leg in W.MCR_LEGS.items() for w in leg[4]]


@pytest.mark.parametrize("tag,world", CASES, ids=[f"{t}-dp{w}" for t, w in CASES])
def test_dp_mcr_policy_steps_and_requests_match_unsharded(runs, tag, world):
    _check_run(runs[1][world], runs[0][tag], tag, world)


@pytest.mark.parametrize("world", WORLDS)
def test_shard_state_takes_every_mcr_class(runs, world):
    got = runs[1][world][0]["classes"]
    assert set(got) == set(W.MCR_CLASSES)
    for cls, (name, err) in got.items():
        assert name == cls and err is None, (cls, name, err)


@pytest.mark.parametrize("world", WORLDS)
def test_dp_pretraining_matches_unsharded(runs, world):
    """Two steps and an evaluation step in float64 with the negatives drawn
    over the global batch from the replicated generator (a rank's own
    negatives, or negatives read from its own rows alone, read apart)."""
    _check_run(runs[1][world], runs[0]["pretrain"], "pretrain", world, requests=False)


def test_dp2_pretraining_matches_jax_sharded_step(runs):
    """The port's dp = 2 steps against JAX's sharded step from the same
    weights and negatives: metrics, parameters, BatchNorm statistics and
    Adam moments."""
    metrics, tr = runs[2]
    res = runs[1][2][0]["pretrain_pinned"]
    check_losses(res["losses"], metrics, "pretraining vs JAX dp=2", 1e-4, 1e-5)
    port = W.pretrainer().model
    want = copy.deepcopy(port)
    load_jax_variables(want, flatten_variables({"params": jax.device_get(tr.params),
                                                "batch_stats": jax.device_get(tr.batch_stats)}))
    nets = res["states"][""]["nets"]
    for k, v in want.state_dict().items():
        if v.is_floating_point():
            _close(nets[k], v, 1e-2, 5e-4, f"vs JAX {k}")
    state = res["states"][""]["opt"]["model"]["state"]
    for which, tree in zip(("exp_avg", "exp_avg_sq"), _adam_moments(tr.opt_state)):
        moments = copy.deepcopy(port)
        load_jax_variables(moments, flatten_variables({
            "params": jax.device_get(tree), "batch_stats": jax.device_get(tr.batch_stats)}))
        for i, m in enumerate(moments.parameters()):
            _close(state[i][which], m.detach(), 1e-2, 5e-4, f"vs JAX {which}[{i}]")


def test_mp_refuses_the_mcr_classes_and_pretraining_by_name(runs):
    """Under (dp, mp) = (1, 2) shard_state takes the six MCR classes
    (``MCR_Transformer`` and ``MCR_Transformer_GMM`` with their GPT split)
    and the pretrainer; each class's two steps and request, and the
    pretraining's steps and evaluation, equal the unsharded run's."""
    ref, ranks = runs[0], runs[1][2]
    got = ranks[0]["mp"]
    assert set(got) == {*W.MCR_CLASSES, "pretrain"}
    for tag, res in got.items():
        want = ref["pretrain"] if tag == "pretrain" else ref["classes_steps"][tag]
        msg = f"{tag} (dp, mp) = (1, 2)"
        check_losses(res["losses"], want["losses"], msg)
        check_states(res["states"], want["states"], msg)
        if tag != "pretrain":
            for rank, r in enumerate(ranks):
                _close(r["mp"][tag]["request"], want["request"], 1e-5, 1e-5,
                       f"{msg} rank {rank} request")
        assert ranks[1]["mp"][tag]["digests"] == {
            p: W.digest(s) for p, s in res["states"].items()}, f"{msg} ranks agree"
