"""The port's data-parallel step for offline RL and the hierarchical family
on the CPU over ``gloo``: ranks spawned as in tests/test_torch_mesh.py
(``tests/torch_mesh_workers.py``, no JAX in the ranks), a 2-rank and a
4-rank group and one unsharded process at once, while this process runs
JAX's own sharded steps.

Each leg of ``torch_mesh_workers.VALUE_LEGS`` goes through the normal entry
points (``algo_factory``, ``shard_state``, ``process_batch_for_training``,
``shard_batch``, ``train_on_batch``), two steps at epochs 0 and 1 and a
request after them on the shards, against the same algo from the same seed
taking the same steps and request unsharded:

* offline RL: IQL (Gaussian, GMM, and on a camera: ResNet-18 behind a crop,
  BatchNorm over the global batch in the actor), TD3-BC (lambda = alpha /
  mean |Q| over the global batch, the smoothing noise at the global batch's
  shape), CQL (one backup sample, and three: the backup draw [n, B, A] cut
  along its batch axis; the tiled candidates' draws batch-major), BCQ with
  its perturbation actor, BCQ_GMM (the candidates sampled from the mixture
  gathered over the ranks) and BCQ_Distributional; each critic of an
  ensemble with its own optimizer, the targets moving by Polyak;
* the hierarchical family: GL and GL_VAE (their subgoal predictions of each
  rank's rows), HBC separate (GL_VAE and GL planners) and cascade, and IRIS
  (a GL_VAE planner ranked by a BCQ): stepwise requests with the subgoal
  refreshed at calls 0 and 2.

Bounds: tests/test_torch_mesh.py's fp32 ones: losses 1e-5 relative (1e-6
absolute); weights, buffers, Adam moments and target networks 1e-5; actions
and subgoals 1e-5. Every rank holds the same state, to the bit.

The direct JAX oracles: JAX's own ``parallel.shard_state`` / ``shard_batch``
steps at dp = 2 over two of the 8 CPU devices, from JAX's random variables
(``random_init``; the port's legs load the same weights), of low-dim TD3-BC (its smoothing noise JAX's own draws,
``normal(split(rng)[1])``, injected into the port's ranks at the global
batch's shape) and of low-dim HBC (a GL planner, draw-free), against the
port's dp = 2 steps at tests/test_parallel.py's tolerances (losses rtol
1e-4 / atol 1e-5, parameters and Adam moments atol 5e-4 / rtol 1e-2).
Under (dp, mp) = (1, 2) ``shard_state`` takes each of these legs, and its
steps and request equal the unsharded run's.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import robot_manipulation_vq_vae_tpu.algo as JaxAlgo
from robot_manipulation_vq_vae_tpu.algo import gl as JaxGL
from robot_manipulation_vq_vae_tpu.algo.icl import _device_batch
from robot_manipulation_vq_vae_tpu.config import config_factory as jax_config_factory
from robot_manipulation_vq_vae_tpu.parallel import make_mesh as jax_make_mesh
from robot_manipulation_vq_vae_tpu.parallel import shard_batch as jax_shard_batch
from robot_manipulation_vq_vae_tpu.parallel import shard_state as jax_shard_state
from robot_manipulation_vq_vae_tpu.utils import obs_utils as JaxObsUtils
from robot_manipulation_vq_vae_tpu.utils.ckpt_conversion import flatten_variables

from robot_manipulation_vq_vae_tpu_torch.utils.jax_weights import load_jax_variables
import torch_mesh_workers as W
from torch_offline_rl_harness import port_module
from torch_port_helpers import random_init, set_jax_state
from test_torch_mesh import _adam_moments, _close
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

WORLDS = (2, 4)
# the JAX oracles' legs (``W.VALUE_LEGS``; TD3-BC's with JAX's noise)
ORACLES = ("td3_bc_jax", "hbc_gl")


def td3_bc_noise(steps=2):
    """The JAX TD3-BC step's smoothing noise of each step, at the global
    batch's shape: normal(split(rng)[1], [B, A]), rng <- split(rng)[0], from
    ``set_jax_state``'s rng (split(PRNGKey(seed))[0]): passed to the ranks,
    which import no JAX."""
    rng = jax.random.split(jax.random.PRNGKey(0))[0]
    out = []
    for _ in range(steps):
        rng, key = jax.random.split(rng)
        out.append(np.asarray(jax.random.normal(key, (W.B, W.VA)), np.float32))
    return out


def _jax_config(tag):
    name, configure = W.VALUE_LEGS[tag][:2]
    return configure(jax_config_factory(name))


def _jax_algo(tag):
    name, _, keys = W.VALUE_LEGS[tag][:3]
    cfg = _jax_config(tag)
    JaxObsUtils.initialize_obs_utils_with_config(cfg)
    return JaxAlgo.algo_factory(name, cfg, dict(keys), W.VA)


def _parts(algo):
    """{path: algo} of @algo's parts as ``W.hier_states`` names them."""
    if hasattr(algo, "planner"):
        return {"planner.": algo.planner, "actor.": algo.actor}
    return {"": algo}


def _init_batch(jax_part, processed):
    """What @jax_part's ``train_on_batch`` initializes its state from."""
    if isinstance(jax_part, JaxGL.GL):
        jb = _device_batch(processed)
        jb["subgoals"] = {k: jnp.asarray(v) for k, v in processed["subgoals"].items()}
        return jb
    if isinstance(jax_part, JaxAlgo.ValueAlgo):
        return processed
    return _device_batch(processed)


def _oracle_start(tag, path):
    """JAX's algo of @tag with random variables (``random_init``: nothing
    compiles) and optimizer states initialized on them, and the port's
    twin's parts holding the same weights, saved to @path for the ranks
    (every part's state dict by its ``W.hier_states`` path). Returns the
    JAX algo."""
    jax_algo = _jax_algo(tag)
    port = W.value_algo(tag)
    processed = jax_algo.process_batch_for_training(W.value_batches(tag)[0])
    ports = _parts(port)
    for part_path, jax_part in _parts(jax_algo).items():
        sub = processed[part_path[:-1]] if part_path else processed
        variables = random_init(jax_part._init_variables)(jax.random.PRNGKey(0),
                                                          _init_batch(jax_part, sub))
        for name, tree in variables.items():
            load_jax_variables(port_module(ports[part_path], name), flatten_variables(tree))
        set_jax_state(jax_part, variables)
    torch.save({p: a.nets.state_dict() for p, a in ports.items()}, path)
    return jax_algo


def _jax_dp2(tag, jax_algo):
    """@jax_algo's two steps sharded over dp = 2: (losses, {path: (JAX
    part, the port's twin from the same start)})."""
    ports = _parts(W.value_algo(tag))
    parts = _parts(jax_algo)
    JaxObsUtils.initialize_obs_utils_with_config(_jax_config(tag))
    mesh = jax_make_mesh(n_devices=2, mp=1)
    losses = []
    with mesh:
        for part in parts.values():
            part.state = jax_shard_state(mesh, part.state)
        for epoch, batch in enumerate(W.value_batches(tag)):
            batch = jax.tree_util.tree_map(jnp.asarray,
                                           jax_algo.process_batch_for_training(batch))
            info = jax_algo.train_on_batch(jax_shard_batch(mesh, batch), epoch=epoch)
            losses.append(W.flat_losses(jax.tree_util.tree_map(float, dict(info))))
    return losses, {path: (parts[path], ports[path]) for path in parts}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("mesh_value")
    noise = td3_bc_noise()
    starts = {tag: str(work / f"{tag}_start.pt") for tag in ORACLES}
    jax_algos = {tag: _oracle_start(tag, path) for tag, path in starts.items()}
    started = {w: W.start_ranks(W.job_value, w, work / f"world{w}", noise, starts)
               for w in WORLDS}
    unsharded = W.start_ranks(W.job_value, 1, work / "unsharded", noise, starts, True)
    try:
        oracles = {tag: _jax_dp2(tag, jax_algos[tag]) for tag in ORACLES}
    finally:
        ranks = {w: results() for w, results in started.items()}
        ref = unsharded()[0]
    return ref, ranks, oracles


def check_states(got, want, msg, tol=1e-5):
    """Every part's networks (weights, buffers, targets) and every
    optimizer's state within @tol."""
    assert set(got) == set(want), msg
    for path, st in want.items():
        for k, v in st["nets"].items():
            g = got[path]["nets"][k]
            if v.is_floating_point():
                _close(g, v, tol, tol, f"{msg} {path}{k}")
            else:
                assert torch.equal(g, v), f"{msg} {path}{k}"
        assert set(got[path]["opt"]) == set(st["opt"]), msg
        for name, sd in st["opt"].items():
            for i, state in sd["state"].items():
                for k, v in state.items():
                    _close(got[path]["opt"][name]["state"][i][k], v, tol, tol,
                           f"{msg} {path}opt {name}[{i}].{k}")


def check_losses(got, want, msg, rtol=1e-5, atol=1e-6):
    assert len(got) == len(want), msg
    for step, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w), (msg, step)
        for k in w:
            _close(g[k], w[k], rtol, atol, f"{msg} step {step} {k}")


def check_request(got, want, world, rank, msg):
    """A request's actions (the global batch's on every rank), or a
    planner's subgoals of the rank's rows."""
    if isinstance(want, dict):
        m = W.B // world
        want = {k: v[rank * m:(rank + 1) * m] for k, v in want.items()}
        assert set(got) == set(want), msg
        for k in want:
            _close(got[k], want[k], 1e-5, 1e-5, f"{msg} {k}")
        return
    assert got.shape == want.shape and want.shape[1:] == (W.B, W.VA), msg
    _close(got, want, 1e-5, 1e-5, msg)


CASES = [(tag, w) for tag, leg in W.VALUE_LEGS.items() for w in leg[4]]


@pytest.mark.parametrize("tag,world", CASES, ids=[f"{t}-dp{w}" for t, w in CASES])
def test_dp_steps_and_requests_match_unsharded(runs, tag, world):
    ref, ranks = runs[0][tag], runs[1][world]
    res = ranks[0][tag]
    msg = f"{tag} dp={world}"
    check_losses(res["losses"], ref["losses"], msg)
    check_states(res["states"], ref["states"], msg)
    for rank, r in enumerate(ranks):
        check_request(r[tag]["request"], ref["request"], world, rank,
                      f"{msg} rank {rank} request")
        if rank:
            check_losses(r[tag]["losses"], res["losses"], "ranks agree", 0, 0)
            assert r[tag]["digests"] == {p: W.digest(s) for p, s in res["states"].items()}, \
                "ranks agree"


def _load_jax(module, tree):
    out = copy.deepcopy(module)
    load_jax_variables(out, flatten_variables({"params": tree}))
    return out


@pytest.mark.parametrize("tag", ORACLES)
def test_dp2_step_matches_jax_sharded_step(runs, tag):
    """The port's dp = 2 steps against JAX's sharded ones: losses, every
    network's weights (targets too) and every optimizer's Adam moments."""
    losses, parts = runs[2][tag]
    res = runs[1][2][0][tag]
    check_losses(res["losses"], losses, f"{tag} vs JAX dp=2", 1e-4, 1e-5)
    for path, (jax_part, port0) in parts.items():
        nets, opt = res["states"][path]["nets"], res["states"][path]["opt"]
        prefix = {id(m): n for n, m in port0.nets.named_modules()}
        for jax_name, tree in jax_part.state.params.items():
            module = port_module(port0, jax_name)
            want = _load_jax(module, tree).state_dict()
            for k, v in want.items():
                _close(nets[f"{prefix[id(module)]}.{k}"], v, 1e-2, 5e-4,
                       f"{tag} {path}{jax_name}.{k}")
            if jax_name not in jax_part.state.opt_states:
                continue
            mu, nu = _adam_moments(jax_part.state.opt_states[jax_name])
            state = opt[jax_name]["state"]
            for which, tree_m in (("exp_avg", mu), ("exp_avg_sq", nu)):
                moments = list(_load_jax(module, tree_m).parameters())
                for i, m in enumerate(moments):
                    _close(state[i][which], m.detach(), 1e-2, 5e-4,
                           f"{tag} {path}{jax_name} {which}[{i}]")


def test_td3_bc_lambda_is_the_global_batchs(runs):
    """lambda = alpha / mean |Q(s, pi(s))|: the ranks' actor loss is the
    global batch's, not the mean of the ranks' own lambdas' losses."""
    ref = runs[0]["td3_bc"]["losses"]
    for world in WORLDS:
        got = runs[1][world][0]["td3_bc"]["losses"]
        for g, w in zip(got, ref):
            _close(g["actor/loss"], w["actor/loss"], 1e-5, 1e-6, f"dp={world}")


def test_mp_refuses_each_family_by_name(runs):
    """Under (dp, mp) = (1, 2) shard_state takes every leg's algo (JAX's
    ``_param_spec`` splits none of its weights: each is replicated over
    mp), and its two steps and request equal the unsharded run's; both
    ranks the same, to the bit."""
    ref, ranks = runs[0], runs[1][2]
    assert set(ranks[0]["mp"]) == set(W.VALUE_LEGS)
    for tag in W.VALUE_LEGS:
        res = ranks[0]["mp"][tag]
        msg = f"{tag} (dp, mp) = (1, 2)"
        check_losses(res["losses"], ref[tag]["losses"], msg)
        check_states(res["states"], ref[tag]["states"], msg)
        for rank, r in enumerate(ranks):
            check_request(r["mp"][tag]["request"], ref[tag]["request"], 1, 0,
                          f"{msg} rank {rank} request")
        assert ranks[1]["mp"][tag]["digests"] == {
            p: W.digest(s) for p, s in res["states"].items()}, f"{msg} ranks agree"
