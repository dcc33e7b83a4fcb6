"""The port's mesh (``parallel/mesh.py``) on the CPU over ``gloo``: ranks
are spawned processes (``tests/torch_mesh_workers.py``, which imports no
JAX) with a ``file://`` rendezvous under the test's temporary directory; a
2-rank and a 4-rank group run at the same time while this process runs the
unsharded port and the JAX package.

* ``make_mesh``: shape and axis names against the JAX package's over as
  many devices.
* ``shard_params`` at mp = 2: the placement of every GPT backbone parameter
  against JAX's ``_param_spec`` over the same parameter tree, and the
  forward within 1e-5 of the replicated one.
* dp = 2 and dp = 4: test_parallel's LipVQ step; two steps of the tiny
  flagship (``__graft_entry__._tiny_config``, low-dim, and with rgb for
  BatchNorm; dropout 0 and no crop randomizer, since JAX's draws differ:
  the draws under dp are tests/test_torch_mesh_draws.py)
  and of ``icl_gmm_paper`` with LipVQ. Each equals the port's unsharded
  steps (within float32 reduction-order noise: losses 1e-5, weights,
  buffers and Adam moments 1e-5) and, the LipVQ and flagship steps, JAX's
  unsharded steps within
  ``tests/test_parallel.py``'s tolerances (losses rtol 1e-4 / atol 1e-5;
  parameters and Adam moments atol 5e-4 / rtol 1e-2; the ``vq`` collection
  per row as at test_parallel.py:278-305). The JAX algos start from the
  port's initial weights (``jax_variables``); their flagship starts from an
  initialized ``vq`` state (no random draw), and a third flagship leg starts
  uninitialized through a clustered batch: the k-means init and the
  dead-code picks on the all-gathered batch with the replicated generator,
  the replacement firing, against the unsharded port.
* what ``shard_state`` takes under mp = 2 (the bf16 step, a bc policy,
  the bin tokenizer, offline RL, the hierarchical family, MCR and its
  pretraining, which dp > 1 takes too) and refuses (an object of no
  covered class, a weight dim that mp does not divide), and
  ``train_on_batch``'s refusal of a batch that is not a shard.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import robot_manipulation_vq_vae_tpu.algo as JaxAlgo
from robot_manipulation_vq_vae_tpu.config import config_factory as jax_config_factory
from robot_manipulation_vq_vae_tpu.models.base_nets import set_pallas_pool
from robot_manipulation_vq_vae_tpu.models.tokenizers import LipVQVAE as JaxLipVQVAE
from robot_manipulation_vq_vae_tpu.models.transformers import GPT_Backbone as JaxGPT
from robot_manipulation_vq_vae_tpu.parallel import make_mesh as jax_make_mesh
from robot_manipulation_vq_vae_tpu.parallel.mesh import _param_spec
from robot_manipulation_vq_vae_tpu.utils import obs_utils as JaxObsUtils
from robot_manipulation_vq_vae_tpu.utils.ckpt_conversion import flatten_variables

from robot_manipulation_vq_vae_tpu_torch.utils.jax_weights import (
    _entries,
    jax_tree,
    jax_variables,
)
import torch_mesh_workers as W
from torch_port_helpers import set_jax_state
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

WORLDS = (2, 4)


# --------------------------------------------------------------------------
# this process: the unsharded port and the JAX package
# --------------------------------------------------------------------------

def _jax_variables(module):
    flat = jax_variables(module)
    return {c: jax_tree(flat, c) for c in sorted({k.split("/")[0] for k in flat})}


def _jax_leg(tag, leg, algo0):
    """JAX's algo from the port's initial weights @algo0, two steps: (losses,
    {net: flat variables}, {net: opt state})."""
    name, cfg_name, with_rgb, _, batches, halves = leg
    cfg = jax_config_factory(name)
    cfg = W.flagship_config(cfg, with_rgb) if cfg_name == "flagship" else W.paper_config(cfg)
    JaxObsUtils.initialize_obs_utils_with_config(cfg)
    algo = JaxAlgo.algo_factory(name, cfg, W.shapes(with_rgb), W.A)
    set_jax_state(algo, {n: _jax_variables(algo0.nets[n]) for n in algo0.nets})
    losses = []
    for batch in batches:
        if not halves:
            batch = algo.process_batch_for_training(batch)
        info = algo.train_on_batch(batch, epoch=0)
        losses.append({k: float(v) for k, v in info["losses"].items()})
    flat = {n: flatten_variables({"params": algo.state.params[n], **algo.state.aux[n]})
            for n in algo.state.params}
    moments = {n: tuple(flatten_variables({"params": m}) for m in _adam_moments(o))
               for n, o in algo.state.opt_states.items()}
    return losses, flat, moments


def _jax_lipvq_step(model):
    import optax

    jm = JaxLipVQVAE(feature_dim=6, latent_dim=16, num_codes=8, use_pallas=False)
    x = jnp.asarray(W.lipvq_input().numpy())
    params = _jax_variables(model)["params"]
    opt = optax.adam(1e-3)

    @jax.jit
    def step(params):
        loss, grads = jax.value_and_grad(lambda p: jm.apply({"params": p}, x)[1])(params)
        updates, _ = opt.update(grads, opt.init(params), params)
        return loss, optax.apply_updates(params, updates)

    loss, params = step(params)
    return float(loss), flatten_variables({"params": params})


def _parent():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = {"legs": {}, "jax": {}}
        for tag, leg in W.legs().items():
            name, cfg_name, with_rgb, init_vq, batches, halves = leg
            algo, vq = W.leg_algo(name, cfg_name, with_rgb, init_vq)
            algo0, _ = W.leg_algo(name, cfg_name, with_rgb, init_vq)
            losses = W.steps(algo, batches, None, halves)
            out["legs"][tag] = {"losses": losses, **W.algo_state(algo), "algo": algo}
            if tag in ("flagship", "flagship_rgb"):
                try:
                    out["jax"][tag] = _jax_leg(tag, leg, algo0)
                finally:
                    set_pallas_pool(False)   # the JAX algo set the package's flag
        model = W.lipvq_model()
        out["jax"]["lipvq"] = _jax_lipvq_step(model)
        out["lipvq"] = W.lipvq_step(model, W.lipvq_input())
        gpt = W.gpt_backbone()
        with torch.no_grad():
            out["gpt_ref"] = gpt(W.gpt_input())
        out["gpt"] = gpt
        return out
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("mesh")
    started = {w: W.start_ranks(W.job_all, w, work / f"world{w}") for w in WORLDS}
    try:
        parent = _parent()
    finally:
        ranks = {w: results() for w, results in started.items()}
    return parent, ranks


# --------------------------------------------------------------------------
# comparisons
# --------------------------------------------------------------------------

def _close(got, want, rtol, atol, msg):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape or not np.all(np.abs(got - want) <= atol + rtol * np.abs(want)):
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=msg)


def _check_losses(got, want, rtol, atol, msg):
    assert len(got) == len(want)
    for step, (g, w) in enumerate(zip(got, want)):
        keys = sorted(set(g) & set(w))
        assert keys, (g, w)
        for k in keys:
            _close(g[k], w[k], rtol, atol, f"{msg} step {step} {k}")


def _check_vq_rows(got, want, msg):
    """test_parallel.py:278-305: codebook / EMA-sum rows within
    6e-2 + 3e-2 |want|, at most 3 rows off; the rest rtol 3e-2 / atol 6e-2,
    the total EMA mass within 2e-3."""
    for key, b in want.items():
        a = np.asarray(got[key], np.float32)
        b = np.asarray(b, np.float32)
        if key == "initialized":
            np.testing.assert_array_equal(a, b)
        elif key.startswith(("codebook", "embed_avg")):
            ok = np.all(np.abs(a - b) <= 6e-2 + 3e-2 * np.abs(b), axis=1)
            assert int((~ok).sum()) <= 3, f"{msg} vq {key}: {int((~ok).sum())} rows differ"
        else:
            _close(a, b, 3e-2, 6e-2, f"{msg} vq {key}")
            if key.startswith("cluster_size"):
                _close(a.sum(), b.sum(), 2e-3, 0.0, f"{msg} vq {key} mass")


def _check_nets_against_port(got, want, msg, tol=1e-5):
    assert set(got) == set(want)
    for k, v in want.items():
        if v.is_floating_point():
            _close(got[k], v, tol, tol, f"{msg} {k}")
        else:
            assert torch.equal(got[k], v), f"{msg} {k}"


def _check_opt_against_port(got, want, msg, tol=1e-5):
    assert set(got) == set(want)
    for name in want:
        for i, state in want[name]["state"].items():
            for k, v in state.items():
                _close(got[name]["state"][i][k], v, tol, tol, f"{msg} opt {name}[{i}].{k}")


def _adam_moments(opt_state):
    """(mu, nu) of the Adam state inside an optax chain's state."""
    for leaf in jax.tree_util.tree_leaves(opt_state,
                                          is_leaf=lambda x: hasattr(x, "mu")):
        if hasattr(leaf, "mu") and hasattr(leaf, "nu"):
            return leaf.mu, leaf.nu
    raise AssertionError("no Adam state")


def _check_against_jax(nets, opt, algo, jax_flat, jax_moments, msg):
    """The port's weights, buffers and Adam moments (in the JAX layout)
    against JAX's, at test_parallel's tolerances."""
    for net, module in algo.nets.items():
        flat = jax_flat[net]
        prefix = net + "."
        vq_got, vq_want = {}, {}
        for jax_key, torch_key, _, inv in _entries(module, [], []):
            got = inv(nets[prefix + torch_key].numpy())
            if jax_key.startswith("vq/"):
                vq_got[jax_key[3:]], vq_want[jax_key[3:]] = got, flat[jax_key]
            else:
                _close(got, flat[jax_key], 1e-2, 5e-4, f"{msg} {net} {jax_key}")
        if vq_want:
            _check_vq_rows(vq_got, vq_want, f"{msg} {net}")
        if net not in jax_moments:
            continue
        mu, nu = jax_moments[net]
        names = [n for n, _ in module.named_parameters()]
        inv_of = {t: (j, inv) for j, t, _, inv in _entries(module, [], [])}
        for i, state in opt[net]["state"].items():
            jax_key, inv = inv_of[names[i]]
            _close(inv(state["exp_avg"].numpy()), mu[jax_key], 1e-2, 5e-4,
                   f"{msg} {net} mu {jax_key}")
            _close(inv(state["exp_avg_sq"].numpy()), nu[jax_key], 1e-2, 5e-4,
                   f"{msg} {net} nu {jax_key}")


# --------------------------------------------------------------------------
# the tests
# --------------------------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_make_mesh_matches_jax(runs, world):
    _, ranks = runs
    want = jax_make_mesh(n_devices=world, mp=2)
    for rank, res in enumerate(ranks[world]):
        assert res["mesh"]["shape"] == want.devices.shape
        assert res["mesh"]["names"] == want.axis_names == ("dp", "mp")
        assert res["mesh"]["coord"] == (rank // 2, rank % 2)


def test_gpt_placements_match_jax_param_spec(runs):
    parent, ranks = runs
    jm = JaxGPT(embed_dim=32, context_length=4, num_layers=2, num_heads=4)
    params = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((2, 4, 32)),
                                            deterministic=True))["params"]
    specs = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        key = "params/" + "/".join(str(getattr(p, "key", p)) for p in path)
        specs[key] = tuple(_param_spec(path, leaf))
    to_torch = {"": [("Replicate", None)], (None, "mp"): [("Shard", 0)],
                ("mp", None): [("Shard", 1)]}
    seen = 0
    for jax_key, torch_key, _, _ in _entries(parent["gpt"], [], []):
        spec = specs[jax_key]
        want = to_torch[spec if spec else ""]
        for res in ranks[2]:
            assert res["gpt"]["placements"][torch_key] == want, (jax_key, torch_key)
        seen += 1
    assert seen == len(specs)
    # column- and row-parallel weights hold half their rows / columns
    local = ranks[2][0]["gpt"]["local"]
    assert local["nets.transformer.0.nets.mlp.0.weight"] == (64, 32)
    assert local["nets.transformer.0.nets.mlp.2.weight"] == (32, 64)
    assert local["nets.transformer.0.nets.attention.nets.qkv.weight"] == (48, 32)


def test_gpt_mp2_forward_matches_replicated(runs):
    parent, ranks = runs
    for res in ranks[2]:
        torch.testing.assert_close(res["gpt"]["out"], parent["gpt_ref"], rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_lipvq_step_dp_matches_unsharded_and_jax(runs, world):
    parent, ranks = runs
    loss, state = parent["lipvq"]
    jax_loss, jax_flat = parent["jax"]["lipvq"]
    model = W.lipvq_model()
    for res in ranks[world]:
        got_loss, got_state = res["lipvq"]
        _close(got_loss, loss, 1e-6, 0.0, "loss")
        _close(got_loss, jax_loss, 1e-6, 0.0, "loss against JAX")
        for k, v in state.items():
            _close(got_state[k], v, 1e-5, 1e-6, k)
        model.load_state_dict(got_state)
        for k, v in jax_variables(model).items():
            _close(v, jax_flat[k], 1e-4, 1e-5, f"against JAX {k}")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("tag", ["flagship", "flagship_rgb", "paper"])
def test_dp_steps_match_unsharded_and_jax(runs, world, tag):
    """The paper step is held against the unsharded port here; the port's
    unsharded paper step against JAX's is tests/test_torch_icl_gmm_train.py."""
    parent, ranks = runs
    port = parent["legs"][tag]
    res = ranks[world][0][tag]
    _check_losses(res["losses"], port["losses"], 1e-5, 1e-6, f"{tag} dp={world} vs port")
    _check_nets_against_port(res["nets"], port["nets"], f"{tag} dp={world}")
    _check_opt_against_port(res["opt"], port["opt"], f"{tag} dp={world}")
    if tag in parent["jax"]:
        jax_losses, jax_flat, jax_opt = parent["jax"][tag]
        _check_losses(res["losses"], jax_losses, 1e-4, 1e-5, f"{tag} dp={world} vs JAX")
        _check_against_jax(res["nets"], res["opt"], port["algo"], jax_flat, jax_opt,
                           f"{tag} dp={world}")
    for other in ranks[world][1:]:
        _check_losses(other[tag]["losses"], res["losses"], 0, 0, "ranks agree")
        _check_nets_against_port(other[tag]["nets"], res["nets"], "ranks agree", 0.0)


@pytest.mark.parametrize("world", WORLDS)
def test_dp_kmeans_init_and_replacement_match_unsharded(runs, world):
    """The flagship from an uninitialized ``vq`` state: step 0's k-means
    init on the all-gathered batch, then a clustered batch whose dead codes
    are replaced by picks of the replicated generator; every ``vq`` buffer
    and weight as the unsharded port's."""
    parent, ranks = runs
    port = parent["legs"]["flagship_kmeans"]
    res = ranks[world][0]["flagship_kmeans"]
    _check_losses(res["losses"], port["losses"], 1e-5, 1e-6, f"kmeans dp={world}")
    _check_nets_against_port(res["nets"], port["nets"], f"kmeans dp={world}")
    _check_opt_against_port(res["opt"], port["opt"], f"kmeans dp={world}")
    # the replacement fired: replaced codes count 1 and hold a batch row
    size = port["nets"]["vqvae.cluster_size_z"]
    assert int((size == 1.0).sum()) >= W.KZ // 4, size


@pytest.mark.parametrize("world", WORLDS)
def test_shard_state_refuses_what_it_does_not_cover(runs, world):
    """Under mp = 2 shard_state takes offline RL, the hierarchical family,
    the MCR policies and MCR pretraining (each under dp too: their steps
    are tests/test_torch_mesh_value.py's and tests/test_torch_mesh_mcr.py's),
    the bf16 step, a bc policy and the paper's bin tokenizer (their steps
    under mp: tests/test_torch_mesh_mp_*.py). It refuses what JAX's
    ``shard_state`` cannot run either: an object of no covered class, and a
    GPT whose qkv rows mp does not divide; and train_on_batch refuses a
    batch that is not a shard."""
    _, ranks = runs
    got = ranks[world][0]["refusals"]
    for case in ("iql", "gl", "mcr", "mcr_pretrain"):
        assert got[case] is None, (case, got[case])
        assert got[f"{case}_dp"] is None, got[f"{case}_dp"]
    for case in ("bc_mp", "bin_mp", "mixed_precision_mp"):
        assert got[case] is None, (case, got[case])
    assert got["not_covered"].startswith("NotImplementedError")
    assert "SimpleNamespace (covered:" in got["not_covered"]
    assert got["undivisible_mp"].startswith("ValueError")
    assert "qkv.weight (45, 15) is not divisible by mp=2" in got["undivisible_mp"]
    assert got["unsharded_batch"].startswith("ValueError")
    assert "shard_batch" in got["unsharded_batch"]


class _StubMesh:
    """A ('dp', 'mp') mesh's shape and this rank's coordinates, for
    ``shard_batch`` alone."""

    mesh_dim_names = ("dp", "mp")

    def __init__(self, dp, rank):
        self.dp, self.rank = dp, rank

    def size(self, dim):
        return (self.dp, 1)[dim]

    def get_local_rank(self, axis):
        return self.rank if axis == "dp" else 0


def test_shard_batch_rows_and_halves():
    from robot_manipulation_vq_vae_tpu_torch.parallel import LocalBatch, shard_batch

    batch = {"obs": {"a": torch.arange(8)[:, None]}, "actions": np.arange(8), "goal": None}
    got = shard_batch(_StubMesh(4, 1), batch)
    assert isinstance(got, LocalBatch) and got.layout == "rows" and got.dp == 4
    assert got["obs"]["a"].flatten().tolist() == [2, 3]
    assert got["actions"].tolist() == [2, 3] and got["goal"] is None
    # halves: rank r holds its slice of the context half and of the
    # supervised half, row i of one beside row B/2 + i of the other
    halves = shard_batch(_StubMesh(2, 1), batch, halves=True)
    assert halves.layout == "halves"
    assert halves["obs"]["a"].flatten().tolist() == [2, 3, 6, 7]
    assert halves["actions"].tolist() == [2, 3, 6, 7]
    with pytest.raises(ValueError, match="not divisible"):
        shard_batch(_StubMesh(3, 0), batch)
    with pytest.raises(ValueError, match="each half"):
        shard_batch(_StubMesh(2, 0), {"x": torch.zeros(6)}, halves=True)


def test_make_mesh_starts_a_one_rank_group_and_dp1_is_the_unsharded_step():
    """With no process group started, make_mesh starts one of this process
    alone (gloo here); at dp = 1 shard_state leaves the algo as it is and a
    step on shard_batch's shard equals the plain step."""
    import torch.distributed as dist

    from robot_manipulation_vq_vae_tpu_torch.parallel import make_mesh, shard_state

    assert not dist.is_initialized()
    mesh = make_mesh()
    try:
        assert tuple(mesh.mesh.shape) == (1, 1) and dist.get_backend() == "gloo"
        leg = W.legs()["paper"]
        name, cfg_name, with_rgb, init_vq, batches, halves = leg
        a, _ = W.leg_algo(name, cfg_name, with_rgb, init_vq)
        b, _ = W.leg_algo(name, cfg_name, with_rgb, init_vq)
        assert shard_state(mesh, b) is b and b.dp is None
        want = W.steps(a, batches[:1], None, halves)
        got = W.steps(b, batches[:1], mesh, halves)
        assert got == want
    finally:
        dist.destroy_process_group()
