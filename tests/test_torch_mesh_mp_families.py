"""The port's tensor parallelism (mp > 1) for the GPT-bearing policies on
the CPU over ``gloo``: ranks spawned as in tests/test_torch_mesh.py
(``tests/torch_mesh_workers.py``, no JAX in the ranks), a 2-rank group at
(dp, mp) = (1, 2) and a 4-rank group at (2, 2) and (1, 4), and one
unsharded process at once, while this process runs JAX's own sharded steps.

``shard_state`` places every algo's parameters by JAX's ``_param_spec``
(``TP_RULES``): each attention block's ``mlp_fc`` and ``qkv``
column-parallel, its ``mlp_proj`` and attention ``output`` row-parallel,
wherever the block sits, and the ViT's ``qkv``; everything else
replicated. The legs of ``torch_mesh_workers.MP_LEGS["families"]``:
``icl_gmm_paper`` with LipVQ in bf16 (``half_call``'s bf16 copies of the
DTensor parameters: each local shard cast, in its placement) and with the
bin, LN-act, default and FAST tokenizers,
``BC_Transformer``, ``BC_Transformer_GMM`` and its GEGLU GPT (the
``[8 d, d]`` ``mlp_fc`` split contiguously: rank 0 holds value rows alone)
and its 6-head GPT (mp = 4 does not divide the heads: every rank attends
with every head), ACT (its style encoder's blocks split) with its own
latent draw and with it pinned, and ``MCR_Transformer``. Each takes two
steps on ``shard_batch``'s shards, ``serialize`` with its optimizers, a
request, and a fresh algo under the mesh serves that request again from
the checkpoint:

* the steps equal the unsharded port's: losses 1e-5 relative (1e-6
  absolute), weights, buffers and Adam moments 1e-5 (the bf16 leg at
  ``torch_mesh_workers.check_half_leg``'s bounds, as under dp); every rank
  the same, to the bit;
* every rank's request equals the unsharded request (1e-5; bf16 1e-3), the reloaded
  algo's to the bit, and an unsharded algo from the mp checkpoint (whole
  tensors in the unsharded layout) serves the same (1e-5);
* the placement of every parameter after ``shard_params`` is JAX's
  ``_param_spec`` on the same JAX variables (matched through the modules'
  ``JAX_NAMES``, JAX's [in, out] spec moved to torch's [out, in]); the
  tiny MVP ViT's too, whose forward and gradients under mp equal the
  replicated ones (1e-5);
* with each mp rank's replicated gradients moved by its own amount (as a
  card's non-deterministic kernels part them), the ranks' states stay
  equal to the bit;
* JAX's own sharded step (``parallel.shard_state`` over the virtual CPU
  devices) of ``BC_Transformer_GMM`` at (2, 2), ACT (latent pinned),
  ``MCR_Transformer`` at (1, 2) and the GEGLU and 6-head GPTs at (1, 4),
  from the port's initial weights: losses rtol 1e-4 / atol 1e-5, weights
  and Adam moments atol 5e-4 / rtol 1e-2 (tests/test_parallel.py's).
"""

import pytest
import torch

import jax
import jax.numpy as jnp

import robot_manipulation_vq_vae_tpu.algo as JaxAlgo
from robot_manipulation_vq_vae_tpu.algo import act as JaxAct
from robot_manipulation_vq_vae_tpu.config import config_factory as jax_config_factory
from robot_manipulation_vq_vae_tpu.parallel import make_mesh as jax_make_mesh
from robot_manipulation_vq_vae_tpu.parallel import shard_batch as jax_shard_batch
from robot_manipulation_vq_vae_tpu.parallel import shard_state as jax_shard_state
from robot_manipulation_vq_vae_tpu.parallel.mesh import _param_spec
from robot_manipulation_vq_vae_tpu.utils import obs_utils as JaxObsUtils
from robot_manipulation_vq_vae_tpu.utils.ckpt_conversion import flatten_variables

from robot_manipulation_vq_vae_tpu_torch.utils.jax_weights import _entries
import torch_mesh_workers as W
from torch_port_helpers import PinnedJaxRandom, set_jax_state
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
MESHES = ((1, 2), (2, 2), (1, 4))
TABLE = W.MP_LEGS["families"]
# JAX's sharded steps the port's are held against: {tag: (dp, mp)}
ORACLES = {"bc_transformer_gmm": (2, 2), "act_pinned": (1, 2), "MCR_Transformer": (1, 2),
           "bc_transformer_gmm_geglu": (1, 4), "bc_transformer_gmm_6heads": (1, 4)}


class _PinnedLatent(PinnedJaxRandom):
    """JAX's ACT drawing ``W.act_noise()`` as its latent in every trace."""

    def _normal(self, key, shape=(), dtype=None):
        return self._record("normal", W.act_noise().reshape(shape), self._float())


def _jax_sharded(tag, dp, mp, table=TABLE):
    """JAX's algo of @table's leg @tag from the port's initial weights, its
    two steps sharded over a (dp, mp) mesh of virtual CPU devices: (losses,
    {net: flat variables}, {net: Adam moments}, the port's initial algo)."""
    legs = table[tag]
    name, configure, keys = legs[tag][:3]
    value = legs is W.MCR_CLASS_LEGS
    algo0 = W.value_algo(tag, legs=legs) if value else W.family_algo(tag, legs=legs)
    cfg = configure(jax_config_factory(name))
    JaxObsUtils.initialize_obs_utils_with_config(cfg)
    algo = JaxAlgo.algo_factory(name, cfg, dict(keys), W.VA if value else W.A)
    raw = W.value_batches(tag, legs) if value else W.family_batches(tag, legs)
    batches = [jax.tree_util.tree_map(jnp.asarray, algo.process_batch_for_training(b))
               for b in raw]
    set_jax_state(algo, {n: _jax_variables(algo0.nets[n]) for n in algo0.nets})
    mesh = jax_make_mesh(n_devices=dp * mp, mp=mp)
    losses = []
    with mesh:
        algo.state = jax_shard_state(mesh, algo.state)
        for epoch, batch in enumerate(batches):
            info = algo.train_on_batch(jax_shard_batch(mesh, batch),
                                       epoch=epoch if value else 0)
            losses.append(W.flat_losses(jax.tree_util.tree_map(float, dict(info))))
    flat = {n: flatten_variables({"params": algo.state.params[n], **algo.state.aux[n]})
            for n in algo.state.params}
    moments = {n: tuple(flatten_variables({"params": m}) for m in _adam_moments(o))
               for n, o in algo.state.opt_states.items()}
    return losses, flat, moments, algo0


def _oracles():
    out = {}
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(JaxAct, "jax", _PinnedLatent(W.ACT_SEED))
        for tag, (dp, mp) in ORACLES.items():
            out[tag] = _jax_sharded(tag, dp, mp)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("mesh_mp_families")
    started = {w: W.start_ranks(W.job_mp_families, w, work / f"world{w}", "families")
               for w in WORLDS}
    unsharded = W.start_ranks(W.job_mp_families, 1, work / "unsharded", "families", True)
    try:
        oracles = _oracles()
    finally:
        ranks = {w: results() for w, results in started.items()}
        ref = unsharded()[0]
    return ref, ranks, oracles


def _ranks(runs, mesh, tag):
    dp, mp = mesh
    return [res[(dp, mp, tag)] for res in runs[1][dp * mp]]


def _state(res):
    """A leg's networks and optimizers: a value leg's one part's."""
    return res["states"][""] if "states" in res else res


def _request(res):
    return res["request"] if "request" in res else res["action"]


def _half(tag):
    """Whether @tag is a bf16 leg (``W.check_half_leg``'s bounds)."""
    legs = TABLE[tag]
    return legs is not W.MCR_CLASS_LEGS and legs[tag][7]


CASES = [(tag, mesh) for tag in TABLE for mesh in MESHES]
IDS = [f"{t}-dp{d}mp{m}" for t, (d, m) in CASES]


@pytest.mark.parametrize("tag,mesh", CASES, ids=IDS)
def test_mp_family_steps_match_unsharded(runs, tag, mesh):
    ref = runs[0][tag]
    got = _ranks(runs, mesh, tag)
    msg = f"{tag} {mesh}"
    if _half(tag):
        W.check_half_leg(got[0], ref, tag, msg)
    else:
        _check_losses(got[0]["losses"], ref["losses"], 1e-5, 1e-6, msg)
        _check_nets_against_port(_state(got[0])["nets"], _state(ref)["nets"], msg)
        _check_opt_against_port(_state(got[0])["opt"], _state(ref)["opt"], msg)
    for other in got[1:]:
        _check_losses(other["losses"], got[0]["losses"], 0, 0, "ranks agree")
        assert other["digest"] == W.leg_digest(got[0]), f"{msg} ranks agree"


@pytest.mark.parametrize("tag,mesh", CASES, ids=IDS)
def test_mp_family_requests_and_checkpoints(runs, tag, mesh):
    """The request on every rank, the mp algo reloaded from its checkpoint,
    and an unsharded algo from that checkpoint."""
    ref = runs[0][tag]
    got = _ranks(runs, mesh, tag)
    msg = f"{tag} {mesh}"
    tol = 1e-3 if _half(tag) else 1e-5
    for rank, res in enumerate(got):
        _close(_request(res), _request(ref), tol, tol, f"{msg} rank {rank}")
        _close(res["reloaded"], _request(res), 0, 0, f"{msg} rank {rank} reloaded")
    ser, want = got[0]["serialized"], ref["serialized"]
    assert set(ser) == set(want), msg
    for k, v in want.items():
        if isinstance(v, torch.Tensor):
            assert type(ser[k]) is torch.Tensor and ser[k].shape == v.shape, (msg, k)
            if not _half(tag):   # a bf16 leg's weights: check_half_leg's bounds
                _close(ser[k], v, 1e-5, 1e-5, f"{msg} {k}")
    _close(W.serve_checkpoint(tag, TABLE, ser), _request(got[0]), 1e-5, 1e-5,
           f"{msg} unsharded from the mp checkpoint")


_TO_TORCH = {(): ("Replicate", None), (None, "mp"): ("Shard", 0), ("mp", None): ("Shard", 1)}


def _jax_spec(jax_key, ndim):
    """JAX's ``_param_spec`` of the variable @jax_key ("params/a/.../kernel")
    of rank @ndim, as the port's (placement, dim)."""
    path = tuple(jax.tree_util.DictKey(k) for k in jax_key.split("/")[1:])
    return _TO_TORCH[tuple(_param_spec(path, jnp.zeros((1,) * ndim)))]


def _check_placements(module, got, prefix, msg):
    """Every parameter of @module placed as JAX's ``_param_spec`` places its
    JAX variable; returns the split ones."""
    params = dict(module.named_parameters())
    seen, split = set(), {}
    for jax_key, torch_key, _, _ in _entries(module, [], []):
        if isinstance(jax_key, tuple) or not jax_key.startswith("params/"):
            continue
        if torch_key not in params:
            continue
        want = _jax_spec(jax_key, params[torch_key].dim())
        assert got[prefix + torch_key] == want, (msg, jax_key, torch_key, got[prefix + torch_key])
        seen.add(torch_key)
        if want[0] == "Shard":
            split[prefix + torch_key] = want
    # a parameter of no JAX variable (a stacked LSTM weight) is replicated
    for name in set(params) - seen:
        assert got[prefix + name] == ("Replicate", None), (msg, name)
    return split


@pytest.mark.parametrize("tag", list(TABLE))
def test_mp_placements_match_jax_param_spec(runs, tag):
    """After ``shard_params`` (rank 0 of the (1, 2) mesh): the split
    weights are the kernels JAX's ``_param_spec`` splits, on the same dims,
    and every other parameter is replicated."""
    got = _ranks(runs, (1, 2), tag)[0]["placements"]
    legs = TABLE[tag]
    algo = W.value_algo(tag, legs=legs) if legs is W.MCR_CLASS_LEGS else W.family_algo(
        tag, legs=legs)
    split = {}
    for net, module in algo.nets.items():
        split.update(_check_placements(module, got, f"{net}.", tag))
    assert split == {k: v for k, v in got.items() if v[0] == "Shard"}, tag
    # every GPT-bearing leg splits: ACT its style blocks, the others their GPT
    assert split and all(k.endswith(("qkv.weight", "output.weight", "mlp.0.weight",
                                     "mlp.2.weight")) for k in split), (tag, split)
    if tag.startswith("act"):
        assert any(".style_blocks." in k for k in split), split


@pytest.mark.parametrize("mesh", MESHES, ids=[f"dp{d}mp{m}" for d, m in MESHES])
def test_mp_vit_qkv_split_and_gathered(runs, mesh):
    """MVP's ViT: its blocks' qkv kernels split as JAX's ``_param_spec``
    splits them, gathered in the forward; output and gradients as the
    replicated ViT's."""
    ref = runs[0]["vit"]
    got = _ranks(runs, mesh, "vit")
    model, _ = W.vit()
    split = _check_placements(model, got[0]["placements"], "", "vit")
    assert sorted(split) == ["blocks.0.attn.qkv.weight", "blocks.1.attn.qkv.weight"]
    for rank, res in enumerate(got):
        _close(res["out"], ref["out"], 1e-5, 1e-5, f"vit {mesh} rank {rank}")
        for k, g in ref["grads"].items():
            _close(res["grads"][k], g, 1e-5, 1e-5, f"vit {mesh} rank {rank} grad {k}")


@pytest.mark.parametrize("mesh", MESHES, ids=[f"dp{d}mp{m}" for d, m in MESHES])
def test_mp_replicas_stay_equal_when_their_gradients_part(runs, mesh):
    """Each mp rank computes the replicated modules itself, and on a card
    their non-deterministic kernels part the ranks' gradients: with each mp
    rank's replicated gradients moved by its own amount, two steps still
    leave every rank's weights and buffers equal to the bit."""
    got = _ranks(runs, mesh, "parted_replicas")
    assert all(d == got[0] for d in got[1:]), mesh


@pytest.mark.parametrize("tag", list(ORACLES))
def test_mp_step_matches_jax_sharded_step(runs, tag):
    """The port's sharded steps against JAX's at the same (dp, mp)."""
    losses, flat, moments, algo0 = runs[2][tag]
    res = _ranks(runs, ORACLES[tag], tag)[0]
    msg = f"{tag} {ORACLES[tag]} vs JAX"
    _check_losses(res["losses"], losses, 1e-4, 1e-5, msg)
    state = _state(res)
    _check_against_jax(state["nets"], state["opt"], algo0, flat, moments, msg)
