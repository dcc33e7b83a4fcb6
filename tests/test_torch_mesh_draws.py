"""The port's data-parallel step with the shipped models' random draws on the
CPU over ``gloo``: ranks spawned as in tests/test_torch_mesh.py
(``tests/torch_mesh_workers.py``, no JAX in the ranks), a 2-rank and a 4-rank
group at once while this process runs the unsharded port and JAX.

Each draw (dropout, the randomizers' crops, color jitter and noise,
SpatialSoftmax's keypoint noise, the GMM sample) is taken at the global
batch's shape from the generator every rank holds in the same state, and
each rank keeps its rows (``utils.draws.global_draw``), so:

* the tiny flagship with rgb (``__graft_entry__._tiny_config``'s crop 28 and
  icl's dropout 0.1 in the GPT and the HVQVAE, SpatialSoftmax keypoint noise
  0.1), the same behind ``ColorRandomizer`` + ``GaussianNoiseRandomizer``,
  and ``icl_gmm_paper`` with its dropout 0.1 in the halves layout: two dp
  steps equal the port's unsharded steps (losses 1e-5; weights, buffers and
  Adam moments 1e-5), and ``get_action`` after them, on each rank's shards,
  returns the unsharded request's actions within 1e-5 on every rank (the
  paper's GMM sample included);
* the flagship's dp serving, draw-free, from its initial weights equals
  JAX's ``get_action`` from the same weights (test_parallel.py's 1e-3);
* ``global_draw``'s rows and halves, and ``base_nets.Dropout``'s semantics.
"""

import numpy as np
import pytest
import torch

import robot_manipulation_vq_vae_tpu.algo as JaxAlgo
from robot_manipulation_vq_vae_tpu.config import config_factory as jax_config_factory
from robot_manipulation_vq_vae_tpu.models.base_nets import set_pallas_pool
from robot_manipulation_vq_vae_tpu.utils import obs_utils as JaxObsUtils

from robot_manipulation_vq_vae_tpu_torch.models.base_nets import Dropout
from robot_manipulation_vq_vae_tpu_torch.parallel import global_draw
import torch_mesh_workers as W
from torch_port_helpers import set_jax_state
from test_torch_mesh import (
    _check_losses,
    _check_nets_against_port,
    _check_opt_against_port,
    _close,
    _jax_variables,
)
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

WORLDS = (2, 4)


def _jax_serving(algo0):
    """JAX's flagship (draw-free, with rgb) from the port's weights @algo0:
    its ``get_action`` on ``W.request``."""
    cfg = W.flagship_config(jax_config_factory("icl"), True)
    JaxObsUtils.initialize_obs_utils_with_config(cfg)
    algo = JaxAlgo.algo_factory("icl", cfg, W.shapes(True), W.A)
    try:
        set_jax_state(algo, {n: _jax_variables(algo0.nets[n]) for n in algo0.nets})
        obs, ctx = W.request(True)
        return np.asarray(algo.get_action(obs, ctx))
    finally:
        set_pallas_pool(False)   # the JAX algo set the package's flag


def _parent():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = {tag: W.run_leg(leg, None, None)[1] for tag, leg in W.draw_legs().items()}
        algo0, _ = W.leg_algo("icl", "flagship", True, True)
        out["jax_serving"] = _jax_serving(algo0)
        return out
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("mesh_draws")
    started = {w: W.start_ranks(W.job_draws, w, work / f"world{w}") for w in WORLDS}
    try:
        parent = _parent()
    finally:
        ranks = {w: results() for w, results in started.items()}
    return parent, ranks


TAGS = list(W.draw_legs())


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("tag", TAGS)
def test_dp_steps_with_draws_match_unsharded(runs, world, tag):
    parent, ranks = runs
    port, res = parent[tag], ranks[world][0][tag]
    _check_losses(res["losses"], port["losses"], 1e-5, 1e-6, f"{tag} dp={world}")
    _check_nets_against_port(res["nets"], port["nets"], f"{tag} dp={world}")
    _check_opt_against_port(res["opt"], port["opt"], f"{tag} dp={world}")
    for other in ranks[world][1:]:
        _check_losses(other[tag]["losses"], res["losses"], 0, 0, "ranks agree")
        assert other[tag]["digest"] == W.digest(res), "ranks agree"


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("tag", TAGS)
def test_dp_get_action_returns_the_global_batch(runs, world, tag):
    """Every rank returns the B rows of the unsharded request; the paper's
    GMM sample draws the global batch from the replicated generator."""
    parent, ranks = runs
    want = parent[tag]["action"]
    assert want.shape == (W.B, W.A)
    for rank, res in enumerate(ranks[world]):
        _close(res[tag]["action"], want, 1e-5, 1e-5, f"{tag} dp={world} rank {rank}")


@pytest.mark.parametrize("world", WORLDS)
def test_dp_serving_matches_jax(runs, world):
    parent, ranks = runs
    for res in ranks[world]:
        _close(res["serve_initial"], parent["jax_serving"], 1e-3, 1e-3,
               f"dp={world} serving against JAX")


class _Axis:
    """A dp axis' size and this rank's index, for ``global_draw`` alone."""

    def __init__(self, size, rank):
        self.size, self.rank = size, rank


def test_global_draw_keeps_this_ranks_rows():
    """dp = 4: each rank's rows (or its rows of each half) of one draw at
    the global shape; the ranks' parts make up the unsharded draw."""
    def draw(seed):
        return lambda shape: torch.rand(shape, generator=torch.Generator().manual_seed(seed))

    want = draw(0)((8, 3))
    assert torch.equal(global_draw(draw(0), (8, 3)), want)
    assert torch.equal(global_draw(draw(0), (8, 3), _Axis(1, 0)), want)
    rows = [global_draw(draw(0), (2, 3), _Axis(4, r)) for r in range(4)]
    assert torch.equal(torch.cat(rows), want)
    halves = [global_draw(draw(0), (2, 3), _Axis(4, r), "halves") for r in range(4)]
    assert torch.equal(torch.cat([h[:1] for h in halves] + [h[1:] for h in halves]), want)


def test_dropout_draws_flax_semantics_from_its_generator():
    """Kept with probability 1 - p and scaled by 1 / (1 - p), the mask from
    the generator it is handed; the identity in eval and at p = 0."""
    x = torch.ones(200, 50)
    drop = Dropout(0.1).train()
    drop.generator = torch.Generator().manual_seed(3)
    y = drop(x)
    kept = y != 0
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.9))
    assert abs(kept.float().mean().item() - 0.9) < 0.01
    drop.generator.manual_seed(3)
    assert torch.equal(drop(x), y)
    # the attention's mask under mp: every head's drawn, a part applied
    drop.generator.manual_seed(3)
    part = drop(x[:, :20], (200, 50), (slice(None), slice(10, 30)))
    assert torch.equal(part, y[:, 10:30])
    assert drop.eval()(x) is x
    assert Dropout(0.0).train()(x) is x
