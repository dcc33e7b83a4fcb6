"""The ``bcq`` family, the port's against the JAX package's (see
``test_torch_offline_rl.py`` for the sizes, draws and tolerances):
``BCQ`` with the perturbation actor and n-step 2; ``BCQ`` with the
critic's window closing and the actor's opening at epoch 2 (and the
sampler's closing at 1); ``BCQ_GMM``; ``BCQ_Distributional`` with the
perturbation actor. Each B = 16 request picks the same candidate of each
row as JAX's. Also the ``bcq`` routing, and a ``.pth`` of each algo of the
family served through ``policy_from_checkpoint`` by the plain
``RolloutPolicy`` to the trained algo's actions."""

import copy

import numpy as np
import pytest
import torch

import robot_manipulation_vq_vae_tpu.algo as JaxAlgo
from robot_manipulation_vq_vae_tpu.config import config_factory as jax_config_factory

import robot_manipulation_vq_vae_tpu_torch.algo as PortAlgo
from robot_manipulation_vq_vae_tpu_torch.algo import bcq as PortBCQ
from robot_manipulation_vq_vae_tpu_torch.config import config_factory
from robot_manipulation_vq_vae_tpu_torch.utils import file_utils as FileUtils
from robot_manipulation_vq_vae_tpu_torch.utils import train_utils as TrainUtils
from torch_offline_rl_harness import (
    A,
    MODES,
    O,
    check_get_action_matches_jax,
    check_parameters_match_jax,
    check_step_metrics_match_jax,
    make,
    raw_batch,
    run_pair,
    set_key,
)


@pytest.fixture(scope="module", params=["bcq", "bcq_windows", "bcq_gmm",
                                        "bcq_distributional"])
def run(request):
    return run_pair(request.param)


def test_step_metrics_match_jax(run):
    check_step_metrics_match_jax(run)


def test_parameters_after_three_steps_match_jax(run):
    check_parameters_match_jax(run)


def test_get_action_matches_jax(run, monkeypatch):
    check_get_action_matches_jax(run, monkeypatch)


def test_closed_windows_hold_their_networks():
    """bcq_windows: the sampler steps at epoch 0 only, the critics at 0 and
    1 (their targets with them), the actor at 2 only."""
    algo = make("bcq_windows", "port")
    rng = np.random.RandomState(3)
    nets = ("action_sampler", "critic", "critic_target", "actor", "actor_target")
    moved = []
    for epoch in range(3):
        before = {n: copy.deepcopy(algo.nets[n].state_dict()) for n in nets}
        algo.train_on_batch(algo.process_batch_for_training(raw_batch(rng)), epoch)
        moved.append([n for n in nets if any(
            not torch.equal(v, before[n][k]) for k, v in algo.nets[n].state_dict().items())])
    assert moved == [["action_sampler", "critic", "critic_target"],
                     ["critic", "critic_target"], ["actor", "actor_target"]]


@pytest.mark.parametrize("edits", [{}, {"action_sampler.gmm.enabled": True},
                                   {"critic.distributional.enabled": True},
                                   {"critic.distributional.enabled": True,
                                    "action_sampler.gmm.enabled": True}],
                         ids=["vae", "gmm", "distributional", "distributional_gmm"])
def test_bcq_routes_as_jax(edits):
    names = []
    for make_cfg, factory in ((jax_config_factory, JaxAlgo.bcq.algo_config_to_class),
                              (config_factory, PortBCQ.algo_config_to_class)):
        cfg = make_cfg("bcq")
        with cfg.values_unlocked():
            for k, v in edits.items():
                set_key(cfg.algo, k, v)
        names.append(factory(cfg.algo)[0].__name__)
    assert names[0] == names[1]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_checkpoint_serves_through_the_plain_rollout_policy(mode, tmp_path):
    """A trained algo's .pth (the reference's key names) through
    ``policy_from_checkpoint``: a ``RolloutPolicy`` whose episode, with
    generators seeded alike, equals the trained algo's."""
    algo = make(mode, "port")
    rng = np.random.RandomState(7)
    for epoch in range(2):
        algo.train_on_batch(algo.process_batch_for_training(raw_batch(rng)), epoch)
    path = str(tmp_path / f"{mode}.pth")
    TrainUtils.save_model(algo, algo.global_config,
                          {"env_name": "Fake", "type": 1, "env_kwargs": {}},
                          {"ac_dim": A, "all_shapes": {"flat": [O]}, "all_obs_keys": ["flat"],
                           "use_images": False}, path)
    policy, ckpt = FileUtils.policy_from_checkpoint(device="cpu", ckpt_path=path)
    assert type(policy) is PortAlgo.RolloutPolicy
    assert type(policy.policy).__name__ == MODES[mode][1]
    names = set(ckpt["model"])
    assert any(k.startswith("critic.0.nets.") for k in names)
    assert any(k.startswith("critic_target.0.nets.") for k in names)
    twin = PortAlgo.RolloutPolicy(algo)
    for p in (policy, twin):
        p.start_episode()
        p.policy.generator.manual_seed(11)
    for _ in range(3):
        ob = {"flat": rng.randn(O).astype(np.float32)}
        got, want = policy(ob), twin(ob)
        assert got.shape == (A,) and np.isfinite(got).all()
        np.testing.assert_array_equal(got, want)
