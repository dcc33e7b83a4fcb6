"""The offline-RL family, the port's against the JAX package's: ``IQL``
(Gaussian, tanh-wrapped Gaussian and GMM actors), ``TD3_BC`` and ``CQL``
here, the ``bcq`` classes in ``test_torch_offline_rl_bcq.py``; the shared
pieces in ``torch_offline_rl_harness.py``.

* Each algo at small sizes (B 16, a 5-d ``flat`` observation, A 3, layers
  (8, 8), n-step 2 where the algo takes it, L2 and gradient clipping): JAX's
  weights carried across (every leaf, targets and log weights included, made
  random), 3 ``train_on_batch`` steps and a validation call on both sides in
  float64 with the same draws (CQL's and BCQ's through both ``_noise_hook``s;
  TD3-BC's smoothing noise replayed from the JAX step's key), then a B = 16
  ``get_action`` with JAX's draws pinned (``PinnedJaxRandom``) and replayed
  into ``_sample_hook``, and the value queries (``get_state_action_value``;
  BCQ's ``get_state_value``). Metrics within 1e-6 relative; every
  parameter, target parameter and log weight within 1e-6 of its tensor's
  largest; actions and values within 1e-9. TD3-BC's 3 steps cross its actor delay (update_freq
  2: the actor and the targets move at the second step only), and its
  counter survives a ``.pth`` resume.
* An IQL step on a camera: ``test_torch_offline_rl_image.py``.
* Each template (``exps/templates/{iql,td3_bc,cql}.json``) builds its class
  unchanged and takes a step; ``train.mixed_precision`` and goals raise.

The JAX algos' variables come from ``torch_port_helpers.random_init``
(nothing compiles for the initialization); their steps compile under jit.
Batches are float32 values held as float64 (the port reads actions in
float32).
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

import robot_manipulation_vq_vae_tpu_torch.algo as PortAlgo
from robot_manipulation_vq_vae_tpu_torch.config import config_factory
from robot_manipulation_vq_vae_tpu_torch.utils import file_utils as FileUtils
from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils as PortObsUtils
from robot_manipulation_vq_vae_tpu_torch.utils import train_utils as TrainUtils
from torch_offline_rl_harness import (
    A,
    O,
    check_get_action_matches_jax,
    check_parameters_match_jax,
    check_step_metrics_match_jax,
    make,
    raw_batch,
    run_pair,
    tune,
)
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

TEMPLATES = os.path.join(os.path.dirname(__file__), "..", "robot_manipulation_vq_vae_tpu",
                         "exps", "templates")


@pytest.fixture(scope="module", params=["iql", "iql_tanh", "iql_gmm", "td3_bc", "cql",
                                        "cql_samples"])
def run(request):
    return run_pair(request.param)


def test_step_metrics_match_jax(run):
    check_step_metrics_match_jax(run)


def test_parameters_after_three_steps_match_jax(run):
    check_parameters_match_jax(run)


def test_get_action_matches_jax(run, monkeypatch):
    check_get_action_matches_jax(run, monkeypatch)


def _moved(module, before):
    return any(not torch.equal(v, before[k]) for k, v in module.state_dict().items())


def test_td3_bc_actor_moves_on_every_second_critic_step():
    """update_freq 2: the actor and the targets move at the second of 3
    critic steps only; a validation call counts no step."""
    algo = make("td3_bc", "port")
    rng = np.random.RandomState(1)
    moved = []
    for epoch in range(3):
        before = {n: copy.deepcopy(algo.nets[n].state_dict())
                  for n in ("actor", "actor_target", "critic_target")}
        algo.train_on_batch(algo.process_batch_for_training(raw_batch(rng)), epoch)
        moved.append({n: _moved(algo.nets[n], sd) for n, sd in before.items()})
    assert [m["actor"] for m in moved] == [False, True, False]
    assert moved == [{n: m["actor"] for n in m} for m in moved]
    algo.train_on_batch(algo.process_batch_for_training(raw_batch(rng)), 3, validate=True)
    assert algo.critic_steps == 3


def _save(algo, path, include_optimizer=True):
    cfg = algo.global_config
    with cfg.values_unlocked():
        cfg.experiment.save.include_optimizer = include_optimizer
    TrainUtils.save_model(algo, cfg, {"env_name": "Fake", "type": 1, "env_kwargs": {}},
                          {"ac_dim": A, "all_shapes": dict(algo.obs_shapes),
                           "all_obs_keys": list(algo.obs_shapes), "use_images": False},
                          path)


def test_td3_bc_counter_survives_a_checkpoint_resume(tmp_path):
    """After one step (counter 1) a .pth with the optimizers resumes to the
    same counter: the resumed algo's next step moves the actor, as the
    uninterrupted algo's does, to the same weights."""
    algo = make("td3_bc", "port")
    rng = np.random.RandomState(2)
    batches = [algo.process_batch_for_training(raw_batch(rng)) for _ in range(2)]
    algo.train_on_batch(batches[0], 0)
    path = str(tmp_path / "td3_bc.pth")
    _save(algo, path)
    resumed, _ = FileUtils.algo_from_checkpoint(device="cpu", ckpt_path=path)
    assert resumed.critic_steps == algo.critic_steps == 1
    for a in (algo, resumed):
        a.generator.manual_seed(3)
        a.train_on_batch(batches[1], 1)
    assert resumed.critic_steps == 2
    for k, v in algo.nets.state_dict().items():
        assert torch.equal(resumed.nets.state_dict()[k], v), k


# the templates' observations: robomimic Lift's low-dim keys, D4RL's flat
LIFT = {"robot0_eef_pos": (3,), "robot0_eef_quat": (4,), "robot0_gripper_qpos": (2,),
        "object": (10,)}


@pytest.mark.parametrize("name,cls", [("iql", "IQL"), ("td3_bc", "TD3_BC"), ("cql", "CQL"),
                                      ("bcq", "BCQ")])
def test_template_builds_its_class_and_steps(name, cls):
    cfg = config_factory(name)
    with open(os.path.join(TEMPLATES, f"{name}.json")) as f:
        template = json.load(f)
    with cfg.values_unlocked():
        cfg.update(template)
    PortObsUtils.initialize_obs_utils_with_config(cfg)
    shapes = {"flat": (17,)} if name == "td3_bc" else LIFT
    ac_dim = 6 if name == "td3_bc" else 7
    algo = PortAlgo.algo_factory(name, cfg, shapes, ac_dim, device="cpu")
    assert type(algo).__name__ == cls
    assert PortAlgo.rollout_policy_class(algo) is PortAlgo.RolloutPolicy
    rng = np.random.RandomState(0)
    batch = {"obs": {k: rng.randn(4, 1, *s).astype(np.float32) for k, s in shapes.items()},
             "actions": rng.uniform(-1, 1, (4, 1, ac_dim)).astype(np.float32),
             "rewards": rng.rand(4, 1).astype(np.float32), "dones": np.zeros((4, 1))}
    batch["next_obs"] = {k: v + 0.1 for k, v in batch["obs"].items()}
    log = algo.log_info(algo.train_on_batch(algo.process_batch_for_training(batch), 0))
    assert all(np.isfinite(v) for v in log.values())
    obs = {k: v[:, 0] for k, v in batch["obs"].items()}
    assert algo.get_action(obs).shape == (4, ac_dim)


@pytest.mark.parametrize("name", ["iql", "td3_bc", "cql", "bcq"])
def test_options_the_port_refuses_raise(name):
    cfg = tune(config_factory(name), name)
    with cfg.values_unlocked():
        cfg.train.mixed_precision = True
    PortObsUtils.initialize_obs_utils_with_config(cfg)
    with pytest.raises(NotImplementedError, match="mixed_precision"):
        PortAlgo.algo_factory(name, cfg, {"flat": (O,)}, A, device="cpu")
    cfg = tune(config_factory(name), name)
    with cfg.values_unlocked():
        cfg.observation.modalities.goal.low_dim = ["goal_flat"]
    PortObsUtils.initialize_obs_utils_with_config(cfg)
    with pytest.raises(NotImplementedError, match="goal"):
        PortAlgo.algo_factory(name, cfg, {"flat": (O,), "goal_flat": (O,)}, A, device="cpu")
