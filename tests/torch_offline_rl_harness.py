"""Shared pieces of the offline-RL family's parity tests
(``tests/test_torch_offline_rl*.py``): the small configurations of each
algo (``MODES``), both packages' algos from the same weights, the step's
draws for both, and ``run_pair``: 3 training steps, a validation call and
the results of both. See ``tests/test_torch_offline_rl.py``'s docstring."""

import copy

import numpy as np
import torch

import jax
import jax.numpy as jnp

import robot_manipulation_vq_vae_tpu.algo as JaxAlgo
from robot_manipulation_vq_vae_tpu.config import config_factory as jax_config_factory
from robot_manipulation_vq_vae_tpu.models import distributions as JaxDist
from robot_manipulation_vq_vae_tpu.models import vae_nets as JaxVAENets
from robot_manipulation_vq_vae_tpu.utils import obs_utils as JaxObsUtils
from robot_manipulation_vq_vae_tpu.utils.ckpt_conversion import flatten_variables

import robot_manipulation_vq_vae_tpu_torch.algo as PortAlgo
from robot_manipulation_vq_vae_tpu_torch.config import config_factory
from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils as PortObsUtils
from robot_manipulation_vq_vae_tpu_torch.utils.jax_weights import load_jax_variables
from torch_port_helpers import PinnedJaxRandom, perturbed_variables, random_init

B, O, A, T = 16, 5, 3, 2
LAYERS = (8, 8)
LR, STEPS = 1e-3, 3
LATENT, N_RAND, N_SAMPLES, N_ROLLOUT, ATOMS = 4, 4, 3, 5, 11

# mode -> (algo name, class name, config edits {dotted key under algo: value});
# every mode is run by one of the test files
MODES = {
    "iql": ("iql", "IQL", {"adv.clip_adv_value": 0.5}),
    "iql_tanh": ("iql", "IQL", {"actor.net.common.use_tanh": True,
                                "critic.use_huber": True}),
    "iql_gmm": ("iql", "IQL", {"actor.net.type": "gmm", "actor.net.gmm.num_modes": 3}),
    "td3_bc": ("td3_bc", "TD3_BC", {"n_step": 2, "infinite_horizon": True,
                                    "critic.ensemble.weight": 0.75}),
    "cql": ("cql", "CQL", {"n_step": 2, "critic.num_random_actions": N_RAND,
                           "critic.deterministic_backup": False,
                           "actor.bc_start_steps": 2}),
    "cql_samples": ("cql", "CQL", {"critic.num_random_actions": N_RAND,
                                   "critic.num_action_samples": N_SAMPLES,
                                   "critic.target_q_gap": -1.0, "critic.cql_weight": 2.0,
                                   "actor.target_entropy": None}),
    "bcq": ("bcq", "BCQ", {"n_step": 2, "actor.enabled": True}),
    "bcq_windows": ("bcq", "BCQ", {"actor.enabled": True,
                                   "optim_params.actor.start_epoch": 2,
                                   "optim_params.critic.end_epoch": 2,
                                   "optim_params.action_sampler.end_epoch": 1}),
    "bcq_gmm": ("bcq", "BCQ_GMM", {"action_sampler.gmm.enabled": True,
                                   "action_sampler.gmm.num_modes": 3}),
    "bcq_distributional": ("bcq", "BCQ_Distributional", {
        "actor.enabled": True, "critic.distributional.enabled": True,
        "critic.distributional.num_atoms": ATOMS, "critic.value_bounds": [-4.0, 4.0]}),
}


def set_key(node, dotted, value):
    *path, leaf = dotted.split(".")
    for p in path:
        node = node[p]
    node[leaf] = value


def tune(cfg, mode):
    """Small widths, lr 1e-3 (constant) with L2 and a clip limit; the BCQ
    samplers' sizes; @mode's edits."""
    with cfg.values_unlocked():
        cfg.observation.modalities.obs.low_dim = ["flat"]
        cfg.observation.modalities.obs.rgb = []
        algo = cfg.algo
        algo.critic.layer_dims = list(LAYERS)
        algo.actor.layer_dims = list(LAYERS)
        for name in algo.optim_params:
            p = algo.optim_params[name]
            p.learning_rate.initial, p.learning_rate.scheduler_type = LR, None
            p.regularization.L2 = 1e-2
        cfg.train.max_grad_norm = 1.0
        if "action_sampler" in algo:
            vae = algo.action_sampler.vae
            vae.latent_dim = LATENT
            vae.encoder_layer_dims = vae.decoder_layer_dims = vae.prior_layer_dims = [8]
            vae.kl_weight = 0.5
            algo.action_sampler.actor_layer_dims = list(LAYERS)
            algo.critic.num_action_samples = N_SAMPLES
            algo.critic.num_action_samples_rollout = N_ROLLOUT
        for key, value in MODES[mode][2].items():
            set_key(algo, key, value)
    return cfg


def make(mode, side):
    """The JAX (@side "jax") or port algo of @mode."""
    name, cls, _ = MODES[mode]
    if side == "jax":
        cfg = tune(jax_config_factory(name), mode)
        JaxObsUtils.initialize_obs_utils_with_config(cfg)
        algo = JaxAlgo.algo_factory(name, cfg, {"flat": (O,)}, A)
        algo._init_variables = random_init(algo._init_variables)
    else:
        cfg = tune(config_factory(name), mode)
        PortObsUtils.initialize_obs_utils_with_config(cfg)
        algo = PortAlgo.algo_factory(name, cfg, {"flat": (O,)}, A, device="cpu")
    assert type(algo).__name__ == cls
    return algo


def raw_batch(rng):
    def f32(*shape, low=None):
        v = rng.uniform(-0.9, 0.9, shape) if low else rng.randn(*shape)
        return v.astype(np.float32).astype(np.float64)

    return {"obs": {"flat": f32(B, T, O)}, "next_obs": {"flat": f32(B, T, O)},
            "actions": f32(B, T, A, low=True),
            "rewards": rng.rand(B, T).astype(np.float32).astype(np.float64),
            "dones": (rng.rand(B, T) < 0.25).astype(np.float64)}


def port_module(algo, jax_name):
    """The port's module of the JAX state's entry @jax_name."""
    for prefix, net in (("critic", "critic"), ("critic", "critic_target")):
        if jax_name.startswith(prefix) and jax_name.endswith("_target") == (
                net == "critic_target"):
            return algo.nets[net][int(jax_name[len("critic"):].split("_")[0])]
    return algo.nets[jax_name]


def carry_weights(jax_algo, algo, batch=None):
    """Every JAX parameter tree (initialized on @batch) made random (float64)
    and loaded into the port (float64); the JAX optimizer states initialized
    on them."""
    if batch is None:
        batch = raw_batch(np.random.RandomState(99))
    jax_algo.ensure_state(jax_algo.process_batch_for_training(batch))
    params = {}
    with jax.enable_x64():
        for i, (name, tree) in enumerate(sorted(jax_algo.state.params.items())):
            nested, flat = perturbed_variables({"params": tree}, 10 + i)
            params[name] = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                                  nested["params"])
        jax_algo.state = jax_algo.state.replace(
            params=params,
            opt_states={n: jax_algo.optimizers[n].init(params[n]) for n in params
                        if n in jax_algo.optimizers})
    algo.nets.double()
    for name, tree in params.items():
        load_jax_variables(port_module(algo, name), flatten_variables({"params": tree}))
    return params


def step_draws(mode, jax_algo, rng):
    """(JAX hook value, port hook value) of one step's draws, or None."""
    if mode.startswith("cql"):
        n = N_SAMPLES if mode == "cql_samples" else 1
        d = {"actor": rng.randn(B, A), "curr": rng.randn(B * N_RAND, A),
             "next": rng.randn(B * N_RAND, A),
             "backup": rng.randn(n, B, A) if n > 1 else rng.randn(B, A),
             "rand": rng.uniform(-1, 1, (B * N_RAND, A))}
    elif mode == "bcq_gmm":
        d = {"enc": rng.randn(B, LATENT),
             "backup": (rng.randint(0, 3, B * N_SAMPLES), rng.randn(B * N_SAMPLES, A)),
             "actor": (rng.randint(0, 3, B), rng.randn(B, A))}
    elif mode.startswith("bcq"):
        d = {"enc": rng.randn(B, LATENT), "backup": rng.randn(B * N_SAMPLES, LATENT),
             "actor": rng.randn(B, LATENT)}
    elif mode == "td3_bc":
        # the JAX step's own draw: normal(split(state.rng)[1], [B, A])
        with jax.enable_x64():
            key = jax.random.split(jax_algo.state.rng)[1]
            return None, np.array(jax.random.normal(key, (B, A)))
    else:
        return None, None
    return d, d


def _jax_hook(value):
    if value is None:
        return None
    return lambda: jax.tree_util.tree_map(jnp.asarray, value)


def run_pair(mode):
    """Both algos of @mode from the same weights through the same 3 batches
    (epochs 0, 1, 2) and a validation call: {mode, metrics [(JAX's,
    port's)], jax, port, expected (the port's algo holding JAX's
    weights)}."""
    rng = np.random.RandomState(0)
    jax_algo, algo = make(mode, "jax"), make(mode, "port")
    carry_weights(jax_algo, algo)
    metrics = []
    for epoch in range(STEPS + 1):
        validate = epoch == STEPS
        batch = raw_batch(rng)
        jax_hook, port_hook = step_draws(mode, jax_algo, rng)
        jax_algo._noise_hook, algo._noise_hook = _jax_hook(jax_hook), (
            None if port_hook is None else (lambda v=port_hook: v))
        with jax.enable_x64():
            want = jax_algo.train_on_batch(jax_algo.process_batch_for_training(batch),
                                           epoch=min(epoch, STEPS - 1),
                                           validate=validate)["losses"]
        got = algo.train_on_batch(algo.process_batch_for_training(batch),
                                  epoch=min(epoch, STEPS - 1), validate=validate)["losses"]
        metrics.append(({k: float(v) for k, v in want.items()},
                        {k: float(v) for k, v in got.items()}))
    expected = copy.deepcopy(algo)
    for name, tree in jax_algo.state.params.items():
        load_jax_variables(port_module(expected, name), flatten_variables({"params": tree}))
    return dict(mode=mode, metrics=metrics, jax=jax_algo, port=algo, expected=expected)


def check_step_metrics_match_jax(run):
    """Every metric of every step within 1e-6 relative."""
    for step, (want, got) in enumerate(run["metrics"]):
        assert set(got) == set(want), f"step {step}"
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-12,
                                       err_msg=f"step {step} {k}")


def check_parameters_match_jax(run):
    """Every tensor of the state dict within 1e-6 of its largest."""
    got, want = run["port"].nets.state_dict(), run["expected"].nets.state_dict()
    assert set(got) == set(want)
    for k, w in want.items():
        err = float((got[k] - w).abs().max())
        assert err <= 1e-6 * max(float(w.abs().max()), 1e-12), f"{k}: {err}"


def check_get_action_matches_jax(run, monkeypatch):
    """A B = 16 request, JAX's draws pinned and replayed, within 1e-9; BCQ
    picks the same candidate of each row, and its ``get_state_value`` (the
    best candidate's Q) agrees; so does ``get_state_action_value`` where
    the JAX class has it."""
    jax_algo, algo, mode = run["jax"], run["port"], run["mode"]
    obs = {"flat": np.random.RandomState(5).randn(B, O)}
    pinned = PinnedJaxRandom(6)
    monkeypatch.setattr(JaxDist, "jax", pinned)
    monkeypatch.setattr(JaxVAENets, "jax", pinned)
    with jax.enable_x64():
        want = np.asarray(jax_algo.get_action(obs))
    draws = [np.array(v) for _, v in pinned.log]
    if draws:
        algo._sample_hook = lambda: draws[0] if len(draws) == 1 else tuple(draws)
    got = algo.get_action(obs).numpy()
    assert got.shape == (B, A)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    if mode.startswith("bcq"):
        with torch.no_grad():
            cand, q = algo._scored_candidates(obs)
        picked = np.abs(cand.numpy() - want[:, None]).sum(-1).argmin(1)
        np.testing.assert_array_equal(q.argmax(1).numpy(), picked)
        pinned.log.clear()
        with jax.enable_x64():
            want_v = np.asarray(jax_algo.get_state_value(obs))
        value_draws = [np.array(v) for _, v in pinned.log]
        algo._sample_hook = lambda: (value_draws[0] if len(value_draws) == 1
                                     else tuple(value_draws))
        got_v = algo.get_state_value(obs).numpy()
        assert got_v.shape == (B, 1)
        np.testing.assert_allclose(got_v, want_v, rtol=1e-9, atol=1e-9)
    if hasattr(jax_algo, "get_state_action_value"):
        acts = np.random.RandomState(7).uniform(-0.9, 0.9, (B, A))
        with jax.enable_x64():
            want_q = np.asarray(jax_algo.get_state_action_value(
                obs, jnp.asarray(acts)))
        got_q = algo.get_state_action_value(obs, acts).numpy()
        np.testing.assert_allclose(got_q, want_q, rtol=1e-9, atol=1e-9)
