"""``diffusion_policy``'s ``DiffusionPolicyUNet``, the port's against the JAX
package's (its schedule and UNet are held in
``tests/test_torch_diffusion_nets.py``).

* At small widths (a 5-d observation, To 2, Tp 8, A 3, down dims (16, 32),
  a step embedding of 16, 4 groups, B 6), EMA on, from the same weights in
  float64, the timestep embedding JAX's (its float32 one, see
  ``test_torch_diffusion_nets.py``): 3 ``train_on_batch`` steps (JAX's
  timesteps and noise replayed from its key into ``_noise_hook``), then
  ``get_action`` (its initial noise and DDPM step noises replayed into
  ``_sample_hook``) under DDPM (2 inference steps of 100, the strided grid)
  and DDIM (2; the DDIM config builds JAX's sampler). The loss within 1e-8
  relative; the UNet's, the encoder's and the EMA shadow's parameters in
  bulk, 99 % of each tensor within 1e-8 of its largest and all within 1e-6
  (Flax GroupNorm's one-pass variance and Adam near its epsilon; see the
  test); and, served from JAX's trained weights, the actions within 1e-6
  (the x0 prediction divides the UNet's 1e-10 by sqrt(alphas_bar); see the
  test).
* A validation call leaves the EMA decay's step count alone; the one-time
  action-range check and an unported prediction type raise,
  ``train.mixed_precision`` trains (held against JAX in
  tests/test_torch_bf16_baselines.py); the observation window must hold To frames; a checkpoint from ``scripts/train.train`` serves through
  ``policy_from_checkpoint`` as a ``RolloutPolicy``, its actions equal to
  the trained algo's.
"""

import copy
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import robot_manipulation_vq_vae_tpu.algo as JaxAlgo
from robot_manipulation_vq_vae_tpu.config import config_factory as jax_config_factory
from robot_manipulation_vq_vae_tpu.models import diffusion_nets as JaxDiff
from robot_manipulation_vq_vae_tpu.utils import obs_utils as JaxObsUtils
from robot_manipulation_vq_vae_tpu.utils.ckpt_conversion import flatten_variables

import robot_manipulation_vq_vae_tpu_torch.algo as PortAlgo
from robot_manipulation_vq_vae_tpu_torch.config import config_factory
from robot_manipulation_vq_vae_tpu_torch.models import diffusion_nets as PortDiff
from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils as PortObsUtils
from robot_manipulation_vq_vae_tpu_torch.utils.jax_weights import load_jax_variables
from test_torch_bc import train_and_reload
from test_torch_diffusion_nets import jax_embedding_forward
from torch_port_helpers import perturbed_variables, random_init
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

B, O, A, TO, TP = 6, 5, 3, 2, 8
DOWN, DSED, GROUPS = (16, 32), 16, 4
LR, STEPS = 1e-3, 3
NET_NAMES = ("policy", "obs_encoder", "policy_ema", "obs_encoder_ema")


# ---------------------------------------------------------------------------
# the algo
# ---------------------------------------------------------------------------

def _tune(cfg, ddim=False):
    with cfg.values_unlocked():
        cfg.observation.modalities.obs.low_dim = ["flat"]
        cfg.observation.modalities.obs.rgb = []
        cfg.algo.horizon.observation_horizon = TO
        cfg.algo.horizon.prediction_horizon = TP
        cfg.algo.unet.down_dims = list(DOWN)
        cfg.algo.unet.diffusion_step_embed_dim = DSED
        cfg.algo.unet.n_groups = GROUPS
        cfg.algo.ddpm.enabled = not ddim
        cfg.algo.ddpm.num_inference_timesteps = 2
        cfg.algo.ddim.enabled = ddim
        cfg.algo.ddim.num_inference_timesteps = 2
        lr = cfg.algo.optim_params.policy.learning_rate
        lr.initial, lr.scheduler_type = LR, None
        cfg.algo.optim_params.policy.regularization.L2 = 1e-2
        cfg.train.max_grad_norm = 1.0
        cfg.train.seq_length = TP
    return cfg


def _make(side, ddim):
    jax_side = side == "jax"
    cfg = _tune((jax_config_factory if jax_side else config_factory)("diffusion_policy"), ddim)
    (JaxObsUtils if jax_side else PortObsUtils).initialize_obs_utils_with_config(cfg)
    if jax_side:
        algo = JaxAlgo.algo_factory("diffusion_policy", cfg, {"flat": (O,)}, A)
        algo._init_variables = random_init(algo._init_variables)
        return algo
    return PortAlgo.algo_factory("diffusion_policy", cfg, {"flat": (O,)}, A, device="cpu")


def _f32(a):
    """float32 values held as float64: both sides read the batch in float32
    (JAX's observations, the port's observations and actions)."""
    return a.astype(np.float32).astype(np.float64)


def _batch(rng):
    return {"obs": {"flat": _f32(rng.randn(B, TP, O))},
            "actions": _f32(rng.uniform(-0.9, 0.9, (B, TP, A)))}


def _step_draws(jax_algo):
    """(t, noise): the draws of JAX's next training step, from its key."""
    _, r_t, r_n, _, _ = jax.random.split(jax_algo.state.rng, 5)
    t = jax.random.randint(r_t, (B,), 0, jax_algo.schedule.num_train_timesteps)
    return np.asarray(t), np.asarray(jax.random.normal(r_n, (B, TP, A)))


def _sample_draws(jax_algo):
    """(initial noise, the DDPM steps' noises): the draws of JAX's next
    get_action, from its key."""
    key = jax.random.split(jax_algo._init_rng)[1]
    shape = (B, TP, A)
    rng, noises = key, []
    for _ in jax_algo.schedule.inference_timesteps(jax_algo.num_inference_steps,
                                                   jax_algo.use_ddim):
        rng, sub = jax.random.split(rng)
        noises.append(np.asarray(jax.random.normal(sub, shape)))
    return np.asarray(jax.random.normal(key, shape)), np.stack(noises)


def _to_ddim(algo, schedule_cls):
    """Serve @algo (either package's) with ``algo.ddim``'s sampler."""
    cfg = algo.algo_config.ddim
    algo.schedule = schedule_cls(cfg.num_train_timesteps, clip_sample=cfg.clip_sample,
                                 set_alpha_to_one=cfg.set_alpha_to_one,
                                 steps_offset=cfg.steps_offset)
    algo.use_ddim, algo.num_inference_steps = True, cfg.num_inference_timesteps


def test_ddim_config_builds_the_jax_sampler():
    jax_algo, algo = _make("jax", True), _make("port", True)
    assert algo.use_ddim and jax_algo.use_ddim
    assert algo.num_inference_steps == jax_algo.num_inference_steps == 2
    for name in ("num_train_timesteps", "clip_sample", "set_alpha_to_one", "steps_offset"):
        assert getattr(algo.schedule, name) == getattr(jax_algo.schedule, name), name


@pytest.fixture(scope="module")
def run():
    """3 steps under the DDPM config, then one request served by DDPM and
    one by DDIM (``_to_ddim``; the DDIM config's sampler is held by
    ``test_ddim_config_builds_the_jax_sampler``)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PortDiff.SinusoidalPosEmb, "forward", jax_embedding_forward)
        return _run()


def _run():
    rng = np.random.RandomState(0)
    batches = [_batch(rng) for _ in range(STEPS)]
    ddim = False
    jax_algo = _make("jax", ddim)
    jax_algo.ensure_state(jax_algo.process_batch_for_training(batches[0]))
    nested, flat = perturbed_variables({"params": jax_algo.state.params["policy"]}, 3)
    with jax.enable_x64():
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                        nested["params"])
        state = jax_algo.state
        new = {**state.params, "policy": params, "policy_ema": params}
        jax_algo.state = state.replace(params=new, opt_states={
            n: jax_algo.optimizers[n].init(new[n]) for n in ("policy", "obs_encoder")})
    algo = _make("port", ddim)
    assert type(algo).__name__ == "DiffusionPolicyUNet" and not algo.use_ddim
    assert PortAlgo.rollout_policy_class(algo) is PortAlgo.RolloutPolicy
    algo.nets.double()
    for name in ("policy", "policy_ema"):
        load_jax_variables(algo.nets[name], flat)
    metrics = []
    for batch in batches:
        with jax.enable_x64():
            draws = _step_draws(jax_algo)
            want = jax_algo.train_on_batch(jax_algo.process_batch_for_training(batch),
                                           epoch=0)["losses"]
        algo._noise_hook = lambda: draws
        got = algo.train_on_batch(algo.process_batch_for_training(batch), epoch=0)["losses"]
        metrics.append(({k: float(v) for k, v in want.items()},
                        {k: float(v) for k, v in got.items()}))
    trained = {name: copy.deepcopy(algo.nets[name]) for name in NET_NAMES}
    expected = {}
    for name in NET_NAMES:
        expected[name] = copy.deepcopy(algo.nets[name])
        load_jax_variables(expected[name], flatten_variables(
            {"params": jax_algo.state.params[name]}))
    # served from JAX's trained weights: a denoising step divides the
    # predicted noise's error by sqrt(alphas_bar), so the steps' drift
    # (above) would not show the sampler's own agreement
    for name in NET_NAMES:
        algo.nets[name].load_state_dict(expected[name].state_dict())
    obs = {"flat": _f32(np.random.RandomState(1).randn(B, 3, O))}   # more frames than To
    actions = {}
    for sampler in ("ddpm", "ddim"):
        if sampler == "ddim":
            _to_ddim(jax_algo, JaxDiff.DiffusionSchedule)
            _to_ddim(algo, PortDiff.DiffusionSchedule)
            jax_algo._jit_cache.clear()
        with jax.enable_x64():
            sample = _sample_draws(jax_algo)
            want_action = np.asarray(jax_algo.get_action(obs))
        algo._sample_hook = lambda: sample
        actions[sampler] = (want_action, algo.get_action(obs).numpy())
    return dict(metrics=metrics, trained=trained, expected=expected, actions=actions)


def test_step_loss_matches_jax(run):
    for want, got in run["metrics"]:
        assert set(got) == set(want) == {"l2_loss"}
        np.testing.assert_allclose(got["l2_loss"], want["l2_loss"], rtol=1e-8, atol=1e-12)


def test_parameters_and_ema_after_three_steps_match_jax(run):
    """In bulk: at least 99 % of each tensor within 1e-8 of its largest
    element, every element within 1e-6 (measured: 99.88 % and 2.7e-7). Flax
    GroupNorm's one-pass variance, E[x^2] - E[x]^2, puts the first loss
    1e-9 relative from the port's even in float64, and Adam's first steps
    move a weight whose gradient is near its epsilon (1e-8) by lr g / (|g|
    + eps), which such a difference in g shifts: 4 weights of 5,120 in the
    worst tensor after one step, 72 after three."""
    trained = run["trained"]
    assert set(trained) == set(NET_NAMES)
    assert not any(p.requires_grad for p in trained["policy_ema"].parameters())
    for name in NET_NAMES:
        want = run["expected"][name].state_dict()
        got = trained[name].state_dict()
        assert set(got) == set(want)
        for k, w in want.items():
            rel = (got[k] - w).abs() / float(w.abs().max())
            assert float(rel.max()) <= 1e-6, f"{name}.{k}: {float(rel.max())}"
            assert float((rel <= 1e-8).double().mean()) >= 0.99, f"{name}.{k}"
    # the shadow is not the live UNet after 3 steps (decays 0.1, 2/11, 3/12)
    live = trained["policy"].state_dict()
    assert any(not torch.equal(v, live[k])
               for k, v in trained["policy_ema"].state_dict().items())


@pytest.mark.parametrize("sampler", ["ddpm", "ddim"])
def test_get_action_matches_jax(run, sampler):
    """Within 1e-6 (measured under DDPM 1.2e-7, DDIM below 1e-10): from the
    same weights the UNets' noise predictions differ by Flax GroupNorm's
    one-pass variance (about 1e-10), and the predicted x0 divides that by
    sqrt(alphas_bar), 4.9e-4 at the chain's start."""
    want, got = run["actions"][sampler]
    assert got.shape == (B, A)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_validation_leaves_the_ema_decay_alone():
    """The EMA decay counts training steps, as the reference's ``EMAModel``
    does: train, validate, train leaves the shadows of train, train. (The
    JAX step advances its ``state.step``, which the decay reads, on a
    validation call too; ROADMAP Queue 3.)"""
    rng = np.random.RandomState(5)
    draws = (rng.randint(0, 100, B), rng.randn(B, TP, A))
    algos = [_make("port", True), _make("port", True)]
    algos[1].nets.load_state_dict(algos[0].nets.state_dict())
    batch = _batch(rng)
    for validate_between, algo in enumerate(algos):
        algo._noise_hook = lambda: draws
        processed = algo.process_batch_for_training(batch)
        algo.train_on_batch(processed, epoch=0)
        if validate_between:
            algo.train_on_batch(processed, epoch=0, validate=True)
        algo.train_on_batch(processed, epoch=0)
    assert algos[0].global_step == algos[1].global_step == 2
    for name in ("policy", "policy_ema"):
        for k, v in algos[0].nets[name].state_dict().items():
            assert torch.equal(v, algos[1].nets[name].state_dict()[k]), f"{name}.{k}"


def test_action_range_check_raises_once():
    algo = _make("port", False)
    batch = _batch(np.random.RandomState(4))
    batch["actions"][0, 0, 0] = 1.5
    with pytest.raises(ValueError, match="range"):
        algo.process_batch_for_training(batch)
    batch["actions"][0, 0, 0] = 0.5
    algo.process_batch_for_training(batch)
    batch["actions"][0, 0, 0] = 1.5   # checked on the first batch only, as JAX
    assert algo.process_batch_for_training(batch)["actions"].shape == (B, TP, A)


def test_observation_window_must_hold_to_frames():
    """A rollout without ``frame_stack`` >= To hands ``get_action`` [B, ...]
    observations: JAX's ``[:, -To:]`` then cuts the feature axis and Flax
    fails on a parameter's shape; the port refuses them by name (ROADMAP
    Queue 3)."""
    import flax

    jax_algo = _make("jax", True)
    jax_algo.ensure_state(jax_algo.process_batch_for_training(_batch(np.random.RandomState(3))))
    with pytest.raises(flax.errors.ScopeParamShapeError):
        jax_algo.get_action({"flat": np.zeros((B, O))})
    algo = _make("port", True)
    with pytest.raises(ValueError, match="observation_horizon"):
        algo.get_action({"flat": np.zeros((B, O))})
    with pytest.raises(ValueError, match="observation_horizon"):
        algo.get_action({"flat": np.zeros((B, TO - 1, O))})


@pytest.mark.parametrize("option", ["mixed_precision", "prediction_type"])
def test_unported_options_raise(option):
    """An unported prediction type raises; ``train.mixed_precision`` is
    ported: it builds and takes a bf16 step on fp32 masters."""
    cfg = _tune(config_factory("diffusion_policy"))
    with cfg.values_unlocked():
        if option == "mixed_precision":
            cfg.train.mixed_precision = True
        else:
            cfg.algo.ddpm.prediction_type = "sample"
    PortObsUtils.initialize_obs_utils_with_config(cfg)
    if option == "prediction_type":
        with pytest.raises(NotImplementedError, match=option):
            PortAlgo.algo_factory("diffusion_policy", cfg, {"flat": (O,)}, A, device="cpu")
        return
    algo = PortAlgo.algo_factory("diffusion_policy", cfg, {"flat": (O,)}, A, device="cpu")
    assert algo.mixed_precision
    losses = algo.train_on_batch(algo.process_batch_for_training(
        _batch(np.random.RandomState(1))), epoch=0)["losses"]
    assert np.isfinite(float(losses["l2_loss"]))
    assert all(p.dtype == torch.float32 for p in algo.nets.parameters())


def test_checkpoint_serves_through_the_plain_rollout_policy(tmp_path, monkeypatch):
    """One epoch through ``scripts/train.train`` (windows of Tp actions and
    To stacked frames, actions min-max normalized into [-1, 1]); the
    checkpoint's ``RolloutPolicy`` serves the trained algo's actions (EMA
    shadow included) on stacked observations."""
    cfg = _tune(config_factory("diffusion_policy"), ddim=True)
    with cfg.values_unlocked():
        cfg.train.frame_stack = TO
    trained, policy, ckpt = train_and_reload(tmp_path, monkeypatch, cfg, "dp_ckpt",
                                             demo_lengths=(14, 12, 13))
    assert type(policy) is PortAlgo.RolloutPolicy
    assert type(policy.policy).__name__ == "DiffusionPolicyUNet"
    assert json.loads(ckpt["config"])["algo"]["ema"]["enabled"]
    twin = PortAlgo.RolloutPolicy(
        trained, obs_normalization_stats=ckpt.get("obs_normalization_stats"),
        action_normalization_stats=ckpt.get("action_normalization_stats"))
    rng = np.random.RandomState(4)
    for p in (policy, twin):
        p.start_episode()
        p.policy.generator.manual_seed(11)
    for _ in range(3):
        ob = {"eef_pos": rng.randn(TO, 3).astype(np.float32)}
        got, want = policy(ob), twin(ob)
        assert got.shape == (A,) and np.isfinite(got).all()
        np.testing.assert_array_equal(got, want)
