"""``act``, the port's against the JAX package's: ``CrossAttentionBlock``,
``DETRVAE`` and ``ACT``.

* The modules in float64 from JAX's weights through ``load_jax_variables``
  (hidden 32, 2 heads, feed-forward 64, one style and one decoder layer,
  latent 8, chunk 4): the decoder block within 1e-10; the DETR-VAE's
  training forward (JAX's latent draw pinned and replayed) and its z = 0
  inference within 1e-6 (the style encoder's GPT attention keeps float32
  products in JAX: measured 1.8e-7 on mu).
* The algo at those widths (a 5-d observation, A 3, B 8): 3
  ``train_on_batch`` steps on both sides in float64 with AdamW, L2 1e-4,
  the ``linear`` schedule decaying, gradient clipping and a ``pad_mask``
  that masks a quarter of the chunk's steps: losses within 1e-6 relative,
  every parameter within 1e-6 of its tensor's largest (the style encoder
  again; measured 3.4e-8 and 1.3e-7); then ``get_action`` pops the chunk's
  actions one a call (each within 1e-6 of JAX's; measured 4.7e-8),
  predicts a new chunk when the queue is empty, and ``reset`` empties it.
* ``train.mixed_precision`` raises; a checkpoint from
  ``scripts/train.train`` serves through ``policy_from_checkpoint`` as a
  ``RolloutPolicy`` whose ``start_episode`` empties the queue, its actions
  equal to the trained algo's.
"""

import copy
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import robot_manipulation_vq_vae_tpu.algo as JaxAlgo
from robot_manipulation_vq_vae_tpu.algo import act as JaxAct
from robot_manipulation_vq_vae_tpu.config import config_factory as jax_config_factory
from robot_manipulation_vq_vae_tpu.utils import obs_utils as JaxObsUtils
from robot_manipulation_vq_vae_tpu.utils.ckpt_conversion import flatten_variables

import robot_manipulation_vq_vae_tpu_torch.algo as PortAlgo
from robot_manipulation_vq_vae_tpu_torch.algo import act as PortAct
from robot_manipulation_vq_vae_tpu_torch.config import config_factory
from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils as PortObsUtils
from robot_manipulation_vq_vae_tpu_torch.utils.jax_weights import load_jax_variables
from test_torch_bc import train_and_reload
from torch_port_helpers import PinnedJaxRandom, perturbed_variables, random_init
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

B, O, A, T = 8, 5, 3, 4
HIDDEN, HEADS, FF, LATENT = 32, 2, 64, 8
LR, STEPS = 1e-3, 3
DETR = dict(ac_dim=A, num_queries=T, hidden_dim=HIDDEN, dim_feedforward=FF, enc_layers=1,
            dec_layers=1, nheads=HEADS, latent_dim=LATENT)


def _f32(a):
    """float32 values held as float64 (both sides read the batch so)."""
    return a.astype(np.float32).astype(np.float64)


def _flax(module, *inputs, method=None, rngs=None, seed=0):
    """(flat variables for the port, JAX's output) of @module in float64,
    every leaf made random."""
    with jax.enable_x64():
        inputs = jax.tree_util.tree_map(jnp.asarray, list(inputs))

        def init(rng, args):
            return module.init({"params": rng, "latent": rng}, *args, method=method)

        nested, flat = perturbed_variables(random_init(init)(jax.random.PRNGKey(seed), inputs),
                                           seed + 1)
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), nested)
        out = jax.jit(lambda p, args: module.apply(p, *args, method=method, rngs=rngs))(
            params, inputs)
        return flat, params, jax.tree_util.tree_map(np.asarray, out)


def test_cross_attention_block_matches_jax():
    rng = np.random.RandomState(0)
    q, memory = rng.randn(B, T, HIDDEN), rng.randn(B, 2, HIDDEN)
    flat, _, want = _flax(JaxAct.CrossAttentionBlock(HIDDEN, HEADS, FF), q, memory)
    port = PortAct.CrossAttentionBlock(HIDDEN, HEADS, FF).double()
    load_jax_variables(port, flat)
    got = port(torch.tensor(q), torch.tensor(memory))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-10)


def test_detr_vae_matches_jax(monkeypatch):
    _init_obs_utils()
    rng = np.random.RandomState(1)
    obs, actions = rng.randn(B, O), rng.randn(B, T, A)
    pinned = PinnedJaxRandom(2)
    monkeypatch.setattr(JaxAct, "jax", pinned)
    jm = JaxAct.DETRVAE(obs_shapes=(("flat", (O,)),), **DETR)
    flat, params, want = _flax(jm, {"flat": obs}, actions, method=jm.forward_train,
                               rngs={"latent": jax.random.PRNGKey(5)})
    eps = [v for n, v in pinned.log if n == "normal"][-1]   # the apply's (the init drew first)
    with jax.enable_x64():
        want_inf = np.asarray(jax.jit(lambda p: jm.apply(p, {"flat": jnp.asarray(obs)}))(params))
    port = PortAct.DETRVAE(obs_shapes={"flat": (O,)}, **DETR).double()
    load_jax_variables(port, flat)
    got = port.forward_train({"flat": torch.tensor(obs)}, torch.tensor(actions),
                             eps=torch.tensor(eps))
    for k in ("a_hat", "mu", "logvar"):
        np.testing.assert_allclose(got[k].detach().numpy(), want[k], rtol=0, atol=1e-6,
                                   err_msg=k)
    with torch.no_grad():
        got_inf = port({"flat": torch.tensor(obs)})
    assert got_inf.shape == (B, T, A)
    np.testing.assert_allclose(got_inf.numpy(), want_inf, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the algo
# ---------------------------------------------------------------------------

def _tune(cfg):
    with cfg.values_unlocked():
        cfg.observation.modalities.obs.low_dim = ["flat"]
        cfg.observation.modalities.obs.rgb = []
        act = cfg.algo.act
        act.hidden_dim, act.dim_feedforward, act.nheads = HIDDEN, FF, HEADS
        act.enc_layers, act.dec_layers, act.latent_dim = 1, 1, LATENT
        lr = cfg.algo.optim_params.policy.learning_rate
        lr.initial, lr.decay_factor = LR, 0.5   # linear: 1 -> 0.5 over 10,000 steps
        cfg.train.max_grad_norm = 1.0
        cfg.train.seq_length = T
    return cfg


def _init_obs_utils():
    JaxObsUtils.initialize_obs_utils_with_config(_tune(jax_config_factory("act")))
    PortObsUtils.initialize_obs_utils_with_config(_tune(config_factory("act")))


def _batch(rng):
    pad = np.ones((B, T, 1))
    pad[: B // 2, T - 2:] = 0.0   # the last 2 steps of half the chunks are padding
    return {"obs": {"flat": _f32(rng.randn(B, T, O)), "pad_mask": pad},
            "actions": _f32(rng.uniform(-0.9, 0.9, (B, T, A)))}


@pytest.fixture(scope="module")
def run():
    with pytest.MonkeyPatch.context() as mp:
        pinned = PinnedJaxRandom(3)
        mp.setattr(JaxAct, "jax", pinned)
        return _run(pinned)


def _run(pinned):
    rng = np.random.RandomState(0)
    batches = [_batch(rng) for _ in range(STEPS)]
    cfg = _tune(jax_config_factory("act"))
    JaxObsUtils.initialize_obs_utils_with_config(cfg)
    jax_algo = JaxAlgo.algo_factory("act", cfg, {"flat": (O,)}, A)
    jax_algo._init_variables = random_init(jax_algo._init_variables)
    jax_algo.ensure_state(jax_algo.process_batch_for_training(batches[0]))
    pinned.log.clear()   # the init's trace drew too
    nested, flat = perturbed_variables({"params": jax_algo.state.params["policy"]}, 4)
    with jax.enable_x64():
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                        nested["params"])
        jax_algo.state = jax_algo.state.replace(
            params={"policy": params},
            opt_states={"policy": jax_algo.optimizers["policy"].init(params)})
    cfg = _tune(config_factory("act"))
    PortObsUtils.initialize_obs_utils_with_config(cfg)
    algo = PortAlgo.algo_factory("act", cfg, {"flat": (O,)}, A, device="cpu")
    assert type(algo).__name__ == "ACT" and not algo.TAKES_CONTEXT
    assert PortAlgo.rollout_policy_class(algo) is PortAlgo.RolloutPolicy
    algo.nets.double()
    load_jax_variables(algo.nets["policy"], flat)
    # the latent draw of JAX's step: a constant of its trace
    algo._noise_hook = lambda: np.array([v for n, v in pinned.log if n == "normal"][0])
    metrics, processed = [], []
    for batch in batches:
        with jax.enable_x64():
            want = jax_algo.train_on_batch(jax_algo.process_batch_for_training(batch),
                                           epoch=0)["losses"]
        ours = algo.process_batch_for_training(batch)
        processed.append(ours)
        got = algo.train_on_batch(ours, epoch=0)["losses"]
        metrics.append(({k: float(v) for k, v in want.items()},
                        {k: float(v) for k, v in got.items()}))
    expected = copy.deepcopy(algo.nets["policy"])
    load_jax_variables(expected, flatten_variables(
        {"params": jax_algo.state.params["policy"]}))
    obs_rng = np.random.RandomState(1)
    requests = [{"flat": _f32(obs_rng.randn(B, O))} for _ in range(T + 1)]
    served = []
    for obs in requests:
        with jax.enable_x64():
            want = np.asarray(jax_algo.get_action(obs))
        served.append((want, algo.get_action(obs).numpy(), len(algo._ac_queue)))
    algo.reset()
    queue_after_reset = len(algo._ac_queue)
    return dict(metrics=metrics, processed=processed, got=algo.nets["policy"].state_dict(),
                want=expected.state_dict(), served=served, log=algo.log_info(
                    {"losses": metrics[-1][1]}), queue_after_reset=queue_after_reset)


def test_batch_keeps_the_pad_mask_window(run):
    batch = run["processed"][0]
    assert batch["obs"]["flat"].shape == (B, O)
    assert tuple(batch["obs"]["pad_mask"].shape) == (B, T, 1)
    assert float(batch["obs"]["pad_mask"].mean()) == 0.75


def test_step_metrics_match_jax(run):
    for want, got in run["metrics"]:
        assert set(got) == set(want) == {"l1_loss", "kl_loss", "action_loss",
                                         "policy_grad_norms"}
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-12, err_msg=k)
    assert set(run["log"]) == {"Loss", "L1_Loss", "Reconstruction_Loss", "KL_Loss"}


def test_parameters_after_three_steps_match_jax(run):
    assert set(run["got"]) == set(run["want"])
    for k, want in run["want"].items():
        err = float((run["got"][k] - want).abs().max())
        assert err <= 1e-6 * float(want.abs().max()), f"{k}: {err}"


def test_get_action_pops_the_chunk_and_matches_jax(run):
    """T + 1 requests: the first predicts a chunk of T, the next T - 1 pop
    it, the last finds the queue empty and predicts again."""
    assert [q for _, _, q in run["served"]] == [T - 1, T - 2, T - 3, 0, T - 1]
    for want, got, _ in run["served"]:
        assert got.shape == (B, A)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert run["queue_after_reset"] == 0


def test_mixed_precision_raises():
    cfg = _tune(config_factory("act"))
    with cfg.values_unlocked():
        cfg.train.mixed_precision = True
    PortObsUtils.initialize_obs_utils_with_config(cfg)
    with pytest.raises(NotImplementedError, match="mixed_precision"):
        PortAlgo.algo_factory("act", cfg, {"flat": (O,)}, A, device="cpu")


def test_checkpoint_serves_and_start_episode_empties_the_queue(tmp_path, monkeypatch):
    cfg = _tune(config_factory("act"))
    trained, policy, ckpt = train_and_reload(tmp_path, monkeypatch, cfg, "act_ckpt")
    assert type(policy) is PortAlgo.RolloutPolicy
    assert type(policy.policy).__name__ == "ACT"
    assert json.loads(ckpt["config"])["algo"]["act"]["hidden_dim"] == HIDDEN
    twin = PortAlgo.RolloutPolicy(
        trained, obs_normalization_stats=ckpt.get("obs_normalization_stats"),
        action_normalization_stats=ckpt.get("action_normalization_stats"))
    rng = np.random.RandomState(4)
    for episode in range(2):
        for p in (policy, twin):
            p.start_episode()
            assert p.policy._ac_queue == []
        for _ in range(T - 2 if episode == 0 else T + 1):
            ob = {"eef_pos": rng.randn(3).astype(np.float32)}
            got, want = policy(ob), twin(ob)
            assert got.shape == (A,) and np.isfinite(got).all()
            np.testing.assert_array_equal(got, want)
        assert len(policy.policy._ac_queue) == (2 if episode == 0 else T - 1)
