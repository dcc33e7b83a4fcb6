"""The ``bc`` family, the port's against the JAX package's: ``BC``,
``BC_Gaussian``, ``BC_GMM``, ``BC_RNN``, ``BC_RNN_GMM``, ``BC_VAE`` (with
``models/vae_nets.py``), ``ICLVAE``, ``BC_Transformer`` and
``BC_Transformer_GMM`` (with ``TransformerGMMActorNetwork``).

* The factory: every combination of the gaussian / gmm / vae / rnn /
  transformer switches routes to the class of the JAX package's name, or
  raises where it raises.
* ``VAEActor`` under each prior (N(0, I), a learned Gaussian, a learned GMM
  with learned weights, the categorical prior soft and hard) at small
  widths in float64: the training forward's outputs and the parameters'
  gradients, and a prior sample's action, with JAX's draws pinned
  (``PinnedJaxRandom``) and replayed into the port. Within 1e-10.
* Each algo at ``tests/test_icl_variants_parity.py``'s sizes (B 16, a 5-d
  observation, A 3, T 4, MLP (8, 8), a 2-layer LSTM of 10; the transformer
  2 layers of 16, 2 heads, no dropout): JAX's weights carried across (every
  leaf made random), 3 ``train_on_batch`` steps on both sides in float64 at
  lr 1e-3 with L2 and gradient clipping, then ``get_action`` with JAX's
  draws injected (the VAE's eps through both ``_noise_hook``s and its prior
  sample and Gumbel uniforms pinned; the GMMs' mode and normal draws from
  the JAX key). Losses within 1e-8 relative, every parameter within 1e-8 of
  its tensor's largest, actions within 1e-10; the transformer policies all
  three within 1e-6 (the JAX attention keeps float32 products: the actions
  measured 1.9e-7 apart).
* A ``BC_VAE`` checkpoint written by ``scripts/train.train`` serves through
  ``policy_from_checkpoint`` as a ``RolloutPolicy``, its episode's actions
  equal to the trained algo's; ``train.mixed_precision`` trains
  ``BC_Transformer`` (held against JAX in tests/test_torch_bf16_baselines.py)
  and raises for ``BC_VAE``, whose JAX step ignores it.
"""

import contextlib
import copy
import glob
import itertools
import json

import h5py
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import robot_manipulation_vq_vae_tpu.algo as JaxAlgo
from robot_manipulation_vq_vae_tpu.algo import bc as JaxBC
from robot_manipulation_vq_vae_tpu.algo import icl as JaxIcl
from robot_manipulation_vq_vae_tpu.config import config_factory as jax_config_factory
from robot_manipulation_vq_vae_tpu.models import vae_nets as JaxVAENets
from robot_manipulation_vq_vae_tpu.utils import obs_utils as JaxObsUtils
from robot_manipulation_vq_vae_tpu.utils.ckpt_conversion import flatten_variables

import robot_manipulation_vq_vae_tpu_torch.algo as PortAlgo
from robot_manipulation_vq_vae_tpu_torch.algo import bc as PortBC
from robot_manipulation_vq_vae_tpu_torch.config import config_factory
from robot_manipulation_vq_vae_tpu_torch.models import vae_nets as PortVAENets
from robot_manipulation_vq_vae_tpu_torch.scripts import train as PortTrain
from robot_manipulation_vq_vae_tpu_torch.utils import file_utils as FileUtils
from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils as PortObsUtils
from robot_manipulation_vq_vae_tpu_torch.utils.jax_weights import load_jax_variables
from torch_port_helpers import (
    PinnedJaxRandom,
    perturbed_variables,
    random_init,
    write_demo_file,
)
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

B, O, A, T = 16, 5, 3, 4
LAYERS = (8, 8)
H_RNN, N_LSTM = 10, 2
LR, STEPS = 1e-3, 3
LATENT, CATS = 4, 3
SWITCHES = ("gaussian", "gmm", "vae", "rnn", "transformer")
PRIORS = {
    "normal": {},
    "learned": {"learn": True, "is_conditioned": True},
    "gmm": {"learn": True, "use_gmm": True, "gmm_num_modes": 3, "gmm_learn_weights": True},
    "categorical": {"use_categorical": True, "categorical_dim": CATS},
    "categorical_hard": {"use_categorical": True, "categorical_dim": CATS,
                         "categorical_gumbel_softmax_hard": True},
}
# mode -> (factory, class name)
MODES = {"plain": ("bc", "BC"), "gaussian": ("bc", "BC_Gaussian"), "gmm": ("bc", "BC_GMM"),
         "rnn": ("bc", "BC_RNN"), "rnn_gmm": ("bc", "BC_RNN_GMM"),
         "vae": ("bc", "BC_VAE"), "vae_categorical": ("bc", "BC_VAE"),
         "iclvae": ("icl", "ICLVAE"), "transformer": ("bc", "BC_Transformer"),
         "transformer_gmm": ("bc", "BC_Transformer_GMM")}


def _routed(factory, cfg):
    try:
        return factory(cfg.algo)[0].__name__
    except NotImplementedError:
        return "raises"


@pytest.mark.parametrize("on", list(itertools.product([False, True], repeat=5)),
                         ids=lambda on: "-".join(s for s, v in zip(SWITCHES, on) if v) or "none")
def test_factory_routes_as_jax(on):
    classes = []
    for make, factory in ((jax_config_factory, JaxBC.algo_config_to_class),
                          (config_factory, PortBC.algo_config_to_class)):
        cfg = make("bc")
        with cfg.values_unlocked():
            for switch, value in zip(SWITCHES, on):
                cfg.algo[switch].enabled = value
        classes.append(_routed(factory, cfg))
    assert classes[1] == classes[0]


# ---------------------------------------------------------------------------
# VAEActor under each prior
# ---------------------------------------------------------------------------

def _vae_kwargs(prior):
    return dict(ac_dim=A, encoder_layer_dims=(8,), decoder_layer_dims=(8,),
                latent_dim=LATENT, latent_clip=2.0 if prior == "learned" else None,
                prior_layer_dims=(8,), **{f"prior_{k}": v for k, v in PRIORS[prior].items()})


@pytest.mark.parametrize("prior", sorted(PRIORS))
def test_vae_actor_matches_jax(prior, monkeypatch):
    """The training forward (reconstruction, KL, z, losses) and its
    gradients, then a prior sample's action; every draw pinned on the JAX
    side and replayed into the port."""
    JaxObsUtils.initialize_obs_utils_with_config(_tune(jax_config_factory("bc"), "vae"))
    PortObsUtils.initialize_obs_utils_with_config(_tune(config_factory("bc"), "vae"))
    rng = np.random.RandomState(3)
    obs = rng.randn(B, O)
    actions = rng.uniform(-0.9, 0.9, (B, A))
    pinned = PinnedJaxRandom(5)
    monkeypatch.setattr(JaxVAENets, "jax", pinned)
    with jax.enable_x64():
        jm = JaxVAENets.VAEActor(obs_shapes=(("flat", (O,)),), **_vae_kwargs(prior))
        variables = jax.jit(lambda a, o: jm.init(
            {"params": jax.random.PRNGKey(0), "latent": jax.random.PRNGKey(1)}, a, o,
            method=jm.forward_train))(jnp.asarray(actions), {"flat": jnp.asarray(obs)})
        nested, flat = perturbed_variables(variables, 2)
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), nested["params"])
        eps = rng.randn(B, LATENT)
        pinned.log.clear()

        def loss(p):
            out = jm.apply({"params": p}, jnp.asarray(actions), {"flat": jnp.asarray(obs)},
                           temperature=0.7, eps=jnp.asarray(eps), method=jm.forward_train,
                           rngs={"latent": jax.random.PRNGKey(2)})
            return out["reconstruction_loss"] + out["kl_loss"], out

        # jitted: the same computation (the pinned draws are constants of
        # the trace); eagerly each op compiles alone
        (_, want), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
        uniforms = [v for n, v in pinned.log if n == "uniform"]
        pinned.log.clear()
        want_action = np.asarray(jax.jit(lambda p: jm.apply(
            {"params": p}, {"flat": jnp.asarray(obs)},
            rngs={"latent": jax.random.PRNGKey(3)}))(params))
        draws = [v for _, v in pinned.log]

    port = PortVAENets.VAEActor(obs_shapes={"flat": (O,)}, **_vae_kwargs(prior)).double()
    load_jax_variables(port, flat)
    train_eps = torch.tensor(uniforms[0] if uniforms else eps)
    got = port.forward_train(torch.tensor(actions), {"flat": torch.tensor(obs)},
                             temperature=0.7, eps=train_eps)
    (got["reconstruction_loss"] + got["kl_loss"]).backward()
    for key in ("decoder_outputs", "kl_loss", "reconstruction_loss", "encoder_z"):
        np.testing.assert_allclose(got[key].detach().numpy(), np.asarray(want[key]),
                                   rtol=1e-10, atol=1e-12, err_msg=key)
    want_grads = copy.deepcopy(port)
    load_jax_variables(want_grads, flatten_variables({"params": grads}))
    expected = dict(want_grads.named_parameters())
    for n, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), expected[n].detach().numpy(),
                                   rtol=0, atol=1e-10, err_msg=n)
    prior_draws = tuple(torch.tensor(d) for d in draws)
    with torch.no_grad():
        got_action = port({"flat": torch.tensor(obs)},
                          prior_draws=prior_draws if len(prior_draws) > 1 else prior_draws[0])
    np.testing.assert_allclose(got_action.numpy(), want_action, rtol=0, atol=1e-10)


# ---------------------------------------------------------------------------
# 3 steps + get_action of each algo
# ---------------------------------------------------------------------------

def _tune(cfg, mode):
    """``test_icl_variants_parity.py``'s settings, with L2 and a clip limit
    below the gradient norms; the VAE at small widths."""
    with cfg.values_unlocked():
        cfg.observation.modalities.obs.low_dim = ["flat"]
        cfg.observation.modalities.obs.rgb = []
        tx = cfg.algo.transformer
        tx.enabled = mode.startswith("transformer")
        tx.ln_act_enabled = False
        tx.context_length, tx.embed_dim, tx.num_layers, tx.num_heads = T, 16, 2, 2
        tx.emb_dropout = tx.attn_dropout = tx.block_output_dropout = 0.0
        cfg.algo.gaussian.enabled = mode == "gaussian"
        cfg.algo.gmm.enabled = mode in ("gmm", "rnn_gmm", "transformer_gmm")
        cfg.algo.gmm.num_modes = 3
        cfg.algo.vae.enabled = "vae" in mode
        cfg.algo.vae.latent_dim = LATENT
        cfg.algo.vae.encoder_layer_dims = cfg.algo.vae.decoder_layer_dims = [8]
        cfg.algo.vae.prior_layer_dims = [8]
        cfg.algo.vae.kl_weight = 0.5
        if mode == "vae_categorical":
            for k, v in PRIORS["categorical_hard"].items():
                cfg.algo.vae.prior[k] = v
        cfg.algo.rnn.enabled = mode in ("rnn", "rnn_gmm")
        cfg.algo.rnn.horizon = T
        cfg.algo.rnn.hidden_dim = H_RNN
        cfg.algo.rnn.num_layers = N_LSTM
        cfg.algo.actor_layer_dims = [] if mode.startswith("rnn") else list(LAYERS)
        cfg.algo.loss.l1_weight = 0.5
        cfg.algo.loss.cos_weight = 0.25
        lr = cfg.algo.optim_params.policy.learning_rate
        lr.initial, lr.scheduler_type = LR, None
        cfg.algo.optim_params.policy.regularization.L2 = 1e-2
        cfg.train.max_grad_norm = 0.5
        cfg.train.seq_length = T
    return cfg


def _batch(rng):
    """float32 values held as float64 (see ``test_torch_icl_variants.py``)."""
    return {"obs": {"flat": rng.randn(B, T, O).astype(np.float32).astype(np.float64)},
            "actions": rng.uniform(-0.9, 0.9, (B, T, A)).astype(np.float32).astype(
                np.float64)}


def _make(mode, side):
    """The JAX (@side "jax") or port algo of @mode."""
    factory, name = MODES[mode]
    jax_side = side == "jax"
    cfg = _tune((jax_config_factory if jax_side else config_factory)(factory), mode)
    (JaxObsUtils if jax_side else PortObsUtils).initialize_obs_utils_with_config(cfg)
    shapes = {"flat": (O,)}
    if mode == "iclvae":   # the factory never routes here
        cls = JaxIcl.ICLVAE if jax_side else PortAlgo.ICLVAE
        kwargs = {} if jax_side else {"device": "cpu"}
        algo = cls(algo_config=cfg.algo, obs_config=cfg.observation, global_config=cfg,
                   obs_key_shapes=shapes, ac_dim=A, **kwargs)
    elif jax_side:
        algo = JaxAlgo.algo_factory(factory, cfg, shapes, A)
    else:
        algo = PortAlgo.algo_factory(factory, cfg, shapes, A, device="cpu")
    assert type(algo).__name__ == name
    if jax_side:
        algo._init_variables = random_init(algo._init_variables)
    return algo


def _jax_sample_draws(key, logits):
    """(mode, eps) that JAX's ``GMMActionDistribution.sample(key)`` draws."""
    rng_mode, rng_eps = jax.random.split(key)
    mode = jax.random.categorical(rng_mode, jnp.asarray(logits), axis=-1)
    eps = jax.random.normal(rng_eps, tuple(mode.shape) + (A,))
    return torch.from_numpy(np.array(mode)), torch.from_numpy(np.array(eps))


def _serve(jax_algo, algo, mode, rng, pinned):
    """(JAX action, port action) pairs: one request, or 2 horizons of steps
    for the RNN policies."""
    pairs = []
    windowed = mode.startswith("transformer")
    for _ in range(2 * T if mode.startswith("rnn") else 1):
        obs = {"flat": rng.randn(B, T, O) if windowed else rng.randn(B, O)}
        with jax.enable_x64():
            key = jax.random.split(jax_algo._init_rng)[1]   # the key JAX draws with
            pinned.log.clear()
            want = np.asarray(jax_algo.get_action(obs))
            if "vae" in mode:
                draws = [np.array(v) for _, v in pinned.log]
                algo._prior_hook = lambda: draws[0] if len(draws) == 1 else tuple(draws)
                got = algo.get_action(obs)
            elif mode in ("gmm", "rnn_gmm", "transformer_gmm"):
                dist = algo.action_distribution(obs)
                if mode == "rnn_gmm":   # JAX samples the [B, 1] step
                    m, eps = _jax_sample_draws(key, dist.logits.numpy()[:, None])
                    got = dist.sample(mode=m[:, 0], eps=eps[:, 0])
                else:
                    got = dist.sample(None, *_jax_sample_draws(key, dist.logits.numpy()))
                    if windowed:
                        got = algo._select_output(got)
            else:
                got = algo.get_action(obs)
        pairs.append((want, got.numpy()))
    return pairs


@pytest.fixture(scope="module", params=sorted(MODES))
def run(request):
    """Both algos from the same weights through the same 3 batches (epochs 0,
    1, 2: the categorical prior's temperature anneals), then served."""
    mode = request.param
    rng = np.random.RandomState(0)
    batches = [_batch(rng) for _ in range(STEPS)]
    eps = [rng.randn(B, LATENT) for _ in range(STEPS)]
    pinned = PinnedJaxRandom(8)
    with contextlib.ExitStack() as stack:
        jax_algo = _make(mode, "jax")
        jax_algo.ensure_state(jax_algo.process_batch_for_training(batches[0]))
        nested, flat = perturbed_variables({"params": jax_algo.state.params["policy"]}, 3)
        with jax.enable_x64():
            params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                            nested["params"])
            jax_algo.state = jax_algo.state.replace(
                params={"policy": params},
                opt_states={"policy": jax_algo.optimizers["policy"].init(params)})
        algo = _make(mode, "port")
        assert not algo.TAKES_CONTEXT
        assert PortAlgo.rollout_policy_class(algo) is PortAlgo.RolloutPolicy
        algo.nets.double()
        load_jax_variables(algo.nets["policy"], flat)
        if "vae" in mode:
            stack.enter_context(pytest.MonkeyPatch.context()).setattr(
                JaxVAENets, "jax", pinned)
            jax_eps, port_eps = iter(eps), iter(eps)
            jax_algo._noise_hook = lambda: jnp.asarray(next(jax_eps))
            if mode == "vae_categorical":   # the Gumbel noise's uniform, pinned
                algo._noise_hook = lambda: np.array(
                    [v for n, v in pinned.log if n == "uniform"][0])
            else:
                algo._noise_hook = lambda: next(port_eps)

        metrics = []
        for epoch, batch in enumerate(batches):
            with jax.enable_x64():
                want = jax_algo.train_on_batch(jax_algo.process_batch_for_training(batch),
                                               epoch=epoch)["losses"]
            got = algo.train_on_batch(algo.process_batch_for_training(batch),
                                      epoch=epoch)["losses"]
            metrics.append(({k: float(v) for k, v in want.items()},
                            {k: float(v) for k, v in got.items()}))
        expected = copy.deepcopy(algo.nets["policy"])
        load_jax_variables(expected, flatten_variables(
            {"params": jax_algo.state.params["policy"]}))
        served = _serve(jax_algo, algo, mode, np.random.RandomState(1), pinned)
    windowed = mode.startswith("transformer")
    return dict(mode=mode, metrics=metrics, got=algo.nets["policy"].state_dict(),
                want=expected.state_dict(), served=served, tol=1e-6 if windowed else 1e-8,
                action_tol=1e-6 if windowed else 1e-10,
                log=algo.log_info({"losses": metrics[-1][1]}))


def test_step_metrics_match_jax(run):
    for want, got in run["metrics"]:
        assert set(got) == set(want) and "policy_grad_norms" in got
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=run["tol"], atol=1e-12,
                                       err_msg=k)
    if "vae" in run["mode"]:
        assert set(run["log"]) == {"Loss", "KL_Loss", "Reconstruction_Loss"}


def test_parameters_after_three_steps_match_jax(run):
    assert set(run["got"]) == set(run["want"])
    for k, want in run["want"].items():
        err = float((run["got"][k] - want).abs().max())
        assert err <= run["tol"] * float(want.abs().max()), f"{k}: {err}"


def test_get_action_matches_jax(run):
    for want, got in run["served"]:
        assert got.shape == (B, A)
        np.testing.assert_allclose(got, want, rtol=0, atol=run["action_tol"])


@pytest.mark.parametrize("mode", ["transformer", "vae"])
def test_mixed_precision_raises(mode):
    """For ``BC_VAE``, whose JAX step ignores the flag; ``BC_Transformer``
    (the JAX class takes ``ICLTransformer``'s bf16 step) builds and takes a
    bf16 step on fp32 masters."""
    cfg = _tune(config_factory("bc"), mode)
    with cfg.values_unlocked():
        cfg.train.mixed_precision = True
    PortObsUtils.initialize_obs_utils_with_config(cfg)
    if mode == "vae":
        with pytest.raises(NotImplementedError, match="mixed_precision"):
            PortAlgo.algo_factory("bc", cfg, {"flat": (O,)}, A, device="cpu")
        return
    algo = PortAlgo.algo_factory("bc", cfg, {"flat": (O,)}, A, device="cpu")
    assert type(algo).__name__ == "BC_Transformer" and algo.mixed_precision
    losses = algo.train_on_batch(algo.process_batch_for_training(
        _batch(np.random.RandomState(1))), epoch=0)["losses"]
    assert all(np.isfinite(float(v)) for v in losses.values())
    assert all(p.dtype == torch.float32 for p in algo.nets.parameters())


# ---------------------------------------------------------------------------
# a BC_VAE checkpoint through policy_from_checkpoint
# ---------------------------------------------------------------------------

def train_and_reload(tmp_path, monkeypatch, cfg, name, demo_lengths=(12, 10, 11)):
    """One epoch of @cfg through ``scripts/train.train`` on the test demos
    (low-dimensional ``eef_pos``, actions min-max normalized); returns (the
    trained in-memory algo, the checkpoint's rollout policy, ckpt_dict)."""
    demos = write_demo_file(str(tmp_path / "demos.hdf5"), list(demo_lengths),
                            with_images=False)
    with h5py.File(demos, "a") as f:
        f["data"].attrs["env_args"] = json.dumps({"env_name": "Fake", "type": 1,
                                                  "env_kwargs": {}})
    with cfg.values_unlocked():
        cfg.observation.modalities.obs.low_dim = ["eef_pos"]
        cfg.experiment.name = name
        cfg.experiment.logging.terminal_output_to_txt = False
        cfg.experiment.logging.log_tb = False
        cfg.experiment.rollout.enabled = False
        cfg.experiment.epoch_every_n_steps = 2
        cfg.experiment.save.enabled = True
        cfg.experiment.save.every_n_epochs = 1
        cfg.train.data = demos
        cfg.train.output_dir = str(tmp_path / "out")
        cfg.train.num_epochs = 1
        cfg.train.batch_size = 4
        cfg.train.num_data_workers = 1
        cfg.train.dataset_keys = ["actions"]
        cfg.train.hdf5_load_next_obs = False
        cfg.train.action_config = {"actions": {"normalization": "min_max"}}
    trained = []
    factory = PortAlgo.algo_factory

    def record(*args, **kwargs):
        trained.append(factory(*args, **kwargs))
        return trained[-1]

    monkeypatch.setattr(PortTrain.Algo, "algo_factory", record)
    PortTrain.train(cfg, device="cpu")
    monkeypatch.undo()
    (path,) = glob.glob(str(tmp_path / "out" / name / "*" / "models" / "*.pth"))
    policy, ckpt = FileUtils.policy_from_checkpoint(device="cpu", ckpt_path=path)
    return trained[0], policy, ckpt


def test_vae_checkpoint_serves_through_the_plain_rollout_policy(tmp_path, monkeypatch):
    """A BC_VAE checkpoint is a ``RolloutPolicy`` whose episode (prior
    samples from generators seeded alike) equals the trained algo's."""
    cfg = _tune(config_factory("bc"), "vae")
    trained, policy, ckpt = train_and_reload(tmp_path, monkeypatch, cfg, "vae_ckpt")
    assert type(policy) is PortAlgo.RolloutPolicy
    assert type(policy.policy).__name__ == "BC_VAE"
    assert json.loads(ckpt["config"])["algo"]["vae"]["enabled"]
    twin = PortAlgo.RolloutPolicy(
        trained, obs_normalization_stats=ckpt.get("obs_normalization_stats"),
        action_normalization_stats=ckpt.get("action_normalization_stats"))
    rng = np.random.RandomState(4)
    for p in (policy, twin):
        p.start_episode()
        p.policy.generator.manual_seed(11)
    for _ in range(5):
        ob = {"eef_pos": rng.randn(3).astype(np.float32)}
        got, want = policy(ob), twin(ob)
        assert got.shape == (A,) and np.isfinite(got).all()
        np.testing.assert_array_equal(got, want)
