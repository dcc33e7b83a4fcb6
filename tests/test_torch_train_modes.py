"""The opt-in ``train`` modes of the port against the JAX package's:

* the ``multistep`` and ``cosine`` learning-rate schedules against the JAX
  package's optax schedules at every step of a run past the warmup and the
  milestones, through the optimizer as ``Algo`` builds it
  (``num_training_steps = train.num_epochs * experiment.epoch_every_n_steps``);
* frozen BatchNorm (``train.frozen_batch_norm``): the module in training
  against Flax's ``use_running_average`` BatchNorm, and one flagship
  ``train_on_batch`` in float64 against the JAX algo's with the mode on
  (metrics within 1e-4, as tests/test_torch_icl_hvqvae.py holds its float64
  steps), the statistics unchanged to the bit on both sides; and one
  flagship ``train.mixed_precision`` step with the mode on against JAX's at
  the flagship bf16 test's tolerances, where both sides leave the
  statistics rounded once to bf16 (the JAX step returns its bf16 ``aux``);
* the pool-free stem (``train.pool_free_stem``): the output shape of the
  pooled stem at (32, 32), (29, 37) and (116, 116) (JAX
  tests/test_pool_free_stem.py), and the FiLM trunk's outputs and gradients
  against JAX's in float64, with no stem pool run;
* ``_check_train_options`` no longer refusing the four options, and each
  mode set on its own algo's modules only (the JAX package sets them
  process-wide)."""

import copy

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

import robot_manipulation_vq_vae_tpu.models.base_nets as JaxBaseNets
from robot_manipulation_vq_vae_tpu.utils.ckpt_conversion import flatten_variables
from robot_manipulation_vq_vae_tpu.utils.optim_utils import lr_schedule_from_optim_params

import robot_manipulation_vq_vae_tpu_torch.algo as PortAlgo
from robot_manipulation_vq_vae_tpu_torch.config import config_factory
from robot_manipulation_vq_vae_tpu_torch.models import base_nets as PortBaseNets
from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils as PortObsUtils
from robot_manipulation_vq_vae_tpu_torch.utils import optim_utils as PortOptim
from robot_manipulation_vq_vae_tpu_torch.utils.jax_weights import load_jax_variables
import test_torch_icl_hvqvae as Flagship
from torch_port_helpers import perturbed_variables
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

LR = 3e-4


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

SCHEDULES = {
    "multistep": {"scheduler_type": "multistep", "epoch_schedule": [7, 20, 33],
                  "decay_factor": 0.5},
    "cosine": {"scheduler_type": "cosine", "num_warmup_steps": 10},
    "cosine_no_warmup": {"scheduler_type": "cosine", "num_warmup_steps": 0},
}
RUN = 60   # past every milestone and the cosine horizon (50 steps)


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_optax_at_every_step(name):
    optim_params = {"optimizer_type": "adam", "regularization": {"L2": 0.0},
                    "learning_rate": {"initial": LR, **SCHEDULES[name]}}
    want = lr_schedule_from_optim_params(optim_params, num_training_steps=50)
    factor = PortOptim.lr_factor_from_optim_params(optim_params, num_training_steps=50)
    p = torch.nn.Parameter(torch.zeros(2))
    opt, scheduler = PortOptim.optimizer_from_optim_params([p], optim_params, 50)
    for k in range(RUN):
        # optax evaluates the schedule in float32: errors of ~6e-8 of the peak
        np.testing.assert_allclose(LR * factor(k), float(want(k)), rtol=1e-6,
                                   atol=LR * 1e-7, err_msg=f"step {k}")
        np.testing.assert_allclose(opt.param_groups[0]["lr"], LR * factor(k), rtol=1e-12)
        opt.step()
        scheduler.step()
    assert factor(RUN - 1) == (0.125 if name == "multistep" else 0.0)


def test_cosine_schedule_needs_its_horizon_and_algo_gives_it():
    with pytest.raises(ValueError, match="num_training_steps"):
        PortOptim.lr_factor_from_optim_params(
            {"learning_rate": {"initial": LR, "scheduler_type": "cosine"}})
    cfg = _flagship_cfg()
    with cfg.unlocked():
        cfg.algo.optim_params.policy.learning_rate.scheduler_type = "cosine"
        cfg.algo.optim_params.policy.learning_rate.num_warmup_steps = 4
        cfg.train.num_epochs, cfg.experiment.epoch_every_n_steps = 3, 5
    algo = PortAlgo.algo_factory("icl", cfg, Flagship._shapes(True), Flagship.A,
                                 device="cpu")
    sched = algo.lr_schedulers["policy"]
    for _ in range(15):
        sched.optimizer.step()
        sched.step()
    assert sched.get_last_lr()[0] == 0.0   # 15 steps: the horizon, 3 x 5


# ---------------------------------------------------------------------------
# frozen BatchNorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(6, 10, 3), (4, 9, 5)])
def test_frozen_batch_norm_matches_flax_running_average(shape):
    n, hw, c = shape
    rng = np.random.RandomState(1)
    x = rng.randn(n, hw, hw, c) * 2 + 0.5
    mean, var = rng.randn(c) * 0.3, rng.uniform(0.5, 1.5, c)
    scale, bias = rng.randn(c), rng.randn(c)
    with jax.enable_x64():
        bn = fnn.BatchNorm(use_running_average=True)
        y_j = bn.apply({"params": {"scale": scale, "bias": bias},
                        "batch_stats": {"mean": mean, "var": var}}, jnp.asarray(x))
    port = PortBaseNets.BatchNorm2d(c).double()
    load_jax_variables(port, {"params/scale": scale, "params/bias": bias,
                              "batch_stats/mean": mean, "batch_stats/var": var})
    PortBaseNets.set_frozen_batch_norm(port, True)
    port.train()
    before = copy.deepcopy(port.state_dict())
    y_t = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(y_t.detach().permute(0, 2, 3, 1).numpy(), np.asarray(y_j),
                               atol=1e-12, rtol=0)
    for k, v in port.state_dict().items():
        assert torch.equal(v, before[k]), k


def _flagship_cfg(**train):
    cfg = Flagship._configure(config_factory("icl"), True, train=True)
    with cfg.values_unlocked():
        for k, v in train.items():
            cfg.train[k] = v
    PortObsUtils.initialize_obs_utils_with_config(cfg)
    return cfg


@pytest.fixture(scope="module")
def frozen_step():
    """One float64 flagship step with frozen BatchNorm on both sides."""
    try:
        jax_algo, algo = Flagship._pair(True, train=True, x64=True,
                                        frozen_batch_norm=True)
        stats0 = {k: v.clone() for k, v in algo.nets.state_dict().items()
                  if k.endswith(("running_mean", "running_var"))}
        params0 = {k: v.detach().clone() for k, v in algo.nets.named_parameters()}
        batch = Flagship._batch(np.random.RandomState(0), True)
        with jax.enable_x64():
            jax_stats0 = flatten_variables(jax_algo.state.aux["policy"]["batch_stats"])
            want = jax_algo.train_on_batch(batch, epoch=0)["losses"]
            jax_stats1 = flatten_variables(jax_algo.state.aux["policy"]["batch_stats"])
        got = algo.train_on_batch(batch, epoch=0)["losses"]
    finally:
        Flagship.reset_jax_modes()
    return dict(algo=algo, want=want, got=got, stats0=stats0, params0=params0,
                jax_stats=(jax_stats0, jax_stats1))


def test_frozen_batch_norm_flagship_step_matches_jax(frozen_step):
    want, got = frozen_step["want"], frozen_step["got"]
    for k in Flagship.METRICS:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4, atol=1e-4,
                                   err_msg=k)


def test_frozen_batch_norm_leaves_the_statistics_to_the_bit(frozen_step):
    algo = frozen_step["algo"]
    assert all(m.frozen for m in algo.nets.modules()
               if isinstance(m, PortBaseNets.BatchNorm2d))
    state = algo.nets.state_dict()
    assert len(frozen_step["stats0"]) == 2 * len(Flagship.CAMS) * 20
    for k, v in frozen_step["stats0"].items():
        assert torch.equal(state[k], v), k
    jax0, jax1 = frozen_step["jax_stats"]
    for k in jax0:
        np.testing.assert_array_equal(np.asarray(jax1[k]), np.asarray(jax0[k]), err_msg=k)
    moved = [not torch.equal(p, frozen_step["params0"][k])
             for k, p in algo.nets.named_parameters()]
    assert sum(moved) > 0.9 * len(moved)


def test_frozen_batch_norm_bf16_flagship_step_matches_jax():
    """A ``train.mixed_precision`` step with frozen BatchNorm: the metrics
    at the flagship bf16 test's tolerances; the running statistics, which
    normalize the bf16 activations as bf16 copies, are left as those copies
    in fp32 on both sides, to the bit, and not moved by the batch."""
    want, got, algo, expected, stats0 = Flagship._mixed_step(frozen_batch_norm=True)
    Flagship.assert_mixed_step_matches(want, got, algo)
    state, jax_state = algo.nets["policy"].state_dict(), expected.state_dict()
    assert len(stats0) == 2 * len(Flagship.CAMS) * 20
    rounded = 0
    for k, v in stats0.items():
        assert torch.equal(jax_state[k], v.bfloat16().float()), k
        assert torch.equal(state[k], jax_state[k]), k
        rounded += not torch.equal(v, state[k])
    assert rounded > len(stats0) // 2


# ---------------------------------------------------------------------------
# the pool-free stem
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hw", [(32, 32), (29, 37), (116, 116)])
def test_pool_free_stem_keeps_the_pooled_shape(hw):
    h, w = hw
    x = torch.zeros(1, 3, h, w)
    trunk = PortBaseNets.ResNet18Conv().eval()
    pooled = trunk(x).shape
    PortBaseNets.set_pool_free_stem(trunk, True)
    assert trunk(x).shape == pooled
    stem = trunk.nets[:4](x)
    assert stem.shape[-2:] == ((h - 1) // 4 + 1, (w - 1) // 4 + 1)
    assert list(pooled) == [1, 512] + PortBaseNets.ResNet18Conv.output_shape((h, w, 3))[:2]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_pool_free_film_trunk_matches_jax(train, monkeypatch):
    """Outputs, statistics and gradients in float64; the stem runs no pool,
    the recorded-argmax pool's wrapper included (``train.pallas_pool``)."""
    rng = np.random.RandomState(2)
    x, lang = rng.rand(2, 64, 64, 3), rng.randn(2, 16)
    JaxBaseNets.set_pool_free_stem(True)
    try:
        trunk = JaxBaseNets.ResNet18ConvFiLM(lang_emb_dim=16)
        variables = trunk.init(jax.random.PRNGKey(0), jnp.asarray(x, jnp.float32),
                               jnp.asarray(lang, jnp.float32))
        nested, flat = perturbed_variables(variables, 3)
        proj = rng.randn(2, 2, 2, 512)
        with jax.enable_x64():
            nested = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), nested)

            def loss(params):
                out, upd = trunk.apply({"params": params,
                                        "batch_stats": nested["batch_stats"]},
                                       jnp.asarray(x), jnp.asarray(lang), train=train,
                                       mutable=["batch_stats"])
                return jnp.sum(out * proj), (out, upd)

            (_, (out_j, upd)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
                nested["params"])
    finally:
        JaxBaseNets.set_pool_free_stem(False)

    def no_pool(*args, **kwargs):
        raise AssertionError("the pool-free stem ran a pool")

    monkeypatch.setattr(PortBaseNets, "max_pool_3x3_s2", no_pool)
    monkeypatch.setattr(PortBaseNets.F, "max_pool2d", no_pool)
    port = PortBaseNets.ResNet18ConvFiLM(lang_emb_dim=16).double()
    load_jax_variables(port, flat)
    PortBaseNets.set_stem_pool(port, True)
    PortBaseNets.set_pool_free_stem(port, True)
    port.train(train)
    out = port(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(), torch.from_numpy(lang))
    np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(), np.asarray(out_j),
                               atol=1e-9, rtol=0)
    (out * torch.from_numpy(proj).permute(0, 3, 1, 2)).sum().backward()
    holder = copy.deepcopy(port)
    load_jax_variables(holder, flatten_variables({"params": grads, **upd}))
    for name, buf in port.named_buffers():
        np.testing.assert_allclose(buf.numpy(), dict(holder.named_buffers())[name].numpy(),
                                   atol=1e-9, rtol=0, err_msg=name)
    for name, p in holder.named_parameters():
        want = p.detach().numpy()
        got = dict(port.named_parameters())[name].grad.numpy()
        np.testing.assert_allclose(got, want, atol=1e-9 * np.abs(want).max(), rtol=0,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# the options build, each on its own algo
# ---------------------------------------------------------------------------

def test_train_options_build_and_stay_per_algo():
    plain = PortAlgo.algo_factory("icl", _flagship_cfg(), Flagship._shapes(True),
                                  Flagship.A, device="cpu")
    modes = PortAlgo.algo_factory(
        "icl", _flagship_cfg(frozen_batch_norm=True, pool_free_stem=True,
                             packed_rgb_encoders=True, mixed_precision=True),
        Flagship._shapes(True), Flagship.A, device="cpu")
    for algo, on in ((plain, False), (modes, True)):
        mods = list(algo.nets.modules())
        assert algo.mixed_precision == on
        assert all(m.frozen == on for m in mods if isinstance(m, PortBaseNets.BatchNorm2d))
        assert all(m.pool_free == on for m in mods
                   if isinstance(m, (PortBaseNets.StemConv, PortBaseNets.StemMaxPool)))
        assert all(m.recorded_argmax for m in mods
                   if isinstance(m, PortBaseNets.StemMaxPool))
        encoder = algo.nets["policy"].net.encoder.nets["obs"]
        assert encoder.packed_keys == (Flagship.CAMS if on else [])
    # the same parameters and buffers either way, under the same names
    assert list(plain.nets.state_dict()) == list(modes.nets.state_dict())
