"""The port's training slice: ``ICLTransformer_GMM.train_on_batch`` on the
``icl_gmm_paper`` config with ``train.pallas_pool`` on, against the JAX
package's, for 3 steps from the same carried-over weights and the same numpy
batches. Small size: 2 layers, width 32, 4 heads, T = 4, B = 8 (4 context
sequences, 4 supervised), two 64x64 cameras through the FiLM ResNet-18 (at
64x64 its output is 2x2, so SpatialSoftmax passes gradient back into the
trunk and through the stem pool's backward; at 32x32 it would be 1x1 and the
trunk's gradient 0), low-dim keys and a language embedding. No crop
randomizer and no dropout, so both sides are deterministic. On the CPU the
JAX package runs its exact recorded-argmax pool formulation and the port its
plain version.

Both sides run the steps in float64 (``jax.enable_x64``; ``nets.double()``),
from the same float32 weights and the same float32 inputs. In float32 the JAX
package's trunk gradients miss the float64 ones by up to about 2 % on these
inputs (the port's by 3e-6), which is consistent with Flax BatchNorm's
one-pass variance, E[x^2] - E[x]^2. In float64 the two sides' gradients agree
to 7e-7 (the JAX attention keeps float32 products). Adam's first steps move a
weight by about the learning rate on its gradient's sign, so a weight whose
gradient lies within that difference of 0 moves the other way, and the trunk
(BatchNorm over 2x2 maps of 16 images) amplifies such differences from step
to step. So the policy runs at the template's own rate, 1e-4, and the weights
and statistics after 3 steps are held in bulk: at least 99 % of each tensor
within 1e-5, every element within 2 lr per step (measured: 3,560 of 22.8 M
weights beyond 1e-5, at most 0.6 % of a tensor), and at least 95 % of each
running statistic within 1e-5, all within 1e-4 (measured: 1.7e-5 at most).

Also: train-mode BatchNorm against Flax's, the random crop's gather against
``random_crop_hwc`` with the same offsets, and the learning-rate schedules
against optax's."""

import copy

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

import robot_manipulation_vq_vae_tpu.algo as JaxAlgo
from robot_manipulation_vq_vae_tpu.config import config_factory as jax_config_factory
from robot_manipulation_vq_vae_tpu.models.base_nets import set_pallas_pool
from robot_manipulation_vq_vae_tpu.models.obs_core import random_crop_hwc
from robot_manipulation_vq_vae_tpu.utils import obs_utils as JaxObsUtils
from robot_manipulation_vq_vae_tpu.utils.ckpt_conversion import flatten_variables
from robot_manipulation_vq_vae_tpu.utils.optim_utils import (
    lr_schedule_from_optim_params,
)

import robot_manipulation_vq_vae_tpu_torch.algo as PortAlgo
from robot_manipulation_vq_vae_tpu_torch.config import config_factory
from robot_manipulation_vq_vae_tpu_torch.models.base_nets import BatchNorm2d
from robot_manipulation_vq_vae_tpu_torch.models.obs_core import crop_at
from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils as PortObsUtils
from robot_manipulation_vq_vae_tpu_torch.utils import optim_utils as PortOptim
from robot_manipulation_vq_vae_tpu_torch.utils.jax_weights import (
    load_jax_variables,
)
from torch_port_helpers import assert_mostly_close, perturbed_variables

B, T, A, LANG, IMG, STEPS, LR = 8, 4, 12, 16, 64, 3, 1e-4
CAMS = ["agentview_image", "eye_in_hand_image"]
LOW_DIM = {"eef_pos": (3,), "eef_quat": (4,), "gripper_qpos": (2,)}
OBS_KEY_SHAPES = {**LOW_DIM, **{c: (IMG, IMG, 3) for c in CAMS}, "lang_emb": (LANG,)}
METRICS = ("log_probs", "action_loss", "policy_grad_norms", "vq_vae_loss")


def _configure(cfg):
    with cfg.values_unlocked():
        cfg.observation.modalities.obs.low_dim = list(LOW_DIM) + ["lang_emb"]
        cfg.observation.modalities.obs.rgb = CAMS
        cfg.observation.encoder.rgb.core_class = "VisualCoreLanguageConditioned"
        cfg.observation.encoder.rgb.core_kwargs = {
            "feature_dimension": 64, "backbone_class": "ResNet18ConvFiLM",
            "backbone_kwargs": {"pretrained": False, "input_coord_conv": False},
            "pool_class": "SpatialSoftmax",
            "pool_kwargs": {"num_kp": 32, "learnable_temperature": False,
                            "temperature": 1.0, "noise_std": 0.0},
        }
        cfg.observation.encoder.rgb.obs_randomizer_class = None
        tc = cfg.algo.transformer
        tc.context_length, tc.embed_dim, tc.num_layers, tc.num_heads = T, 32, 2, 4
        tc.emb_dropout = tc.attn_dropout = tc.block_output_dropout = 0.0
        lr = cfg.algo.optim_params.policy.learning_rate
        lr.initial, lr.scheduler_type = LR, None
        # L2 > 0: the policy optimizer moves the LipVQ parameters (whose NLL
        # gradient is 0) only if it steps them with zero gradients, as optax
        # does; a clip limit below the gradient norm exercises the clipping
        cfg.algo.optim_params.policy.regularization.L2 = 1e-2
        cfg.train.max_grad_norm = 1.0
        cfg.train.pallas_pool = True
    return cfg


def _batch(rng):
    obs = {k: rng.randn(B, T, *s).astype(np.float32) for k, s in LOW_DIM.items()}
    obs.update({c: rng.randint(0, 256, (B, T, IMG, IMG, 3)).astype(np.uint8)
                for c in CAMS})
    obs["lang_emb"] = rng.randn(B, T, LANG).astype(np.float32)
    return {"obs": obs, "actions": rng.uniform(-1, 1, (B, T, A)).astype(np.float32)}


def _jax_flat(state):
    return flatten_variables({"params": state.params["policy"],
                              **state.aux["policy"]})


@pytest.fixture(scope="module")
def run():
    """Both algos from the same weights through the same 3 batches; then one
    validate call on the port. Returns what the tests compare."""
    rng = np.random.RandomState(0)
    batches = [_batch(rng) for _ in range(STEPS + 1)]

    jax_cfg = _configure(jax_config_factory("icl_gmm_paper"))
    JaxObsUtils.initialize_obs_utils_with_config(jax_cfg)
    try:
        jax_algo = JaxAlgo.algo_factory("icl_gmm_paper", jax_cfg, OBS_KEY_SHAPES, A)
        jax_algo.ensure_state(batches[0])
        variables = {"params": jax_algo.state.params["policy"],
                     **jax_algo.state.aux["policy"]}
        # GPT kernels x10: at their 0.02 init, attention is nearly uniform
        nested, flat = perturbed_variables(variables, 5, kernel_scale=10.0,
                                           scale_under="net/transformer/")
        with jax.enable_x64():
            nested = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                            nested)
            params = nested.pop("params")
            jax_algo.state = jax_algo.state.replace(
                params={"policy": params}, aux={"policy": nested},
                opt_states={
                    "policy": jax_algo.optimizers["policy"].init(params),
                    "vq_tokenizer": jax_algo.optimizers["vq_tokenizer"].init(
                        params["net"]["encoder"]["action_network"]),
                },
            )

        port_cfg = _configure(config_factory("icl_gmm_paper"))
        PortObsUtils.initialize_obs_utils_with_config(port_cfg)
        algo = PortAlgo.algo_factory("icl_gmm_paper", port_cfg, OBS_KEY_SHAPES, A,
                                     device="cpu")
        algo.nets.double()
        load_jax_variables(algo.nets["policy"], flat)

        metrics = []
        for batch in batches[:STEPS]:
            with jax.enable_x64():
                want = jax_algo.train_on_batch(batch, epoch=0)["losses"]
            got = algo.train_on_batch(batch, epoch=0)["losses"]
            metrics.append(({k: float(want[k]) for k in METRICS},
                            {k: float(got[k]) for k in METRICS}))
        expected = copy.deepcopy(algo.nets["policy"])
        load_jax_variables(expected, _jax_flat(jax_algo.state))

        before = {k: v.clone() for k, v in algo.nets.state_dict().items()}
        validate = algo.train_on_batch(batches[STEPS], epoch=0, validate=True)
        after = algo.nets.state_dict()
    finally:
        set_pallas_pool(False)   # Algo.__init__ set the JAX package's flag
    return dict(metrics=metrics, port=algo, expected=expected,
                validate=(before, after, validate["losses"]))


def test_the_stem_pools_use_the_recorded_argmax(run):
    pools = [m for m in run["port"].nets.modules()
             if type(m).__name__ == "StemMaxPool"]
    assert len(pools) == len(CAMS)
    assert all(p.recorded_argmax and p.use_kernel for p in pools)


@pytest.mark.parametrize("step", range(STEPS))
def test_step_metrics_match_jax(run, step):
    want, got = run["metrics"][step]
    for k in METRICS:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4, err_msg=k)


def _state_pairs(run, buffers):
    got = run["port"].nets["policy"].state_dict()
    want = run["expected"].state_dict()
    for k in got:
        is_bn_stat = k.endswith(("running_mean", "running_var"))
        if not k.endswith("num_batches_tracked") and is_bn_stat == buffers:
            yield k, got[k].numpy(), want[k].numpy()


def test_parameters_after_three_steps_match_jax(run):
    pairs = list(_state_pairs(run, buffers=False))
    assert len(pairs) == sum(1 for _ in run["port"].nets["policy"].parameters())
    for k, got, want in pairs:
        assert_mostly_close(got, want, atol=1e-5, frac=0.99,
                            max_abs=2 * LR * STEPS, msg=k)


def test_batch_norm_statistics_after_three_steps_match_jax(run):
    pairs = list(_state_pairs(run, buffers=True))
    assert len(pairs) == 2 * len(CAMS) * 20   # 20 BatchNorms per ResNet-18
    for k, got, want in pairs:
        assert_mostly_close(got, want, atol=1e-5, frac=0.95, max_abs=1e-4, msg=k)


def test_validate_updates_nothing(run):
    before, after, losses = run["validate"]
    for k in before:
        assert torch.equal(before[k], after[k]), k
    assert not run["port"].nets.training
    assert "policy_grad_norms" not in losses
    assert float(losses["action_loss"]) == -float(losses["log_probs"])
    assert all(np.isfinite(float(v)) for v in losses.values())


@pytest.mark.parametrize("shape", [(6, 10, 3), (64, 64, 5)])
def test_batch_norm_training_matches_flax(shape):
    """Two train-mode updates: the output, and the running statistics with
    Flax's momentum 0.99 and biased variance (torch's defaults, 0.1 and the
    unbiased variance, miss by far more than the tolerance at this n)."""
    n, hw, c = shape
    rng = np.random.RandomState(1)
    xs = [rng.randn(n, hw, hw, c).astype(np.float32) * 2 + 0.5 for _ in range(2)]
    bn = fnn.BatchNorm(use_running_average=False)
    variables = bn.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]))
    port = BatchNorm2d(c).train()
    for x in xs:
        y_j, upd = bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
        variables = {**variables, **upd}
        y_t = port(torch.from_numpy(x).permute(0, 3, 1, 2))
        np.testing.assert_allclose(y_t.detach().permute(0, 2, 3, 1).numpy(),
                                   np.asarray(y_j), atol=1e-5)
    stats = variables["batch_stats"]
    np.testing.assert_allclose(port.running_mean.numpy(), np.asarray(stats["mean"]),
                               atol=1e-6)
    np.testing.assert_allclose(port.running_var.numpy(), np.asarray(stats["var"]),
                               atol=1e-6)


def test_random_crop_gather_matches_jax_with_the_same_offsets():
    rng = np.random.RandomState(2)
    images = rng.randn(3, 20, 24, 3).astype(np.float32)
    key = jax.random.PRNGKey(4)
    want = random_crop_hwc(key, jnp.asarray(images), 12, 16, num_crops=2)
    # the offsets random_crop_hwc draws from @key
    rh, rw = jax.random.split(key)
    hy = jax.random.randint(rh, (3, 2), 0, 20 - 12 + 1)
    wx = jax.random.randint(rw, (3, 2), 0, 24 - 16 + 1)
    got = crop_at(torch.from_numpy(images), torch.from_numpy(np.asarray(hy)).long(),
                  torch.from_numpy(np.asarray(wx)).long(), 12, 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("sched", ["constant_with_warmup", "linear", "constant", None])
def test_lr_schedule_matches_optax(sched):
    optim_params = {"optimizer_type": "adam", "regularization": {"L2": 0.0},
                    "learning_rate": {"initial": 1e-4, "decay_factor": 0.1,
                                      "scheduler_type": sched}}
    want = lr_schedule_from_optim_params(optim_params)
    factor = PortOptim.lr_factor_from_optim_params(optim_params)
    for k in (0, 1, 5, 10000):
        w = float(want(k)) if callable(want) else float(want)
        # optax evaluates the schedule in float32: absolute error ~1e-4 * 6e-8
        np.testing.assert_allclose(1e-4 * factor(k), w, rtol=1e-6, atol=1e-11)
    # the scheduler gives update k the rate at k: update 0 gets rate 0 with
    # the warmup
    p = torch.nn.Parameter(torch.zeros(2))
    opt, scheduler = PortOptim.optimizer_from_optim_params([p], optim_params)
    for k in range(3):
        np.testing.assert_allclose(opt.param_groups[0]["lr"], 1e-4 * factor(k))
        opt.step()
        scheduler.step()


def test_other_schedules_name_the_roadmap():
    optim_params = {"learning_rate": {"initial": 1e-4, "scheduler_type": "cosine"}}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        PortOptim.lr_factor_from_optim_params(optim_params)
