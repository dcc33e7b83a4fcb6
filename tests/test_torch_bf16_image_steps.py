"""A bf16 training step on image observations, the port's against the JAX
package's from the same weights and batch: one ``icl_gmm_paper`` step on
ResNet-34 FiLM with the crop and the colour jitter's defaults
(tests/test_torch_icl_cores.py's configuration: a 40 x 40 camera cropped to
36, low-dimensional keys, a language embedding, ``train.pallas_pool``, GPT
2 x 32, B = 4, T = 3), the randomizers' draws pinned in JAX
(``PinnedJaxRandom``) and replayed into the port, the JAX LipVQ pinned to
the TPU kernel's semantics as in tests/test_torch_icl_gmm_bf16.py. The
jitter's fp32 factors lift the image to fp32, so the trunk computes in fp32
on bf16 weights on both sides (``jax.make_jaxpr`` of the JAX step: all 294
convolutions fp32, the FiLM projections bf16), its BatchNorm statistics
rounded through bf16.

The log-probabilities and the action loss within 2 %, the LipVQ loss within
1e-5; the masters stay fp32. The gradient norm within 4 %: from the same
weights JAX's bf16 step lies 2.2 % from its own fp32 step here and the
port's 0.7 % from the same fp32 value (the fp32 steps agree within 3e-5),
so the two bf16 steps lie 3.0 % apart; the 34 FiLM layers over 6 crops
amplify each side's bf16 rounding of the weights and the FiLM projections
(ResNet-18 FiLM with the same jitter, and ResNet-34 FiLM without it, agree
within 0.7 %).
"""

import numpy as np
import torch

import jax

from robot_manipulation_vq_vae_tpu.config import config_factory as jax_config_factory
from robot_manipulation_vq_vae_tpu.models import obs_core as JaxObsCore
from robot_manipulation_vq_vae_tpu.models.base_nets import set_pallas_pool
from robot_manipulation_vq_vae_tpu.ops import quantize as JaxQ
from robot_manipulation_vq_vae_tpu.ops.pallas.lipvq_kernel import l2_nearest_pallas

import robot_manipulation_vq_vae_tpu_torch.algo as PortAlgo
from robot_manipulation_vq_vae_tpu_torch.config import config_factory
from robot_manipulation_vq_vae_tpu_torch.models import obs_core as PortObsCore
from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils as PortObsUtils
from robot_manipulation_vq_vae_tpu_torch.utils.jax_weights import load_jax_variables
import test_torch_icl_cores as Cores
from torch_bf16_helpers import one_torch_thread  # noqa: F401 (autouse)
from torch_port_helpers import PinnedJaxRandom, jax_algo_jit_init, perturbed_variables, \
    port_draws, set_jax_state


def _pinned_pallas(z, codebook):
    return l2_nearest_pallas(z, codebook, 512, True)


def _check(want, got, keys):
    for k in keys:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=2e-2, err_msg=k)


def test_paper_step_on_resnet34_film_with_colour_jitter_matches_jax(monkeypatch):
    monkeypatch.setattr(JaxQ, "l2_nearest", _pinned_pallas)
    batch = Cores._batch(np.random.RandomState(0))
    jax_cfg = Cores._configure(jax_config_factory("icl_gmm_paper"), mixed_precision=True)
    try:
        jax_algo = jax_algo_jit_init("icl_gmm_paper", jax_cfg, Cores.OBS_KEY_SHAPES, Cores.A)
        jax_algo.ensure_state(batch)
        variables = {"params": jax_algo.state.params["policy"],
                     **jax_algo.state.aux["policy"]}
        nested, flat = perturbed_variables(variables, 5, kernel_scale=10.0,
                                           scale_under="net/transformer/")
        set_jax_state(jax_algo, {"policy": nested})
        jax_algo.state = jax_algo.state.replace(opt_states={
            **jax_algo.state.opt_states,
            "vq_tokenizer": jax.jit(jax_algo.optimizers["vq_tokenizer"].init)(
                jax_algo.state.params["policy"]["net"]["encoder"]["action_network"])})
        cfg = Cores._configure(config_factory("icl_gmm_paper"), mixed_precision=True)
        PortObsUtils.initialize_obs_utils_with_config(cfg)
        algo = PortAlgo.algo_factory("icl_gmm_paper", cfg, Cores.OBS_KEY_SHAPES, Cores.A,
                                     device="cpu")
        assert algo.mixed_precision
        load_jax_variables(algo.nets["policy"], flat)
        shim = PinnedJaxRandom(12)
        monkeypatch.setattr(JaxObsCore, "jax", shim)
        want = jax_algo.train_on_batch(batch, epoch=0)["losses"]
        # the step's forward, then its LipVQ loss's second forward (whose
        # draws reach nothing)
        port_draws(monkeypatch, shim.log[:len(shim.log) // 2], PortObsCore)
        got = algo.train_on_batch(batch, epoch=0)["losses"]
    finally:
        set_pallas_pool(False)
    _check(want, got, ("log_probs", "action_loss"))
    np.testing.assert_allclose(float(got["policy_grad_norms"]),
                               float(want["policy_grad_norms"]), rtol=4e-2)
    np.testing.assert_allclose(float(got["vq_vae_loss"]), float(want["vq_vae_loss"]),
                               rtol=1e-5)
    assert all(p.dtype == torch.float32 for p in algo.nets.parameters())
