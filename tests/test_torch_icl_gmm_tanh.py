"""The ICL GMM actor with ``use_tanh`` (the tanh-wrapped GMM: the means are
the heads themselves, and the mixture is squashed), the port's against the
JAX package's ``ICLTransformerGMMActorNetwork`` at
``test_torch_icl_gmm_get_action.py``'s small size, in eval mode from the
same weights and inputs: the base GMM's parameters and the log likelihood
of actions inside (-1, 1)."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

import robot_manipulation_vq_vae_tpu.algo as JaxAlgo
from robot_manipulation_vq_vae_tpu.algo.algo import device_process_obs
from robot_manipulation_vq_vae_tpu.config import config_factory as jax_config_factory
from robot_manipulation_vq_vae_tpu.utils import obs_utils as JaxObsUtils

import robot_manipulation_vq_vae_tpu_torch.algo as PortAlgo
from robot_manipulation_vq_vae_tpu_torch.config import config_factory
from robot_manipulation_vq_vae_tpu_torch.models.distributions import TanhWrappedGMM
from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils as PortObsUtils
from robot_manipulation_vq_vae_tpu_torch.utils.jax_weights import load_jax_variables
from test_torch_icl_gmm_get_action import A, B, OBS_KEY_SHAPES, T, _configure, _obs
from torch_port_helpers import perturbed_variables
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)


def test_tanh_wrapped_icl_gmm_matches_jax():
    jax_cfg = _configure(jax_config_factory("icl_gmm_paper"))
    JaxObsUtils.initialize_obs_utils_with_config(jax_cfg)
    policy = JaxAlgo.algo_factory("icl_gmm_paper", jax_cfg, OBS_KEY_SHAPES,
                                  A).nets["policy"].clone(use_tanh=True)
    rng = np.random.RandomState(3)
    obs, ctx_obs = _obs(rng), _obs(rng)
    ctx_act = rng.uniform(-1, 1, (B, T, A)).astype(np.float32)
    actions = rng.uniform(-0.95, 0.95, (B, T, A)).astype(np.float32)

    def jobs(o):
        return device_process_obs({k: jnp.asarray(v) for k, v in o.items()})

    args = (jobs(obs), jobs(ctx_obs), jnp.asarray(ctx_act))
    variables = jax.jit(lambda *a: policy.init(
        {"params": jax.random.PRNGKey(0)}, *a, train=False,
        method=policy.forward_train))(*args)
    variables, flat = perturbed_variables(variables, 4)
    dist_j, _ = policy.apply(variables, *args, low_noise_eval=False, train=False,
                             method=policy.forward_train)
    want_lp = np.asarray(dist_j.log_prob(jnp.asarray(actions)))

    port_cfg = _configure(config_factory("icl_gmm_paper"))
    PortObsUtils.initialize_obs_utils_with_config(port_cfg)
    algo = PortAlgo.algo_factory("icl_gmm_paper", port_cfg, OBS_KEY_SHAPES, A,
                                 device="cpu")
    load_jax_variables(algo.nets["policy"], flat)
    algo.nets["policy"].use_tanh = True
    dist_t, _ = algo.action_distribution(obs, {"obs": ctx_obs, "actions": ctx_act},
                                         low_noise_eval=False)
    assert isinstance(dist_t, TanhWrappedGMM)
    for name in ("means", "scales", "logits"):
        np.testing.assert_allclose(getattr(dist_t.base, name).numpy(),
                                   np.asarray(getattr(dist_j.base, name)),
                                   atol=1e-4, rtol=1e-4, err_msg=name)
    assert float(dist_t.base.means.abs().max()) > 1.0   # the heads, not tanh'd
    got_lp = dist_t.log_prob(torch.tensor(actions)).numpy()
    np.testing.assert_allclose(got_lp, want_lp, rtol=1e-4, atol=1e-3)
