"""The offline-RL family's modules, the port's against the JAX package's, in
float64 with the JAX weights carried across (every leaf made random):

* ``ValueNetwork``, ``ActionValueNetwork`` (with and without
  ``value_bounds``) and ``DistributionalActionValueNetwork`` (log
  probabilities, mean), and BCQ's ``PerturbationActor``, within 1e-10; the
  atoms within 1e-13 (``torch.linspace`` and ``jnp.linspace`` round a few
  atoms to neighbouring values);
* the tanh-wrapped Gaussian and GMM: ``log_prob`` with and without the
  pre-tanh value, ``rsample_with_pretanh`` with injected draws, at scale 1
  and 2, within 1e-10; ``GaussianActorNetwork`` with ``use_tanh`` in
  training and inference mode;
* ``project_values_onto_atoms`` on random values, on values exactly on
  atoms (the ``eq`` term) and on values past the grid (clipped), fed the
  same atoms, within 1e-12; the mass it keeps sums to 1.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robot_manipulation_vq_vae_tpu.algo import bcq as JaxBCQ
from robot_manipulation_vq_vae_tpu.config import config_factory as jax_config_factory
from robot_manipulation_vq_vae_tpu.models import distributions as JaxDist
from robot_manipulation_vq_vae_tpu.models import policy_nets as JaxPolicyNets
from robot_manipulation_vq_vae_tpu.models import value_nets as JaxValueNets
from robot_manipulation_vq_vae_tpu.utils import loss_utils as JaxLossUtils
from robot_manipulation_vq_vae_tpu.utils import obs_utils as JaxObsUtils

from robot_manipulation_vq_vae_tpu_torch.algo import bcq as PortBCQ
from robot_manipulation_vq_vae_tpu_torch.config import config_factory
from robot_manipulation_vq_vae_tpu_torch.models import distributions as PortDist
from robot_manipulation_vq_vae_tpu_torch.models import policy_nets as PortPolicyNets
from robot_manipulation_vq_vae_tpu_torch.models import value_nets as PortValueNets
from robot_manipulation_vq_vae_tpu_torch.utils import loss_utils as PortLossUtils
from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils as PortObsUtils
from robot_manipulation_vq_vae_tpu_torch.utils.jax_weights import load_jax_variables
from torch_port_helpers import perturbed_variables
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

B, O, A = 16, 5, 3
LAYERS = (8, 8)
ATOMS = 11
SHAPES = (("flat", (O,)),)


@pytest.fixture(autouse=True)
def low_dim_flat():
    """Both packages' observation registries: one low-dim key ``flat``."""
    for make, obs_utils in ((jax_config_factory, JaxObsUtils),
                            (config_factory, PortObsUtils)):
        cfg = make("iql")
        with cfg.values_unlocked():
            cfg.observation.modalities.obs.low_dim = ["flat"]
        obs_utils.initialize_obs_utils_with_config(cfg)


def _inputs(seed):
    rng = np.random.RandomState(seed)
    return rng.randn(B, O), rng.uniform(-0.95, 0.95, (B, A))


def _carry(jax_module, port_module, args, method=None, seed=1):
    """@jax_module's variables (initialized on @args, every leaf random),
    loaded into @port_module (float64); returns the JAX variables."""
    with jax.enable_x64():
        variables = jax.jit(lambda *a: jax_module.init(jax.random.PRNGKey(0), *a,
                                                       method=method))(*args)
        nested, flat = perturbed_variables(variables, seed)
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), nested)
    port_module.double()
    load_jax_variables(port_module, flat)
    return params


VALUE_CASES = {
    "value": dict(),
    "action_value": dict(ac_dim=A),
    "action_value_bounded": dict(ac_dim=A, value_bounds=(-3.0, 2.0)),
    "distributional": dict(ac_dim=A, value_bounds=(-5.0, 5.0), num_atoms=ATOMS),
    "no_hidden_layers": dict(ac_dim=A, mlp_layer_dims=()),
}


@pytest.mark.parametrize("case", sorted(VALUE_CASES))
def test_value_network_matches_jax(case):
    kwargs = dict(VALUE_CASES[case])
    layers = kwargs.pop("mlp_layer_dims", LAYERS)
    obs, acts = _inputs(0)
    if case == "value":
        jm = JaxValueNets.ValueNetwork(obs_shapes=SHAPES, mlp_layer_dims=layers)
        pm = PortValueNets.ValueNetwork({"flat": (O,)}, mlp_layer_dims=layers)
    elif case == "distributional":
        jm = JaxValueNets.DistributionalActionValueNetwork(
            obs_shapes=SHAPES, mlp_layer_dims=layers, **kwargs)
        pm = PortValueNets.DistributionalActionValueNetwork(
            {"flat": (O,)}, mlp_layer_dims=layers, **kwargs)
    else:
        jm = JaxValueNets.ActionValueNetwork(obs_shapes=SHAPES, mlp_layer_dims=layers,
                                             **kwargs)
        pm = PortValueNets.ActionValueNetwork({"flat": (O,)}, mlp_layer_dims=layers,
                                              **kwargs)
    with jax.enable_x64():
        jo, ja = {"flat": jnp.asarray(obs)}, jnp.asarray(acts)
        args = (jo,) if case == "value" else (jo, ja)
        params = _carry(jm, pm, args)
        want = np.asarray(jm.apply(params, *args))
        if case == "distributional":
            want_lp, want_atoms = jm.apply(params, jo, ja, method=jm.forward_train)
    to = {"flat": torch.tensor(obs)}
    with torch.no_grad():
        got = pm(to) if case == "value" else pm(to, torch.tensor(acts))
        assert got.shape == (B, 1)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-10)
        if case == "distributional":
            lp, atoms = pm.forward_train(to, torch.tensor(acts))
            np.testing.assert_allclose(lp.numpy(), np.asarray(want_lp), rtol=0, atol=1e-10)
            np.testing.assert_allclose(atoms.numpy(), np.asarray(want_atoms), rtol=0,
                                       atol=1e-13)
    if case != "value":
        # the split forward: features once, the head over two action sets
        with torch.no_grad():
            feats = pm.features(to)
            for a in (torch.tensor(acts), -torch.tensor(acts)):
                np.testing.assert_array_equal(pm.head(feats, a).numpy(), pm(to, a).numpy())


def test_perturbation_actor_matches_jax():
    obs, acts = _inputs(1)
    jm = JaxBCQ.PerturbationActor(obs_shapes=SHAPES, ac_dim=A, layer_dims=LAYERS,
                                  perturbation_scale=0.3)
    pm = PortBCQ.PerturbationActor({"flat": (O,)}, A, layer_dims=LAYERS,
                                   perturbation_scale=0.3)
    with jax.enable_x64():
        args = ({"flat": jnp.asarray(obs)}, jnp.asarray(acts))
        params = _carry(jm, pm, args)
        want = np.asarray(jm.apply(params, *args))
    with torch.no_grad():
        got = pm({"flat": torch.tensor(obs)}, torch.tensor(acts)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
    assert np.abs(got - acts).max() <= 0.3 + 1e-12


# ---------------------------------------------------------------------------
# the tanh-wrapped distributions
# ---------------------------------------------------------------------------

def _gaussian(seed):
    rng = np.random.RandomState(seed)
    return rng.randn(B, A) * 0.7, rng.uniform(0.2, 1.3, (B, A))


@pytest.mark.parametrize("scale", [1.0, 2.0])
def test_tanh_wrapped_gaussian_matches_jax(scale):
    mean, std = _gaussian(2)
    rng = np.random.RandomState(3)
    eps = rng.randn(4, B, A)
    values = np.tanh(rng.randn(B, A)) * scale * 0.999
    with jax.enable_x64():
        jd = JaxDist.TanhWrappedGaussian(
            base=JaxDist.DiagGaussian(mean=jnp.asarray(mean), scale=jnp.asarray(std)),
            scale=scale)
        want_sample, want_pre = jd.rsample_with_pretanh(None, sample_shape=(4,),
                                                        eps=jnp.asarray(eps))
        want_lp_pre = jd.log_prob(want_sample, want_pre)
        want_lp = jd.log_prob(jnp.asarray(values))
        want_one, want_one_pre = jd.rsample_with_pretanh(None, eps=jnp.asarray(eps[0]))
    pd = PortDist.TanhWrappedGaussian(
        base=PortDist.DiagGaussian(mean=torch.tensor(mean), scale=torch.tensor(std)),
        scale=scale)
    sample, pre = pd.rsample_with_pretanh((4,), eps=torch.tensor(eps))
    for got, want in ((sample, want_sample), (pre, want_pre),
                      (pd.log_prob(sample, pre), want_lp_pre),
                      (pd.log_prob(torch.tensor(values)), want_lp),
                      (pd.rsample_with_pretanh(eps=torch.tensor(eps[0]))[0], want_one),
                      (pd.rsample_with_pretanh(eps=torch.tensor(eps[0]))[1], want_one_pre)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-10)
    np.testing.assert_array_equal(pd.mean.numpy(), mean)
    # a value on the boundary: atanh through the clamped 1 +- v, still finite
    edge = torch.full((B, A), scale)
    assert torch.isfinite(pd.log_prob(edge)).all()


@pytest.mark.parametrize("scale", [1.0, 2.0])
def test_tanh_wrapped_gmm_matches_jax(scale):
    rng = np.random.RandomState(4)
    means, scales = rng.randn(B, 4, A) * 0.6, rng.uniform(0.2, 1.0, (B, 4, A))
    logits, values = rng.randn(B, 4), np.tanh(rng.randn(B, A)) * scale * 0.99
    with jax.enable_x64():
        jd = JaxDist.TanhWrappedGMM(base=JaxDist.GMMActionDistribution(
            means=jnp.asarray(means), scales=jnp.asarray(scales),
            logits=jnp.asarray(logits)), scale=scale)
        want = np.asarray(jd.log_prob(jnp.asarray(values)))
    pd = PortDist.TanhWrappedGMM(base=PortDist.GMMActionDistribution(
        means=torch.tensor(means), scales=torch.tensor(scales),
        logits=torch.tensor(logits)), scale=scale)
    np.testing.assert_allclose(pd.log_prob(torch.tensor(values)).numpy(), want, rtol=0,
                               atol=1e-10)
    mode, eps = torch.tensor(rng.randint(0, 4, B)), torch.tensor(rng.randn(B, A))
    np.testing.assert_array_equal(
        pd.sample(mode=mode, eps=eps).numpy(),
        (torch.tanh(pd.base.sample(mode=mode, eps=eps)) * scale).numpy())


@pytest.mark.parametrize("train", [True, False])
def test_gaussian_actor_with_use_tanh_matches_jax(train):
    obs, acts = _inputs(5)
    kwargs = dict(ac_dim=A, mlp_layer_dims=LAYERS, std_activation="exp",
                  init_last_fc_weight=0.001, use_tanh=True)
    jm = JaxPolicyNets.GaussianActorNetwork(obs_shapes=SHAPES, **kwargs)
    pm = PortPolicyNets.GaussianActorNetwork({"flat": (O,)}, **kwargs)
    with jax.enable_x64():
        jo = {"flat": jnp.asarray(obs)}
        params = _carry(jm, pm, (jo,))
        jd = jm.apply(params, jo, train=train)
        want_mean, want_scale = np.asarray(jd.base.mean), np.asarray(jd.base.scale)
        want_lp = np.asarray(jd.log_prob(jnp.asarray(acts)))
    pm.train(train)
    with torch.no_grad():
        pd = pm({"flat": torch.tensor(obs)})
    assert isinstance(pd, PortDist.TanhWrappedGaussian)
    np.testing.assert_allclose(pd.base.mean.numpy(), want_mean, rtol=0, atol=1e-10)
    np.testing.assert_allclose(pd.base.scale.numpy(), want_scale, rtol=0, atol=1e-12)
    np.testing.assert_allclose(pd.log_prob(torch.tensor(acts)).numpy(), want_lp,
                               rtol=1e-10, atol=1e-8)
    # the action of CQL's get_action: tanh of the untanh'd mean
    np.testing.assert_allclose(torch.tanh(pd.mean).numpy(), np.tanh(want_mean), rtol=0,
                               atol=1e-10)


# ---------------------------------------------------------------------------
# the C51 projection
# ---------------------------------------------------------------------------

def _projection_case(kind, atoms, rng):
    n = 7
    probs = rng.rand(B, n)
    probs /= probs.sum(1, keepdims=True)
    if kind == "random":
        values = rng.uniform(atoms[0], atoms[-1], (B, n))
    elif kind == "on_atoms":
        values = atoms[rng.randint(0, len(atoms), (B, n))]
    elif kind == "clipped":
        values = rng.uniform(atoms[0] - 5.0, atoms[-1] + 5.0, (B, n))
        values[:, 0], values[:, 1] = atoms[0] - 1.0, atoms[-1] + 1.0
    else:   # a Bellman target: r + gamma (1 - done) atoms
        r, done = rng.randn(B, 1), (rng.rand(B, 1) < 0.3).astype(np.float64)
        values = r + 0.99 * (1.0 - done) * atoms[None]
        probs = rng.rand(B, len(atoms))
        probs /= probs.sum(1, keepdims=True)
    return values, probs


@pytest.mark.parametrize("kind", ["random", "on_atoms", "clipped", "bellman"])
def test_project_values_onto_atoms_matches_jax(kind):
    rng = np.random.RandomState(6)
    with jax.enable_x64():
        atoms = np.asarray(jnp.linspace(-5.0, 5.0, ATOMS))
        values, probs = _projection_case(kind, atoms, rng)
        want = np.asarray(JaxLossUtils.project_values_onto_atoms(
            jnp.asarray(values), jnp.asarray(probs), jnp.asarray(atoms)))
    got = PortLossUtils.project_values_onto_atoms(
        torch.tensor(values), torch.tensor(probs), torch.tensor(atoms)).numpy()
    assert got.shape == (B, ATOMS)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.sum(1), 1.0, atol=1e-9)
    if kind == "on_atoms":
        # each value gives its whole mass to its own atom
        direct = np.zeros_like(got)
        idx = np.rint((values - atoms[0]) / (atoms[1] - atoms[0])).astype(int)
        for i in range(B):
            np.add.at(direct[i], idx[i], probs[i])
        np.testing.assert_allclose(got, direct, rtol=0, atol=1e-12)
