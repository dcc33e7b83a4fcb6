"""``icl_gmm_paper`` with the bin and the LN-act tokenizers: 3
``train_on_batch`` steps against the JAX package's in float64, the served
GMM, validation and the ``.pth`` round trip (``torch_icl_modality_harness``
says how and to what tolerance). Also the modality dispatch."""

import pytest

import torch_icl_modality_harness as H
from robot_manipulation_vq_vae_tpu_torch.config import config_factory
from robot_manipulation_vq_vae_tpu_torch.models.tokenizers import (
    AdaptiveBinActionEmbedding,
    DefaultActionEncoder,
    FastProjection,
    LipVQVAE,
    LNActEncoder,
)


@pytest.fixture(scope="module", params=["bin", "ln_act"])
def run(request):
    with pytest.MonkeyPatch.context() as mp:
        yield H.run_modality(request.param, mp)


@pytest.mark.parametrize("step", range(H.STEPS))
def test_step_metrics_match_jax(run, step):
    H.check_step_metrics(run, step)


def test_parameters_after_three_steps_match_jax(run):
    H.check_parameters(run)


def test_tokenizer_buffers_after_three_steps_match_jax(run):
    H.check_buffers(run)


def test_get_action_gmm_matches_jax(run):
    H.check_gmm(run)


def test_validate_changes_nothing(run):
    H.check_validate(run)


def test_pth_round_trip_is_bit_equal(run):
    H.check_round_trip(run)


@pytest.mark.parametrize("modality,cls", [
    ("bin", AdaptiveBinActionEmbedding), ("ln_act", LNActEncoder),
    ("fast", FastProjection), ("default", DefaultActionEncoder)])
def test_each_flag_builds_its_tokenizer_without_lipvq(modality, cls):
    algo = H.port_algo(modality)
    assert type(algo.nets["policy"].net.encoder.action_network) is cls
    assert set(algo.optimizers) == {"policy"}


def test_lipvq_keeps_its_optimizer():
    cfg = H.configure(config_factory("icl_gmm_paper"), "default")
    with cfg.values_unlocked():
        cfg.algo.transformer.vq_vae_enabled = True
    algo = H.PortAlgo.algo_factory("icl_gmm_paper", cfg, dict(H.LOW_DIM), H.A,
                                   device="cpu")
    assert isinstance(algo.nets["policy"].net.encoder.action_network, LipVQVAE)
    assert set(algo.optimizers) == {"policy", "vq_tokenizer"}


def test_two_modalities_raise():
    cfg = H.configure(config_factory("icl_gmm_paper"), "bin")
    with cfg.values_unlocked():
        cfg.algo.transformer.ln_act_enabled = True
    with pytest.raises(ValueError, match="at most one tokenizer modality"):
        H.PortAlgo.algo_factory("icl_gmm_paper", cfg, dict(H.LOW_DIM), H.A,
                                device="cpu")


def test_fast_without_a_host_stage_raises_as_jax_does(monkeypatch):
    monkeypatch.delenv("RMVQ_FAST_PROCESSOR_DIR", raising=False)
    algo = H.port_algo("default")
    algo.fast_enabled = True
    with pytest.raises(RuntimeError, match="RMVQ_FAST_PROCESSOR_DIR"):
        algo._get_fast_tokenizer()
