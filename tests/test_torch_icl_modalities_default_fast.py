"""``icl_gmm_paper`` with the default encoder and FAST: 3
``train_on_batch`` steps against the JAX package's in float64, the served
GMM, validation and the ``.pth`` round trip (``torch_icl_modality_harness``
says how and to what tolerance)."""

import pytest

import torch_icl_modality_harness as H
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module", params=["default", "fast"])
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
