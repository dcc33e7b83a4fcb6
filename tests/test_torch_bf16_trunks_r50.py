"""The ResNet-50 trunks under ``train.mixed_precision`` (MCR's ResNet-50
and ResNet-50 FiLM, each with BatchNorm on its running statistics, and
ResNet-50 FiLM with BatchNorm in training), held against the JAX trunks on
bf16 casts as tests/test_torch_bf16_trunks.py holds the others, with its
tolerances."""

import pytest

from test_torch_bf16_trunks import check_trunk, check_training_trunk
from torch_bf16_helpers import one_torch_thread  # noqa: F401 (autouse)

TRUNKS = {
    "resnet50": ("ResNet50Conv", {}, False, False),
    "resnet50_film": ("ResNet50ConvFiLM", {}, True, False),
}


@pytest.mark.parametrize("name", list(TRUNKS))
def test_trunk_bf16_matches_jax(name):
    check_trunk(name, TRUNKS)


def test_batch_norm_trunk_in_training_bf16_matches_jax():
    check_training_trunk("ResNet50ConvFiLM")
