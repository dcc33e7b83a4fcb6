"""The port's FiLM and Bottleneck trunks against the JAX package's in
training, in float64 at 40 x 40, B = 2, as tests/test_torch_vision_cores.py
holds the others (``check_trunk``: outputs, BatchNorm statistics and
gradients within 1e-9): ResNet-34 with FiLM, ResNet-50 (MCR's encoder),
ResNet-50 with FiLM after every Bottleneck (4 x the block's width), and
ResNet-18 FiLM with the language cross-attention, whose ``q`` and ``k``
get zero gradients on both sides (a softmax over one key is exactly 1)."""

import numpy as np
import pytest

from robot_manipulation_vq_vae_tpu.models import base_nets as JaxBaseNets

from robot_manipulation_vq_vae_tpu_torch.models import base_nets as PortBaseNets
from test_torch_vision_cores import LANG, check_trunk

TRUNKS = {
    "resnet34_film": (JaxBaseNets.ResNet34ConvFiLM,
                      lambda: PortBaseNets.ResNet34ConvFiLM(lang_emb_dim=LANG), True),
    "resnet50": (JaxBaseNets.ResNet50Conv, PortBaseNets.ResNet50Conv, False),
    "resnet50_film": (JaxBaseNets.ResNet50ConvFiLM,
                      lambda: PortBaseNets.ResNet50ConvFiLM(lang_emb_dim=LANG), True),
    "resnet18_film_cross_attn": (
        JaxBaseNets.ResNet18ConvFiLMCrossAttn,
        lambda: PortBaseNets.ResNet18ConvFiLMCrossAttn(lang_emb_dim=LANG), True),
}


@pytest.mark.parametrize("name", list(TRUNKS))
def test_trunk_training_forward_matches_jax(name):
    port, grads = check_trunk(*TRUNKS[name])
    if name.startswith("resnet50"):
        blocks = [m for m in port.modules() if isinstance(m, PortBaseNets.Bottleneck)]
        assert len(blocks) == 16 and blocks[0].conv3.weight.shape[0] == 256
    if name == "resnet50_film":
        assert [port._film_layers[i].lang_proj.out_features for i in (0, 3, 7, 13)] == [
            512, 1024, 2048, 4096]
    if name == "resnet18_film_cross_attn":
        for n in ("q", "k"):
            assert not np.asarray(grads[n]["kernel"]).any()
            assert getattr(port, n).weight.grad is None
