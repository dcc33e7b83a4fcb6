from robot_manipulation_vq_vae_tpu_torch.models.tokenizers.lipvq import (
    LFQQuantizer,
    LipschitzDense,
    LipVQVAE,
)
