from robot_manipulation_vq_vae_tpu_torch.models.tokenizers.lipvq import (
    LFQQuantizer,
    LipschitzDense,
    LipVQVAE,
)
from robot_manipulation_vq_vae_tpu_torch.models.tokenizers.hvqvae import (
    HierarchicalVQVAE,
    compute_vqvae_loss,
    get_codebook_usage,
)
