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
from robot_manipulation_vq_vae_tpu_torch.models.tokenizers.bin_action import (
    AdaptiveBinActionEmbedding,
)
from robot_manipulation_vq_vae_tpu_torch.models.tokenizers.ln_act import (
    LNActEncoder,
    MambaBlock,
)
from robot_manipulation_vq_vae_tpu_torch.models.tokenizers.default_encoder import (
    DefaultActionEncoder,
    SNDense,
)
from robot_manipulation_vq_vae_tpu_torch.models.tokenizers.fast import (
    FastHostEncoder,
    FastProjection,
)
