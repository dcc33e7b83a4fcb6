from robot_manipulation_vq_vae_tpu_torch.config.config import Config
from robot_manipulation_vq_vae_tpu_torch.config.base_config import (
    BaseConfig,
    config_factory,
    get_all_registered_configs,
    REGISTERED_CONFIGS,
)
from robot_manipulation_vq_vae_tpu_torch.config.icl_config import (
    ICLConfig,
    ICLGMMPaperConfig,
    ICLHVQVAEConfig,
)
from robot_manipulation_vq_vae_tpu_torch.config.icl_mamba_config import ICLMambaConfig
from robot_manipulation_vq_vae_tpu_torch.config.bc_config import BCConfig
from robot_manipulation_vq_vae_tpu_torch.config.diffusion_policy_config import (
    DiffusionPolicyConfig,
)
from robot_manipulation_vq_vae_tpu_torch.config.act_config import ACTConfig
