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
from robot_manipulation_vq_vae_tpu_torch.config.iql_config import IQLConfig
from robot_manipulation_vq_vae_tpu_torch.config.td3_bc_config import TD3_BCConfig
from robot_manipulation_vq_vae_tpu_torch.config.cql_config import CQLConfig
from robot_manipulation_vq_vae_tpu_torch.config.bcq_config import BCQConfig
