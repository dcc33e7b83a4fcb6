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
)
