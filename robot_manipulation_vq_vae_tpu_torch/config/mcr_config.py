"""The MCR config (copy of the JAX package's ``config/mcr_config.py``): the
BC config with the GMM head on and a ResNet-50 / SpatialSoftmax visual core."""

from robot_manipulation_vq_vae_tpu_torch.config.bc_config import BCConfig


class MCRConfig(BCConfig):
    ALGO_NAME = "mcr"

    def algo_config(self):
        super().algo_config()
        self.algo.gmm.enabled = True

    def observation_config(self):
        super().observation_config()
        self.observation.encoder.rgb.core_class = "VisualCore"
        self.observation.encoder.rgb.core_kwargs.feature_dimension = 64
        self.observation.encoder.rgb.core_kwargs.backbone_class = "ResNet50Conv"
        self.observation.encoder.rgb.core_kwargs.pool_class = "SpatialSoftmax"
