from robot_manipulation_vq_vae_tpu_torch.algo.algo import (
    REGISTERED_ALGOS,
    ICLRolloutPolicy,
    PolicyAlgo,
    RolloutPolicy,
    algo_factory,
    register_algo_factory_func,
    rollout_policy_class,
)
from robot_manipulation_vq_vae_tpu_torch.algo.icl import (
    ICL,
    ICLGMM,
    ICLRNN,
    ICLRNN_GMM,
    ICLGaussian,
    ICLTransformer,
    ICLTransformer_GMM,
    ICLTransformerHVQVAE,
)
from robot_manipulation_vq_vae_tpu_torch.algo.icl_mamba import (
    ICLMamba_GMM,
    ICLMambaHVQVAE,
)
from robot_manipulation_vq_vae_tpu_torch.algo.bc import (
    BC,
    BC_GMM,
    BC_RNN,
    BC_RNN_GMM,
    BC_VAE,
    BC_Gaussian,
    BC_Transformer,
    BC_Transformer_GMM,
    ICLVAE,
)
from robot_manipulation_vq_vae_tpu_torch.algo.diffusion_policy import DiffusionPolicyUNet
from robot_manipulation_vq_vae_tpu_torch.algo.act import ACT
