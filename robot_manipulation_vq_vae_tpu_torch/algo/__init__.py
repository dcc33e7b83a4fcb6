from robot_manipulation_vq_vae_tpu_torch.algo.algo import (
    REGISTERED_ALGOS,
    HierarchicalAlgo,
    ICLRolloutPolicy,
    PlannerAlgo,
    PolicyAlgo,
    RolloutPolicy,
    ValueAlgo,
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
from robot_manipulation_vq_vae_tpu_torch.algo.iql import IQL
from robot_manipulation_vq_vae_tpu_torch.algo.td3_bc import TD3_BC
from robot_manipulation_vq_vae_tpu_torch.algo.cql import CQL
from robot_manipulation_vq_vae_tpu_torch.algo.bcq import BCQ, BCQ_GMM, BCQ_Distributional
from robot_manipulation_vq_vae_tpu_torch.algo.gl import GL, GL_VAE, ValuePlanner
from robot_manipulation_vq_vae_tpu_torch.algo.hbc import HBC
from robot_manipulation_vq_vae_tpu_torch.algo.iris import IRIS
from robot_manipulation_vq_vae_tpu_torch.algo.mcr import (
    MCR,
    MCR_GMM,
    MCR_RNN,
    MCR_RNN_GMM,
    MCR_Transformer,
    MCR_Transformer_GMM,
)
