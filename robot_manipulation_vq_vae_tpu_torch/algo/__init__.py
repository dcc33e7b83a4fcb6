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
