from robot_manipulation_vq_vae_tpu_torch.algo.algo import (
    REGISTERED_ALGOS,
    algo_factory,
    register_algo_factory_func,
)
from robot_manipulation_vq_vae_tpu_torch.algo.icl import (
    ICLTransformer,
    ICLTransformer_GMM,
    ICLTransformerHVQVAE,
)
