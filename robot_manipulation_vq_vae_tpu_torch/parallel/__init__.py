from robot_manipulation_vq_vae_tpu_torch.parallel.mesh import (
    AxisComm,
    LocalBatch,
    make_mesh,
    batch_sharding,
    replicated,
    shard_batch,
    shard_params,
    shard_state,
    tp_placements,
)
from robot_manipulation_vq_vae_tpu_torch.utils.draws import global_draw, keep_rows
