"""parallel/ of the PyTorch port: ("data", "model") device meshes over
torch.distributed ranks, batch sharding, the data-parallel learner and env
steps, the tensor-parallel placement, and process-group start-up (the
JAX package's parallel/ names)."""

from mujoco_rl_ur5_tpu_torch.parallel.mesh import (
    make_mesh, shard_batch, replicate, dp_train_step, dp_env_rollout,
    dp_env_reset, tp_param_shardings, tp_place_train_state,
)
from mujoco_rl_ur5_tpu_torch.parallel.distributed import initialize_multihost

__all__ = ["make_mesh", "shard_batch", "replicate", "dp_train_step",
           "dp_env_rollout", "dp_env_reset", "tp_param_shardings",
           "tp_place_train_state", "initialize_multihost"]
