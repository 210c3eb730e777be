"""mpc/ of the PyTorch port: Riccati backward passes (torch and the CUDA
kernel), the batched iLQR on the fused chain kernels and the generic
per-instance iLQR, GraspMPC and the MPC pick policy.

Exports the JAX package's mpc/ names, each the port's own object:
``ilqr_chain_batch`` lives in ``cuda_ilqr`` (the JAX package's
``pallas_ilqr``).
"""

from mujoco_rl_ur5_tpu_torch.mpc.lqr import (
    LQR, Gains, backward_parallel, backward_sequential, rollout_policy,
)
from mujoco_rl_ur5_tpu_torch.mpc.ilqr import ILQRResult, ilqr
from mujoco_rl_ur5_tpu_torch.mpc.cuda_ilqr import ilqr_chain_batch
from mujoco_rl_ur5_tpu_torch.mpc.grasp_mpc import GraspMPC, MPCWeights
from mujoco_rl_ur5_tpu_torch.mpc.policy import MPCGraspPolicy, PickResult

__all__ = [
    "LQR", "Gains", "backward_sequential", "backward_parallel",
    "rollout_policy", "ILQRResult", "ilqr", "ilqr_chain_batch",
    "GraspMPC", "MPCWeights", "MPCGraspPolicy", "PickResult",
]
