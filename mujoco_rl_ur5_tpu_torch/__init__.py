"""mujoco_rl_ur5_tpu_torch: the PyTorch/CUDA port of mujoco_rl_ur5_tpu.

A second package beside the JAX one, written for one NVIDIA H100. This
slice holds the batched grasp-MPC tracking solve and what it stands on:

  scene/    MJCF parser and compiler (the arm subset), arm reduction
  ops/      unrolled small-block Cholesky solves
  physics/  chain dynamics (torch) and the generated-substep CUDA kernels
            rollout_open, lin_fd, rollout_closed (cuda_chain.py)
  mpc/      Riccati backward (torch and the CUDA kernel), the batched iLQR
            and GraspMPC.track_batch
  csrc/     the kernels' CUDA sources, built by _build.py with nvcc
  assets/   ur5_2finger_arm.xml, the hand-written 8-dof arm scene

Entry point::

    from mujoco_rl_ur5_tpu_torch.mpc.grasp_mpc import GraspMPC
    mpc = GraspMPC.from_scene(ASSET, horizon=64, substeps=8, iters=6)
    res = mpc.track_batch(x0, q_refs)      # runs on "cuda" by default

The package imports torch and numpy, never jax, and nothing of
mujoco_rl_ur5_tpu.
"""

import os

ASSET = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets",
                     "ur5_2finger_arm.xml")
