"""mujoco_rl_ur5_tpu_torch: the PyTorch/CUDA port of mujoco_rl_ur5_tpu.

A second package beside the JAX one, written for one NVIDIA H100. It holds
the batched grasp-MPC (reach and track) and the batched contact step, and
what they stand on:

  scene/    MJCF parser and compiler (primitive geoms, cylinder prism
            hulls, contact pairs, invweights), arm reduction, State
  ops/      unrolled small-block Cholesky solves, quaternion and spatial
            algebra, device-resident constant tables
  physics/  chain dynamics and the generated-substep CUDA kernels
            (cuda_chain.py); batched kinematics, dynamics, the plain
            narrowphase, the contact solver, and the narrowphase kernels
            box_box, hull_hull, box_hull, plane_hull (cuda_collide.py)
  mpc/      Riccati backward (torch and the CUDA kernel), the batched and
            the generic iLQR, GraspMPC
  csrc/     the kernels' CUDA sources, built by _build.py with nvcc
  assets/   ur5_2finger_arm.xml (the 8-dof arm scene) and
            ur5_2finger_pile.xml (the arm, a bin and 40 free boxes and
            cylinders), written by hand

Entry points::

    from mujoco_rl_ur5_tpu_torch.mpc.grasp_mpc import GraspMPC
    mpc = GraspMPC.from_scene(ASSET, horizon=64, substeps=8, iters=6)
    res = mpc.solve_batch_x(x0, targets)   # runs on "cuda" by default

    from mujoco_rl_ur5_tpu_torch.physics import constraints, dynamics
    from mujoco_rl_ur5_tpu_torch.scene.compile import load_model
    from mujoco_rl_ur5_tpu_torch.scene.model import make_state
    model = load_model(PILE)                # on "cuda" by default
    state = make_state(model, 4096)         # device="cpu" for both: the
                                            # plain versions on the CPU
    warm = constraints.init_warm(model, state)
    state, warm = dynamics.step_warm(model, state, warm, ncon=128,
                                     iterations=100)

The package imports torch and numpy, never jax, and nothing of
mujoco_rl_ur5_tpu.
"""

import os

ASSET = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets",
                     "ur5_2finger_arm.xml")
PILE = os.path.join(os.path.dirname(ASSET), "ur5_2finger_pile.xml")
