"""mujoco_rl_ur5_tpu_torch: the PyTorch/CUDA port of mujoco_rl_ur5_tpu.

A second package beside the JAX one, written for one NVIDIA H100. It holds
the batched grasp-MPC (reach and track), the batched contact step, the
RGB-D observation, the grasping and reacher environments with their
gymnasium wrapper, the grasp-DQN that learns on them, its data- and
tensor-parallel layer, and what they stand on:

  scene/    MJCF parser and compiler (primitive and mesh geoms, STL meshes
            and their hulls, cylinder prism hulls, contact pairs,
            invweights, cameras, colours), arm reduction, State
  ops/      unrolled small-block Cholesky solves, quaternion and spatial
            algebra, device-resident constant tables
  physics/  chain dynamics and the generated-substep CUDA kernels
            (cuda_chain.py); batched kinematics, dynamics, the plain
            narrowphase, the contact solver, and the narrowphase kernels
            box_box, hull_hull, box_hull, plane_hull, sphere_hull and
            capsule_hull (cuda_collide.py)
  render/   the camera, the batched ray-cast RGB-D renderer and its
            ray-cast kernel (cuda_raycast.py)
  mpc/      Riccati backward (torch and the CUDA kernel), the batched and
            the generic iLQR, GraspMPC, and the MPC pick policy
            (policy.py: MPCGraspPolicy)
  control/  the PID bank, batched IK and the Controller's motion
            primitives (masked tolerance loops over the contact step)
  env/      the batched grasping environment GraspEnv: reset, the
            13-phase pick (step) and the MPC pick (step_mpc); the reacher
            ReacherEnv (reach_ik); the gymnasium wrapper GrasperEnv
            ("mujoco_rl_ur5_tpu_torch/Grasper-v0")
  learn/    the grasp Q-network (MultidiscreteResnet, Flax's layout and
            BatchNorm), the device-resident replay ring, the
            shortsighted-DQN GraspAgent, normalization statistics, the
            online Trainer and the offline pipeline (shards, dataset,
            train_offline, generate)
  utils/    decorators (timer, torch_trace, ...), the MetricsTracker with
            the reference's tensorboard tags, the Config tree
  parallel/ ("data", "model") meshes over torch.distributed ranks, batch
            sharding, the data-parallel learner and env steps, the
            tensor-parallel placement, process-group start-up
  examples/ the controller walkthrough and the random gymnasium agent
  csrc/     the kernels' CUDA sources, built by _build.py with nvcc
  assets/   ur5_2finger_arm.xml (the 8-dof arm scene),
            ur5_2finger_pile.xml (the arm, a bin and 40 free boxes and
            cylinders), written by hand, and ur5_2finger_objects.xml (the
            reference pile's 10 spheres, 10 boxes, 10 cylinders and 10
            capsules, mesh finger pads finger_pad.stl, a top_down and a
            side camera), written by make_objects.py, and
            ur5_2finger_reacher.xml (the arm and a target on three slide
            joints), written by hand

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

    from mujoco_rl_ur5_tpu_torch.physics.kinematics import fk
    from mujoco_rl_ur5_tpu_torch.render.camera import make_camera
    from mujoco_rl_ur5_tpu_torch.render.raycast import render_rgbd
    model = load_model(OBJECTS)
    cam = make_camera(model, "top_down", 200, 200)
    rgb, depth = render_rgbd(model, fk(model, state.qpos), cam)

    import torch
    from mujoco_rl_ur5_tpu_torch.env import GraspEnv
    env = GraspEnv(load_model(OBJECTS), ncon=128, iterations=30,
                   mpc=GraspMPC.from_scene(OBJECTS, horizon=16))
    es = env.reset(torch.Generator(device="cuda").manual_seed(0), 64)
    es, reward, done, info = env.step(es, actions)     # (B, 2) [pixel, rot]
    es, reward, done, info = env.step_mpc(es, actions)

    from mujoco_rl_ur5_tpu_torch.control import Controller
    ctl = Controller(model)                 # move_group, move_ee, grasp, ...

    from mujoco_rl_ur5_tpu_torch.learn import Trainer
    from mujoco_rl_ur5_tpu_torch.utils import Config
    ts, replay = Trainer(Config()).run()    # episodes of reset, eps-greedy,
                                            # env.step, replay, learn
    # or: python -m mujoco_rl_ur5_tpu_torch.learn.train --budget-scale 0.01

    from mujoco_rl_ur5_tpu_torch.env import ReacherEnv
    renv = ReacherEnv(load_model(REACHER))
    es, info = renv.reach_ik(renv.reset(torch.Generator(device="cuda"), 64))

    import gymnasium                        # registers the port's id
    from mujoco_rl_ur5_tpu_torch.env import gym_wrapper
    env = gymnasium.make(gym_wrapper.ENV_ID, image_width=64,
                         image_height=64)   # device="cuda" by default

    # python -m mujoco_rl_ur5_tpu_torch.examples.example --budget-scale 0.05

The package imports torch and numpy, never jax, flax, optax or orbax, and
nothing of mujoco_rl_ur5_tpu.
"""

import os

ASSET = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets",
                     "ur5_2finger_arm.xml")
PILE = os.path.join(os.path.dirname(ASSET), "ur5_2finger_pile.xml")
OBJECTS = os.path.join(os.path.dirname(ASSET), "ur5_2finger_objects.xml")
REACHER = os.path.join(os.path.dirname(ASSET), "ur5_2finger_reacher.xml")
