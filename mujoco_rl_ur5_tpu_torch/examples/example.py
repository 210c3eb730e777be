"""The controller walkthrough, the port's counterpart of the JAX package's
examples/example.py: show the model's information, move the grasp centre
above the object (recording an Arm move for the trajectory plot), descend,
wait, grasp, lift, toss, settle. One scenario, on the card unless
``--device cpu``.

    python -m mujoco_rl_ur5_tpu_torch.examples.example [--budget-scale S]
        [--device cuda|cpu] [--scene PATH] [--plot PNG] [--skip-toss]

S < 1 shrinks every motion's step budget for a quick run. The toss is 300
raw-torque steps at any S; ``--skip-toss`` leaves it and its settle out.
The trajectory plot needs matplotlib; without it the plot is skipped and
said so.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from mujoco_rl_ur5_tpu_torch import ASSET
from mujoco_rl_ur5_tpu_torch.control import (
    Controller, joint_angle_plot, show_model_info,
)
from mujoco_rl_ur5_tpu_torch.scene.compile import load_model
from mujoco_rl_ur5_tpu_torch.scene.model import make_state


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--budget-scale", type=float, default=1.0)
    p.add_argument("--scene", default=ASSET)
    p.add_argument("--device", default="cuda")
    p.add_argument("--skip-toss", action="store_true",
                   help="leave out the toss (300 steps at any budget)")
    p.add_argument("--plot", default=os.path.join(tempfile.gettempdir(),
                                                  "example_trajectory.png"))
    args = p.parse_args(argv)

    def S(n):
        return max(2, int(round(n * args.budget_scale)))

    model = load_model(args.scene, device=args.device)
    controller = Controller(model, ncon=128, device=args.device)
    dev = controller.device

    def point(*xyz):
        return torch.tensor([xyz], dtype=torch.float32, device=dev)

    # the robot's information (MujocoController.show_model_info)
    show_model_info(model, controller)

    state = make_state(model, 1, device=dev)
    cstate = controller.init(qpos0=state.qpos)

    # the grasp centre above the object
    res = controller.move_ee(state, cstate, point(0.0, -0.6, 0.95),
                             tolerance=0.05, max_steps=S(1000))
    print(f"move_ee -> success={bool(res.success[0])} "
          f"steps={int(res.steps[0])}")

    # a recorded Arm move, for the trajectory plot
    res2, traj = controller.move_group(res.state, res.ctrl, "Arm", None,
                                       tolerance=0.05, max_steps=S(200),
                                       record=True)
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print("matplotlib is not installed: trajectory plot skipped")
    else:
        joint_angle_plot(traj[0, :, :5].cpu().numpy(),
                         res2.ctrl.setpoints[0, :5].cpu().numpy(), 0.05,
                         joint_names=["shoulder_pan", "shoulder_lift",
                                      "elbow", "wrist_1", "wrist_2"],
                         filename=args.plot)

    # down to the object
    res = controller.move_ee(res2.state, res2.ctrl, point(0.0, -0.6, 0.895),
                             tolerance=0.01, max_steps=S(300))
    print(f"descend -> success={bool(res.success[0])}")

    # wait a second
    res = controller.stay(res.state, res.ctrl, 1000.0 * args.budget_scale)

    # grasp (inverted convention: True = an object blocks the fingers)
    res_g = controller.grasp(res.state, res.ctrl, max_steps=S(300))
    print(f"grasp -> object in gripper: {bool(res_g.success[0])}")

    # up again
    res = controller.move_ee(res_g.state, res_g.ctrl, point(0.0, -0.6, 1.0),
                             tolerance=0.05, max_steps=S(1000))

    # throw the object away
    if not args.skip_toss:
        res = controller.toss_it_from_the_ellbow(res.state, res.ctrl,
                                                 settle_steps=S(2000))
        print(f"toss -> settled={bool(res.success[0])}")

    # wait before finishing
    res = controller.stay(res.state, res.ctrl, 2000.0 * args.budget_scale)
    assert np.isfinite(res.state.qpos.cpu().numpy()).all()
    print("Finished.")


if __name__ == "__main__":
    main()
