"""Model and state introspection and trajectory plots (host-side
diagnostics): the port's counterpart of the JAX package's
control/introspect.py, printing the same text.

  * ``show_model_info``        bodies, joints and limits, actuators and
                               ranges, the IK chain, PID gains, cameras;
  * ``display_current_values`` one scenario's actuated joint positions and
                               velocities (and PID setpoints);
  * ``joint_angle_plot``       per-joint trajectory subplots with the target
                               and +-tolerance bands, saved as a PNG.

The states are batched (B, ...): ``display_current_values`` prints the row
``scenario``, as the JAX function prints its one (unbatched) scenario.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from mujoco_rl_ur5_tpu_torch.control.pid import reference_gains
from mujoco_rl_ur5_tpu_torch.scene.model import Model, State

_PLOT_NUMBER = itertools.count(1)


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def show_model_info(model: Model, controller=None) -> None:
    """Print bodies, joints, actuators, the chain, PID gains, cameras."""
    t = model.topo
    print(f"\nNumber of bodies: {t.nbody}")
    for i, name in enumerate(t.body_names):
        print(f"Body ID: {i}, Body Name: {name}")

    print(f"\nNumber of joints: {t.njnt}")
    jr = _np(model.jnt_range)
    limited = np.isin(np.arange(t.njnt), np.asarray(t.dof_jnt)[
        np.asarray(t.limit_dof, np.int64)])
    for i, name in enumerate(t.joint_names):
        lim = jr[i] if limited[i] else "unlimited"
        print(f"Joint ID: {i}, Joint Name: {name}, Limits: {lim}")

    print(f"\nNumber of Actuators: {t.nu}")
    cr = _np(model.act_ctrlrange)
    for i in range(t.nu):
        jname = t.joint_names[int(t.act_jnt[i])]
        print(f"Actuator ID: {i}, Controlled Joint: {jname}, "
              f"Control Range: {cr[i]}")

    if controller is not None:
        print("\nJoints in kinematic chain: "
              f"{[t.body_names[b] for b in controller.chain.bodies]}")
        print("\nPID Info: \n")
        # the gains live in CtrlState.params at run time: the defaults
        g = reference_gains()
        for i in range(min(t.nu, g.kp.shape[0])):
            jname = t.joint_names[int(t.act_jnt[i])]
            print(f"{jname}: P: {float(g.kp[i])}, I: {float(g.ki[i])}, "
                  f"D: {float(g.kd[i])}, output limits: "
                  f"({float(g.out_lo[i])}, {float(g.out_hi[i])})")

    print("\nCamera Info: \n")
    fovy = _np(model.cam_fovy)
    cpos = _np(model.cam_pos)
    for i, name in enumerate(t.cam_names):
        print(f"Camera ID: {i}, Camera Name: {name}, "
              f"Camera FOV (y, degrees): {fovy[i]}, Position: {cpos[i]}")


def display_current_values(model: Model, state: State, cstate=None,
                           scenario: int = 0) -> None:
    """Print one scenario's joint positions and velocities (and its PID
    setpoints when a CtrlState is given)."""
    t = model.topo
    qpos = _np(state.qpos[scenario])
    qvel = _np(state.qvel[scenario])
    print("\n################################################")
    print("CURRENT JOINT POSITIONS (ACTUATED)")
    print("################################################")
    for i in range(t.nu):
        j = int(t.act_jnt[i])
        print(f"Current angle for joint {t.joint_names[j]}: "
              f"{qpos[t.jnt_qposadr[j]]}")
    print("\n################################################")
    print("CURRENT JOINT VELOCITIES (ACTUATED)")
    print("################################################")
    for i in range(t.nu):
        j = int(t.act_jnt[i])
        print(f"Current velocity for joint {t.joint_names[j]}: "
              f"{qvel[t.jnt_dofadr[j]]}")
    if cstate is not None:
        print("\n################################################")
        print("CURRENT PID SETPOINTS")
        print("################################################")
        sp = _np(cstate.setpoints[scenario])
        for i in range(t.nu):
            j = int(t.act_jnt[i])
            print(f"Setpoint for joint {t.joint_names[j]}: {sp[i]}")


def joint_angle_plot(traj, setpoints, tolerance: float, joint_names=None,
                     filename: str | None = None) -> str:
    """Save per-joint trajectory subplots with the green target and red
    +-tolerance bands. ``traj`` is (T, n) joint angles (one scenario of
    the Controller's ``record``), ``setpoints`` (n,)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    traj, setpoints = _np(traj), _np(setpoints)
    T, n = traj.shape
    if joint_names is None:
        joint_names = [f"joint_{i}" for i in range(n)]
    cols = 3
    rows = -(-n // cols)
    fig = plt.figure(1, figsize=(15, 10))
    plt.subplots_adjust(hspace=0.4, left=0.05, right=0.95, top=0.95,
                        bottom=0.05)
    steps = np.arange(T)
    for i in range(n):
        ax = fig.add_subplot(rows, cols, i + 1)
        ax.plot(steps, traj[:, i])
        ax.set_title(joint_names[i])
        ax.set_xlabel("Steps")
        ax.set_ylabel("Joint angle [rad]")
        ax.axhline(setpoints[i], color="g", linestyle="--")
        ax.axhline(setpoints[i] + tolerance, color="r", linestyle="--")
        ax.axhline(setpoints[i] - tolerance, color="r", linestyle="--")
    if filename is None:
        filename = f"Joint_values_{next(_PLOT_NUMBER)}.png"
    fig.savefig(filename)
    plt.close(fig)
    print(f"Saved trajectory to {filename}.")
    return filename
