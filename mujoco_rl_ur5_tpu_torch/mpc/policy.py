"""MPC as the pick policy: plan with GraspMPC, execute through the full
contact scene. The port's counterpart of the JAX package's mpc/policy.py.

Where the reference moves the arm with IK and serial PID tolerance loops,
this module scripts the same pick with iLQR plans:

  * the arm actuators follow the plan: at each knot
    ``u = clip(u_k + K_k ((x - x_k) * fb))``, TVLQR feedback around the
    optimized trajectory, replanned once per move. The plan lives on the
    contact-free arm submodel (scene/reduce.py), as the reference's IK
    chain ignores the objects;
  * the gripper actuator keeps the reference's PID law (0.0 open-half,
    -0.4 close) every physics step: finger-object contact is what the plan
    cannot represent, and the reference's grasp test ("the fingers did NOT
    converge") is defined by that law's fixed point.

The feedback mask ``fb`` keeps the arm dofs only: the fingers leave the
plan as soon as they touch an object, and that error must not reach the
arm torques. ``hold`` drives the whole bank with the reference gains
(``reference_gains``), whatever gains an environment has changed.

Every state carries a leading batch axis B. ``move_to`` plans the B moves
with ``GraspMPC.track_batch`` (one batched solve through the chain
kernels and the Riccati kernel: the JAX package's own batched route for
the problem it vmaps as per-instance ``track``); the execution's contact
steps run through the collide kernels. On the CPU every kernel wrapper
takes its plain version.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from mujoco_rl_ur5_tpu_torch.control.ik import ArmChain, ik_solve
from mujoco_rl_ur5_tpu_torch.control.pid import (
    PIDState, pid_init, pid_output, reference_gains,
)
from mujoco_rl_ur5_tpu_torch.mpc.grasp_mpc import GraspMPC
from mujoco_rl_ur5_tpu_torch.mpc.ilqr import ILQRResult
from mujoco_rl_ur5_tpu_torch.physics import constraints, dynamics
from mujoco_rl_ur5_tpu_torch.scene.model import Model, State, resolve_device

# the gripper's setpoints: open-half and close
GRIP_OPEN = 0.0
GRIP_CLOSE = -0.4


@dataclass(eq=False)
class PickResult:
    state: State            # the full scene after the pick
    pid: PIDState           # the PID bank's state (for chaining)
    grasped: torch.Tensor   # (B,) bool: the fingers blocked
    ee_err: torch.Tensor    # (B,) the last move's end-effector error [m]

    def replace(self, **kw) -> "PickResult":
        return dataclasses.replace(self, **kw)


class MPCGraspPolicy:
    """Execute GraspMPC plans on a full contact scene on ``device``.

    ``mpc`` plans on the arm submodel (on the same device); ``model`` is
    the scene the plans are executed through, with the contact step's
    ``ncon`` and ``iterations``."""

    def __init__(self, model: Model, mpc: GraspMPC, ncon: int = 64,
                 iterations: Optional[int] = None, device="cuda"):
        self.device = resolve_device(device, "MPCGraspPolicy")
        if mpc.device != self.device:
            raise ValueError(f"MPCGraspPolicy on {self.device}: the GraspMPC "
                             f"plans on {mpc.device}")
        self.model = model.to(self.device)
        self.mpc = mpc
        t = model.topo
        self.ncon = ncon
        self.iterations = (int(t.iterations) if iterations is None
                           else iterations)
        self.nu = int(t.nu)
        self.dt = float(t.timestep)
        self.gains = reference_gains(device=self.device)
        # feedback mask: the arm dofs only (see the module docstring)
        nq = mpc.nq
        arm_jnt = [i for i, n in enumerate(mpc.arm.topo.joint_names)
                   if "ik" not in n]            # base_to_lik / base_to_rik
        fb = np.zeros(2 * nq, np.float32)
        fb[arm_jnt] = 1.0
        fb[[nq + i for i in arm_jnt]] = 1.0
        self.fb_mask = fb
        self.arm_act = np.asarray(arm_jnt, np.int64)
        self.grip_act = np.asarray(
            [i for i in range(self.nu) if i not in arm_jnt], np.int64)
        act_qadr = np.asarray(t.jnt_qposadr)[np.asarray(t.act_jnt)]
        self.grip_qadr = act_qadr[self.grip_act]
        self._qadr = torch.as_tensor(act_qadr, device=self.device)
        self._chain = ArmChain(model)

    def _const(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device=self.device)

    def _pid_step(self, st, ps, warm, sp, arm_u=None):
        """One physics step: the PID bank toward ``sp`` (B, nu) and, with
        ``arm_u``, the plan's controls on every channel but the gripper."""
        q = st.qpos[:, self._qadr]
        u, ps = pid_output(self.gains, ps, sp, q, self.dt)
        if arm_u is not None:
            ctrl = arm_u.clone()
            ctrl[:, self.grip_act] = u[:, self.grip_act]
            u = ctrl
        st, warm = dynamics.step_warm(self.model, st.replace(ctrl=u), warm,
                                      ncon=self.ncon,
                                      iterations=self.iterations)
        return st, ps, warm

    # -- plan execution -------------------------------------------------------

    def execute(self, state: State, pid: PIDState, res: ILQRResult,
                grip_sp: torch.Tensor):
        """Roll the full scene through the plans ``res`` (batched: us
        (B, H, nu), xs (B, H+1, nx), gains.K (B, H, nu, nx)): H knots x
        substeps steps. The arm channels take u_k + K_k (x - x_k) at each
        knot; the gripper takes the reference PID toward ``grip_sp`` (B,)
        every step. Returns (State, PIDState)."""
        m = self.mpc
        fb = self._const(self.fb_mask)
        u_lo, u_hi = self._const(m.u_lo), self._const(m.u_hi)
        st, ps = state, pid
        warm = constraints.init_warm(self.model, state)
        for k in range(res.us.shape[1]):
            dx = (m.x_from_state(st.qpos, st.qvel) - res.xs[:, k]) * fb
            u_arm = torch.clamp(res.us[:, k] + (res.gains.K[:, k]
                                                @ dx[..., None])[..., 0],
                                u_lo, u_hi)
            for _ in range(m.substeps):
                sp = st.qpos[:, self._qadr].clone()
                sp[:, self.grip_act] = grip_sp[:, None]
                st, ps, warm = self._pid_step(st, ps, warm, sp, u_arm)
        return st, ps

    def move_to(self, state: State, pid: PIDState, target: torch.Tensor,
                grip_sp: torch.Tensor, wrist=None, fallback=None):
        """Plan moves to the world grasp-centre targets (B, 3) and execute
        them: H x substeps physics steps. ``wrist`` (B,) pins wrist_3's
        reference (the rotation action); ``fallback`` (B, 3) is a second
        IK target taken where the first misses the 0.02 m gate. The plan
        tracks a smoothstep joint ramp from the current pose to the IK
        solution (zero end slope, so the next move does not inherit the
        ramp's speed). Returns (State, PIDState, end-effector error (B,))."""
        m = self.mpc
        x0 = m.x_from_state(state.qpos, state.qvel)
        B, f = x0.shape[0], x0.dtype
        target = target.to(f)
        if fallback is None:
            q5, _, ok = ik_solve(self.model, self._chain, target, state.qpos)
        else:
            q, _, oks = ik_solve(self.model, self._chain,
                                 torch.cat([target, fallback.to(f)]),
                                 torch.cat([state.qpos, state.qpos]))
            ok, okc = oks.split(B)
            q5 = torch.where(ok[:, None], q[:B], q[B:])
            ok = ok | okc
        q0 = x0[:, : m.nq]
        n5 = q5.shape[-1]
        qt = q0.clone()
        qt[:, :n5] = torch.where(ok[:, None], q5, q0[:, :n5])
        if wrist is not None:
            qt[:, 5] = wrist
        s = torch.linspace(0.0, 1.0, m.H + 1, dtype=f,
                           device=self.device)[:, None]
        a = s * s * (3.0 - 2.0 * s)
        q_refs = q0[:, None] * (1 - a) + qt[:, None] * a
        T = m.H * m.substeps * self.dt
        qd_refs = (qt - q0)[:, None] * (6.0 * s * (1.0 - s)) / T
        res = m.track_batch(x0, q_refs, qd_refs)
        st, ps = self.execute(state, pid, res, grip_sp)
        ee = m.ee_pos(m.x_from_state(st.qpos, st.qvel)[:, : m.nq])
        return st, ps, torch.linalg.vector_norm(ee - target, dim=-1)

    def hold(self, state: State, pid: PIDState, grip_sp: torch.Tensor,
             steps: int):
        """Hold the arm at its entry pose for ``steps`` physics steps while
        the gripper drives to ``grip_sp`` (B,): the whole bank on the
        reference PID law. Returns (State, PIDState)."""
        sp = state.qpos[:, self._qadr].clone()
        sp[:, self.grip_act] = grip_sp[:, None]
        st, ps = state, pid
        warm = constraints.init_warm(self.model, state)
        for _ in range(steps):
            st, ps, warm = self._pid_step(st, ps, warm, sp)
        return st, ps

    # -- the scripted pick ----------------------------------------------------

    def pick(self, state: State, coords: torch.Tensor,
             close_steps: int = 250) -> PickResult:
        """One MPC-driven pick per scenario: pre-grasp above ``coords``
        (B, 3) at z = 1.1, descend to max(0.91, z - 0.01), stay, close,
        lift back to z = 1.1. ``grasped``: the fingers did NOT converge to
        the close setpoint (the reference's convention)."""
        B, f = coords.shape[0], state.qpos.dtype
        coords = coords.to(self.device, f)
        pid = pid_init(self.nu, B, f, self.device)
        pre, low = coords.clone(), coords.clone()
        pre[:, 2] = 1.1
        low[:, 2] = torch.clamp_min(coords[:, 2] - 0.01, 0.91)
        open_sp = torch.full((B,), GRIP_OPEN, dtype=f, device=self.device)
        close_sp = torch.full_like(open_sp, GRIP_CLOSE)
        st, pid, _ = self.move_to(state, pid, pre, open_sp)
        st, pid, _ = self.move_to(st, pid, low, open_sp)
        # stay 100 ms before closing: the descent's residual speed at the
        # fingertips ejects the object otherwise
        st, pid = self.hold(st, pid, open_sp, 50)
        st, pid = self.hold(st, pid, close_sp, close_steps)
        st, pid, ee_err = self.move_to(st, pid, pre, close_sp)
        q_grip = st.qpos[:, self.grip_qadr]
        grasped = ((q_grip - GRIP_CLOSE).abs() > 0.01).all(-1)
        return PickResult(state=st, pid=pid, grasped=grasped, ee_err=ee_err)
