"""Motion primitives as fixed-horizon masked rollouts: the port's
counterpart of the JAX package's control/controller.py.

The reference's semantics, as there:
  * joint groups "All" = actuators 0-6, "Arm" = 0-4 (wrist_3 excluded),
    "Gripper" = [6];
  * all seven PIDs actuate every physics step, whatever group moves;
  * a move succeeds when every joint of its group is within ``tolerance``
    of its setpoint, checked before the physics step; a scenario that has
    succeeded is not stepped again;
  * ``grasp`` returns success when ``close_gripper`` did NOT converge
    within its steps (an object blocks the fingers: the inverted
    convention);
  * ``stay(ms)`` holds every setpoint for ``ms`` of simulated time,
    ``max(1, round(ms / 1000 / timestep))`` steps.

Where the JAX package writes one scenario and vmaps it, every state here
carries a leading batch axis B, and the tolerance loop is a Python loop
over ``max_steps`` contact steps with a per-scenario ``done`` mask that
freezes converged scenarios; nothing is read back to the host inside it.
The contact step runs where the state lies: on the card through the
collide kernels, on the CPU through their plain versions.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from mujoco_rl_ur5_tpu_torch.control.ik import ArmChain, EE_OFFSET, ik_solve
from mujoco_rl_ur5_tpu_torch.control.pid import (
    PIDParams, PIDState, pid_init, pid_output, reference_gains,
)
from mujoco_rl_ur5_tpu_torch.physics import constraints, dynamics, fk
from mujoco_rl_ur5_tpu_torch.scene.model import Model, State, resolve_device

GROUPS = {"All": (0, 1, 2, 3, 4, 5, 6), "Arm": (0, 1, 2, 3, 4),
          "Gripper": (6,)}


def select(mask: torch.Tensor, a, b):
    """Per-scenario select, field by field: where ``mask`` (B,) is True,
    ``a``'s row, else ``b``'s (tensors, tuples and dataclasses of them)."""
    if isinstance(a, torch.Tensor):
        return torch.where(mask.reshape(mask.shape + (1,) * (a.dim()
                                                             - mask.dim())),
                           a, b)
    if isinstance(a, tuple):
        return tuple(select(mask, x, y) for x, y in zip(a, b))
    return dataclasses.replace(a, **{
        f.name: select(mask, getattr(a, f.name), getattr(b, f.name))
        for f in dataclasses.fields(a)})


@dataclass(eq=False)
class CtrlState:
    """Per-scenario controller state: the PID bank's state, the setpoints
    (B, nu) and the gains (B, nu each; the env changes shoulder_pan's Kp)."""

    pid: PIDState
    setpoints: torch.Tensor
    params: PIDParams

    def replace(self, **kw) -> "CtrlState":
        return dataclasses.replace(self, **kw)


@dataclass(eq=False)
class MoveResult:
    state: State
    ctrl: CtrlState
    success: torch.Tensor    # (B,) bool: tolerance reached within max_steps
    steps: torch.Tensor      # (B,) int32: physics steps integrated
    ik_ok: torch.Tensor = None   # (B,) bool, move_ee only: the IK gate

    def replace(self, **kw) -> "MoveResult":
        return dataclasses.replace(self, **kw)


class Controller:
    """The controller bound to a compiled scene on ``device`` (the card
    unless the caller asks for the CPU; a host model is uploaded once).

    ``iterations=None`` takes the scene's solver iterations (100 in the
    grasp scenes). ``group``, ``tolerance`` and ``max_steps`` are Python
    values at every call site, as the reference's call sites hard-code
    them."""

    def __init__(self, model: Model, ncon: int = 64,
                 iterations: int | None = None, device="cuda"):
        self.device = resolve_device(device, "Controller")
        self.model = model.to(self.device)
        t = model.topo
        self.ncon = ncon
        self.iterations = t.iterations if iterations is None else iterations
        self.act_qadr = np.asarray(t.jnt_qposadr)[np.asarray(t.act_jnt)]
        self.act_dofadr = np.asarray(t.act_dofadr)
        self.nu = t.nu
        self.chain = ArmChain(model)
        self.ee_body = t.body_id("ee_link")
        self.dt = t.timestep
        self.groups = dict(GROUPS)
        self._qadr = torch.as_tensor(self.act_qadr, device=self.device)

    def create_group(self, name: str, actuator_ids) -> None:
        """Define an ad-hoc joint group."""
        ids = tuple(int(i) for i in actuator_ids)
        if len(set(ids)) != len(ids):
            raise ValueError("duplicate actuator ids")
        if not all(0 <= i < self.nu for i in ids):
            raise ValueError("actuator id out of range")
        self.groups[name] = ids

    # -- state constructors -------------------------------------------------

    def init(self, qpos0: torch.Tensor | None = None, batch: int = 1,
             dtype=torch.float32) -> CtrlState:
        """Initial controller state of ``batch`` scenarios (or of qpos0's
        rows): setpoints at the reference's construction defaults, or at
        qpos0's actuated joints."""
        if qpos0 is not None:
            batch = qpos0.shape[0]
            sp = qpos0[:, self._qadr]
        else:
            sp = torch.tensor([0.0, -1.57, 1.57, -1.57, -1.57, 0.0, 0.0],
                              dtype=dtype, device=self.device
                              ).expand(batch, self.nu).clone()
        g = reference_gains(sp.dtype, self.device)
        params = PIDParams(*(getattr(g, f.name).expand(batch, -1).clone()
                             for f in dataclasses.fields(g)))
        return CtrlState(pid=pid_init(self.nu, batch, sp.dtype, self.device),
                         setpoints=sp, params=params)

    def set_kp(self, cstate: CtrlState, actuator: int, value) -> CtrlState:
        """The functional ``controller.actuators[i][4].Kp = value``."""
        kp = cstate.params.kp.clone()
        kp[:, actuator] = value
        return cstate.replace(params=cstate.params.replace(kp=kp))

    def _gmask(self, ids) -> torch.Tensor:
        return torch.as_tensor(np.isin(np.arange(self.nu), ids),
                               device=self.device)

    # -- the motion loop ------------------------------------------------------

    def move_group(self, state: State, cstate: CtrlState, group: str,
                   target, tolerance: float, max_steps: int,
                   record: bool = False):
        """Move one group to ``target`` (B or 1, len(group)); None
        re-converges to the current setpoints. ``record=True`` also returns
        the actuated joints' trajectory (B, max_steps, nu)."""
        ids = list(self.groups[group])
        setpoints = cstate.setpoints
        if target is not None:
            setpoints = setpoints.clone()
            setpoints[:, ids] = torch.as_tensor(
                target, dtype=setpoints.dtype, device=setpoints.device
            ).expand(setpoints.shape[0], len(ids))
        return self._run(state, cstate.replace(setpoints=setpoints),
                         self._gmask(ids), tolerance, max_steps,
                         record=record)

    def _run(self, state: State, cstate: CtrlState, gmask, tolerance,
             max_steps: int, check_tolerance: bool = True,
             record: bool = False, done: torch.Tensor | None = None):
        """The tolerance loop; ``done`` (B,) marks scenarios that start
        done (frozen: the env's skipped phases)."""
        qadr, sp, params = self._qadr, cstate.setpoints, cstate.params
        B = state.qpos.shape[0]
        if done is None:
            done = torch.zeros(B, dtype=torch.bool, device=self.device)
        steps = torch.zeros(B, dtype=torch.int32, device=self.device)
        # each move starts with a cold (zero) solver warm start
        st, ps, warm = state, cstate.pid, constraints.init_warm(self.model,
                                                                state)
        traj = []
        for _ in range(max_steps):
            q = st.qpos[:, qadr]
            ctrl, ps_new = pid_output(params, ps, sp, q, self.dt)
            if check_tolerance:
                deltas = torch.where(gmask, (sp - q).abs(),
                                     torch.zeros_like(q))
                done = done | (deltas.amax(-1) < tolerance)
            st_new, warm = dynamics.step_warm(
                self.model, st.replace(ctrl=ctrl), warm, ncon=self.ncon,
                iterations=self.iterations)
            st, ps = select(done, st, st_new), select(done, ps, ps_new)
            steps = steps + (~done).to(torch.int32)
            if record:
                traj.append(st.qpos[:, qadr])
        res = MoveResult(state=st, ctrl=cstate.replace(pid=ps), success=done,
                         steps=steps)
        return (res, torch.stack(traj, 1)) if record else res

    # -- the reference's API --------------------------------------------------

    def move_ee(self, state: State, cstate: CtrlState, position,
                tolerance: float = 0.1, max_steps: int = 10000) -> MoveResult:
        """IK, then an Arm move to the grasp-centre ``position`` (B, 3).
        A scenario whose IK misses the 0.02 m gate does not move (its
        setpoints stay) and does not succeed."""
        q5, _, ok = ik_solve(self.model, self.chain, position, state.qpos)
        ids = list(GROUPS["Arm"])
        sp = cstate.setpoints.clone()
        sp[:, ids] = torch.where(ok[:, None], q5, sp[:, ids])
        res = self._run(state, cstate.replace(setpoints=sp),
                        self._gmask(ids), tolerance, max_steps)
        return res.replace(success=res.success & ok, ik_ok=ok)

    def open_gripper(self, state, cstate, half=False, max_steps=1000):
        return self.move_group(state, cstate, "Gripper",
                               [0.0 if half else 0.4], tolerance=0.05,
                               max_steps=max_steps)

    def close_gripper(self, state, cstate, max_steps=10000, tolerance=0.01):
        return self.move_group(state, cstate, "Gripper", [-0.4],
                               tolerance=tolerance, max_steps=max_steps)

    def grasp(self, state, cstate, max_steps: int = 300):
        """Success when an object blocks the fingers (inverted)."""
        res = self.close_gripper(state, cstate, max_steps=max_steps)
        return res.replace(success=~res.success)

    def toss_it_from_the_ellbow(self, state, cstate,
                                settle_steps: int = 2000) -> MoveResult:
        """The reference's toss demo: 300 raw-torque steps (elbow and
        shoulder_pan full negative; after step 200 the gripper opens and
        wrist_1 flicks), cold-started, then every joint re-converges to
        its setpoint."""
        st = state
        for t in range(300):
            ctrl = torch.zeros_like(st.ctrl)
            ctrl[:, 2] = -2.0
            ctrl[:, 0] = -2.0
            if t > 200:
                ctrl[:, 6] += 1.0
                ctrl[:, 3] += -1.0
            st = dynamics.step(self.model, st.replace(ctrl=ctrl),
                               ncon=self.ncon, iterations=self.iterations)
        return self.move_group(st, cstate, "All", None, tolerance=0.1,
                               max_steps=settle_steps)

    def stay(self, state, cstate, duration_ms: float) -> MoveResult:
        """Hold every setpoint for ``duration_ms`` of simulated time."""
        n = max(1, int(round(duration_ms / 1000.0 / self.dt)))
        return self._run(state, cstate, self._gmask(list(GROUPS["All"])),
                         0.0, n, check_tolerance=False)

    # -- kinematic readouts ---------------------------------------------------

    def grasp_center(self, state: State) -> torch.Tensor:
        """World position of the gripper's grasp centre (B, 3)."""
        return fk(self.model, state.qpos).xpos[:, self.ee_body] - \
            torch.as_tensor(EE_OFFSET, dtype=state.qpos.dtype,
                            device=state.qpos.device)
