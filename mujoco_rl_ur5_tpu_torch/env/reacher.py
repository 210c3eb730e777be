"""The reacher task (BASELINE config 1): the port's counterpart of the JAX
package's env/reacher.py, on the port's reacher scene
(assets/ur5_2finger_reacher.xml: the arm and a "target" body on three
slide joints with the reference's ranges).

A 6-dof PID reach to a random target over H=500 contact-free steps.
Actions are the six arm-joint setpoints; each ``step`` advances
``frame_skip`` physics steps with the reference's PID gains (the first six
controllers). ``reach_ik`` is the scripted primitive (IK, then PID until
every arm joint is within the tolerance). The reward is the negative
grasp-centre-to-target distance with a bonus of 1 inside 5 cm.

Every state carries a leading batch axis B, where the JAX package writes
one scenario and vmaps it: ``reach_ik``'s per-scenario scan becomes one
fixed-horizon loop over the batch with ``torch.where`` masks, and
``steps`` counts per scenario. Random draws take an explicit
``torch.Generator``; the state carries no key. The physics runs on the
card unless the caller asks for the CPU (``device="cpu"``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from mujoco_rl_ur5_tpu_torch.control.controller import select
from mujoco_rl_ur5_tpu_torch.control.ik import ArmChain, EE_OFFSET, ik_solve
from mujoco_rl_ur5_tpu_torch.control.pid import (
    PIDParams, PIDState, pid_init, pid_output, reference_gains,
)
from mujoco_rl_ur5_tpu_torch.physics import dynamics, fk
from mujoco_rl_ur5_tpu_torch.scene.model import (
    Model, State, make_state, resolve_device,
)

ARM_HOME = np.array([0.0, -1.57, 1.57, -1.57, -1.57, 0.0])
SUCCESS_RADIUS = 0.05


@dataclass(eq=False)
class ReacherState:
    sim: State
    pid: PIDState             # (B, 6) arm PID bank
    setpoints: torch.Tensor   # (B, 6)
    target: torch.Tensor      # (B, 3) world target position

    def replace(self, **kw) -> "ReacherState":
        return dataclasses.replace(self, **kw)


class ReacherEnv:
    """The batched reacher bound to the compiled reacher scene on
    ``device``."""

    def __init__(self, model: Model, ncon: int = 0,
                 iterations: int | None = None, frame_skip: int = 5,
                 device="cuda"):
        self.device = resolve_device(device, "ReacherEnv")
        self.model = model.to(self.device)
        t = model.topo
        self.ncon = ncon
        self.iterations = t.iterations if iterations is None else iterations
        self.frame_skip = frame_skip
        self.nu = t.nu
        # the six arm motors are actuators 0..5
        act = np.asarray(t.act_jnt)[:6]
        self.arm_qadr = np.asarray(t.jnt_qposadr)[act]
        self.arm_dofadr = np.asarray(t.jnt_dofadr)[act]
        g = reference_gains(device=self.device)
        self.params = PIDParams(kp=g.kp[:6], ki=g.ki[:6], kd=g.kd[:6],
                                out_lo=g.out_lo[:6], out_hi=g.out_hi[:6])
        tj = np.asarray([t.joint_id(f"target_{ax}") for ax in "xyz"])
        self.target_qadr = np.asarray(t.jnt_qposadr)[tj]
        self.target_range = np.asarray(model.jnt_range, np.float64)[tj]
        self.target_body = t.body_id("target")
        # the index tables on the device, uploaded once (a numpy index
        # would be copied to the card at every step)
        self._arm_q, self._arm_d, self._target_q = (
            torch.as_tensor(a, device=self.device)
            for a in (self.arm_qadr, self.arm_dofadr, self.target_qadr))
        self.ee_body = t.body_id("ee_link")
        self.chain = ArmChain(model)
        self.dt = t.timestep

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    # -- core -----------------------------------------------------------------

    def ee_pos(self, qpos: torch.Tensor) -> torch.Tensor:
        """The grasp centre the IK solves for (ee_link minus the gripper
        offset): (B, 3)."""
        return (fk(self.model, qpos).xpos[:, self.ee_body]
                - torch.as_tensor(EE_OFFSET, dtype=qpos.dtype,
                                  device=qpos.device))

    def _pid_step(self, sim: State, pid: PIDState, setpoints):
        q = sim.qpos[:, self._arm_q]
        ctrl, pid = pid_output(self.params, pid, setpoints, q, self.dt)
        full = torch.zeros_like(sim.ctrl)
        full[:, :6] = ctrl
        sim = dynamics.step(self.model, sim.replace(ctrl=full),
                            ncon=self.ncon, iterations=self.iterations)
        return sim, pid

    # -- api ------------------------------------------------------------------

    def reset(self, generator: torch.Generator, batch: int,
              rows: slice | None = None) -> ReacherState:
        """``batch`` scenarios at the home pose, each with a target drawn
        uniformly within the slide ranges from ``generator``; with
        ``rows``, all ``batch`` are drawn and only those rows kept (a
        data-parallel rank's share)."""
        u = torch.rand(batch, 3, generator=generator,
                       device=generator.device).to(self.device)
        if rows is not None:
            u = u[rows]
        batch = u.shape[0]
        sim = make_state(self.model, batch, device=self.device)
        qpos = sim.qpos.clone()
        qpos[:, self._arm_q] = self._tensor(ARM_HOME)
        lo, hi = (self._tensor(self.target_range[:, i]) for i in (0, 1))
        qpos[:, self._target_q] = lo + (hi - lo) * u
        sim = sim.replace(qpos=qpos)
        target = fk(self.model, qpos).xpos[:, self.target_body]
        return ReacherState(
            sim=sim, pid=pid_init(6, batch, device=self.device),
            setpoints=self._tensor(ARM_HOME).expand(batch, 6).clone(),
            target=target)

    def observe(self, es: ReacherState) -> torch.Tensor:
        """(B, 18): [q_arm(6), qd_arm(6), target(3), ee(3)]."""
        return torch.cat([es.sim.qpos[:, self._arm_q],
                          es.sim.qvel[:, self._arm_d], es.target,
                          self.ee_pos(es.sim.qpos)], -1)

    def step(self, es: ReacherState, action: torch.Tensor):
        """action (B, 6) = the desired arm-joint angles; ``frame_skip`` PID
        steps. Returns (state, reward (B,), done (B,), info)."""
        sp = torch.clamp(action.to(es.setpoints), -np.pi, np.pi)
        sim, pid = es.sim, es.pid
        for _ in range(self.frame_skip):
            sim, pid = self._pid_step(sim, pid, sp)
        es = es.replace(sim=sim, pid=pid, setpoints=sp)
        dist = torch.linalg.vector_norm(self.ee_pos(sim.qpos) - es.target,
                                        dim=-1)
        success = dist < SUCCESS_RADIUS
        reward = -dist + success.to(dist.dtype)
        return es, reward, success, {"dist": dist, "success": success}

    def reach_ik(self, es: ReacherState, max_steps: int = 500,
                 tolerance: float = 0.05):
        """Scripted reach: IK to the target, then PID until every arm joint
        is within ``tolerance`` rad, a masked loop of ``max_steps`` physics
        steps (a scenario that has converged is not stepped again).
        Returns (state, info: ik_ok, converged, steps (per scenario),
        dist)."""
        q5, _, ok = ik_solve(self.model, self.chain, es.target, es.sim.qpos)
        sp = es.setpoints.clone()
        sp[:, :5] = torch.where(ok[:, None], q5, sp[:, :5])
        sim, pid = es.sim, es.pid
        B = sp.shape[0]
        done = torch.zeros(B, dtype=torch.bool, device=self.device)
        steps = torch.zeros(B, dtype=torch.int32, device=self.device)
        for _ in range(max_steps):
            q = sim.qpos[:, self._arm_q]
            done = done | ((sp - q).abs().amax(-1) < tolerance)
            sim_new, pid_new = self._pid_step(sim, pid, sp)
            sim = select(done, sim, sim_new)
            pid = select(done, pid, pid_new)
            steps = steps + (~done).to(torch.int32)
        es = es.replace(sim=sim, pid=pid, setpoints=sp)
        dist = torch.linalg.vector_norm(self.ee_pos(sim.qpos) - es.target,
                                        dim=-1)
        return es, {"ik_ok": ok, "converged": done, "steps": steps,
                    "dist": dist}
