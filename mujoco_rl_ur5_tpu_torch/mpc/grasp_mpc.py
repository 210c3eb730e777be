"""Grasp-MPC: iLQR trajectory optimization over the UR5 arm submodel.

The port's counterpart of the JAX package's mpc/grasp_mpc.GraspMPC. It
plans on the arm submodel (scene/reduce.py: 8 hinge dofs, state 16); each
knot is ``substeps`` physics steps. Two modes:

  * **reach**: costs are functions of the FK; the grasp center (ee_link
    plus the gripper offset) is driven to a world target with the gripper's
    approach axis pointing down, no IK needed;
  * **track**: joint-space knot references (the parity mode of the
    reference's PID command sequences), warm-startable from a shifted plan
    for receding-horizon use.

``solve_batch`` / ``solve_batch_x`` and ``track_batch`` run B scenarios in
lock-step through the fused kernels of mpc/cuda_ilqr.py (linearized by
``lin_fd_fast`` at a power-of-two ``substeps``, by ``lin_fd`` over the
full knot otherwise). ``solve`` and
``track`` are the per-instance solves on the generic optimizer of
mpc/ilqr.py (autodiff Jacobians, no kernel).

The planner runs on the card unless the caller asks for the CPU
(``device="cpu"``, as the tests do); asking for CUDA where there is none
raises. On the CPU every kernel wrapper runs its plain version.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from mujoco_rl_ur5_tpu_torch import _build
from mujoco_rl_ur5_tpu_torch.mpc import cuda_lqr
from mujoco_rl_ur5_tpu_torch.mpc.cuda_ilqr import ilqr_chain_batch
from mujoco_rl_ur5_tpu_torch.mpc.ilqr import ILQRResult, ilqr
from mujoco_rl_ur5_tpu_torch.physics import cuda_chain
from mujoco_rl_ur5_tpu_torch.physics.chain import (
    body_slot, chain_body_pos, chain_body_xaxis, chain_ee_geom,
    chain_hold_ctrl, chain_step, const, make_chain_plan,
)
from mujoco_rl_ur5_tpu_torch.physics.cuda_chain import (
    ee_quad_gn, make_fk, sadd, smul, ssub,
)
from mujoco_rl_ur5_tpu_torch.scene.compile import compile_file
from mujoco_rl_ur5_tpu_torch.scene.mjcf import JNT_HINGE
from mujoco_rl_ur5_tpu_torch.scene.model import Model, resolve_device
from mujoco_rl_ur5_tpu_torch.scene.reduce import load_arm_model
from mujoco_rl_ur5_tpu_torch.trace import spanned


# gripper grasp-center offset from ee_link
EE_OFFSET = np.array([0.0, -0.005, 0.16])


class MPCWeights(NamedTuple):
    """Quadratic cost weights (all scalars; the JAX package's values)."""

    w_ee: float = 60.0        # terminal EE position
    w_ee_run: float = 2.0     # running EE position
    w_vel: float = 0.05       # joint velocity damping
    w_ctrl: float = 1e-3      # control effort
    w_posture: float = 0.02   # stay near a reference posture
    w_orient: float = 1.0     # running vertical-gripper orientation
    w_orient_term: float = 20.0  # terminal vertical-gripper orientation
    w_track: float = 50.0     # joint-space tracking (track mode)
    w_track_vel: float = 0.5


class GraspMPC:
    """Batched iLQR grasp planner bound to an arm submodel."""

    def __init__(self, model: Model, horizon: int = 64, substeps: int = 8,
                 iters: int = 6, weights: MPCWeights = MPCWeights(),
                 arm_model: Optional[Model] = None, parallel: bool = True,
                 lin_chunks: int = 8, device="cuda"):
        """``model`` may be the full scene (for the state index maps);
        planning runs on ``arm_model`` (see from_scene). ``parallel`` and
        ``lin_chunks`` set the Riccati pass and the linearization chunks of
        the per-instance ``solve`` / ``track`` (mpc/ilqr.py)."""
        self.device = resolve_device(device, "GraspMPC")
        self.full = model
        self.arm = arm_model if arm_model is not None else model
        t = self.arm.topo
        if np.any(t.jnt_type != JNT_HINGE):
            raise ValueError("GraspMPC plans on an all-hinge arm submodel; "
                             "use scene.reduce.load_arm_model or from_scene")
        self.H, self.substeps, self.iters, self.w = (
            horizon, substeps, iters, weights)
        # one-substep differences composed by squaring need a power of
        # two; any other count differences the full knot (lin_fd)
        self.fast_lin = substeps & (substeps - 1) == 0
        self.parallel = parallel
        # a non-divisor falls back to the largest divisor of the horizon
        # below it, not to 1 (which would undo the memory cap)
        self.lin_chunks = next(c for c in range(min(lin_chunks, horizon), 0,
                                                -1) if horizon % c == 0)
        self.nq, self.nu, self.nx = t.nq, t.nu, 2 * t.nq
        self.ee_body = t.body_id("ee_link")
        self.home = np.asarray(
            [0.0, -1.57, 1.57, -1.57, -1.57, 0.0, 0.0, 0.0])[: self.nq]
        self.u_lo = np.asarray(self.arm.act_ctrlrange[:, 0])
        self.u_hi = np.asarray(self.arm.act_ctrlrange[:, 1])
        ft = model.topo
        self.full_qadr = np.array(
            [ft.jnt_qposadr[ft.joint_id(n)] for n in t.joint_names])
        self.full_dofadr = np.array(
            [ft.jnt_dofadr[ft.joint_id(n)] for n in t.joint_names])
        self.plan = make_chain_plan(self.arm)
        self.ee_slot = body_slot(self.plan, self.ee_body)
        self._build_kernel_costs()

    @classmethod
    def from_scene(cls, path: str, **kw) -> "GraspMPC":
        return cls(compile_file(path), arm_model=load_arm_model(path), **kw)

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    # -- dynamics and geometry (batched over any leading dims) ----------------

    def dyn_step(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """One MPC knot = ``substeps`` physics steps of the arm
        (physics/chain.chain_step). The batched solves go through the fused
        kernels instead."""
        q, v = x[..., : self.nq], x[..., self.nq:]
        for _ in range(self.substeps):
            q, v = chain_step(self.plan, q, v, u)
        return torch.cat([q, v], -1)

    def ee_pos(self, qpos: torch.Tensor) -> torch.Tensor:
        """Grasp-center world position."""
        return (chain_body_pos(self.plan, qpos, self.ee_body)
                - const(EE_OFFSET, qpos))

    def ee_axis_err(self, qpos: torch.Tensor) -> torch.Tensor:
        """Deviation of the gripper approach axis from vertical-down."""
        return (chain_body_xaxis(self.plan, qpos, self.ee_body)
                - const([0.0, 0.0, -1.0], qpos))

    def ee_geom(self, qpos: torch.Tensor):
        """(grasp-center position, approach-axis error, J_pos, J_axis) from
        one FK pass: the shared primitive of the reach costs and their
        Gauss-Newton quadratizations."""
        p, xa, Jp, Ja = chain_ee_geom(self.plan, qpos, self.ee_body)
        return (p - const(EE_OFFSET, qpos),
                xa - const([0.0, 0.0, -1.0], qpos), Jp, Ja)

    def hold_ctrl(self, qpos: torch.Tensor) -> torch.Tensor:
        """Gravity-compensation controls (the iLQR warm start)."""
        return chain_hold_ctrl(self.plan, qpos)

    def x_from_state(self, qpos: torch.Tensor,
                     qvel: torch.Tensor) -> torch.Tensor:
        """Arm MPC state from full-scene (qpos, qvel) over batch dims."""
        qadr = torch.as_tensor(self.full_qadr, device=qpos.device)
        dofadr = torch.as_tensor(self.full_dofadr, device=qvel.device)
        return torch.cat([qpos[..., qadr], qvel[..., dofadr]], -1)

    # -- costs (batched over any leading dims) ---------------------------------

    def _reach_stage(self, x, u, target):
        w = self.w
        q, qd = x[..., : self.nq], x[..., self.nq:]
        p, a, _, _ = self.ee_geom(q)          # one FK for both errors
        e = p - target
        posture = q - const(self.home, q)
        return (0.5 * w.w_ee_run * (e * e).sum(-1)
                + 0.5 * w.w_orient * (a * a).sum(-1)
                + 0.5 * w.w_vel * (qd * qd).sum(-1)
                + 0.5 * w.w_ctrl * (u * u).sum(-1)
                + 0.5 * w.w_posture * (posture * posture).sum(-1))

    def _reach_term(self, x, target):
        w = self.w
        q, qd = x[..., : self.nq], x[..., self.nq:]
        p, a, _, _ = self.ee_geom(q)
        e = p - target
        return (0.5 * w.w_ee * (e * e).sum(-1)
                + 0.5 * w.w_orient_term * (a * a).sum(-1)
                + 0.5 * 10.0 * w.w_vel * (qd * qd).sum(-1))

    def _track_stage(self, x, u, ref):
        """ref = (q_ref, qd_ref) joint-space knots."""
        w = self.w
        dq = x[..., : self.nq] - ref[0]
        dv = x[..., self.nq:] - ref[1]
        return (0.5 * w.w_track * (dq * dq).sum(-1)
                + 0.5 * w.w_track_vel * (dv * dv).sum(-1)
                + 0.5 * w.w_ctrl * (u * u).sum(-1))

    def _track_term(self, x, ref):
        w = self.w
        dq = x[..., : self.nq] - ref[0]
        dv = x[..., self.nq:] - ref[1]
        return (0.5 * 20.0 * w.w_track * (dq * dq).sum(-1)
                + 0.5 * w.w_track_vel * (dv * dv).sum(-1))

    def _diag(self, a: float, b: float, like: torch.Tensor) -> torch.Tensor:
        return torch.diag(torch.tensor([a] * self.nq + [b] * self.nq,
                                       dtype=like.dtype, device=like.device))

    def _track_quad(self, xs, us, ref):
        """Exact expansion (the tracking cost is already quadratic):
        (X, q, U, r) batch-first over the knots."""
        w, nq = self.w, self.nq
        X = self._diag(w.w_track, w.w_track_vel, xs).expand(
            *xs.shape[:-1], self.nx, self.nx)
        g = torch.cat([w.w_track * (xs[..., :nq] - ref[0]),
                       w.w_track_vel * (xs[..., nq:] - ref[1])], -1)
        U = (w.w_ctrl * torch.eye(self.nu, dtype=xs.dtype, device=xs.device)
             ).expand(*us.shape[:-1], self.nu, self.nu)
        return X, g, U, w.w_ctrl * us

    def _track_term_quad(self, x, ref):
        w, nq = self.w, self.nq
        XH = self._diag(20.0 * w.w_track, w.w_track_vel, x).expand(
            *x.shape[:-1], self.nx, self.nx)
        qH = torch.cat([20.0 * w.w_track * (x[..., :nq] - ref[0]),
                        w.w_track_vel * (x[..., nq:] - ref[1])], -1)
        return XH, qH

    # -- Gauss-Newton quadratizations of the reach costs -----------------------

    def _block_diag(self, Xq, v: float):
        """[[Xq, 0], [0, v I]] over leading dims, without in-place writes."""
        z = torch.zeros_like(Xq)
        vI = z + v * torch.eye(self.nq, dtype=Xq.dtype, device=Xq.device)
        return torch.cat([torch.cat([Xq, z], -1), torch.cat([z, vI], -1)], -2)

    def _reach_quad(self, x, u, target):
        """Gauss-Newton expansion of _reach_stage (the FK's curvature is
        dropped, so the stage Hessian is positive semidefinite):
        (X, q, U, r) over leading dims."""
        w, nq = self.w, self.nq
        q, qd = x[..., :nq], x[..., nq:]
        p, a, J, Ja = self.ee_geom(q)
        e = p - target
        JT, JaT = J.transpose(-1, -2), Ja.transpose(-1, -2)
        eye = torch.eye(nq, dtype=x.dtype, device=x.device)
        Xq = w.w_ee_run * JT @ J + w.w_orient * JaT @ Ja + w.w_posture * eye
        g = torch.cat([
            w.w_ee_run * (JT @ e[..., None])[..., 0]
            + w.w_orient * (JaT @ a[..., None])[..., 0]
            + w.w_posture * (q - const(self.home, q)),
            w.w_vel * qd], -1)
        U = (w.w_ctrl * torch.eye(self.nu, dtype=x.dtype, device=x.device)
             ).expand(*u.shape[:-1], self.nu, self.nu)
        return self._block_diag(Xq, w.w_vel), g, U, w.w_ctrl * u

    def _reach_term_quad(self, x, target):
        w, nq = self.w, self.nq
        q, qd = x[..., :nq], x[..., nq:]
        p, a, J, Ja = self.ee_geom(q)
        e = p - target
        JT, JaT = J.transpose(-1, -2), Ja.transpose(-1, -2)
        XH = self._block_diag(w.w_ee * JT @ J + w.w_orient_term * JaT @ Ja,
                              10.0 * w.w_vel)
        qH = torch.cat([w.w_ee * (JT @ e[..., None])[..., 0]
                        + w.w_orient_term * (JaT @ a[..., None])[..., 0],
                        10.0 * w.w_vel * qd], -1)
        return XH, qH

    def _reach_quad_batch_kernel(self, xs, us, targets):
        """Batched stage quadratization through the ``ee_quad_gn`` kernel:
        one launch writes the full stage blocks X and g for all B x H
        expansions; the control blocks are constants. Equal to _reach_quad
        over (B, H)."""
        w = self.w
        nu = self.nu
        B, H = us.shape[0], us.shape[1]
        X, g = ee_quad_gn(self.plan, self.ee_slot, EE_OFFSET, w.w_ee_run,
                          w.w_orient, w.w_posture, w.w_vel, self.home, xs,
                          targets)
        U = (w.w_ctrl * torch.eye(nu, dtype=xs.dtype, device=xs.device)
             ).expand(B, H, nu, nu)
        return X, g, U, w.w_ctrl * us

    def _build_kernel_costs(self):
        """Symbolic stage/terminal costs for the fused line-search kernel
        (entry lists in, one entry out), mirroring _reach_stage / _reach_term
        and _track_stage / _track_term. Built once: each pair keys a kernel
        source."""
        w, nq = self.w, self.nq
        slot = self.ee_slot
        fk = make_fk(self.plan)
        off = [float(o) for o in EE_OFFSET]
        home = [float(h) for h in self.home]

        def sq(xs):
            return sadd(*[smul(x, x) for x in xs], 0.0)

        def ee_err(q, tr):
            xpos, xrot, _, _ = fk(q)
            e = [ssub(ssub(xpos[slot][i], off[i]), tr[i]) for i in range(3)]
            xa = [xrot[slot][i][0] for i in range(3)]
            return e, [xa[0], xa[1], sadd(xa[2], 1.0)]

        def reach_stage(q, v, u, sr, tr):
            e, a = ee_err(q, tr)
            post = [ssub(q[i], home[i]) for i in range(nq)]
            return sadd(smul(0.5 * w.w_ee_run, sq(e)),
                        smul(0.5 * w.w_orient, sq(a)),
                        smul(0.5 * w.w_vel, sq(v)),
                        smul(0.5 * w.w_ctrl, sq(u)),
                        smul(0.5 * w.w_posture, sq(post)))

        def reach_term(q, v, tr):
            e, a = ee_err(q, tr)
            return sadd(smul(0.5 * w.w_ee, sq(e)),
                        smul(0.5 * w.w_orient_term, sq(a)),
                        smul(0.5 * 10.0 * w.w_vel, sq(v)))

        def track_stage(q, v, u, sr, tr):
            dq = [ssub(q[i], sr[i]) for i in range(nq)]
            dv = [ssub(v[i], sr[nq + i]) for i in range(nq)]
            return sadd(smul(0.5 * w.w_track, sq(dq)),
                        smul(0.5 * w.w_track_vel, sq(dv)),
                        smul(0.5 * w.w_ctrl, sq(u)))

        def track_term(q, v, tr):
            dq = [ssub(q[i], tr[i]) for i in range(nq)]
            dv = [ssub(v[i], tr[nq + i]) for i in range(nq)]
            return sadd(smul(0.5 * 20.0 * w.w_track, sq(dq)),
                        smul(0.5 * w.w_track_vel, sq(dv)))

        self._k_reach = (reach_stage, reach_term)
        self._k_track = (track_stage, track_term)

    # -- kernels and solves ------------------------------------------------------

    def kernel_sources(self) -> list:
        """Every kernel the batched solves launch, as build units:
        rollout_open, lin_fd, rollout_closed with the track costs and with
        the reach costs, the Riccati backward pass and ee_quad_gn."""
        w = self.w
        return (cuda_chain.kernel_sources(self.plan, self._k_track, self.nx,
                                          self.nx)
                + cuda_chain.kernel_sources(self.plan, self._k_reach, 0, 3)[2:]
                + [cuda_lqr.SOURCE,
                   cuda_chain.ee_quad_source(
                       self.plan, self.ee_slot, EE_OFFSET, w.w_ee_run,
                       w.w_orient, w.w_posture, w.w_vel, self.home)])

    def build_kernels(self) -> float:
        """Build every kernel of the path at once (one nvcc per source, in
        parallel); returns the wall time in seconds."""
        t0 = time.perf_counter()
        _build.build_many(self.kernel_sources())
        return time.perf_counter() - t0

    def _hold_init(self, x0: torch.Tensor) -> torch.Tensor:
        """The default start: the gravity hold at x0 over the horizon."""
        return self.hold_ctrl(x0[..., : self.nq])[..., None, :].expand(
            *x0.shape[:-1], self.H, -1).contiguous()

    def _reach_closures(self, targets: torch.Tensor):
        """(total_cost, quad, term_quad, kernel_cost) of the batched reach
        problem toward ``targets`` (B, 3): the arguments ilqr_chain_batch
        takes around the states and controls."""
        def total_cost(xs, us):
            return (self._reach_stage(xs[:, :-1], us, targets[:, None]).sum(-1)
                    + self._reach_term(xs[:, -1], targets))

        return (total_cost,
                lambda xs, us: self._reach_quad_batch_kernel(xs, us, targets),
                lambda xH: self._reach_term_quad(xH, targets),
                (self._k_reach, None, targets))

    @spanned("mpc.solve")
    def solve_batch_x(self, x0, targets) -> ILQRResult:
        """Batched reach solves from MPC states x0 (B, nx) to world
        grasp-center targets (B, 3), from the gravity hold."""
        x0 = self._tensor(x0)
        targets = self._tensor(targets).contiguous()
        total_cost, quad, term_quad, kernel_cost = self._reach_closures(targets)
        return ilqr_chain_batch(self.plan, self.substeps, total_cost, quad,
                                term_quad, x0, self._hold_init(x0),
                                kernel_cost, iters=self.iters,
                                fast_lin=self.fast_lin)

    def solve_batch(self, qpos, qvel, targets) -> ILQRResult:
        """Batched reach solves from full-scene states (qpos (B, nq_full),
        qvel (B, nv_full)): the headline workload."""
        return self.solve_batch_x(
            self.x_from_state(self._tensor(qpos), self._tensor(qvel)),
            targets)

    def solve(self, x0, target, u_init=None) -> ILQRResult:
        """Reach the world target (3,) from MPC state x0 (nx,), one
        instance, on the generic optimizer. Warm-startable with u_init
        (H, nu); defaults to the gravity hold."""
        x0, target = self._tensor(x0), self._tensor(target)
        u_init = self._hold_init(x0) if u_init is None \
            else self._tensor(u_init)
        return ilqr(self.dyn_step, self._reach_stage, self._reach_term, x0,
                    u_init, target.expand(self.H, -1), target,
                    iters=self.iters, parallel=self.parallel,
                    u_lo=self.u_lo, u_hi=self.u_hi,
                    lin_chunks=self.lin_chunks, quad_fn=self._reach_quad,
                    term_quad_fn=self._reach_term_quad)

    def track(self, x0, q_refs, qd_refs=None, u_init=None) -> ILQRResult:
        """Track a joint-space knot trajectory q_refs (H+1, nq), one
        instance, on the generic optimizer; optional qd_refs (default
        zeros) and warm start u_init (H, nu) (default: the gravity hold)."""
        x0, q_refs = self._tensor(x0), self._tensor(q_refs)
        qd_refs = (torch.zeros_like(q_refs) if qd_refs is None
                   else self._tensor(qd_refs))
        u_init = self._hold_init(x0) if u_init is None \
            else self._tensor(u_init)
        # the stage cost at step k is evaluated on x_k: refs of knots 0..H-1
        return ilqr(self.dyn_step, self._track_stage, self._track_term, x0,
                    u_init, (q_refs[:-1], qd_refs[:-1]),
                    (q_refs[-1], qd_refs[-1]), iters=self.iters,
                    parallel=self.parallel, u_lo=self.u_lo, u_hi=self.u_hi,
                    lin_chunks=self.lin_chunks, quad_fn=self._track_quad,
                    term_quad_fn=self._track_term_quad)

    @spanned("mpc.solve")
    def track_batch(self, x0, q_refs, qd_refs=None,
                    u_init=None) -> ILQRResult:
        """Batched tracking solves: x0 (B, nx), q_refs (B, H+1, nq),
        optional qd_refs (B, H+1, nq) (default zeros) and warm start
        u_init (B, H, nu) (default: the gravity hold at x0)."""
        x0 = self._tensor(x0)
        q_refs = self._tensor(q_refs)
        qd_refs = (torch.zeros_like(q_refs) if qd_refs is None
                   else self._tensor(qd_refs))
        u_init = self._hold_init(x0) if u_init is None \
            else self._tensor(u_init)
        refs = (q_refs[:, :-1], qd_refs[:, :-1])
        term_ref = (q_refs[:, -1], qd_refs[:, -1])
        sref = torch.cat(refs, -1).contiguous()          # (B, H, 2nq)
        tref = torch.cat(term_ref, -1).contiguous()      # (B, 2nq)

        def total_cost(xs, us):
            return (self._track_stage(xs[:, :-1], us, refs).sum(-1)
                    + self._track_term(xs[:, -1], term_ref))

        return ilqr_chain_batch(
            self.plan, self.substeps, total_cost,
            lambda xs, us: self._track_quad(xs, us, refs),
            lambda xH: self._track_term_quad(xH, term_ref),
            x0, u_init, (self._k_track, sref, tref), iters=self.iters,
            fast_lin=self.fast_lin)
