"""Grasp-MPC: batched iLQR over the UR5 arm submodel, tracking mode.

The port's counterpart of the JAX package's mpc/grasp_mpc.GraspMPC. It
plans on the arm submodel (scene/reduce.py: 8 hinge dofs, state 16); each
knot is ``substeps`` physics steps. ``track_batch`` tracks joint-space
knot references (the parity mode of the reference's PID command
sequences) through the fused kernels of mpc/cuda_ilqr.py, warm-startable
from a shifted plan for receding-horizon use.

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
from mujoco_rl_ur5_tpu_torch.mpc.ilqr import ILQRResult
from mujoco_rl_ur5_tpu_torch.physics import cuda_chain
from mujoco_rl_ur5_tpu_torch.physics.chain import (
    chain_hold_ctrl, make_chain_plan,
)
from mujoco_rl_ur5_tpu_torch.physics.cuda_chain import sadd, smul, ssub
from mujoco_rl_ur5_tpu_torch.scene.compile import load_model
from mujoco_rl_ur5_tpu_torch.scene.mjcf import JNT_HINGE
from mujoco_rl_ur5_tpu_torch.scene.model import Model
from mujoco_rl_ur5_tpu_torch.scene.reduce import load_arm_model


class MPCWeights(NamedTuple):
    """Quadratic cost weights of track mode (the JAX package's values; its
    reach-mode weights arrive with reach mode)."""

    w_ctrl: float = 1e-3      # control effort
    w_track: float = 50.0     # joint-space tracking
    w_track_vel: float = 0.5


def resolve_device(device) -> torch.device:
    """The device to plan on; CUDA that is absent raises, never falls back.
    On CUDA, TF32 is switched off for matmuls and cuDNN: the solver's
    Jacobian composition and references need full float32."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("GraspMPC: device 'cuda' was asked for but "
                               "torch.cuda.is_available() is False; pass "
                               "device='cpu' to run the plain versions")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise RuntimeError(f"GraspMPC: unsupported device {dev}")
    return dev


class GraspMPC:
    """Batched iLQR grasp planner bound to an arm submodel."""

    def __init__(self, model: Model, horizon: int = 64, substeps: int = 8,
                 iters: int = 6, weights: MPCWeights = MPCWeights(),
                 arm_model: Optional[Model] = None, device="cuda"):
        """``model`` may be the full scene (for the state index maps);
        planning runs on ``arm_model`` (see from_scene)."""
        self.device = resolve_device(device)
        self.full = model
        self.arm = arm_model if arm_model is not None else model
        t = self.arm.topo
        if np.any(t.jnt_type != JNT_HINGE):
            raise ValueError("GraspMPC plans on an all-hinge arm submodel; "
                             "use scene.reduce.load_arm_model or from_scene")
        self.H, self.substeps, self.iters, self.w = (
            horizon, substeps, iters, weights)
        self.nq, self.nu, self.nx = t.nq, t.nu, 2 * t.nq
        ft = model.topo
        self.full_qadr = np.array(
            [ft.jnt_qposadr[ft.joint_id(n)] for n in t.joint_names])
        self.full_dofadr = np.array(
            [ft.jnt_dofadr[ft.joint_id(n)] for n in t.joint_names])
        self.plan = make_chain_plan(self.arm)
        self._build_kernel_costs()

    @classmethod
    def from_scene(cls, path: str, **kw) -> "GraspMPC":
        return cls(load_model(path), arm_model=load_arm_model(path), **kw)

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    def hold_ctrl(self, qpos: torch.Tensor) -> torch.Tensor:
        """Gravity-compensation controls (the iLQR warm start)."""
        return chain_hold_ctrl(self.plan, qpos)

    def x_from_state(self, qpos: torch.Tensor,
                     qvel: torch.Tensor) -> torch.Tensor:
        """Arm MPC state from full-scene (qpos, qvel) over batch dims."""
        qadr = torch.as_tensor(self.full_qadr, device=qpos.device)
        dofadr = torch.as_tensor(self.full_dofadr, device=qvel.device)
        return torch.cat([qpos[..., qadr], qvel[..., dofadr]], -1)

    # -- tracking costs (batched over any leading dims) ----------------------

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

    def _build_kernel_costs(self):
        """Symbolic stage/terminal track costs for the fused line-search
        kernel (entry lists in, one entry out), mirroring _track_stage and
        _track_term. Built once: the pair keys the kernel source."""
        w, nq = self.w, self.nq

        def sq(xs):
            return sadd(*[smul(x, x) for x in xs], 0.0)

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

        self._k_track = (track_stage, track_term)

    # -- kernels and solves ------------------------------------------------------

    def kernel_sources(self) -> list:
        """The four kernels track_batch launches, as build units."""
        return cuda_chain.kernel_sources(self.plan, self._k_track,
                                         self.nx, self.nx) + [cuda_lqr.SOURCE]

    def build_kernels(self) -> float:
        """Build every kernel of the path at once (one nvcc per source, in
        parallel); returns the wall time in seconds."""
        t0 = time.perf_counter()
        _build.build_many(self.kernel_sources())
        return time.perf_counter() - t0

    def track_batch(self, x0, q_refs, qd_refs=None,
                    u_init=None) -> ILQRResult:
        """Batched tracking solves: x0 (B, nx), q_refs (B, H+1, nq),
        optional qd_refs (B, H+1, nq) (default zeros) and warm start
        u_init (B, H, nu) (default: the gravity hold at x0)."""
        x0 = self._tensor(x0)
        q_refs = self._tensor(q_refs)
        qd_refs = (torch.zeros_like(q_refs) if qd_refs is None
                   else self._tensor(qd_refs))
        if u_init is None:
            u_init = self.hold_ctrl(x0[:, : self.nq])[:, None].expand(
                -1, self.H, -1).contiguous()
        u_init = self._tensor(u_init)
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
            x0, u_init, (self._k_track, sref, tref), iters=self.iters)
