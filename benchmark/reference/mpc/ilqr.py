"""Plain batched iLQR for the grasp-MPC cells: the benchmark's reference.

The algorithm of the program's batched solver (an open-loop rollout of the
start controls; per iteration forward-difference knot Jacobians, the stage
and terminal quadratizations, a Riccati backward pass and a line search
over the alphas; per scenario the best finite candidate by first index,
the improved mask and the Levenberg-Marquardt schedule; the final gains
at the floor), written on the plain chain dynamics (``chain_step`` of
``benchmark.reference.physics.chain``; the rollouts step it in numpy,
``chain_np.Chain``) and the plain Riccati pass of
``benchmark.reference.mpc.lqr``. The costs and their Gauss-Newton
quadratizations are the grasp planner's, over the chain's FK. An ``Arm``
computes in one dtype; the benchmark runs it in float64 on the CPU, and
the control in float32 with its products in TF32.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference.mpc.lqr import LQR, Gains, backward_sequential
from benchmark.reference.ops.consts import const
from benchmark.reference.physics.chain import (
    chain_ee_geom, chain_step, make_chain_plan,
)
from benchmark.reference.physics.chain_np import Chain
from benchmark.reference.scene.reduce import load_arm_model

ALPHAS = (1.0, 0.6, 0.3, 0.1, 0.03)
REG = 1e-6
EPS = 1e-3              # forward-difference step (rad, rad/s, ctrl)
EE_OFFSET = np.array([0.0, -0.005, 0.16])
HOME = np.array([0.0, -1.57, 1.57, -1.57, -1.57, 0.0, 0.0, 0.0])


class Weights(NamedTuple):
    w_ee: float = 60.0
    w_ee_run: float = 2.0
    w_vel: float = 0.05
    w_ctrl: float = 1e-3
    w_posture: float = 0.02
    w_orient: float = 1.0
    w_orient_term: float = 20.0
    w_track: float = 50.0
    w_track_vel: float = 0.5


class Result(NamedTuple):
    xs: torch.Tensor      # (B, H+1, nx)
    us: torch.Tensor      # (B, H, nu)
    cost: torch.Tensor    # (B,)
    gains: Gains


class Arm:
    """The arm submodel of a scene file with its chain plan, the planner's
    costs and the solver."""

    def __init__(self, scene: str, horizon: int, substeps: int,
                 w: Weights = Weights(), dtype=np.float64, tf32=False):
        model = load_arm_model(scene, dtype=np.float64)
        self.plan = make_chain_plan(model)
        self.chain = Chain(self.plan, dtype, tf32)
        t = model.topo
        self.nq, self.nu, self.nx = t.nq, t.nu, 2 * t.nq
        self.H, self.substeps, self.w = horizon, substeps, w
        self.ee = t.body_id("ee_link")
        self.home = HOME[: self.nq]

    # -- dynamics -------------------------------------------------------------

    def knot(self, x: np.ndarray, u: np.ndarray) -> np.ndarray:
        q, v = x[..., : self.nq], x[..., self.nq:]
        for _ in range(self.substeps):
            q, v = self.chain.step(q, v, u)
        return np.concatenate([q, v], -1)

    def rollout(self, x0: torch.Tensor, us: torch.Tensor) -> torch.Tensor:
        xs, u = [x0.numpy()], us.numpy()
        for k in range(u.shape[-2]):
            xs.append(self.knot(xs[-1], u[..., k, :]))
        return torch.from_numpy(np.stack(xs, -2))

    def hold(self, x0: torch.Tensor) -> torch.Tensor:
        u = torch.from_numpy(self.chain.hold(x0[..., : self.nq].numpy()))
        return u[..., None, :].expand(*x0.shape[:-1], self.H, -1).clone()

    def lin(self, xs: torch.Tensor, us: torch.Tensor):
        """Knot Jacobians: one-substep forward differences (step EPS),
        composed over the substeps by repeated squaring."""
        nq, nx, nu = self.nq, self.nx, self.nu
        xu = torch.cat([xs, us], -1)
        pert = torch.cat([EPS * torch.eye(nx + nu, dtype=xs.dtype),
                          torch.zeros(1, nx + nu, dtype=xs.dtype)])
        z = xu[None] + pert.reshape((nx + nu + 1,) + (1,) * (xu.dim() - 1)
                                    + (nx + nu,))
        # one substep of a large batch: torch's threaded operations
        q, v = chain_step(self.plan, z[..., :nq], z[..., nq:nx], z[..., nx:])
        res = torch.cat([q, v], -1)
        diff = (res[:-1] - res[-1]) * (1.0 / EPS)          # (nx+nu, ..., nx)
        diff = diff.movedim(0, -1)                          # (..., nx, nx+nu)
        A, Bm = diff[..., :nx], diff[..., nx:]
        F = A
        S = torch.eye(nx, dtype=xs.dtype).expand_as(A)
        m = 1
        while m < self.substeps:
            S = S + F @ S
            F = F @ F
            m *= 2
        return F, S @ Bm

    # -- costs ----------------------------------------------------------------

    def ee_geom(self, q):
        p, xa, Jp, Ja = chain_ee_geom(self.plan, q, self.ee)
        return (p - const(EE_OFFSET, q), xa - const([0.0, 0.0, -1.0], q),
                Jp, Ja)

    def reach(self, targets: torch.Tensor):
        """(total_cost, quad, term_quad) toward targets (B, 3)."""
        w, nq = self.w, self.nq

        def stage(x, u, tg):
            q, qd = x[..., :nq], x[..., nq:]
            p, a, _, _ = self.ee_geom(q)
            e, post = p - tg, q - const(self.home, q)
            return (0.5 * w.w_ee_run * (e * e).sum(-1)
                    + 0.5 * w.w_orient * (a * a).sum(-1)
                    + 0.5 * w.w_vel * (qd * qd).sum(-1)
                    + 0.5 * w.w_ctrl * (u * u).sum(-1)
                    + 0.5 * w.w_posture * (post * post).sum(-1))

        def term(x, tg):
            q, qd = x[..., :nq], x[..., nq:]
            p, a, _, _ = self.ee_geom(q)
            e = p - tg
            return (0.5 * w.w_ee * (e * e).sum(-1)
                    + 0.5 * w.w_orient_term * (a * a).sum(-1)
                    + 0.5 * 10.0 * w.w_vel * (qd * qd).sum(-1))

        def total(xs, us):
            return (stage(xs[..., :-1, :], us, targets[..., None, :]).sum(-1)
                    + term(xs[..., -1, :], targets))

        def gn(x, tg, wp, wa, wpost, wv):
            q, qd = x[..., :nq], x[..., nq:]
            p, a, J, Ja = self.ee_geom(q)
            e = p - tg
            JT, JaT = J.transpose(-1, -2), Ja.transpose(-1, -2)
            eye = torch.eye(nq, dtype=x.dtype)
            Xq = wp * JT @ J + wa * JaT @ Ja + wpost * eye
            g = torch.cat([wp * (JT @ e[..., None])[..., 0]
                           + wa * (JaT @ a[..., None])[..., 0]
                           + wpost * (q - const(self.home, q)), wv * qd], -1)
            z = torch.zeros_like(Xq)
            X = torch.cat([torch.cat([Xq, z], -1),
                           torch.cat([z, z + wv * eye], -1)], -2)
            return X, g

        def quad(xs, us):
            X, g = gn(xs, targets[..., None, :], w.w_ee_run, w.w_orient,
                      w.w_posture, w.w_vel)
            return (X, g) + self._ctrl_quad(us)

        def term_quad(xH):
            return gn(xH, targets, w.w_ee, w.w_orient_term, 0.0,
                      10.0 * w.w_vel)

        return total, quad, term_quad

    def track(self, q_refs: torch.Tensor):
        """(total_cost, quad, term_quad) tracking q_refs (B, H+1, nq), zero
        velocity references."""
        w, nq = self.w, self.nq
        ref, refH = q_refs[..., :-1, :], q_refs[..., -1, :]

        def cost(x, u, r, wq):
            dq, dv = x[..., :nq] - r, x[..., nq:]
            c = 0.5 * wq * (dq * dq).sum(-1) + 0.5 * w.w_track_vel * (
                dv * dv).sum(-1)
            return c if u is None else c + 0.5 * w.w_ctrl * (u * u).sum(-1)

        def total(xs, us):
            return (cost(xs[..., :-1, :], us, ref, w.w_track).sum(-1)
                    + cost(xs[..., -1, :], None, refH, 20.0 * w.w_track))

        def blocks(x, r, wq):
            d = torch.tensor([wq] * nq + [w.w_track_vel] * nq,
                             dtype=x.dtype)
            X = torch.diag(d).expand(*x.shape[:-1], self.nx, self.nx)
            g = torch.cat([wq * (x[..., :nq] - r), w.w_track_vel
                           * x[..., nq:]], -1)
            return X, g

        def quad(xs, us):
            return blocks(xs, ref, w.w_track) + self._ctrl_quad(us)

        def term_quad(xH):
            return blocks(xH, refH, 20.0 * w.w_track)

        return total, quad, term_quad

    def _ctrl_quad(self, us):
        U = (self.w.w_ctrl * torch.eye(self.nu, dtype=us.dtype)).expand(
            *us.shape[:-1], self.nu, self.nu)
        return U, self.w.w_ctrl * us

    # -- solver ---------------------------------------------------------------

    def solve(self, problem, x0: torch.Tensor, u_init: torch.Tensor,
              iters: int) -> Result:
        """``problem``: (total_cost, quad, term_quad) of ``reach`` or
        ``track``; x0 (B, nx), u_init (B, H, nu)."""
        total, quad, term_quad = problem
        B = x0.shape[0]
        lo = self.chain.c(self.plan.ctrlrange[:, 0])
        hi = self.chain.c(self.plan.ctrlrange[:, 1])
        al = torch.tensor(ALPHAS, dtype=torch.float32).to(x0.dtype)

        def backward(xs, us, rg):
            F, L = self.lin(xs[:, :-1], us)
            X, q, U, r = quad(xs[:, :-1], us)
            XH, qH = term_quad(xs[:, -1])
            return backward_sequential(
                LQR(F, L, torch.zeros_like(q), X, q, U, r, XH, qH), rg)

        def line_search(xs, us, g):
            A = len(ALPHAS)
            K, d = g.K.numpy(), g.d.numpy()
            xb, ub, a = xs.numpy(), us.numpy(), al.numpy()[:, None, None]
            x = np.broadcast_to(x0.numpy(), (A, B, self.nx))
            xs_c, us_c = [x], []
            for k in range(self.H):
                du = self.chain.mm(K[:, k], (x - xb[:, k])[..., None])[..., 0]
                u = np.clip(ub[:, k] + a * d[:, k] + du, lo, hi)
                us_c.append(u)
                x = self.knot(x, u)
                xs_c.append(x)
            xs_c = torch.from_numpy(np.stack(xs_c, 2))
            us_c = torch.from_numpy(np.stack(us_c, 2))
            costs = total(xs_c, us_c)                        # (A, B)
            return xs_c.transpose(0, 1), us_c.transpose(0, 1), costs.t()

        us = u_init
        xs = self.rollout(x0, us)
        cost = total(xs, us)
        rg = torch.full((B,), REG, dtype=x0.dtype)
        rows = torch.arange(B)
        for _ in range(iters):
            g = backward(xs, us, rg)
            xs_c, us_c, costs = line_search(xs, us, g)
            best = torch.argmin(costs, dim=1)
            bcost = costs[rows, best]
            improved = (bcost < cost) & torch.isfinite(costs).all(1)
            xs = torch.where(improved[:, None, None], xs_c[rows, best], xs)
            us = torch.where(improved[:, None, None], us_c[rows, best], us)
            cost = torch.where(improved, bcost, cost)
            rg = torch.where(improved, torch.clamp_min(rg * 0.5, REG),
                             torch.clamp_max(rg * 10.0, 1e3))
        return Result(xs, us, cost, backward(xs, us, torch.full_like(rg, REG)))
