"""Time-varying LQR/LQT backward passes, sequential and parallel in time,
batched in torch.

Problem per scenario (leading batch axis B on every array):

    x_{k+1} = F_k x_k + L_k u_k + c_k                       k = 0..H-1
    cost    = sum_k [ 1/2 x'X_k x + q_k'x + 1/2 u'U_k u + r_k'u ]
              + 1/2 x'X_H x + q_H'x

Value functions V_k(x) = 1/2 x'S_k x + s_k'x; policy u_k = K_k x + d_k.
``backward_sequential`` is the classic O(H) recursion with per-scenario
Levenberg-Marquardt ``reg`` on Quu; it is the plain version of the Riccati
kernel (mpc/cuda_lqr.py).

``backward_parallel`` has O(log H) sequential depth: conditional value
functions V_{i->j}(x, z) are closed under composition and representable by
5-tuples (A, b, C, eta, J) with

    V(x, z) = max_l [ l'(z - A x - b) - 1/2 l'C l ] + 1/2 x'J x - eta'x,

composed by an associative combination (Sarkka and Garcia-Fernandez,
"Temporal Parallelization of Dynamic Programming and Linear Quadratic
Regulators", IEEE TAC 2021, with the affine terms of the iLQR subproblem).
The suffix compositions are formed by a doubling loop over the horizon
axis. The port's counterpart of the JAX package's mpc/lqr.py.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mujoco_rl_ur5_tpu_torch.ops.blockchol import (
    chol_small, cho_solve_small, solve_general_small,
)


class LQR(NamedTuple):
    """Stacked problem data, batch-first: F/L/c/X/q/U/r are (B, H, ...),
    XH/qH the terminal expansion (B, ...)."""

    F: torch.Tensor    # (B, H, nx, nx)
    L: torch.Tensor    # (B, H, nx, nu)
    c: torch.Tensor    # (B, H, nx)
    X: torch.Tensor    # (B, H, nx, nx) stage state Hessians
    q: torch.Tensor    # (B, H, nx)     stage state gradients (at x = 0)
    U: torch.Tensor    # (B, H, nu, nu) stage control Hessians (PD)
    r: torch.Tensor    # (B, H, nu)     stage control gradients
    XH: torch.Tensor   # (B, nx, nx)    terminal Hessian
    qH: torch.Tensor   # (B, nx)        terminal gradient


class Gains(NamedTuple):
    K: torch.Tensor    # (B, H, nu, nx)
    d: torch.Tensor    # (B, H, nu)
    S: torch.Tensor    # (B, H+1, nx, nx) value Hessians
    s: torch.Tensor    # (B, H+1, nx)     value gradients


def _sym(M: torch.Tensor) -> torch.Tensor:
    return 0.5 * (M + M.transpose(-1, -2))


def backward_sequential(p: LQR, reg) -> Gains:
    """Riccati recursion over the horizon, batched over B. ``reg`` is a
    float or a (B,) tensor added to the diagonal of Quu."""
    B, H, nx, nu = p.L.shape
    reg = torch.as_tensor(reg, dtype=p.F.dtype, device=p.F.device)
    reg_eye = reg.reshape(-1, 1, 1) * torch.eye(nu, dtype=p.F.dtype,
                                                device=p.F.device)
    S1, s1 = p.XH, p.qH
    Ks, ds, Ss, ss = [None] * H, [None] * H, [None] * (H + 1), [None] * (H + 1)
    Ss[H], ss[H] = S1, s1
    for k in reversed(range(H)):
        F, L, c = p.F[:, k], p.L[:, k], p.c[:, k]
        LT, FT = L.transpose(-1, -2), F.transpose(-1, -2)
        Quu = _sym(p.U[:, k] + LT @ S1 @ L) + reg_eye
        Qux = LT @ S1 @ F
        Sc_s = S1 @ c[..., None] + s1[..., None]
        Qu = p.r[:, k] + (LT @ Sc_s)[..., 0]
        cho = chol_small(Quu)
        K = -cho_solve_small(cho, Qux)
        d = -cho_solve_small(cho, Qu[..., None])[..., 0]
        Qxx = p.X[:, k] + FT @ S1 @ F
        Qx = p.q[:, k] + (FT @ Sc_s)[..., 0]
        KT, QuxT = K.transpose(-1, -2), Qux.transpose(-1, -2)
        S1 = _sym(Qxx + QuxT @ K)
        s1 = Qx + (KT @ Qu[..., None])[..., 0] \
            + ((KT @ Quu + QuxT) @ d[..., None])[..., 0]
        Ks[k], ds[k], Ss[k], ss[k] = K, d, S1, s1
    return Gains(K=torch.stack(Ks, 1), d=torch.stack(ds, 1),
                 S=torch.stack(Ss, 1), s=torch.stack(ss, 1))


# -- parallel-in-time pass ----------------------------------------------------


class _Elem(NamedTuple):
    A: torch.Tensor
    b: torch.Tensor
    C: torch.Tensor
    eta: torch.Tensor
    J: torch.Tensor


def _combine(e1: _Elem, e2: _Elem) -> _Elem:
    """Compose V_{i->k} (e1, earlier) with V_{k->j} (e2, later)."""
    eye = torch.eye(e1.A.shape[-1], dtype=e1.A.dtype, device=e1.A.device)
    # (I + C1 J2)^-1 once; PSD C, J make it invertible
    M = solve_general_small(eye + e1.C @ e2.J, eye.expand_as(e1.C))
    MT = M.transpose(-1, -2)   # (I + J2 C1)^-1 = M' for symmetric C, J
    A2M = e2.A @ M
    A1T = e1.A.transpose(-1, -2)
    b = (A2M @ (e1.b[..., None] + e1.C @ e2.eta[..., None]))[..., 0] + e2.b
    eta = (A1T @ MT @ (e2.eta[..., None] - e2.J @ e1.b[..., None]))[..., 0] \
        + e1.eta
    return _Elem(A=A2M @ e1.A, b=b,
                 C=_sym(A2M @ e1.C @ e2.A.transpose(-1, -2) + e2.C),
                 eta=eta, J=_sym(A1T @ MT @ e2.J @ e1.A + e1.J))


def backward_parallel(p: LQR, reg) -> Gains:
    """Riccati pass with O(log H) sequential depth, batched over B: the H
    step elements and the terminal element are suffix-composed by doubling
    (round m composes each element with the one 2^m knots later), V_k =
    (J_k, -eta_k) is read off, and all H gains come from one batched solve.
    ``reg`` is a float or a (B,) tensor added to the diagonal of U and Quu."""
    B, H, nx, nu = p.L.shape
    dt, dev = p.F.dtype, p.F.device
    reg = torch.as_tensor(reg, dtype=dt, device=dev)
    reg_eye = (reg.reshape(-1, 1, 1, 1) * torch.eye(nu, dtype=dt, device=dev))
    LT = p.L.transpose(-1, -2)
    # step elements: A = F, b = c - L U^-1 r, C = L U^-1 L', J = X, eta = -q
    Uc = chol_small(p.U + reg_eye)
    Uinv_r = cho_solve_small(Uc, p.r[..., None])
    Uinv_LT = cho_solve_small(Uc, LT)
    z = torch.zeros(B, 1, nx, nx, dtype=dt, device=dev)
    e = _Elem(A=torch.cat([p.F, z], 1),
              b=torch.cat([p.c - (p.L @ Uinv_r)[..., 0], z[..., 0]], 1),
              C=torch.cat([_sym(p.L @ Uinv_LT), z], 1),
              eta=torch.cat([-p.q, -p.qH[:, None]], 1),
              J=torch.cat([p.X, p.XH[:, None]], 1))
    step = 1
    while step <= H:
        head = _combine(_Elem(*[t[:, :-step] for t in e]),
                        _Elem(*[t[:, step:] for t in e]))
        e = _Elem(*[torch.cat([h, t[:, -step:]], 1) for h, t in zip(head, e)])
        step *= 2
    S, s = e.J, -e.eta                                   # (B, H+1, ...)
    S1, s1 = S[:, 1:], s[:, 1:]
    Quu = _sym(p.U + LT @ S1 @ p.L) + reg_eye
    Qux = LT @ S1 @ p.F
    Qu = p.r + (LT @ (S1 @ p.c[..., None] + s1[..., None]))[..., 0]
    cho = chol_small(Quu)
    return Gains(K=-cho_solve_small(cho, Qux),
                 d=-cho_solve_small(cho, Qu[..., None])[..., 0], S=S, s=s)


def rollout_policy(dyn_step, x0, xbar, ubar, gains: Gains, alpha,
                   u_lo=None, u_hi=None):
    """Closed-loop rollout of the iLQR policy u_k = ubar_k + alpha d_k +
    K_k (x - xbar_k) through the true dynamics, for one instance: x0 (nx,),
    xbar (H+1, nx), ubar (H, nu), gains without a batch axis -> xs
    (H+1, nx), us (H, nu). The optional box clamp keeps the nominal controls
    inside the actuator limits."""
    x, xs, us = x0, [x0], []
    for k in range(ubar.shape[0]):
        u = ubar[k] + alpha * gains.d[k] + gains.K[k] @ (x - xbar[k])
        if u_lo is not None:
            u = torch.clamp(u, u_lo, u_hi)
        x = dyn_step(x, u)
        xs.append(x)
        us.append(u)
    return torch.stack(xs), torch.stack(us)
