# Frozen copy of mujoco_rl_ur5_tpu_torch/mpc/lqr.py at commit c4951def7b192ba06c207f9c1c9298bddc6ddcb8, imports
# rewritten to this package; the benchmark's plain reference. Dropped, as no
# check or count calls them: _Elem, _combine, backward_parallel,
# rollout_policy.
"""Time-varying LQR/LQT backward pass, batched in torch.

Problem per scenario (leading batch axis B on every array):

    x_{k+1} = F_k x_k + L_k u_k + c_k                       k = 0..H-1
    cost    = sum_k [ 1/2 x'X_k x + q_k'x + 1/2 u'U_k u + r_k'u ]
              + 1/2 x'X_H x + q_H'x

Value functions V_k(x) = 1/2 x'S_k x + s_k'x; policy u_k = K_k x + d_k.
``backward_sequential`` is the classic O(H) recursion with per-scenario
Levenberg-Marquardt ``reg`` on Quu; it is the plain version of the Riccati
kernel (mpc/cuda_lqr.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.ops.blockchol import (
    chol_small, cho_solve_small,
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
