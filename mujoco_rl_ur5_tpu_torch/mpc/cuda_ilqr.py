"""Batched iLQR on the fused chain kernels: the grasp-MPC solver.

The algorithm of the JAX package's mpc/pallas_ilqr.ilqr_chain_batch, with
its kernels replaced by the port's:

  * open-loop rollout     -> physics/cuda_chain.rollout_open   (1 launch)
  * linearization         -> physics/cuda_chain.lin_fd_fast    (1 lin_fd
    launch: one-substep forward differences, composed over the substeps
    inside the same launch)
  * stage quadratization  -> ``quad``: in reach mode
    physics/cuda_chain.ee_quad_gn (1 launch: FK, geometric Jacobians and
    the full stage blocks X and g for all B x H knots); in track mode
    plain torch (the tracking cost is already quadratic: diagonal
    constants and linear terms). The terminal quadratization and the
    start cost are plain torch
  * Riccati backward pass -> mpc/cuda_lqr.backward             (1 launch)
  * 5-alpha line search   -> physics/cuda_chain.rollout_closed (1 launch,
    candidate costs fused)

then the best alpha per scenario (first index on ties, as ``argmin``), the
improved mask and the per-scenario Levenberg-Marquardt schedule. A cold
solve launches rollout_open once, lin_fd and backward (and, in reach mode,
ee_quad_gn) iters+1 times and rollout_closed iters times. One solver
serves both modes: the mode is in the closures and the fused cost pair.

Semantics per scenario match the JAX solver, with the same two deviations
from the exact iLQR (forward-difference Jacobians, the plan's baked
ctrlrange). The best candidate is selected by indexing, which equals the
JAX package's one-hot contraction whenever the candidates are finite. A
scenario with a non-finite candidate cost is not improved, as there: the
contraction's 0 * inf (or 0 * NaN) makes its best cost NaN, so the plan
is kept and the regularisation grows.
"""

from __future__ import annotations

from typing import Callable

import torch

from mujoco_rl_ur5_tpu_torch.mpc.cuda_lqr import backward
from mujoco_rl_ur5_tpu_torch.mpc.ilqr import ILQRResult
from mujoco_rl_ur5_tpu_torch.physics.chain import ChainPlan
from mujoco_rl_ur5_tpu_torch.physics.cuda_chain import (
    lin_fd_fast, rollout_closed, rollout_open,
)

ALPHAS = (1.0, 0.6, 0.3, 0.1, 0.03)   # line-search steps (f32 in the kernel)
REG = 1e-6                            # Levenberg-Marquardt floor on Quu


def ilqr_chain_batch(
    plan: ChainPlan,
    substeps: int,
    total_cost: Callable,   # (xs (B,H+1,nx), us (B,H,nu)) -> (B,)
    quad: Callable,         # (xs (B,H,nx), us) -> (X, q, U, r), batch-first
    term_quad: Callable,    # (xH (B,nx)) -> (XH, qH)
    x0: torch.Tensor,       # (B, nx)
    u_init: torch.Tensor,   # (B, H, nu)
    kernel_cost,            # ((stage_cb, term_cb), sref (B,H,R), tref (B,RT))
    iters: int = 6,
) -> ILQRResult:
    """Solve B independent trajectory optimizations in lock-step."""
    B = u_init.shape[0]
    cbs, sref, tref = kernel_cost

    def expand_and_backward(xs, us, rg):
        F, L = lin_fd_fast(plan, substeps, xs[:, :-1], us)
        X, q, U, r = quad(xs[:, :-1], us)
        XH, qH = term_quad(xs[:, -1])
        # the kernel reads every block at full size, batch-first: the
        # quadratizations' expanded constants are materialised here
        return backward(*(t.contiguous() for t in (F, L, X, q, U, r, XH, qH)),
                        rg)

    # the kernels read the public layout as it is: contiguous, batch-first
    x0, us = x0.contiguous(), u_init.contiguous()
    xs = rollout_open(plan, substeps, x0, us)
    cost = total_cost(xs, us)
    rg = torch.full((B,), REG, dtype=x0.dtype, device=x0.device)
    rows = torch.arange(B, device=x0.device)
    for _ in range(iters):
        gains = expand_and_backward(xs, us, rg)
        xs_c, us_c, costs = rollout_closed(
            plan, substeps, x0, xs, us, gains.K, gains.d, ALPHAS,
            cost=cbs, sref=sref, tref=tref)
        best = torch.argmin(costs, dim=1)      # first index on ties
        bcost = costs[rows, best]
        improved = (bcost < cost) & torch.isfinite(costs).all(1)
        xs = torch.where(improved[:, None, None], xs_c[rows, best], xs)
        us = torch.where(improved[:, None, None], us_c[rows, best], us)
        cost = torch.where(improved, bcost, cost)
        # per-scenario Levenberg-Marquardt schedule
        rg = torch.where(improved, torch.clamp_min(rg * 0.5, REG),
                         torch.clamp_max(rg * 10.0, 1e3))
    gains = expand_and_backward(xs, us, torch.full_like(rg, REG))
    return ILQRResult(xs=xs, us=us, cost=cost, gains=gains)
