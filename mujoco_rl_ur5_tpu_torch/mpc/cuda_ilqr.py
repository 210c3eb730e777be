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
  * 5-alpha line search   -> physics/cuda_chain.rollout_closed (1 launch
    per 8 alphas, candidate costs fused)

then the best alpha per scenario (first index on ties, as ``argmin``), the
improved mask and the per-scenario Levenberg-Marquardt schedule. A cold
solve launches rollout_open once, lin_fd and backward (and, in reach mode,
ee_quad_gn) iters+1 times and rollout_closed iters times. One solver
serves both modes: the mode is in the closures and the fused cost pair.

The JAX solver's options are keywords here, with its defaults:
``alphas``, ``reg``, ``fast_lin`` (False: ``lin_fd`` over the full
substeps, any substep count), ``kernel_cost=None`` (the candidates' costs
from ``total_cost`` after the line search), ``parallel_backward`` (True /
False: the plain ``lqr.backward_parallel`` / ``backward_sequential``) and
the autodiff expansion of per-knot costs (``cost_fn``/``term_cost_fn``
with ``refs``/``term_ref``, JAX's arguments of those names, when ``quad``
/ ``term_quad`` are None). The port's ``quad`` is JAX's ``kernel_quad``
(or its vmapped ``quad_fn``): a closure over the whole batch.

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

from mujoco_rl_ur5_tpu_torch.mpc import lqr
from mujoco_rl_ur5_tpu_torch.mpc.cuda_lqr import backward
from mujoco_rl_ur5_tpu_torch.mpc.ilqr import ILQRResult
from mujoco_rl_ur5_tpu_torch.physics.chain import ChainPlan
from mujoco_rl_ur5_tpu_torch.physics.cuda_chain import (
    _NALPHA, lin_fd, lin_fd_fast, rollout_closed, rollout_open,
)

ALPHAS = (1.0, 0.6, 0.3, 0.1, 0.03)   # default line-search steps
REG = 1e-6                            # default Levenberg-Marquardt floor


def autodiff_quads(cost_fn: Callable, term_cost_fn: Callable, refs,
                   term_ref):
    """JAX's default expansion (pallas_ilqr.py's ``quad_fn`` and
    ``term_quad_fn`` when none is given): exact gradients and Hessians of
    the per-knot costs ``cost_fn(x, u, ref_k)`` and
    ``term_cost_fn(x, ref_H)`` by torch.func, over (B, H) knots and B
    scenarios. Returns (quad, term_quad) in the solver's closure form."""
    from torch.func import grad, hessian, vmap

    def quad_one(x, u, ref):
        return (hessian(cost_fn, argnums=0)(x, u, ref),
                grad(cost_fn, argnums=0)(x, u, ref),
                hessian(cost_fn, argnums=1)(x, u, ref),
                grad(cost_fn, argnums=1)(x, u, ref))

    def term_one(x, ref):
        return (hessian(term_cost_fn, argnums=0)(x, ref),
                grad(term_cost_fn, argnums=0)(x, ref))

    vquad, vterm = vmap(vmap(quad_one)), vmap(term_one)
    # a 0-dim tensor times a Python float has a float64 tangent in
    # torch.func: the blocks come back in the states' dtype
    return (lambda xs, us: tuple(t.to(xs.dtype)
                                 for t in vquad(xs, us, refs)),
            lambda xH: tuple(t.to(xH.dtype) for t in vterm(xH, term_ref)))


def knot_total_cost(cost_fn: Callable, term_cost_fn: Callable, refs,
                    term_ref) -> Callable:
    """(xs, us) -> (B,) summed stage costs plus the terminal cost, from the
    per-knot costs (JAX's ``total_cost``)."""
    from torch.func import vmap

    stage, term = vmap(vmap(cost_fn)), vmap(term_cost_fn)
    return lambda xs, us: (stage(xs[:, :-1], us, refs).sum(-1)
                           + term(xs[:, -1], term_ref))


def ilqr_chain_batch(
    plan: ChainPlan,
    substeps: int,
    total_cost: Callable,   # (xs (B,H+1,nx), us (B,H,nu)) -> (B,), or None
    quad: Callable,         # (xs (B,H,nx), us) -> (X, q, U, r), or None
    term_quad: Callable,    # (xH (B,nx)) -> (XH, qH), or None
    x0: torch.Tensor,       # (B, nx)
    u_init: torch.Tensor,   # (B, H, nu)
    kernel_cost=None,       # ((stage_cb, term_cb), sref (B,H,R), tref (B,RT))
    iters: int = 6,
    *,
    alphas=ALPHAS,
    reg: float = REG,
    fast_lin: bool = True,
    parallel_backward: bool = None,
    cost_fn: Callable = None,       # (x, u, ref_k) -> scalar stage cost
    term_cost_fn: Callable = None,  # (x, ref_H) -> scalar terminal cost
    refs=None,                      # tree of (B, H, ...) knot references
    term_ref=None,                  # tree of (B, ...) terminal references
) -> ILQRResult:
    """Solve B independent trajectory optimizations in lock-step.

    ``total_cost``, ``quad`` and ``term_quad`` may be None where the
    per-knot ``cost_fn``/``term_cost_fn`` and their references are given
    (``knot_total_cost``, ``autodiff_quads``). ``kernel_cost`` fuses the
    candidates' costs into the line search; None costs them with
    ``total_cost`` after it. More than 8 ``alphas`` run as several
    line-search launches of at most 8, in order (the first index still
    wins ties). ``fast_lin`` linearizes by one substep and composes
    (``lin_fd_fast``, a power-of-two ``substeps``); False differences the
    full ``substeps`` (``lin_fd``). ``parallel_backward`` None runs the
    Riccati kernel (its plain version on CPU tensors); True / False the
    plain parallel-in-time / sequential pass."""
    B = u_init.shape[0]
    alphas = tuple(float(a) for a in alphas)
    if total_cost is None:
        total_cost = knot_total_cost(cost_fn, term_cost_fn, refs, term_ref)
    if quad is None or term_quad is None:
        auto_quad, auto_term = autodiff_quads(cost_fn, term_cost_fn, refs,
                                              term_ref)
        quad = auto_quad if quad is None else quad
        term_quad = auto_term if term_quad is None else term_quad
    lin = lin_fd_fast if fast_lin else lin_fd

    def riccati(F, L, X, q, U, r, XH, qH, rg):
        if parallel_backward is None:
            # the kernel reads every block at full size, batch-first: the
            # quadratizations' expanded constants are materialised here
            return backward(*(t.contiguous()
                              for t in (F, L, X, q, U, r, XH, qH)), rg)
        c = torch.zeros_like(q)
        p = lqr.LQR(F=F, L=L, c=c, X=X, q=q, U=U, r=r, XH=XH, qH=qH)
        pass_ = (lqr.backward_parallel if parallel_backward
                 else lqr.backward_sequential)
        return pass_(p, rg)

    def expand_and_backward(xs, us, rg):
        F, L = lin(plan, substeps, xs[:, :-1], us)
        X, q, U, r = quad(xs[:, :-1], us)
        XH, qH = term_quad(xs[:, -1])
        return riccati(F, L, X, q, U, r, XH, qH, rg)

    def line_search(xs, us, gains):
        K, d = gains.K.contiguous(), gains.d.contiguous()
        parts = []
        for i in range(0, len(alphas), _NALPHA):
            al = alphas[i: i + _NALPHA]
            if kernel_cost is None:
                xs_c, us_c = rollout_closed(plan, substeps, x0, xs, us, K, d,
                                            al)
                costs = torch.stack([total_cost(xs_c[:, a], us_c[:, a])
                                     for a in range(len(al))], 1)
                parts.append((xs_c, us_c, costs))
            else:
                cbs, sref, tref = kernel_cost
                parts.append(rollout_closed(plan, substeps, x0, xs, us, K, d,
                                            al, cost=cbs, sref=sref,
                                            tref=tref))
        if len(parts) == 1:
            return parts[0]
        return tuple(torch.cat(t, 1) for t in zip(*parts))

    # the kernels read the public layout as it is: contiguous, batch-first
    x0, us = x0.contiguous(), u_init.contiguous()
    xs = rollout_open(plan, substeps, x0, us)
    cost = total_cost(xs, us)
    rg = torch.full((B,), reg, dtype=x0.dtype, device=x0.device)
    rows = torch.arange(B, device=x0.device)
    for _ in range(iters):
        gains = expand_and_backward(xs, us, rg)
        xs_c, us_c, costs = line_search(xs, us, gains)
        best = torch.argmin(costs, dim=1)      # first index on ties
        bcost = costs[rows, best]
        improved = (bcost < cost) & torch.isfinite(costs).all(1)
        xs = torch.where(improved[:, None, None], xs_c[rows, best], xs)
        us = torch.where(improved[:, None, None], us_c[rows, best], us)
        cost = torch.where(improved, bcost, cost)
        # per-scenario Levenberg-Marquardt schedule
        rg = torch.where(improved, torch.clamp_min(rg * 0.5, reg),
                         torch.clamp_max(rg * 10.0, 1e3))
    gains = expand_and_backward(xs, us, torch.full_like(rg, reg))
    return ILQRResult(xs=xs, us=us, cost=cost, gains=gains)
