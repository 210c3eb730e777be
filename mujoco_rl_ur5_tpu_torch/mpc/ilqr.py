"""iLQR over arbitrary differentiable torch dynamics, one instance at a time.

The port's counterpart of the JAX package's mpc/ilqr.py: plan an H-step
control trajectory by repeatedly (1) linearizing the dynamics along the
nominal trajectory, every knot's Jacobians at once with
``torch.func.vmap(jacfwd)``, (2) solving the LQT subproblem with a Riccati
pass of mpc/lqr.py (parallel in time or sequential), and (3) line-searching
the closed-loop rollout, all step sizes as one vmapped rollout. The
iteration count is fixed.

``dyn_step`` and the cost functions are written for one instance (x (nx,),
u (nu,)) and must pass through ``torch.func`` transforms: no in-place
writes, no branches on values. This optimizer launches many small
operations per knot; the batched grasp-MPC solves go through the fused
kernels of mpc/cuda_ilqr.py instead.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch.func import grad, hessian, jacfwd, vmap

from mujoco_rl_ur5_tpu_torch.mpc.lqr import (
    LQR, Gains, backward_parallel, backward_sequential, rollout_policy,
)


class ILQRResult(NamedTuple):
    """A solve's outcome; the batched solvers put a leading B on each field."""

    xs: torch.Tensor   # (H+1, nx) optimized state trajectory
    us: torch.Tensor   # (H, nu) optimized controls
    cost: torch.Tensor  # () final total cost
    gains: Gains       # feedback policy around the solution (warm starts
                       # and closed-loop execution)


def _total_cost(cost_fn, term_cost_fn, xs, us, refs, term_ref):
    return (vmap(cost_fn)(xs[:-1], us, refs).sum()
            + term_cost_fn(xs[-1], term_ref))


def ilqr(
    dyn_step: Callable,       # (x, u) -> x_next
    cost_fn: Callable,        # (x, u, ref_k) -> scalar stage cost
    term_cost_fn: Callable,   # (x, ref_H) -> scalar terminal cost
    x0: torch.Tensor,         # (nx,)
    u_init: torch.Tensor,     # (H, nu)
    refs,                     # tensor or tuple of tensors, leading axis H
    term_ref,                 # terminal reference, same structure
    iters: int = 10,
    alphas=(1.0, 0.6, 0.3, 0.1, 0.03),
    reg: float = 1e-6,
    parallel: bool = True,
    u_lo=None,
    u_hi=None,
    lin_chunks: int = 1,
    quad_fn: Callable = None,       # (x, u, ref) -> (X, q, U, r)
    term_quad_fn: Callable = None,  # (x, ref) -> (XH, qH)
) -> ILQRResult:
    """Solve one trajectory-optimization problem.

    ``lin_chunks`` splits the horizon-wide linearization into that many
    sequential chunks: the forward-mode tangents of the dynamics hold
    H * (nx + nu) copies of its intermediates at once, and chunking divides
    that peak by the chunk count. ``quad_fn`` / ``term_quad_fn`` replace the
    autodiff cost expansion by an analytic (typically Gauss-Newton) one,
    which is positive semidefinite by construction."""
    H = u_init.shape[0]
    backward = backward_parallel if parallel else backward_sequential
    alphas = torch.as_tensor(alphas, dtype=x0.dtype, device=x0.device)
    if H % lin_chunks:
        raise ValueError(f"lin_chunks={lin_chunks} must divide H={H}")
    if u_lo is not None:
        u_lo = torch.as_tensor(u_lo, dtype=x0.dtype, device=x0.device)
        u_hi = torch.as_tensor(u_hi, dtype=x0.dtype, device=x0.device)

    def open_loop(us):
        xs = [x0]
        for k in range(H):
            xs.append(dyn_step(xs[-1], us[k]))
        return torch.stack(xs)

    lin_dyn = vmap(jacfwd(dyn_step, argnums=(0, 1)))

    def lin_all(xs_k, us_k):
        n = H // lin_chunks
        parts = [lin_dyn(xs_k[c: c + n], us_k[c: c + n])
                 for c in range(0, H, n)]
        return (torch.cat([F for F, _ in parts]),
                torch.cat([L for _, L in parts]))

    if quad_fn is None:
        def quad_fn(x, u, ref):
            return (hessian(cost_fn, argnums=0)(x, u, ref),
                    grad(cost_fn, argnums=0)(x, u, ref),
                    hessian(cost_fn, argnums=1)(x, u, ref),
                    grad(cost_fn, argnums=1)(x, u, ref))
    if term_quad_fn is None:
        def term_quad_fn(x, ref):
            return (hessian(term_cost_fn, argnums=0)(x, ref),
                    grad(term_cost_fn, argnums=0)(x, ref))

    def expand_and_backward(xs, us, rg):
        F, L = lin_all(xs[:-1], us)
        X, q, U, r = vmap(quad_fn)(xs[:-1], us, refs)
        XH, qH = term_quad_fn(xs[-1], term_ref)
        # expansion around the nominal: defect c = 0 (the rollout is exact).
        # The cast: torch.func gives a 0-dim tensor combined with a Python
        # float a float64 derivative
        p = LQR(*[t[None].to(x0.dtype)
                  for t in (F, L, torch.zeros_like(xs[:-1]), X, q, U, r, XH,
                            qH)])
        return Gains(*[t[0] for t in backward(p, reg=rg)])

    def try_alpha(a, xs, us, gains):
        xs_a, us_a = rollout_policy(dyn_step, x0, xs, us, gains, a,
                                    u_lo=u_lo, u_hi=u_hi)
        return xs_a, us_a, _total_cost(cost_fn, term_cost_fn, xs_a, us_a,
                                       refs, term_ref)

    us = u_init
    xs = open_loop(us)
    cost = _total_cost(cost_fn, term_cost_fn, xs, us, refs, term_ref)
    rg = reg
    for _ in range(iters):
        gains = expand_and_backward(xs, us, rg)
        xs_c, us_c, costs = vmap(
            lambda a: try_alpha(a, xs, us, gains))(alphas)
        best = int(torch.argmin(costs))        # first index on ties
        # Levenberg-Marquardt schedule: a rejected step would repeat the
        # identical iteration; raising reg bends the next step toward
        # gradient descent until some alpha improves
        if bool(costs[best] < cost):
            xs, us, cost = xs_c[best], us_c[best], costs[best]
            rg = max(rg * 0.5, reg)
        else:
            rg = min(rg * 10.0, 1e3)
    # the policy around the final trajectory (for closed-loop execution)
    return ILQRResult(xs=xs, us=us, cost=cost,
                      gains=expand_and_backward(xs, us, reg))
