"""The needed work of a batched iLQR solve's chain layer: its rollouts,
linearizations, stage quadratizations and Riccati passes, per call, from
the cell's shapes (B, H, substeps, iterations, alphas, nx, nu).

Copied from the repository's chip_smoke.py at commit
c4951def7b192ba06c207f9c1c9298bddc6ddcb8 (``backward_flops``, and the
kernel rows of its phase 3). An FMA counts 2 operations; every input is
read once and every output written once, in float32. The per-knot counts
of the 8-dof arm below are those of the straight-line physics that the
repository's symbolic substep, cost and quadratization generators emit for
the arm submodel of ``scenes/ur5_2finger_arm.xml`` at that commit (the
CRBA, RNE and SPD solve of one substep; the reach and track costs; the
Gauss-Newton reach quadratization), frozen here.
"""

from __future__ import annotations

SUBSTEP_OPS = 4312                 # one 2 ms substep of the arm chain
COST_OPS = {"reach": (351, 316),   # (stage, terminal) per knot
            "track": (64, 49)}
QUAD_OPS = 696                     # one knot's reach quadratization
F32 = 4


def backward_flops(nx: int, nu: int) -> int:
    """Floating-point operations one Riccati step needs: the products and
    the one nu x nu factorization of the plain recursion."""
    fma = (nx * nu * nx                        # SL = S L
           + nu * nx + nx * nx                 # Qu, Qx
           + nu * (nu + 1) // 2 * nx           # Quu (upper triangle)
           + nu * nx * nx                      # Qux = (S L)' F
           + nu * (nu - 1) * (nu + 1) // 6     # Cholesky
           + (nx + 1) * nu * (nu - 1)          # nx + 1 two-sided solves
           + nx * nx * nx                      # T = S F
           + nx * (nx + 1) // 2 * (nx + 2 * nu)    # S update
           + nx * (nu + nu * (nu + 1)))        # s update
    other = (nu + nx + nu * (nu + 1) // 2 + nu   # additions of U, r, q, reg
             + 3 * nu                          # pivots: sub, sqrt, reciprocal
             + (nx + 1) * 4 * nu               # solve: sub and mul per row
             + nx * (nx + 1) // 2 * 3)         # S: X add, half-sum
    return 2 * fma + other


def solve_work(mode: str, B: int, H: int, S: int, iters: int, A: int,
               nx: int, nu: int) -> list:
    """[(part, calls, operations, bytes) per call] of one batched solve
    with ``iters`` iterations: ``mode`` "reach" (Gauss-Newton stage
    quadratization of the FK costs) or "track" (quadratic costs, no
    quadratization work); S substeps per knot, A line-search alphas."""
    rounds = S.bit_length() - 1
    lin_ops = B * H * ((nx + nu + 1) * SUBSTEP_OPS + (nx + nu) * nx * 2
                       + (2 * rounds - 1) * nx ** 3 * 2 + nx * nx * nu * 2)
    stage, term = COST_OPS[mode]
    law = nu * (2 + 3 * nx) + 2 * nu
    R = 2 * (nx // 2) if mode == "track" else 0
    RT = nx if mode == "track" else 3
    parts = [
        ("lin", iters + 1, lin_ops,
         F32 * B * H * (nx + nu + nx * nx + nx * nu)),
        ("backward", iters + 1, B * H * backward_flops(nx, nu),
         F32 * (B * H * (nx * nx + nx * nu + nx * nx + nx + nu * nu + nu)
                + B * (nx * nx + nx + 1)
                + B * H * (nu * nx + nu) + B * (H + 1) * (nx * nx + nx))),
        ("rollout_closed", iters,
         A * B * (H * (S * SUBSTEP_OPS + law + stage) + term),
         F32 * (B * nx + B * H * (nx + nu + nu * nx + nu + R) + B * RT
                + B * A * ((H + 1) * nx + H * nu + 1))),
        ("rollout_open", 1, B * H * S * SUBSTEP_OPS,
         F32 * (B * nx + B * H * nu + B * (H + 1) * nx)),
    ]
    if mode == "reach":
        parts.append(("quad", iters + 1, B * H * QUAD_OPS,
                      F32 * (B * H * nx + B * 3 + B * H * (nx * nx + nx))))
    return parts


def solve_bound_s(parts: list, bound_s) -> float:
    """The least time of a solve's chain layer on the card: each part's
    bound (``device.bound_s``) times its calls."""
    return sum(calls * bound_s(ops, nbytes)
               for _, calls, ops, nbytes in parts)
