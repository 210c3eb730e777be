# Frozen copy of mujoco_rl_ur5_tpu_torch/ops/blockchol.py at commit c4951def7b192ba06c207f9c1c9298bddc6ddcb8, imports
# rewritten to this package; the benchmark's plain reference. Dropped, as no
# check or count calls them: solve_general_small.
"""Unrolled dense linear algebra for tiny SPD blocks (n <= ~16), in torch.

The port's copy of the JAX package's ops/blockchol: the factorization and
substitution loops are unrolled over the static block width, so a batch of
(..., n, n) blocks costs a few elementwise ops per entry. These are the
plain versions the Riccati passes (mpc/lqr.py) and the chain step
(physics/chain.py) use; the kernels carry their own unrolled copies.
All functions take arbitrary leading batch dims.
"""

from __future__ import annotations

import torch


def chol_small(A: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Lower Cholesky factor of SPD blocks A (..., n, n), unrolled; pivots
    are clamped at ``eps`` before the square root."""
    n = A.shape[-1]
    cols = []
    for j in range(n):
        a_j = A[..., :, j]
        if j:
            Lmat = torch.stack(cols, -1)                   # (..., n, j)
            a_j = a_j - torch.einsum("...ik,...k->...i", Lmat, Lmat[..., j, :])
        # clamp before indexing: a 0-dim pivot combined with the Python
        # float would get a float64 tangent under torch.func.jvp
        d = torch.sqrt(torch.clamp_min(a_j, eps)[..., j])
        col = a_j / d[..., None]
        col = torch.cat([torch.zeros_like(col[..., :j]), d[..., None],
                         col[..., j + 1:]], -1)
        cols.append(col)
    return torch.stack(cols, -1)


def solve_lower(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve L X = B for lower-triangular L (..., n, n), B (..., n, m)."""
    rows = []
    for i in range(L.shape[-1]):
        b_i = B[..., i, :]
        if i:
            b_i = b_i - torch.einsum("...k,...km->...m", L[..., i, :i],
                                     torch.stack(rows, -2))
        rows.append(b_i / L[..., i, i][..., None])
    return torch.stack(rows, -2)


def solve_upper_t(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve L^T X = B (backward substitution), L lower-triangular."""
    n = L.shape[-1]
    rows = [None] * n
    for i in reversed(range(n)):
        b_i = B[..., i, :]
        if i < n - 1:
            b_i = b_i - torch.einsum("...k,...km->...m", L[..., i + 1:, i],
                                     torch.stack(rows[i + 1:], -2))
        rows[i] = b_i / L[..., i, i][..., None]
    return torch.stack(rows, -2)


def cho_solve_small(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve A X = B given L = chol_small(A); B (..., n, m)."""
    return solve_upper_t(L, solve_lower(L, B))


def solve_spd_scaled(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for SPD A (..., n, n), b (..., n) with Jacobi
    equilibration: factor D^-1/2 A D^-1/2 (D = diag A). The arm's mass
    matrix mixes 8 kg links with 1e-6 kg m^2 finger inertias (cond ~1e7);
    the scaled system keeps the f32 Cholesky accurate."""
    s = torch.rsqrt(torch.clamp_min(torch.diagonal(A, dim1=-2, dim2=-1),
                                    1e-30))
    As = A * s[..., :, None] * s[..., None, :]
    y = cho_solve_small(chol_small(As), (b * s)[..., None])[..., 0]
    return y * s
