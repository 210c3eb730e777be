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


def solve_general_small(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve A X = B for general (non-symmetric) blocks A (..., n, n),
    B (..., n, m) by unrolled Gauss-Jordan elimination with partial
    pivoting (first largest entry, as ``argmax``). The parallel Riccati
    pass (mpc/lqr.py) inverts its (I + C J) blocks with it."""
    n = A.shape[-1]
    M = torch.cat([A, B], -1)                              # (..., n, n+m)
    idx = torch.arange(n, device=A.device)
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    for k in range(n):
        col = torch.where(idx >= k, M[..., :, k].abs(), -1.0)
        P = eye[torch.argmax(col, -1)]                     # (..., n) one-hot
        rowp = torch.einsum("...n,...nm->...m", P, M)
        rowk = M[..., k, :]
        e_k = eye[k]
        # swap rows k <-> pivot (the corrections cancel when pivot == k)
        M = (M + e_k[:, None] * (rowp - rowk)[..., None, :]
             + P[..., None] * (rowk - rowp)[..., None, :])
        rk = M[..., k, :] / M[..., k, k][..., None]
        f = torch.where(idx == k, 0.0, M[..., :, k])
        M = M - f[..., None] * rk[..., None, :]
        M = torch.where((idx == k)[:, None], rk[..., None, :], M)
    return M[..., n:]


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
