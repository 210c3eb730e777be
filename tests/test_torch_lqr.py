"""The port's Riccati pass and small-block solves against the JAX package's.

* ops/blockchol: ``chol_small``, ``cho_solve_small`` and
  ``solve_spd_scaled`` against JAX's on random SPD blocks;
* mpc/lqr.backward_sequential (general affine dynamics, scalar reg) against
  ``vmap(backward_sequential)``;
* mpc/cuda_lqr.backward on CPU tensors, the plain version of the Riccati
  kernel, against ``vmap(backward_sequential)`` at c = 0 with a per-scenario
  Levenberg-Marquardt reg, at the solver's widths (nx=16, nu=7).

Never against ``backward_pallas`` in interpret mode (minutes); the JAX
package's own tests hold that kernel equal to the sequential pass. All in
float32: the two packages sum in another order, and the Riccati recursion
carries that over H steps, so values agree to 1e-4 of each output's scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_rl_ur5_tpu.mpc.lqr import LQR as JaxLQR
from mujoco_rl_ur5_tpu.mpc.lqr import backward_sequential as jax_backward
from mujoco_rl_ur5_tpu.ops import blockchol as jbc
from mujoco_rl_ur5_tpu_torch.mpc.cuda_lqr import backward
from mujoco_rl_ur5_tpu_torch.mpc.lqr import LQR, backward_sequential
from mujoco_rl_ur5_tpu_torch.ops import blockchol as tbc


def _spd(rng, shape, n, scale=1.0, floor=0.1):
    W = rng.standard_normal(shape + (n, n))
    return (scale * W @ np.swapaxes(W, -1, -2) / n
            + floor * np.eye(n)).astype(np.float32)


def _assert_scaled(a, b, tol, name=""):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(np.abs(b).max(), 1e-30)
    assert np.abs(a - b).max() <= tol * scale, (
        f"{name}: max |d| {np.abs(a - b).max():.3e} > {tol} x {scale:.3e}")


@pytest.mark.parametrize("n", [7, 8, 16])
def test_blockchol_matches_jax(n):
    rng = np.random.default_rng(n)
    A = _spd(rng, (5,), n)
    Bm = rng.standard_normal((5, n, 3)).astype(np.float32)
    L_t = tbc.chol_small(torch.from_numpy(A))
    L_j = jbc.chol_small(jnp.asarray(A))
    _assert_scaled(L_t.numpy(), L_j, 1e-5, "chol")
    X_t = tbc.cho_solve_small(L_t, torch.from_numpy(Bm))
    X_j = jbc.cho_solve_small(L_j, jnp.asarray(Bm))
    _assert_scaled(X_t.numpy(), X_j, 1e-5, "cho_solve")


def test_solve_spd_scaled_matches_jax_on_arm_conditioning():
    """Mass matrices that mix 8 kg links with 1e-6 finger inertias: the
    Jacobi-equilibrated solve keeps f32 accurate; both packages agree."""
    rng = np.random.default_rng(7)
    d = np.array([8.0, 6.0, 2.0, 0.5, 0.2, 0.1, 1e-6, 1e-6])
    Q = np.linalg.qr(rng.standard_normal((8, 8)))[0]
    A = (np.sqrt(d)[:, None] * (np.eye(8) + 0.1 * Q @ Q.T)
         * np.sqrt(d)[None, :])
    A = np.broadcast_to(A, (4, 8, 8)).astype(np.float32)
    b = rng.standard_normal((4, 8)).astype(np.float32)
    x_t = tbc.solve_spd_scaled(torch.from_numpy(A), torch.from_numpy(b))
    x_j = jbc.solve_spd_scaled(jnp.asarray(A), jnp.asarray(b))
    _assert_scaled(x_t.numpy(), x_j, 1e-5, "solve_spd_scaled")
    x64 = np.linalg.solve(A.astype(np.float64),
                          b.astype(np.float64)[..., None])[..., 0]
    _assert_scaled(x_t.numpy(), x64, 1e-4, "vs float64")


def _problem(seed, B, H, nx, nu, affine):
    rng = np.random.default_rng(seed)
    f = np.float32
    F = (np.eye(nx) + 0.1 * rng.standard_normal((B, H, nx, nx))).astype(f)
    L = (0.1 * rng.standard_normal((B, H, nx, nu))).astype(f)
    c = (0.1 * rng.standard_normal((B, H, nx)) if affine
         else np.zeros((B, H, nx))).astype(f)
    X = _spd(rng, (B, H), nx, floor=1.0)
    q = rng.standard_normal((B, H, nx)).astype(f)
    U = _spd(rng, (B, H), nu, scale=0.1, floor=1e-3)
    r = rng.standard_normal((B, H, nu)).astype(f)
    XH = _spd(rng, (B,), nx, floor=1.0)
    qH = rng.standard_normal((B, nx)).astype(f)
    return F, L, c, X, q, U, r, XH, qH


def _jax_reference(p, reg):
    return jax.vmap(lambda F, L, c, X, q, U, r, XH, qH, rg: jax_backward(
        JaxLQR(F, L, c, X, q, U, r, XH, qH), reg=rg))(
            *(jnp.asarray(a) for a in p), jnp.asarray(reg))


def test_backward_sequential_matches_jax():
    B, H = 3, 5
    p = _problem(0, B, H, 6, 3, affine=True)
    got = backward_sequential(LQR(*(torch.from_numpy(a) for a in p)), 1e-6)
    want = _jax_reference(p, np.full(B, 1e-6, np.float32))
    for name in ("K", "d", "S", "s"):
        _assert_scaled(getattr(got, name).numpy(), getattr(want, name), 1e-4,
                       name)


def test_riccati_kernel_plain_version_matches_jax():
    """cuda_lqr.backward on CPU tensors (its plain version) at nx=16, nu=7,
    c = 0 and per-scenario reg, as the iLQR calls it."""
    B, H = 4, 6
    F, L, c, X, q, U, r, XH, qH = _problem(1, B, H, 16, 7, affine=False)
    reg = np.array([1e-6, 1e-3, 1.0, 10.0], np.float32)
    t = torch.from_numpy
    got = backward(t(F), t(L), t(X), t(q), t(U), t(r), t(XH), t(qH), t(reg))
    want = _jax_reference((F, L, c, X, q, U, r, XH, qH), reg)
    assert got.K.shape == (B, H, 7, 16) and got.S.shape == (B, H + 1, 16, 16)
    for name in ("K", "d", "S", "s"):
        _assert_scaled(getattr(got, name).numpy(), getattr(want, name), 1e-4,
                       name)
