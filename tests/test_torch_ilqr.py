"""The per-instance optimizer and the parallel Riccati pass: the port
against the JAX package on the CPU, inputs seeded with numpy.

* ``solve_general_small`` against ``numpy.linalg.solve`` and the JAX
  function (1e-4 relative: f32 Gauss-Jordan on blocks with cond ~10).
* ``backward_parallel`` against the port's ``backward_sequential`` and
  against JAX ``backward_parallel`` on a random LQR with c != 0 (atol 2e-3
  on gains and value functions of size ~1-10: the two passes associate the
  same f32 products differently; JAX's own gate between its two passes is
  of this size).
* ``rollout_policy`` against JAX on a linear system (1e-5).
* ``ilqr`` on the double integrator and the pendulum of the JAX package's
  tests/test_mpc.py, with the assertions of those tests, and the cost within
  1e-3 relative of JAX ``ilqr``.
* ``GraspMPC.dyn_step``, ``solve`` and ``track`` (``dyn_step`` and
  ``track`` in tests/test_torch_ilqr_track.py, which runs beside this file
  under ``--dist loadfile``) on the fixture against JAX
  (``use_pallas=False``, the same ``parallel``) at H=4, substeps=2, iters=2,
  ``w_ctrl=1``: cost at 1e-3 relative, controls and states at 1e-2
  absolute. Both sides take exact forward-mode Jacobians here, so they
  agree much closer than the forward-difference batched solvers; the
  tolerances are those of the batched slice tests. At the default
  ``w_ctrl=1e-3`` this short horizon leaves the controls undetermined.

The dynamics given to the port's ``ilqr`` combine 0-dim tensors only with
tensors, never with Python floats: ``torch.func.jvp`` (torch 2.x) gives such
a result a float64 tangent.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_rl_ur5_tpu.mpc import ilqr as jax_ilqr
from mujoco_rl_ur5_tpu.mpc import lqr as jlqr
from mujoco_rl_ur5_tpu.mpc.grasp_mpc import GraspMPC as JaxGraspMPC
from mujoco_rl_ur5_tpu.mpc.grasp_mpc import MPCWeights as JaxWeights
from mujoco_rl_ur5_tpu.ops.blockchol import (
    solve_general_small as jax_solve_general,
)
from mujoco_rl_ur5_tpu_torch import ASSET
from mujoco_rl_ur5_tpu_torch.carry import PLAN_FIELDS, plan_from_arrays
from mujoco_rl_ur5_tpu_torch.mpc import lqr as tlqr
from mujoco_rl_ur5_tpu_torch.mpc.grasp_mpc import GraspMPC, MPCWeights
from mujoco_rl_ur5_tpu_torch.mpc.ilqr import ilqr
from mujoco_rl_ur5_tpu_torch.ops.blockchol import solve_general_small

HOME = np.array([0.0, -1.57, 1.57, -1.57, -1.57, 0.0, 0.0, 0.0])


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def test_solve_general_small_matches_numpy_and_jax():
    rng = np.random.default_rng(0)
    A = (np.eye(6) + 0.4 * rng.standard_normal((5, 6, 6))).astype(np.float32)
    A[0, 0, 0] = 0.0                      # forces a row swap at the first pivot
    Bm = rng.standard_normal((5, 6, 3)).astype(np.float32)
    got = solve_general_small(_t(A), _t(Bm)).numpy()
    want = np.linalg.solve(A.astype(np.float64), Bm.astype(np.float64))
    scale = np.abs(want).max()
    assert np.abs(got - want).max() < 1e-4 * scale
    jgot = np.asarray(jax_solve_general(jnp.asarray(A), jnp.asarray(Bm)))
    assert np.abs(got - jgot).max() < 1e-4 * scale


def _random_lqr(seed, B=3, H=9, nx=4, nu=2):
    """A stable random LQT problem with affine terms (c != 0)."""
    rng = np.random.default_rng(seed)

    def spd(*shape):
        M = rng.standard_normal(shape + (shape[-1],))
        return M @ np.swapaxes(M, -1, -2) / shape[-1] + 0.5 * np.eye(shape[-1])

    nxp = dict(
        F=np.eye(nx) + 0.2 * rng.standard_normal((B, H, nx, nx)),
        L=0.5 * rng.standard_normal((B, H, nx, nu)),
        c=0.1 * rng.standard_normal((B, H, nx)),
        X=spd(B, H, nx), q=0.3 * rng.standard_normal((B, H, nx)),
        U=spd(B, H, nu), r=0.3 * rng.standard_normal((B, H, nu)),
        XH=spd(B, nx), qH=0.3 * rng.standard_normal((B, nx)))
    return {k: v.astype(np.float32) for k, v in nxp.items()}


@pytest.mark.parametrize("H", [1, 8, 9])
def test_backward_parallel_matches_sequential_and_jax(H):
    d = _random_lqr(1, H=H)
    reg = np.array([1e-6, 1e-3, 0.1], np.float32)
    p = tlqr.LQR(**{k: _t(v) for k, v in d.items()})
    par = tlqr.backward_parallel(p, _t(reg))
    seq = tlqr.backward_sequential(p, _t(reg))
    jp = jlqr.LQR(**{k: jnp.asarray(v) for k, v in d.items()})
    jpar = jax.vmap(lambda pp, rg: jlqr.backward_parallel(pp, reg=rg))(
        jp, jnp.asarray(reg))
    for name in ("K", "d", "S", "s"):
        a = getattr(par, name).numpy()
        assert a.shape == getattr(seq, name).shape
        np.testing.assert_allclose(a, getattr(seq, name).numpy(), atol=2e-3,
                                   err_msg=f"{name} vs sequential")
        np.testing.assert_allclose(a, np.asarray(getattr(jpar, name)),
                                   atol=2e-3, err_msg=f"{name} vs JAX")


def test_rollout_policy_matches_jax():
    rng = np.random.default_rng(2)
    H, nx, nu = 6, 4, 2
    Am = (np.eye(nx) + 0.1 * rng.standard_normal((nx, nx))).astype(np.float32)
    Bm = (0.3 * rng.standard_normal((nx, nu))).astype(np.float32)
    x0 = rng.standard_normal(nx).astype(np.float32)
    xbar = rng.standard_normal((H + 1, nx)).astype(np.float32)
    ubar = rng.standard_normal((H, nu)).astype(np.float32)
    K = (0.2 * rng.standard_normal((H, nu, nx))).astype(np.float32)
    dd = rng.standard_normal((H, nu)).astype(np.float32)
    lo, hi = np.full(nu, -1.0, np.float32), np.full(nu, 1.0, np.float32)
    tg = tlqr.Gains(K=_t(K), d=_t(dd), S=None, s=None)
    jg = jlqr.Gains(K=jnp.asarray(K), d=jnp.asarray(dd), S=None, s=None)
    for clamp in (False, True):
        xs, us = tlqr.rollout_policy(
            lambda x, u: _t(Am) @ x + _t(Bm) @ u, _t(x0), _t(xbar), _t(ubar),
            tg, 0.6, *((_t(lo), _t(hi)) if clamp else ()))
        jxs, jus = jlqr.rollout_policy(
            lambda x, u: jnp.asarray(Am) @ x + jnp.asarray(Bm) @ u,
            jnp.asarray(x0), jnp.asarray(xbar), jnp.asarray(ubar), jg, 0.6,
            *((jnp.asarray(lo), jnp.asarray(hi)) if clamp else ()))
        assert xs.shape == (H + 1, nx) and us.shape == (H, nu)
        np.testing.assert_allclose(xs.numpy(), np.asarray(jxs), atol=1e-5)
        np.testing.assert_allclose(us.numpy(), np.asarray(jus), atol=1e-5)
        if clamp:
            assert float(us.abs().max()) <= 1.0


def test_ilqr_double_integrator_reaches_target():
    """iLQR drives a 2D double integrator to a target; the parallel and the
    sequential backward pass agree on the solution, and on JAX's."""
    dt, H = 0.1, 30
    target = np.array([1.0, -0.5], np.float32)

    def dyn(x, u):
        p, v = x[:2], x[2:]
        return torch.cat([p + dt * v, v + dt * u])

    def stage(x, u, ref):
        return 0.5 * 1e-2 * u @ u + 0.5 * 0.1 * (x[:2] - ref) @ (x[:2] - ref)

    def term(x, ref):
        e = x[:2] - ref
        return 0.5 * 50.0 * e @ e + 0.5 * 5.0 * x[2:] @ x[2:]

    def jdyn(x, u):
        p, v = x[:2], x[2:]
        return jnp.concatenate([p + dt * v, v + dt * u])

    refs = np.tile(target[None], (H, 1))
    sols = {}
    for par in (True, False):
        res = ilqr(dyn, stage, term, torch.zeros(4), torch.zeros(H, 2),
                   _t(refs), _t(target), iters=12, parallel=par)
        err = np.linalg.norm(res.xs[-1][:2].numpy() - target)
        assert err < 1e-2, f"parallel={par}: terminal error {err}"
        sols[par] = res.us.numpy()
        jres = jax.jit(lambda: jax_ilqr(
            jdyn, stage, term, jnp.zeros(4), jnp.zeros((H, 2)),
            jnp.asarray(refs), jnp.asarray(target), iters=12, parallel=par))()
        assert abs(float(res.cost) - float(jres.cost)) \
            < 1e-3 * abs(float(jres.cost))
        np.testing.assert_allclose(res.us.numpy(), np.asarray(jres.us),
                                   atol=1e-3)
        assert res.gains.K.shape == (H, 2, 4) and res.gains.S.shape == (
            H + 1, 4, 4)
    np.testing.assert_allclose(sols[True], sols[False], atol=1e-4)


def test_ilqr_nonlinear_pendulum_swing():
    """iLQR swings a damped pendulum to upright: a nonlinear problem where
    several linearization rounds must help. Cost expansions by autodiff."""
    dt, H = 0.05, 60

    def dyn(x, u):
        th, w = x[0:1], x[1:2]
        wdot = -9.81 * torch.sin(th) - 0.1 * w + u
        return torch.cat([th + dt * w, w + dt * wdot])

    def stage(x, u, ref):
        return ((0.5 * 1e-3 * u * u).sum()
                + (0.5 * 0.1 * (x[0:1] - math.pi) ** 2).sum())

    def term(x, ref):
        return ((0.5 * 100.0 * (x[0:1] - math.pi) ** 2).sum()
                + (0.5 * 1.0 * x[1:2] ** 2).sum())

    def jdyn(x, u):
        th, w = x[0], x[1]
        wdot = -9.81 * jnp.sin(th) - 0.1 * w + u[0]
        return jnp.asarray([th + dt * w, w + dt * wdot])

    def jstage(x, u, ref):
        return 0.5 * 1e-3 * u @ u + 0.5 * 0.1 * (x[0] - jnp.pi) ** 2

    def jterm(x, ref):
        return 0.5 * 100.0 * (x[0] - jnp.pi) ** 2 + 0.5 * 1.0 * x[1] ** 2

    res = ilqr(dyn, stage, term, torch.zeros(2), torch.zeros(H, 1),
               torch.zeros(H, 0), torch.zeros(0), iters=25)
    assert abs(float(res.xs[-1][0]) - np.pi) < 0.05
    jres = jax.jit(lambda: jax_ilqr(
        jdyn, jstage, jterm, jnp.zeros(2), jnp.zeros((H, 1)),
        jnp.zeros((H, 0)), jnp.zeros(0), iters=25))()
    assert abs(float(res.cost) - float(jres.cost)) \
        < 1e-3 * abs(float(jres.cost))


def test_ilqr_rejects_a_chunk_count_that_does_not_divide():
    with pytest.raises(ValueError, match="lin_chunks"):
        ilqr(lambda x, u: x, None, None, torch.zeros(2), torch.zeros(6, 1),
             None, None, lin_chunks=4)


# -- GraspMPC.solve / .track on the fixture -------------------------------------

H, SUBSTEPS, ITERS = 4, 2, 2


@pytest.fixture(scope="module", params=[True, False],
                ids=["parallel", "sequential"])
def solvers(request):
    kw = dict(horizon=H, substeps=SUBSTEPS, iters=ITERS,
              parallel=request.param, lin_chunks=3)
    jmpc = JaxGraspMPC.from_scene(ASSET, use_pallas=False,
                                  weights=JaxWeights(w_ctrl=1.0), **kw)
    tmpc = GraspMPC.from_scene(ASSET, device="cpu",
                               weights=MPCWeights(w_ctrl=1.0), **kw)
    tmpc.plan = plan_from_arrays({f: np.asarray(getattr(jmpc.plan, f))
                                  for f in PLAN_FIELDS})
    rng = np.random.default_rng(7)
    x0 = np.concatenate([HOME + 0.05 * rng.standard_normal(8),
                         0.05 * rng.standard_normal(8)]).astype(np.float32)
    return jmpc, tmpc, rng, x0


def _compare(jres, tres):
    assert abs(float(tres.cost) - float(jres.cost)) \
        < 1e-3 * abs(float(jres.cost))
    np.testing.assert_allclose(tres.us.numpy(), np.asarray(jres.us),
                               atol=1e-2)
    np.testing.assert_allclose(tres.xs.numpy(), np.asarray(jres.xs),
                               atol=1e-2)
    assert tres.xs.shape == (H + 1, 16) and tres.us.shape == (H, 7)
    assert tres.gains.K.shape == (H, 7, 16)
    assert tres.gains.S.shape == (H + 1, 16, 16)


def test_lin_chunks_falls_back_to_a_divisor(solvers):
    jmpc, tmpc, *_ = solvers
    assert tmpc.lin_chunks == jmpc.lin_chunks == 2      # asked 3, H = 4


def test_solve_matches_jax(solvers):
    jmpc, tmpc, _, x0 = solvers
    target = np.array([0.05, -0.55, 1.05], np.float32)
    jres = jmpc.solve(jnp.asarray(x0), jnp.asarray(target))
    tres = tmpc.solve(_t(x0), _t(target))
    _compare(jres, tres)
    # the solve improved on the gravity hold, in cost and in EE error
    q0, qH = _t(x0[:8]), tres.xs[-1, :8]
    u0 = tmpc.hold_ctrl(q0).expand(H, -1)
    x = _t(x0)
    start = 0.0
    for k in range(H):
        start = start + tmpc._reach_stage(x, u0[k], _t(target))
        x = tmpc.dyn_step(x, u0[k])
    start = start + tmpc._reach_term(x, _t(target))
    assert float(tres.cost) < float(start)
    e_hold = float((tmpc.ee_pos(x[:8]) - _t(target)).norm())
    e_solved = float((tmpc.ee_pos(qH) - _t(target)).norm())
    assert e_solved < e_hold
