"""The port's batched iLQR with the JAX solver's non-default options, held
against the JAX package's ``ilqr_chain_batch`` (mpc/pallas_ilqr.py) on the
same numpy-made problem.

Options: three line-search steps (1.0, 0.5, 0.25) and nine,
``reg=1e-4``, ``fast_lin=False`` at 6 substeps (full-knot differences: no
power of two), ``kernel_cost=None`` (the candidates' costs after the line
search), ``parallel_backward=False`` (the plain sequential Riccati pass)
and the autodiff expansion of the per-knot tracking costs (no ``quad``). With nine steps the port runs two line-search
launches (the kernel takes at most 8) and JAX one pass: the answers must
agree all the same.

JAX's Pallas calls are replaced, in ``pallas_ilqr``'s own namespace, by
stand-ins on the JAX package's plain ``physics/chain.chain_step`` (Pallas
interpret mode is far too slow here): the open and closed-loop rollouts
and the forward-difference linearization (step 1e-3) over the full knot.
The port runs on the CPU, where every kernel wrapper takes its plain
version.

The problem is determined (w_ctrl=1; see tests/test_torch_slice.py): the
costs agree to 1e-3 relative and the controls to 1e-2 absolute, as the
forward differences in float32 allow.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_rl_ur5_tpu.mpc import pallas_ilqr
from mujoco_rl_ur5_tpu.mpc.grasp_mpc import GraspMPC as JaxGraspMPC
from mujoco_rl_ur5_tpu.mpc.grasp_mpc import MPCWeights as JaxWeights
from mujoco_rl_ur5_tpu.physics.chain import chain_step
from mujoco_rl_ur5_tpu_torch import ASSET
from mujoco_rl_ur5_tpu_torch.mpc import cuda_ilqr
from mujoco_rl_ur5_tpu_torch.mpc.grasp_mpc import GraspMPC, MPCWeights

B, H, SUBSTEPS, ITERS = 3, 4, 6, 2
ALPHAS = {3: (1.0, 0.5, 0.25),
          9: (1.0, 0.8, 0.6, 0.5, 0.4, 0.3, 0.25, 0.1, 0.03)}
REG = 1e-4
EPS = 1e-3
HOME = np.array([0.0, -1.57, 1.57, -1.57, -1.57, 0.0, 0.0, 0.0])


def _problem():
    """Start states near home, each tracking a straight joint-space line to
    a target 0.01 rad away."""
    rng = np.random.default_rng(5)
    x0 = np.concatenate([HOME + 0.05 * rng.standard_normal((B, 8)),
                         0.05 * rng.standard_normal((B, 8))], -1)
    target = x0[:, :8] + 0.01 * rng.standard_normal((B, 8))
    s = np.linspace(0.0, 1.0, H + 1)[None, :, None]
    q_refs = x0[:, None, :8] * (1 - s) + target[:, None] * s
    return x0.astype(np.float32), q_refs.astype(np.float32)


def _stand_ins(plan):
    """JAX's rollout_open, lin_fd and rollout_closed on chain_step."""
    nv, nu = plan.nv, plan.nu
    nx = 2 * nv
    lo = jnp.asarray(plan.ctrlrange[:, 0], jnp.float32)
    hi = jnp.asarray(plan.ctrlrange[:, 1], jnp.float32)

    def knot(substeps, x, u):
        q, v = jax.lax.fori_loop(
            0, substeps, lambda i, c: chain_step(plan, c[0], c[1], u),
            (x[:nv], x[nv:]))
        return jnp.concatenate([q, v])

    def rollout_open(plan_, substeps, x0, us):
        def one(x0, us):
            def body(x, u):
                x2 = knot(substeps, x, u)
                return x2, x2
            return jnp.concatenate([x0[None],
                                    jax.lax.scan(body, x0, us)[1]])
        return jax.vmap(one)(x0, us)

    def lin_fd(plan_, substeps, xs, us):
        def one(x, u):
            base = knot(substeps, x, u)
            pert = EPS * jnp.eye(nx + nu, dtype=x.dtype)
            res = jax.vmap(lambda p: knot(substeps, x + p[:nx],
                                          u + p[nx:]))(pert)
            D = (res - base) / EPS                       # (nx + nu, nx)
            return D[:nx].T, D[nx:].T
        return jax.vmap(jax.vmap(one))(xs, us)

    def rollout_closed(plan_, substeps, x0, xbar, ubar, K, d, alphas,
                       cost=None, sref=None, tref=None):
        assert cost is None
        al = jnp.asarray(alphas, jnp.float32)

        def one(x0, xbar, ubar, K, d, a):
            def body(x, k):
                u = jnp.clip(ubar[k] + a * d[k] + K[k] @ (x - xbar[k]),
                             lo, hi)
                x2 = knot(substeps, x, u)
                return x2, (x2, u)
            _, (xs, us) = jax.lax.scan(body, x0, jnp.arange(ubar.shape[0]))
            return jnp.concatenate([x0[None], xs]), us

        per_alpha = jax.vmap(one, (None, None, None, None, None, 0))
        return jax.vmap(per_alpha, (0, 0, 0, 0, 0, None))(
            x0, xbar, ubar, K, d, al)

    return {"rollout_open": rollout_open, "lin_fd": lin_fd,
            "rollout_closed": rollout_closed}


@pytest.fixture(scope="module")
def solvers():
    kw = dict(horizon=H, substeps=SUBSTEPS, iters=ITERS)
    return (JaxGraspMPC.from_scene(ASSET, weights=JaxWeights(w_ctrl=1.0),
                                   **kw),
            GraspMPC.from_scene(ASSET, device="cpu",
                                weights=MPCWeights(w_ctrl=1.0), **kw))


@pytest.fixture(scope="module")
def jax_result(solvers):
    """JAX's solves with three and nine alphas, on the stand-ins."""
    jmpc = solvers[0]
    x0, q_refs = _problem()
    mp = pytest.MonkeyPatch()
    for name, fn in _stand_ins(jmpc.plan).items():
        mp.setattr(pallas_ilqr, name, fn)
    try:
        q = jnp.asarray(q_refs)
        u0 = jax.jit(jax.vmap(lambda x: jnp.tile(jmpc.hold_ctrl(x[:8])[None],
                                                 (H, 1))))(jnp.asarray(x0))
        refs = (q[:, :-1], jnp.zeros_like(q[:, :-1]))
        term = (q[:, -1], jnp.zeros_like(q[:, -1]))
        # both alpha counts in one XLA program (eager dispatch of the
        # stand-ins takes minutes; the two share their first iteration)
        solve = jax.jit(lambda x0, u0, refs, term: {
            n: pallas_ilqr.ilqr_chain_batch(
                jmpc.plan, SUBSTEPS, jmpc._track_stage, jmpc._track_term,
                x0, u0, refs, term, iters=ITERS, alphas=alphas, reg=REG,
                parallel_backward=False, kernel_cost=None, fast_lin=False)
            for n, alphas in ALPHAS.items()})
        res = solve(jnp.asarray(x0), u0, refs, term)
    finally:
        mp.undo()
    return res


@pytest.mark.parametrize("n_alphas", [3, 9])
def test_ilqr_options_match_jax(solvers, jax_result, n_alphas):
    tmpc = solvers[1]
    x0, q_refs = _problem()
    x0t, qt = torch.from_numpy(x0), torch.from_numpy(q_refs)
    launches = cuda_ilqr.rollout_closed.launches
    tres = cuda_ilqr.ilqr_chain_batch(
        tmpc.plan, SUBSTEPS, None, None, None, x0t, tmpc._hold_init(x0t),
        None, iters=ITERS, alphas=ALPHAS[n_alphas], reg=REG,
        fast_lin=False, parallel_backward=False,
        cost_fn=tmpc._track_stage, term_cost_fn=tmpc._track_term,
        refs=(qt[:, :-1], torch.zeros_like(qt[:, :-1])),
        term_ref=(qt[:, -1], torch.zeros_like(qt[:, -1])))
    assert launches == cuda_ilqr.rollout_closed.launches   # plain on CPU
    jres = jax_result[n_alphas]
    np.testing.assert_allclose(tres.cost.numpy(), np.asarray(jres.cost),
                               rtol=1e-3)
    np.testing.assert_allclose(tres.us.numpy(), np.asarray(jres.us),
                               atol=1e-2)
    np.testing.assert_allclose(tres.xs.numpy(), np.asarray(jres.xs),
                               atol=1e-2)
    assert tres.gains.K.shape == (B, H, 7, 16)
    assert tres.gains.K.dtype == torch.float32


def test_track_batch_at_six_substeps_matches_closures(solvers):
    """GraspMPC(substeps=6).track_batch runs (full-knot differences) and
    equals the solver driven with the per-knot costs and their autodiff
    expansion, since the tracking cost is quadratic."""
    tmpc = solvers[1]
    assert not tmpc.fast_lin
    x0, q_refs = _problem()
    x0t, qt = torch.from_numpy(x0), torch.from_numpy(q_refs)
    res = tmpc.track_batch(x0t, qt)
    auto = cuda_ilqr.ilqr_chain_batch(
        tmpc.plan, SUBSTEPS, None, None, None, x0t, tmpc._hold_init(x0t),
        None, iters=ITERS, fast_lin=False, cost_fn=tmpc._track_stage,
        term_cost_fn=tmpc._track_term,
        refs=(qt[:, :-1], torch.zeros_like(qt[:, :-1])),
        term_ref=(qt[:, -1], torch.zeros_like(qt[:, -1])))
    assert bool(torch.isfinite(res.us).all())
    np.testing.assert_allclose(res.cost.numpy(), auto.cost.numpy(),
                               rtol=1e-4)
    np.testing.assert_allclose(res.us.numpy(), auto.us.numpy(), atol=1e-3)
