"""The port's reach path, ``GraspMPC.solve_batch_x``, against the JAX
package's shipping path (``GraspMPC(use_pallas=True).solve_batch_x``, whose
chain kernels run in Pallas interpret mode on the CPU): a cold solve from
the gravity hold, and ``solve_batch`` from full-scene states, which is the
same solve. The warm re-solve from the shifted plan is held in
test_torch_reach_warm.py.

The port runs with ``device="cpu"``, so every kernel wrapper (``ee_quad_gn``
included) takes its plain version. JAX compiles the interpreted solve for
minutes, and the warm re-solve is a second such program: each has a file of
its own so that ``--dist loadfile`` runs the two side by side.

Both packages solve on the JAX plan, carried across with
``plan_from_arrays``. Problem: B=4, H=4, substeps=2, iters=2; starts near home, targets within
0.1 m of (0, -0.6, 1.0), the bench's target, 0.8 m from the grasp center at
home. Conditioning: at the default control weight the 16 ms horizon leaves
the controls barely determined (moving x0 by 3e-7 rad moves them by 3e-2 on
the CPU); with ``w_ctrl=1`` the same change moves the cost by 4e-7 relative,
the controls by 2e-3 and the states by 4e-3, so the comparison measures the
port. Off the TPU the JAX solver runs the parallel Riccati pass and the
port the sequential semantics of its kernel; they agree to that
conditioning.

Tolerances: both solvers linearize by forward differences with eps=1e-3 in
f32. Costs agree to 1e-3 relative; controls and states to 1e-2 absolute.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mujoco_rl_ur5_tpu.mpc.grasp_mpc import GraspMPC as JaxGraspMPC
from mujoco_rl_ur5_tpu.mpc.grasp_mpc import MPCWeights as JaxWeights
from mujoco_rl_ur5_tpu_torch import ASSET
from mujoco_rl_ur5_tpu_torch.carry import PLAN_FIELDS, plan_from_arrays
from mujoco_rl_ur5_tpu_torch.mpc.grasp_mpc import GraspMPC, MPCWeights
from mujoco_rl_ur5_tpu_torch.physics.cuda_chain import rollout_open

B, H, SUBSTEPS, ITERS = 4, 4, 2, 2
HOME = np.array([0.0, -1.57, 1.57, -1.57, -1.57, 0.0, 0.0, 0.0])


@pytest.fixture(scope="module")
def solvers():
    kw = dict(horizon=H, substeps=SUBSTEPS, iters=ITERS)
    jmpc = JaxGraspMPC.from_scene(ASSET, use_pallas=True,
                                  weights=JaxWeights(w_ctrl=1.0), **kw)
    tmpc = GraspMPC.from_scene(ASSET, device="cpu",
                               weights=MPCWeights(w_ctrl=1.0), **kw)
    # both packages solve on the identical plan (the JAX package derives the
    # finger spring from an f32 mass matrix); the fused costs hold the plan's
    # FK, so they are built again on it
    tmpc.plan = plan_from_arrays({f: np.asarray(getattr(jmpc.plan, f))
                                  for f in PLAN_FIELDS})
    tmpc._build_kernel_costs()
    return jmpc, tmpc


def _compare(jres, tres):
    np.testing.assert_allclose(tres.cost.numpy(), np.asarray(jres.cost),
                               rtol=1e-3)
    np.testing.assert_allclose(tres.us.numpy(), np.asarray(jres.us),
                               atol=1e-2)
    np.testing.assert_allclose(tres.xs.numpy(), np.asarray(jres.xs),
                               atol=1e-2)
    assert tres.gains.K.shape == (B, H, 7, 16)
    assert tres.gains.d.shape == (B, H, 7)
    assert tres.gains.S.shape == (B, H + 1, 16, 16)
    assert tres.gains.s.shape == (B, H + 1, 16)


def test_solve_batch_x_matches_jax_cold(solvers):
    jmpc, tmpc = solvers
    rng = np.random.default_rng(0)
    x0 = np.concatenate([HOME + 0.05 * rng.standard_normal((B, 8)),
                         0.05 * rng.standard_normal((B, 8))],
                        -1).astype(np.float32)
    targets = (np.array([0.0, -0.6, 1.0])
               + 0.1 * rng.uniform(-1, 1, (B, 3))).astype(np.float32)
    tx0, ttg = torch.from_numpy(x0), torch.from_numpy(targets)

    jres = jmpc.solve_batch_x(jnp.asarray(x0), jnp.asarray(targets))
    tres = tmpc.solve_batch_x(tx0, ttg)
    _compare(jres, tres)

    # the solve lowered the cost and the EE error of its gravity-hold start
    total_cost = tmpc._reach_closures(ttg)[0]
    u0 = tmpc._hold_init(tx0)
    xs0 = rollout_open(tmpc.plan, SUBSTEPS, tx0, u0)
    assert bool((tres.cost < total_cost(xs0, u0)).all())

    def ee_err(xs):
        return (tmpc.ee_pos(xs[:, -1, :8]) - ttg).norm(dim=-1)

    assert bool((ee_err(tres.xs) < ee_err(xs0)).all())

    # solve_batch maps full-scene states onto the arm state first and is
    # then the same solve
    ft = tmpc.full.topo
    qpos = torch.zeros(B, ft.nq)
    qvel = torch.zeros(B, ft.nv)
    qpos[:, tmpc.full_qadr] = tx0[:, :8]
    qvel[:, tmpc.full_dofadr] = tx0[:, 8:]
    assert torch.equal(tmpc.x_from_state(qpos, qvel), tx0)
    full = tmpc.solve_batch(qpos, qvel, ttg)
    for got, want in zip((full.xs, full.us, full.cost, *full.gains),
                         (tres.xs, tres.us, tres.cost, *tres.gains)):
        assert torch.equal(got, want)
