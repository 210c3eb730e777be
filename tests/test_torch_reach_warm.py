"""The port's warm reach re-solve against the JAX package's: two iterations
of ``ilqr_chain_batch`` from a shifted plan with the reach closures, as the
JAX package's bench.py re-solves (its ``solve_batch_x`` takes no start). The
JAX chain kernels run in Pallas interpret mode on the CPU, the port's
wrappers take their plain versions (``device="cpu"``). The cold solve is
held in test_torch_reach_slice.py; JAX compiles each of the two programs for
minutes, so each has a file of its own and ``--dist loadfile`` runs them side
by side.

Both packages solve on the JAX plan, carried across with
``plan_from_arrays``. Problem: that of test_torch_reach_slice.py (B=4, H=4, substeps=2,
``w_ctrl=1``, targets within 0.1 m of (0, -0.6, 1.0)); the plan that is
shifted by one knot is the port's own cold solution, given to both solvers.
The conditioning is stated there: with ``w_ctrl=1`` a 3e-7 rad change of x0
moves the cost by 4e-7 relative, the controls by 2e-3 and the states by
4e-3.

Tolerances: both solvers linearize by forward differences with eps=1e-3 in
f32. Costs agree to 1e-3 relative; controls and states to 1e-2 absolute.
"""

import numpy as np
import jax.numpy as jnp
import torch

from mujoco_rl_ur5_tpu.mpc.grasp_mpc import GraspMPC as JaxGraspMPC
from mujoco_rl_ur5_tpu.mpc.grasp_mpc import MPCWeights as JaxWeights
from mujoco_rl_ur5_tpu.mpc.pallas_ilqr import (
    ilqr_chain_batch as jax_ilqr_chain_batch,
)
from mujoco_rl_ur5_tpu_torch import ASSET
from mujoco_rl_ur5_tpu_torch.carry import PLAN_FIELDS, plan_from_arrays
from mujoco_rl_ur5_tpu_torch.mpc.cuda_ilqr import ilqr_chain_batch
from mujoco_rl_ur5_tpu_torch.mpc.grasp_mpc import GraspMPC, MPCWeights
from mujoco_rl_ur5_tpu_torch.physics.cuda_chain import rollout_open

B, H, SUBSTEPS, ITERS = 4, 4, 2, 2
HOME = np.array([0.0, -1.57, 1.57, -1.57, -1.57, 0.0, 0.0, 0.0])


def test_warm_reach_resolve_matches_jax():
    kw = dict(horizon=H, substeps=SUBSTEPS, iters=ITERS)
    jmpc = JaxGraspMPC.from_scene(ASSET, use_pallas=True,
                                  weights=JaxWeights(w_ctrl=1.0), **kw)
    tmpc = GraspMPC.from_scene(ASSET, device="cpu",
                               weights=MPCWeights(w_ctrl=1.0), **kw)
    # the identical plan in both packages, and the fused costs built on it
    tmpc.plan = plan_from_arrays({f: np.asarray(getattr(jmpc.plan, f))
                                  for f in PLAN_FIELDS})
    tmpc._build_kernel_costs()
    rng = np.random.default_rng(0)
    x0 = np.concatenate([HOME + 0.05 * rng.standard_normal((B, 8)),
                         0.05 * rng.standard_normal((B, 8))],
                        -1).astype(np.float32)
    targets = (np.array([0.0, -0.6, 1.0])
               + 0.1 * rng.uniform(-1, 1, (B, 3))).astype(np.float32)
    tx0, ttg = torch.from_numpy(x0), torch.from_numpy(targets)

    cold = tmpc.solve_batch_x(tx0, ttg)
    u_warm = torch.cat([cold.us[:, 1:], cold.us[:, -1:]], 1).contiguous()

    jtg = jnp.asarray(targets)
    jw = jax_ilqr_chain_batch(
        jmpc.plan, jmpc.substeps, jmpc._reach_stage, jmpc._reach_term,
        jnp.asarray(x0), jnp.asarray(u_warm.numpy()),
        jnp.tile(jtg[:, None], (1, H, 1)), jtg, iters=ITERS,
        quad_fn=jmpc._reach_quad, term_quad_fn=jmpc._reach_term_quad,
        kernel_cost=(jmpc._k_reach, None, jtg),
        kernel_quad=lambda xs, us:
            jmpc._reach_quad_batch_kernel(xs, us, jtg))
    total_cost, quad, term_quad, kernel_cost = tmpc._reach_closures(ttg)
    tw = ilqr_chain_batch(tmpc.plan, tmpc.substeps, total_cost, quad,
                          term_quad, tx0, u_warm, kernel_cost, iters=ITERS)

    np.testing.assert_allclose(tw.cost.numpy(), np.asarray(jw.cost),
                               rtol=1e-3)
    np.testing.assert_allclose(tw.us.numpy(), np.asarray(jw.us), atol=1e-2)
    np.testing.assert_allclose(tw.xs.numpy(), np.asarray(jw.xs), atol=1e-2)
    assert tw.gains.K.shape == (B, H, 7, 16)
    assert tw.gains.S.shape == (B, H + 1, 16, 16)
    # the re-solve does not end above its start
    start = total_cost(rollout_open(tmpc.plan, SUBSTEPS, tx0, u_warm), u_warm)
    assert bool((tw.cost <= start).all())
