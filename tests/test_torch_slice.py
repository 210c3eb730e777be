"""The port's whole main path, ``GraspMPC.track_batch``, against the JAX
package's shipping path (``GraspMPC(use_pallas=True).track_batch``, whose
chain kernels run in Pallas interpret mode on the CPU), cold and warm.

The port runs with ``device="cpu"``, so every kernel wrapper takes its
plain version. This file costs minutes (interpret mode) and stays alone
so that ``--dist loadfile`` gives it a worker of its own.

Conditioning. At H=4 knots of 2 substeps the horizon is 16 ms, and at the
default control weight (w_ctrl=1e-3) the optimal controls are barely
determined: moving x0 by 3e-7 rad moves the solved controls by 0.3. The
test therefore uses w_ctrl=1, where the same perturbation moves them by
4e-3, so a port-vs-JAX difference measures the port and not the
conditioning.

Tolerances: both solvers linearize by forward differences with eps=1e-3
in f32, which turns last-ulp differences of the dynamics into ~1e-2
differences of Jacobian entries of size ~30. The solved costs agree to
1e-3 relative; controls and states to 1e-2 absolute (controls span
+-1.5, and their measured ulp-noise sensitivity is 4e-3).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mujoco_rl_ur5_tpu.mpc.grasp_mpc import GraspMPC as JaxGraspMPC
from mujoco_rl_ur5_tpu.mpc.grasp_mpc import MPCWeights as JaxWeights
from mujoco_rl_ur5_tpu_torch import ASSET
from mujoco_rl_ur5_tpu_torch.mpc.grasp_mpc import GraspMPC, MPCWeights
from mujoco_rl_ur5_tpu_torch.physics.cuda_chain import rollout_open

B, H, SUBSTEPS, ITERS = 4, 4, 2, 2
HOME = np.array([0.0, -1.57, 1.57, -1.57, -1.57, 0.0, 0.0, 0.0])


def _problem(seed: int):
    """Start states near home, each tracking a straight joint-space line to
    a target 0.01 rad away over the horizon's H+1 knots."""
    rng = np.random.default_rng(seed)
    x0 = np.concatenate([HOME + 0.05 * rng.standard_normal((B, 8)),
                         0.05 * rng.standard_normal((B, 8))], -1)
    target = x0[:, :8] + 0.01 * rng.standard_normal((B, 8))
    s = np.linspace(0.0, 1.0, H + 1)[None, :, None]
    q_refs = x0[:, None, :8] * (1 - s) + target[:, None] * s
    return x0.astype(np.float32), q_refs.astype(np.float32)


@pytest.fixture(scope="module")
def solvers():
    kw = dict(horizon=H, substeps=SUBSTEPS, iters=ITERS)
    return (JaxGraspMPC.from_scene(ASSET, use_pallas=True,
                                   weights=JaxWeights(w_ctrl=1.0), **kw),
            GraspMPC.from_scene(ASSET, device="cpu",
                                weights=MPCWeights(w_ctrl=1.0), **kw))


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


def test_track_batch_matches_jax_cold_and_warm(solvers):
    jmpc, tmpc = solvers
    x0, q_refs = _problem(0)
    # the port's default start (the gravity hold) against the same start
    # given to JAX explicitly: one JAX compile serves both calls
    u_hold = jax.vmap(lambda x: jnp.tile(jmpc.hold_ctrl(x[:8])[None],
                                         (H, 1)))(jnp.asarray(x0))
    jres = jmpc.track_batch(jnp.asarray(x0), jnp.asarray(q_refs),
                            u_init=u_hold)
    tres = tmpc.track_batch(torch.from_numpy(x0), torch.from_numpy(q_refs))
    _compare(jres, tres)

    # the solve improved on its gravity-hold start
    qr = torch.from_numpy(q_refs)
    zr = torch.zeros_like(qr)
    u0 = torch.from_numpy(np.asarray(u_hold))
    xs0 = rollout_open(tmpc.plan, SUBSTEPS, torch.from_numpy(x0), u0)
    start = (tmpc._track_stage(xs0[:, :-1], u0, (qr[:, :-1], zr[:, :-1]))
             .sum(-1) + tmpc._track_term(xs0[:, -1], (qr[:, -1], zr[:, -1])))
    assert bool((tres.cost < start).all())

    # warm start from the shifted plan (the receding-horizon mode)
    u_warm = np.concatenate([np.asarray(jres.us)[:, 1:],
                             np.asarray(jres.us)[:, -1:]], 1)
    jw = jmpc.track_batch(jnp.asarray(x0), jnp.asarray(q_refs),
                          u_init=jnp.asarray(u_warm))
    tw = tmpc.track_batch(torch.from_numpy(x0), torch.from_numpy(q_refs),
                          u_init=torch.from_numpy(u_warm))
    _compare(jw, tw)
