"""The plain versions of the port's three chain kernels against the JAX
package's Pallas kernels (interpret mode on the CPU), on the same plan and
inputs: ``rollout_open``, ``rollout_closed`` with the fused tracking costs,
and ``lin_fd`` / ``lin_fd_fast``.

The wrappers are called with CPU tensors, so they take their plain
versions and launch nothing. Tolerances:

* rollouts: the same f32 arithmetic summed in another order, over 8
  substeps: 2e-5 absolute, 1e-4 relative (the JAX package's own gate for
  its kernel against chain_step); costs are sums of squares, 2e-4 relative;
* Jacobians: forward differences with eps=1e-3 divide last-ulp differences
  of the knot map by 1e-3, so entries of size up to ~30 differ by up to
  ~1e-2; held at 2e-2 x (1 + |J|).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_rl_ur5_tpu.mpc.grasp_mpc import GraspMPC as JaxGraspMPC
from mujoco_rl_ur5_tpu.physics import pallas_chain as jpc
from mujoco_rl_ur5_tpu_torch import ASSET
from mujoco_rl_ur5_tpu_torch.carry import PLAN_FIELDS, plan_from_arrays
from mujoco_rl_ur5_tpu_torch.mpc import cuda_lqr
from mujoco_rl_ur5_tpu_torch.mpc.grasp_mpc import GraspMPC
from mujoco_rl_ur5_tpu_torch.physics import cuda_chain as cc

B, H, SUBSTEPS = 4, 4, 2
HOME = np.array([0.0, -1.57, 1.57, -1.57, -1.57, 0.0, 0.0, 0.0])
ALPHAS = (1.0, 0.3)


@pytest.fixture(scope="module")
def setup():
    jmpc = JaxGraspMPC.from_scene(ASSET, horizon=H, substeps=SUBSTEPS,
                                  use_pallas=True)
    tmpc = GraspMPC.from_scene(ASSET, horizon=H, substeps=SUBSTEPS,
                               device="cpu")
    plan = plan_from_arrays({f: np.asarray(getattr(jmpc.plan, f))
                             for f in PLAN_FIELDS})
    rng = np.random.default_rng(0)
    f = np.float32
    x0 = np.concatenate([HOME + 0.05 * rng.standard_normal((B, 8)),
                         0.1 * rng.standard_normal((B, 8))], -1).astype(f)
    us = (0.1 * rng.standard_normal((B, H, 7))).astype(f)
    return jmpc, tmpc, plan, rng, x0, us


def _launches():
    return (cc.rollout_open.launches, cc.lin_fd.launches,
            cc.rollout_closed.launches, cuda_lqr.backward.launches)


def test_rollout_open_matches_jax_kernel(setup):
    jmpc, _, plan, _, x0, us = setup
    before = _launches()
    xs = cc.rollout_open(plan, SUBSTEPS, torch.from_numpy(x0),
                         torch.from_numpy(us))
    assert _launches() == before
    ref = jpc.rollout_open(jmpc.plan, SUBSTEPS, jnp.asarray(x0),
                           jnp.asarray(us))
    assert xs.shape == (B, H + 1, 16)
    np.testing.assert_allclose(xs.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=1e-4)


def test_rollout_closed_with_track_costs_matches_jax_kernel(setup):
    jmpc, tmpc, plan, rng, x0, us = setup
    f = np.float32
    xbar = np.array(jpc.rollout_open(jmpc.plan, SUBSTEPS, jnp.asarray(x0),
                                     jnp.asarray(us)))
    K = (0.05 * rng.standard_normal((B, H, 7, 16))).astype(f)
    d = (0.1 * rng.standard_normal((B, H, 7))).astype(f)
    q_refs = (x0[:, None, :8] + 0.05 * rng.standard_normal((B, H + 1, 8))
              ).astype(f)
    qd_refs = np.zeros_like(q_refs)
    sref = np.concatenate([q_refs[:, :-1], qd_refs[:, :-1]], -1)
    tref = np.concatenate([q_refs[:, -1], qd_refs[:, -1]], -1)
    before = _launches()
    xs, u, costs = cc.rollout_closed(
        plan, SUBSTEPS, *(torch.from_numpy(a) for a in (x0, xbar, us, K, d)),
        ALPHAS, cost=tmpc._k_track, sref=torch.from_numpy(sref),
        tref=torch.from_numpy(tref))
    assert _launches() == before
    jxs, ju, jcosts = jpc.rollout_closed(
        jmpc.plan, SUBSTEPS, *(jnp.asarray(a) for a in (x0, xbar, us, K, d)),
        ALPHAS, cost=jmpc._k_track, sref=jnp.asarray(sref),
        tref=jnp.asarray(tref))
    assert xs.shape == (B, len(ALPHAS), H + 1, 16)
    assert u.shape == (B, len(ALPHAS), H, 7) and costs.shape == (B, 2)
    np.testing.assert_allclose(xs.numpy(), np.asarray(jxs), atol=2e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), atol=2e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(costs.numpy(), np.asarray(jcosts), rtol=2e-4)


def _assert_jacobian(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want) / (1.0 + np.abs(want))
    assert err.max() < 2e-2, f"max |dJ|/(1+|J|) = {err.max():.3e}"


@pytest.mark.parametrize("fast", [False, True], ids=["lin_fd", "lin_fd_fast"])
def test_linearization_matches_jax_kernel(setup, fast):
    jmpc, _, plan, _, x0, us = setup
    xs = np.array(jpc.rollout_open(jmpc.plan, SUBSTEPS, jnp.asarray(x0),
                                   jnp.asarray(us))[:, :H])
    t_fn, j_fn = ((cc.lin_fd_fast, jpc.lin_fd_fast) if fast
                  else (cc.lin_fd, jpc.lin_fd))
    before = _launches()
    F, L = t_fn(plan, SUBSTEPS, torch.from_numpy(xs), torch.from_numpy(us))
    assert _launches() == before
    jF, jL = j_fn(jmpc.plan, SUBSTEPS, jnp.asarray(xs), jnp.asarray(us))
    assert F.shape == (B, H, 16, 16) and L.shape == (B, H, 16, 7)
    _assert_jacobian(F, jF)
    _assert_jacobian(L, jL)
