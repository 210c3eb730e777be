"""Reach mode, piece by piece: the port against the JAX package on the same
plan and seeded numpy inputs, on the CPU.

* ``chain_body_pos``, ``chain_body_xaxis``, ``chain_ee_geom`` against the
  JAX functions (atol 2e-5: the same f32 FK, summed in another order); the
  geometric Jacobians also against ``torch.func.jacfwd`` of the port's own
  ``chain_body_pos`` / ``chain_body_xaxis`` (atol 2e-5).
* ``ee_quad_gn`` on CPU tensors (its plain version: the generated code run on
  tensors), which writes the full stage blocks X (B, H, 16, 16) and
  g (B, H, 16): its Gauss-Newton block X[..., :8, :8] and g[..., :8]
  against the JAX Pallas kernel in interpret mode, the velocity diagonal
  and the zeros exact; ``_reach_quad_batch_kernel`` (X, g, U, r) against
  JAX's own ``_reach_quad_batch_kernel`` (the Pallas kernel in interpret
  mode and its assembly) and against JAX ``vmap(vmap(_reach_quad))``, at
  atol 2e-4 and rtol 1e-4, the JAX package's own gate for its kernel. B=3,
  H=4, substeps=2 and the targets of that gate.
* ``rollout_closed`` with the fused reach costs (FK inside, no per-knot
  reference, the target as the per-scenario reference) against the JAX
  kernel: states and controls at 2e-5 absolute and 1e-4 relative, costs at
  2e-4 relative, as for the track costs.
* The wrapper launches nothing on CPU tensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd

from mujoco_rl_ur5_tpu.mpc.grasp_mpc import GraspMPC as JaxGraspMPC
from mujoco_rl_ur5_tpu.physics import chain as jchain
from mujoco_rl_ur5_tpu.physics import pallas_chain as jpc
from mujoco_rl_ur5_tpu_torch import ASSET
from mujoco_rl_ur5_tpu_torch.carry import PLAN_FIELDS, plan_from_arrays
from mujoco_rl_ur5_tpu_torch.mpc.grasp_mpc import EE_OFFSET, GraspMPC
from mujoco_rl_ur5_tpu_torch.physics import chain as tchain
from mujoco_rl_ur5_tpu_torch.physics import cuda_chain as cc

B, H, SUBSTEPS = 3, 4, 2
ALPHAS = (1.0, 0.3)
TARGETS = np.array([[0.0, -0.6, 1.0], [0.1, -0.5, 1.1], [-0.1, -0.7, 0.9]],
                   np.float32)


@pytest.fixture(scope="module")
def setup():
    jmpc = JaxGraspMPC.from_scene(ASSET, horizon=H, substeps=SUBSTEPS,
                                  use_pallas=True)
    tmpc = GraspMPC.from_scene(ASSET, horizon=H, substeps=SUBSTEPS,
                               device="cpu")
    # both packages compute on the identical plan (the JAX package derives
    # the finger spring from an f32 mass matrix)
    tmpc.plan = plan_from_arrays({f: np.asarray(getattr(jmpc.plan, f))
                                  for f in PLAN_FIELDS})
    tmpc._build_kernel_costs()          # the fused costs hold the plan's FK
    rng = np.random.default_rng(5)
    home = np.concatenate([jmpc.home, np.zeros(8)])
    x0 = (home + 0.2 * rng.standard_normal((B, 16))).astype(np.float32)
    us = (0.3 * rng.standard_normal((B, H, 7))).astype(np.float32)
    xs = np.array(jpc.rollout_open(jmpc.plan, SUBSTEPS, jnp.asarray(x0),
                                   jnp.asarray(us)))
    return jmpc, tmpc, rng, x0, us, xs


def test_weights_and_constants_match_jax(setup):
    jmpc, tmpc, *_ = setup
    assert tmpc.w._fields == jmpc.w._fields
    assert tuple(tmpc.w) == tuple(jmpc.w)
    assert tmpc.ee_body == jmpc.ee_body
    np.testing.assert_array_equal(tmpc.home, jmpc.home)
    np.testing.assert_array_equal(tmpc.u_lo, jmpc.u_lo)
    np.testing.assert_array_equal(tmpc.u_hi, jmpc.u_hi)
    from mujoco_rl_ur5_tpu.mpc.grasp_mpc import EE_OFFSET as JAX_OFFSET
    np.testing.assert_array_equal(EE_OFFSET, JAX_OFFSET)


@pytest.mark.parametrize("fn", ["chain_body_pos", "chain_body_xaxis"])
def test_body_frame_matches_jax(setup, fn):
    jmpc, tmpc, _, _, _, xs = setup
    q = xs[..., :8]                                     # (B, H+1, 8)
    got = getattr(tchain, fn)(tmpc.plan, torch.from_numpy(q), tmpc.ee_body)
    want = jax.vmap(jax.vmap(
        lambda qq: getattr(jchain, fn)(jmpc.plan, qq, jmpc.ee_body)))(
            jnp.asarray(q))
    assert got.shape == (B, H + 1, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_ee_geom_matches_jax_and_autodiff(setup):
    jmpc, tmpc, _, _, _, xs = setup
    q = xs[..., :8]
    got = tchain.chain_ee_geom(tmpc.plan, torch.from_numpy(q), tmpc.ee_body)
    want = jax.vmap(jax.vmap(
        lambda qq: jchain.chain_ee_geom(jmpc.plan, qq, jmpc.ee_body)))(
            jnp.asarray(q))
    for g, w, shape in zip(got, want, [(3,), (3,), (3, 8), (3, 8)]):
        assert g.shape == (B, H + 1) + shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5)
    # the finger dofs do not move ee_link: their columns are exact zeros
    assert float(got[2][..., 6:].abs().max()) == 0.0
    assert float(got[3][..., 6:].abs().max()) == 0.0
    # the geometric Jacobians equal the autodiff ones of the port's own FK
    for k in range(B):
        qk = torch.from_numpy(q[k, 0])
        Jp = jacfwd(lambda qq: tchain.chain_body_pos(
            tmpc.plan, qq, tmpc.ee_body))(qk)
        Ja = jacfwd(lambda qq: tchain.chain_body_xaxis(
            tmpc.plan, qq, tmpc.ee_body))(qk)
        np.testing.assert_allclose(got[2][k, 0].numpy(), Jp.numpy(),
                                   atol=2e-5)
        np.testing.assert_allclose(got[3][k, 0].numpy(), Ja.numpy(),
                                   atol=2e-5)


def test_ee_helpers_match_jax(setup):
    jmpc, tmpc, _, _, _, xs = setup
    q = xs[:, 0, :8]
    for name in ("ee_pos", "ee_axis_err"):
        got = getattr(tmpc, name)(torch.from_numpy(q))
        want = jax.vmap(getattr(jmpc, name))(jnp.asarray(q))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    got = tmpc.ee_geom(torch.from_numpy(q))
    want = jax.vmap(jmpc.ee_geom)(jnp.asarray(q))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5)


def test_reach_costs_and_plain_quads_match_jax(setup):
    jmpc, tmpc, _, _, us, xs = setup
    xk, tg = xs[:, :H], np.tile(TARGETS[:, None], (1, H, 1))
    t = torch.from_numpy
    got = tmpc._reach_stage(t(xk), t(us), t(tg))
    want = jax.vmap(jax.vmap(jmpc._reach_stage))(
        jnp.asarray(xk), jnp.asarray(us), jnp.asarray(tg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4)
    got = tmpc._reach_term(t(xs[:, -1]), t(TARGETS))
    want = jax.vmap(jmpc._reach_term)(jnp.asarray(xs[:, -1]),
                                      jnp.asarray(TARGETS))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4)
    got = tmpc._reach_quad(t(xk), t(us), t(tg))
    want = jax.vmap(jax.vmap(jmpc._reach_quad))(
        jnp.asarray(xk), jnp.asarray(us), jnp.asarray(tg))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-4,
                                   rtol=1e-4)
    got = tmpc._reach_term_quad(t(xs[:, -1]), t(TARGETS))
    want = jax.vmap(jmpc._reach_term_quad)(jnp.asarray(xs[:, -1]),
                                           jnp.asarray(TARGETS))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-4,
                                   rtol=1e-4)


def test_ee_quad_gn_matches_jax_kernel(setup):
    jmpc, tmpc, _, _, _, xs = setup
    w = tmpc.w
    xk = xs[:, :H]
    before = cc.ee_quad_gn.launches
    X, g = cc.ee_quad_gn(tmpc.plan, tmpc.ee_slot, EE_OFFSET, w.w_ee_run,
                         w.w_orient, w.w_posture, w.w_vel, tmpc.home,
                         torch.from_numpy(xk), torch.from_numpy(TARGETS))
    assert cc.ee_quad_gn.launches == before
    assert X.shape == (B, H, 16, 16) and g.shape == (B, H, 16)
    Xq, gq = X[..., :8, :8], g[..., :8]
    jX, jg = jpc.ee_quad_gn(
        jmpc.plan, tmpc.ee_slot, tuple(EE_OFFSET), float(w.w_ee_run),
        float(w.w_orient), float(w.w_posture),
        tuple(float(h) for h in jmpc.home), jnp.asarray(xk),
        jnp.asarray(TARGETS))
    assert Xq.shape == (B, H, 8, 8) and gq.shape == (B, H, 8)
    np.testing.assert_allclose(Xq.numpy(), np.asarray(jX), atol=2e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(gq.numpy(), np.asarray(jg), atol=2e-4,
                               rtol=1e-4)
    # symmetric, and the finger dofs keep only the posture weight
    assert torch.equal(Xq, Xq.transpose(-1, -2))
    fingers = Xq[..., 6:, :]
    want = torch.zeros_like(fingers)
    want[..., 0, 6] = want[..., 1, 7] = w.w_posture
    assert torch.equal(fingers, want)
    # the velocity block: w_vel on the diagonal, exact zeros off the blocks
    vel = torch.zeros(8, 8)
    vel.diagonal()[:] = w.w_vel
    assert torch.equal(X[..., 8:, 8:], vel.expand(B, H, 8, 8))
    assert not X[..., :8, 8:].any() and not X[..., 8:, :8].any()
    assert torch.equal(g[..., 8:], w.w_vel * torch.from_numpy(xk[..., 8:]))


def test_reach_quad_batch_kernel_matches_jax_quad(setup):
    jmpc, tmpc, _, _, us, xs = setup
    xk = xs[:, :H]
    got = tmpc._reach_quad_batch_kernel(
        torch.from_numpy(xk), torch.from_numpy(us),
        torch.from_numpy(TARGETS))
    want = jax.vmap(jax.vmap(jmpc._reach_quad))(
        jnp.asarray(xk), jnp.asarray(us),
        jnp.asarray(np.tile(TARGETS[:, None], (1, H, 1))))
    for g, w, shape in zip(got, want, [(16, 16), (16,), (7, 7), (7,)]):
        assert g.shape == (B, H) + shape
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               atol=1e-6)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]),
                               atol=1e-6)


def test_reach_quad_batch_kernel_matches_jax_batch_kernel(setup):
    """The port's one launch against the JAX package's kernel and the
    assembly around it (zeros, the block, the velocity diagonal, the
    gradient's velocity half, U and r)."""
    jmpc, tmpc, _, _, us, xs = setup
    xk = xs[:, :H]
    got = tmpc._reach_quad_batch_kernel(
        torch.from_numpy(xk), torch.from_numpy(us),
        torch.from_numpy(TARGETS))
    want = jmpc._reach_quad_batch_kernel(jnp.asarray(xk), jnp.asarray(us),
                                         jnp.asarray(TARGETS))
    for g, w, shape in zip(got, want, [(16, 16), (16,), (7, 7), (7,)]):
        assert g.shape == (B, H) + shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-4,
                                   rtol=1e-4)
    # exact where JAX's assembly writes constants
    jX = np.asarray(want[0])
    assert np.array_equal(got[0][..., 8:, :].numpy(), jX[..., 8:, :])
    assert np.array_equal(got[0][..., :8, 8:].numpy(), jX[..., :8, 8:])
    assert np.array_equal(got[2].numpy(), np.asarray(want[2]))


def test_rollout_closed_with_reach_costs_matches_jax_kernel(setup):
    jmpc, tmpc, rng, x0, us, xs = setup
    f = np.float32
    K = (0.05 * rng.standard_normal((B, H, 7, 16))).astype(f)
    d = (0.1 * rng.standard_normal((B, H, 7))).astype(f)
    before = cc.rollout_closed.launches
    txs, tu, tcosts = cc.rollout_closed(
        tmpc.plan, SUBSTEPS, *(torch.from_numpy(a) for a in (x0, xs, us, K, d)),
        ALPHAS, cost=tmpc._k_reach, sref=None,
        tref=torch.from_numpy(TARGETS))
    assert cc.rollout_closed.launches == before
    jxs, ju, jcosts = jpc.rollout_closed(
        jmpc.plan, SUBSTEPS, *(jnp.asarray(a) for a in (x0, xs, us, K, d)),
        ALPHAS, cost=jmpc._k_reach, sref=None, tref=jnp.asarray(TARGETS))
    assert txs.shape == (B, len(ALPHAS), H + 1, 16)
    assert tu.shape == (B, len(ALPHAS), H, 7) and tcosts.shape == (B, 2)
    np.testing.assert_allclose(txs.numpy(), np.asarray(jxs), atol=2e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), atol=2e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(tcosts.numpy(), np.asarray(jcosts), rtol=2e-4)
    # the fused costs are the reach costs of the candidates
    ref = (tmpc._reach_stage(txs[:, :, :-1], tu,
                             torch.from_numpy(TARGETS)[:, None, None]).sum(-1)
           + tmpc._reach_term(txs[:, :, -1],
                              torch.from_numpy(TARGETS)[:, None]))
    np.testing.assert_allclose(tcosts.numpy(), ref.numpy(), rtol=2e-4)


def test_kernel_sources_list_six_units(setup):
    _, tmpc, *_ = setup
    srcs = tmpc.kernel_sources()
    assert [s.name for s in srcs] == [
        "chain_rollout_open", "chain_lin_fd", "chain_rollout_closed",
        "chain_rollout_closed", "lqr_backward", "chain_ee_quad_gn"]
    assert len({s.key for s in srcs}) == 6
    text = srcs[-1].headers["chain_ee_quad.cuh"]
    assert "chain_ee_quad(" in text and "#define CHAIN_NV 8" in text
    assert "#define CHAIN_W_VEL 0.05" in text
    # the weights key the source: another posture or velocity weight,
    # another library
    w = tmpc.w
    for w_posture, w_vel in ((0.5, w.w_vel), (w.w_posture, 0.5)):
        other = cc.ee_quad_source(tmpc.plan, tmpc.ee_slot, EE_OFFSET,
                                  w.w_ee_run, w.w_orient, w_posture, w_vel,
                                  tmpc.home)
        assert other.key != srcs[-1].key
    reach_cost = srcs[3].headers["chain_cost.cuh"]
    assert "#define CHAIN_NSR 0" in reach_cost
    assert "#define CHAIN_NTR 3" in reach_cost and "cosf(" in reach_cost
