"""The port's chain dynamics (physics/chain.py) and its generated substep
(physics/cuda_chain.py) against the JAX package's, on the same plan.

Both packages evaluate the same arithmetic in another order (torch's
batched matmuls against XLA's fused einsums), so results agree to a few
ulps: 1e-5 in float32 on values of order 1-30, and 1e-10 in float64. The
float32 tests come first: the module-scoped ``x64`` fixture switches 64-bit
JAX on from the first float64 test to the end of the module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_rl_ur5_tpu.physics import chain as jchain
from mujoco_rl_ur5_tpu.physics.pallas_chain import (
    make_knot_step as jax_knot_step,
)
from mujoco_rl_ur5_tpu.scene.reduce import load_arm_model as jax_load_arm
from mujoco_rl_ur5_tpu_torch import ASSET
from mujoco_rl_ur5_tpu_torch.carry import PLAN_FIELDS, plan_from_arrays
from mujoco_rl_ur5_tpu_torch.physics import chain as tchain
from mujoco_rl_ur5_tpu_torch.physics.cuda_chain import make_knot_step

HOME = np.array([0.0, -1.57, 1.57, -1.57, -1.57, 0.0, 0.0, 0.0])
B = 6


@pytest.fixture(scope="module")
def plans():
    """The JAX plan, and the port's plan carried from its arrays (so both
    compute on identical constants)."""
    jplan = jchain.make_chain_plan(jax_load_arm(ASSET))
    return jplan, plan_from_arrays({f: np.asarray(getattr(jplan, f))
                                    for f in PLAN_FIELDS})


def _states(dtype, seed=0):
    rng = np.random.default_rng(seed)
    q = HOME + 0.2 * rng.standard_normal((B, 8))
    v = 0.5 * rng.standard_normal((B, 8))
    u = 0.3 * rng.standard_normal((B, 7))
    return tuple(a.astype(dtype) for a in (q, v, u))


def _check_step(plans, dtype, tol):
    jplan, tplan = plans
    q, v, u = _states(dtype)
    jq, jv = jax.vmap(lambda a, b, c: jchain.chain_step(jplan, a, b, c))(
        jnp.asarray(q), jnp.asarray(v), jnp.asarray(u))
    tq, tv = tchain.chain_step(tplan, torch.from_numpy(q),
                               torch.from_numpy(v), torch.from_numpy(u))
    assert tq.dtype == tv.dtype == torch.from_numpy(q).dtype
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=tol, atol=tol)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=tol, atol=tol)


def _check_mass_bias(plans, dtype, tol):
    jplan, tplan = plans
    q, v, _ = _states(dtype, seed=1)
    jM, jb = jax.vmap(lambda a, b: jchain.chain_mass_bias(jplan, a, b))(
        jnp.asarray(q), jnp.asarray(v))
    tM, tb = tchain.chain_mass_bias(tplan, torch.from_numpy(q),
                                    torch.from_numpy(v))
    np.testing.assert_allclose(tM.numpy(), np.asarray(jM), rtol=tol, atol=tol)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=tol, atol=tol)


def _check_hold(plans, dtype, tol):
    jplan, tplan = plans
    q, _, _ = _states(dtype, seed=2)
    ju = jax.vmap(lambda a: jchain.chain_hold_ctrl(jplan, a))(jnp.asarray(q))
    tu = tchain.chain_hold_ctrl(tplan, torch.from_numpy(q))
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=tol, atol=tol)


def _check_fk(plans, dtype, tol):
    jplan, tplan = plans
    q, _, _ = _states(dtype, seed=3)
    jout = jax.vmap(lambda a: jchain.chain_fk(jplan, a))(jnp.asarray(q))
    tout = tchain.chain_fk(tplan, torch.from_numpy(q))
    for name, a, b in zip(("xpos", "xrot", "anchor", "axis"), tout, jout):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=tol,
                                   atol=tol, err_msg=name)


CHECKS = {"chain_step": _check_step, "chain_mass_bias": _check_mass_bias,
          "chain_hold_ctrl": _check_hold, "chain_fk": _check_fk}


@pytest.mark.parametrize("fn", sorted(CHECKS))
def test_f32_matches_jax(plans, fn):
    CHECKS[fn](plans, np.float32, 1e-5)


@pytest.mark.parametrize("substeps", [1, 2])
def test_generated_knot_matches_jax_knot(plans, substeps):
    """The port's generated straight-line knot on plain tensors against the
    JAX package's generated knot (make_knot_step) applied outside Pallas."""
    jplan, tplan = plans
    q, v, u = _states(np.float32, seed=4)
    jknot = jax_knot_step(jplan, substeps, unroll=True)
    jq, jv = jknot([jnp.asarray(q[:, i]) for i in range(8)],
                   [jnp.asarray(v[:, i]) for i in range(8)],
                   [jnp.asarray(u[:, j]) for j in range(7)])
    tq, tv = make_knot_step(tplan, substeps)(
        [torch.from_numpy(q[:, i]) for i in range(8)],
        [torch.from_numpy(v[:, i]) for i in range(8)],
        [torch.from_numpy(u[:, j]) for j in range(7)])
    got = torch.stack(tq + tv, -1).numpy()
    want = np.stack([np.asarray(a) for a in jq + jv], -1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_generated_knot_matches_chain_step(plans):
    """The generated substep is chain_step with the constants folded."""
    _, tplan = plans
    q, v, u = _states(np.float32, seed=5)
    tq, tv = make_knot_step(tplan, 1)(
        [torch.from_numpy(q[:, i]) for i in range(8)],
        [torch.from_numpy(v[:, i]) for i in range(8)],
        [torch.from_numpy(u[:, j]) for j in range(7)])
    rq, rv = tchain.chain_step(tplan, torch.from_numpy(q),
                               torch.from_numpy(v), torch.from_numpy(u))
    np.testing.assert_allclose(torch.stack(tq, -1).numpy(), rq.numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(torch.stack(tv, -1).numpy(), rv.numpy(),
                               rtol=1e-5, atol=1e-5)


# -- float64: from here to the end of the module JAX runs in 64 bits ---------


@pytest.mark.parametrize("fn", sorted(CHECKS))
def test_f64_matches_jax(x64, plans, fn):
    CHECKS[fn](plans, np.float64, 1e-10)
