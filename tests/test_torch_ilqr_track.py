"""``GraspMPC.dyn_step`` and the per-instance ``track`` (cold and warm)
against the JAX package, as tests/test_torch_ilqr.py holds ``solve`` (its
docstring sets out the fixture and the limits; its ``solvers`` fixture
serves both files: the two tests here draw from its generator in the
order they did there). The file is apart so that ``--dist loadfile`` runs
it beside the other half.
"""

import jax.numpy as jnp
import numpy as np

from tests.test_torch_ilqr import (  # noqa: F401 -- fixtures
    H, _compare, _t, solvers,
)


def test_dyn_step_matches_jax(solvers):
    jmpc, tmpc, rng, x0 = solvers
    u = (0.3 * rng.standard_normal(7)).astype(np.float32)
    got = tmpc.dyn_step(_t(x0), _t(u))
    want = jmpc.dyn_step(jnp.asarray(x0), jnp.asarray(u))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-4)


def test_track_matches_jax_cold_and_warm(solvers):
    jmpc, tmpc, rng, x0 = solvers
    goal = x0[:8] + 0.01 * rng.standard_normal(8)
    s = np.linspace(0.0, 1.0, H + 1)[:, None]
    q_refs = (x0[None, :8] * (1 - s) + goal[None] * s).astype(np.float32)
    jres = jmpc.track(jnp.asarray(x0), jnp.asarray(q_refs))
    tres = tmpc.track(_t(x0), _t(q_refs))
    _compare(jres, tres)
    u_warm = np.concatenate([np.asarray(jres.us)[1:],
                             np.asarray(jres.us)[-1:]])
    jw = jmpc.track(jnp.asarray(x0), jnp.asarray(q_refs),
                    u_init=jnp.asarray(u_warm))
    tw = tmpc.track(_t(x0), _t(q_refs), u_init=_t(u_warm))
    _compare(jw, tw)
