"""The port's batched kinematics and smooth dynamics against the JAX
package's (single-scenario functions vmapped), on the pile fixture: the
8-dof arm and 40 free objects, nv = 248 in 41 trees.

Seeded states: arm angles within 0.5 rad of rest, objects at random
positions and orientations, random velocities and controls. Both packages
step on the same compiled arrays (carried across with model_from_arrays).
Tolerances, all float32 roundoff in another operation order:
  * FK (positions to 2 m, unit axes): 2e-6 absolute;
  * mass blocks and RNE bias: 2e-5 relative to each quantity's largest
    entry (the arm's 20 kg links beside 1e-6 finger inertias);
  * the explicit inverse blocks, on each entry's equilibration scale
    sqrt(M^-1_ii M^-1_jj) (the arm block's condition number is near 1e7):
    the port's within 1e-5 of the float64 inverse of its blocks (measured
    7e-7), and within 5e-4 of the JAX package's, whose own float32
    inverse is 2.5e-4 from float64 on the finger slots (measured, CPU);
  * five smooth steps (ncon = 0): qpos to 2e-5, qvel to 2e-4 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_rl_ur5_tpu.physics import dynamics as jdyn
from mujoco_rl_ur5_tpu.physics import kinematics as jkin
from mujoco_rl_ur5_tpu.scene.compile import compile_spec as jax_compile_spec
from mujoco_rl_ur5_tpu.scene.mjcf import parse_mjcf as jax_parse_mjcf
from mujoco_rl_ur5_tpu.scene.model import State as JState
from mujoco_rl_ur5_tpu_torch import PILE
from mujoco_rl_ur5_tpu_torch.carry import model_from_arrays
from mujoco_rl_ur5_tpu_torch.physics import dynamics, kinematics
from mujoco_rl_ur5_tpu_torch.scene.compile import compile_file
from mujoco_rl_ur5_tpu_torch.scene.model import ARRAY_FIELDS, State

B = 3


@pytest.fixture(scope="module")
def models():
    jm = jax_compile_spec(jax_parse_mjcf(PILE))
    port = model_from_arrays(compile_file(PILE).topo,
                             {n: np.asarray(getattr(jm, n))
                              for n in ARRAY_FIELDS})
    return port, jm


@pytest.fixture(scope="module")
def state(models):
    t = models[0].topo
    rng = np.random.default_rng(0)
    q = np.tile(models[0].qpos0.numpy().astype(np.float64), (B, 1))
    q[:, :8] += rng.uniform(-0.5, 0.5, (B, 8))
    for j in range(t.njnt):
        if t.jnt_type[j] == 0:
            qa = t.jnt_qposadr[j]
            q[:, qa:qa + 3] += rng.uniform(-0.1, 0.1, (B, 3))
            quat = rng.normal(size=(B, 4))
            q[:, qa + 3:qa + 7] = quat / np.linalg.norm(quat, axis=1,
                                                        keepdims=True)
    qvel = rng.normal(0.0, 0.5, (B, t.nv))
    ctrl = rng.uniform(-1.0, 1.0, (B, t.nu))
    return [a.astype(np.float32) for a in (q, qvel, ctrl)]


def _port_state(arrs):
    q, v, u = (torch.from_numpy(a.copy()) for a in arrs)
    return State(q, v, u, torch.zeros(B))


def _jax_state(arrs):
    q, v, u = (jnp.asarray(a) for a in arrs)
    return JState(q, v, u, jnp.zeros(B))


def _rel(a, b, tol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.abs(b).max()
    assert np.abs(a - b).max() <= tol * scale, (np.abs(a - b).max(), scale)


def test_fk_matches_jax(models, state):
    m, jm = models
    kin = kinematics.fk(m, torch.from_numpy(state[0]))
    ref = jax.jit(jax.vmap(lambda q: jkin.fk(jm, q)))(jnp.asarray(state[0]))
    for f in ("xpos", "xquat", "xipos", "xanchor", "xaxis", "cdof",
              "tree_org", "dof_org", "body_org"):
        np.testing.assert_allclose(getattr(kin, f).numpy(),
                                   np.asarray(getattr(ref, f)), atol=2e-6,
                                   rtol=0, err_msg=f)
    gp, gq = kinematics.geom_poses(m, kin)
    jgp, jgq = jax.jit(jax.vmap(lambda q: jkin.geom_poses(
        jm, jkin.fk(jm, q))))(jnp.asarray(state[0]))
    np.testing.assert_allclose(gp.numpy(), np.asarray(jgp), atol=2e-6)
    np.testing.assert_allclose(gq.numpy(), np.asarray(jgq), atol=2e-6)


def _jax_blocks(jm, q, v):
    kin = jkin.fk(jm, q)
    cinert = jdyn.com_inertia(jm, kin)
    crb = jdyn.composite_inertia(jm, cinert)
    mb = jdyn.mass_blocks(jm, kin, crb)
    return mb, jdyn.rne_bias(jm, kin, cinert, v), jdyn.inv_blocks(mb)


def test_mass_blocks_bias_and_inverse_match_jax(models, state):
    m, jm = models
    q, v = torch.from_numpy(state[0]), torch.from_numpy(state[1])
    kin = kinematics.fk(m, q)
    cinert = dynamics.com_inertia(m, kin)
    crb = dynamics.composite_inertia(m, cinert)
    mb = dynamics.mass_blocks(m, kin, crb)
    bias = dynamics.rne_bias(m, kin, cinert, v)
    minv = dynamics.inv_blocks(mb)
    with jax.default_matmul_precision("float32"):
        jmb, jbias, jminv = jax.jit(jax.vmap(lambda a, b: _jax_blocks(
            jm, a, b)))(jnp.asarray(state[0]), jnp.asarray(state[1]))
    _rel(mb.numpy(), jmb, 2e-5)
    _rel(bias.numpy(), jbias, 2e-5)
    inv64 = torch.linalg.inv(mb.double()).numpy()
    d = np.sqrt(np.abs(np.diagonal(inv64, axis1=-2, axis2=-1)))
    scale = d[..., :, None] * d[..., None, :]
    assert np.all(np.abs(minv.numpy() - inv64) <= 1e-5 * scale)
    assert np.all(np.abs(minv.numpy() - np.asarray(jminv)) <= 5e-4 * scale)


def test_smooth_steps_match_jax(models, state):
    m, jm = models
    s, js = _port_state(state), _jax_state(state)
    jstep = jax.jit(jax.vmap(lambda st: jdyn.step(jm, st, ncon=0)))
    for _ in range(5):
        s = dynamics.step(m, s, ncon=0)
        js = jstep(js)
    np.testing.assert_allclose(s.qpos.numpy(), np.asarray(js.qpos),
                               atol=2e-5, rtol=0)
    np.testing.assert_allclose(s.qvel.numpy(), np.asarray(js.qvel),
                               atol=2e-4, rtol=0)
    np.testing.assert_allclose(s.time.numpy(), np.asarray(js.time),
                               rtol=1e-6)
