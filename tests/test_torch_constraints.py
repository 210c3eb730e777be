"""The port's contact solve (physics/constraints.py) and contact step
(dynamics.step_warm) against the JAX package's, on the pile fixture.

Both packages step on identical compiled arrays (model_from_arrays). The
state (B=2): the nine objects of the lowest layer resting upright on the
bin floor (0.5 mm deep), a cylinder pinched between the fingers (the
knuckles at 0.45 rad, up to 2.6 mm deep), the rest of the pile in the air,
small seeded velocities; the second scenario also drives the gripper
closed. The candidate set then holds box-box, box-hull and finger
contacts, the finger equality row and the arm tree. (A box pinched with
one axis perpendicular to the fingers' would not do: box-box's edge axes
then coincide with face axes, a tie between an edge contact and none that
float32 roundoff breaks either way in either package.)

Settings: ncon=128 and iterations=100, the pile's own (the JAX step
compiles in about 12 s on an 8-core CPU at that size, so there is no
reason to shrink). The solve is held from the JAX package's warm start
after one step, as a step loop runs it; three steps of ``step_warm`` are held
against ``jax.jit(jax.vmap(dynamics.step_warm))`` from a cold start.
Tolerances (float32 in another operation order, through a solver whose
100 FISTA iterations amplify it): the selected candidate slots, their
activity, pair geoms and trees exactly; points, frames, distances and
Jacobians to 2e-5 absolute; forces, generalized forces and the warm start
to 1e-3 of their largest entry; qpos after three steps to 2e-5 and qvel
to 1e-3 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_rl_ur5_tpu.physics import constraints as jcon
from mujoco_rl_ur5_tpu.physics import dynamics as jdyn
from mujoco_rl_ur5_tpu.physics import kinematics as jkin
from mujoco_rl_ur5_tpu.scene.compile import compile_spec as jax_compile_spec
from mujoco_rl_ur5_tpu.scene.mjcf import parse_mjcf as jax_parse_mjcf
from mujoco_rl_ur5_tpu.scene.model import State as JState
from mujoco_rl_ur5_tpu_torch import PILE
from mujoco_rl_ur5_tpu_torch.carry import model_from_arrays, warm_from_arrays
from mujoco_rl_ur5_tpu_torch.physics import constraints, dynamics
from mujoco_rl_ur5_tpu_torch.physics.kinematics import fk, geom_poses
from mujoco_rl_ur5_tpu_torch.scene.compile import _mat2quat, compile_file
from mujoco_rl_ur5_tpu_torch.scene.mjcf import GEOM_BOX
from mujoco_rl_ur5_tpu_torch.scene.model import ARRAY_FIELDS, State

NCON, ITERS = 128, 100
PINCHED = 27         # object_27, a cylinder of radius 0.016
KNUCKLES, TILT, SPIN = 0.45, 0.3, 0.1


@pytest.fixture(scope="module")
def models():
    jm = jax_compile_spec(jax_parse_mjcf(PILE))
    port = model_from_arrays(compile_file(PILE).topo,
                             {n: np.asarray(getattr(jm, n))
                              for n in ARRAY_FIELDS})
    return port, jm


def _pile_state(m):
    """qpos, qvel, ctrl (B=2) as the module docstring sets out."""
    t = m.topo
    q = m.qpos0.numpy().astype(np.float64).copy()
    for i in range(40):
        qa = t.jnt_qposadr[t.joint_id(f"free_joint_{i}")]
        g = t.geom_id(f"object_{i}_geom")
        if abs(q[qa + 2] - 0.95) < 1e-6:          # the lowest layer
            half = m.geom_size[g, 2] if t.geom_type[g] == GEOM_BOX \
                else m.geom_size[g, 1]
            q[qa + 2] = 0.86 + float(half) - 5e-4
            q[qa + 3: qa + 7] = [1.0, 0.0, 0.0, 0.0]
    q[6] = q[7] = KNUCKLES
    kin = fk(m, torch.tensor(q, dtype=torch.float32)[None])
    gp = geom_poses(m, kin)[0][0].double().numpy()
    left, right = gp[t.geom_id("left_finger")], gp[t.geom_id("right_finger")]
    u = (left - right) / np.linalg.norm(left - right)
    # the cylinder across the squeeze direction u, its axis tilted about u
    # and spun about itself, away from symmetric (tied) face pairings
    z = np.array([0.0, 0.0, 1.0])
    y0 = np.cross(z, u)
    c, s = np.cos(TILT), np.sin(TILT)
    cs, ss = np.cos(SPIN), np.sin(SPIN)
    R = np.stack([u, c * y0 + s * z, c * z - s * y0], 1) @ np.array(
        [[cs, -ss, 0.0], [ss, cs, 0.0], [0.0, 0.0, 1.0]])
    qa = t.jnt_qposadr[t.joint_id(f"free_joint_{PINCHED}")]
    q[qa: qa + 3] = 0.5 * (left + right)
    q[qa + 3: qa + 7] = _mat2quat(R)
    rng = np.random.default_rng(1)
    qpos = np.stack([q, q]).astype(np.float32)
    qvel = (0.01 * rng.standard_normal((2, t.nv))).astype(np.float32)
    ctrl = np.zeros((2, t.nu), np.float32)
    ctrl[1, 6] = 0.1                              # gripper motor closing
    return qpos, qvel, ctrl


def _states(arrs):
    q, v, u = arrs
    return (State(*(torch.from_numpy(a.copy()) for a in arrs),
                  torch.zeros(2)),
            JState(jnp.asarray(q), jnp.asarray(v), jnp.asarray(u),
                   jnp.zeros(2)))


def _jax_solve(jm, s, w):
    """The JAX package's forward_warm up to the constraint solve."""
    with jax.default_matmul_precision("float32"):
        kin = jkin.fk(jm, s.qpos)
        crb = jdyn.composite_inertia(jm, jdyn.com_inertia(jm, kin))
        minv = jdyn.inv_blocks(jdyn.mass_blocks(jm, kin, crb))
        cinert = jdyn.com_inertia(jm, kin)
        qfrc_smooth = (jdyn.actuator_force(jm, s.ctrl)
                       - jdyn.rne_bias(jm, kin, cinert, s.qvel)
                       - jm.dof_damping * s.qvel)
        qacc_smooth = jdyn.minv_apply(jm, minv, qfrc_smooth)
        return jcon.constraint_forces(jm, s, kin, minv, qacc_smooth, NCON,
                                      ITERS, warm=w)


def _port_solve(m, s, w):
    kin = fk(m, s.qpos)
    cinert = dynamics.com_inertia(m, kin)
    mb = dynamics.mass_blocks(m, kin, dynamics.composite_inertia(m, cinert))
    minv = dynamics.inv_blocks(mb)
    qfrc_smooth = (dynamics.actuator_force(m, s.ctrl)
                   - dynamics.rne_bias(m, kin, cinert, s.qvel)
                   - m.dof_damping * s.qvel)
    qacc_smooth = dynamics.minv_apply(m, minv, qfrc_smooth)
    return constraints.constraint_forces(m, s, kin, minv, qacc_smooth, NCON,
                                         ITERS, warm=w)


@pytest.fixture(scope="module")
def solved(models):
    """Both solves from the JAX package's state and warm start after one
    cold step."""
    m, jm = models
    _, js = _states(_pile_state(m))
    jstep = jax.jit(jax.vmap(lambda s, w: jdyn.step_warm(jm, s, w, NCON,
                                                         ITERS)))
    jw = jax.vmap(lambda s: jcon.init_warm(jm, s))(js)
    js, jw = jstep(js, jw)
    ref = jax.jit(jax.vmap(lambda s, w: _jax_solve(jm, s, w)))(js, jw)
    s = State(*(torch.from_numpy(np.array(a)) for a in
                (js.qpos, js.qvel, js.ctrl, js.time)))
    got = _port_solve(m, s, warm_from_arrays(jw))
    return got, ref


def _close(a, b, atol, rel=False):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    tol = atol * max(np.abs(b).max(), 1e-12) if rel else atol
    assert np.abs(a - b).max() <= tol, (np.abs(a - b).max(), tol)


def test_contact_selection_matches_jax(solved):
    (_, con, _), (_, jcs, _) = solved
    np.testing.assert_array_equal(con.sel.numpy(), np.asarray(jcs.sel))
    act = np.asarray(jcs.active)
    np.testing.assert_array_equal(con.active.numpy(), act)
    assert act.sum(1).min() >= 20          # the pile and the pinch
    np.testing.assert_array_equal(con.geom1.numpy(), np.asarray(jcs.geom1))
    np.testing.assert_array_equal(con.geom2.numpy(), np.asarray(jcs.geom2))
    np.testing.assert_array_equal(con.tree1.numpy(), np.asarray(jcs.tree1))
    np.testing.assert_array_equal(con.tree2.numpy(), np.asarray(jcs.tree2))
    np.testing.assert_array_equal(con.dim_mask.numpy(),
                                  np.asarray(jcs.dim_mask))
    # the pinch reaches the arm tree (tree 0) on both fingers
    t1 = np.asarray(jcs.tree1)
    assert ((t1 == 0) & act).sum() >= 2


def test_contact_geometry_and_jacobians_match_jax(solved):
    (_, con, _), (_, jcs, _) = solved
    act = np.asarray(jcs.active)
    for f in ("pos", "frame", "dist", "J1", "J2", "friction", "solref",
              "solimp", "margin"):
        _close(getattr(con, f).numpy()[act], np.asarray(getattr(jcs, f))[act],
               2e-5)


def test_forces_and_warm_start_match_jax(solved):
    (qfrc, con, warm), (jqfrc, jcs, jwarm) = solved
    _close(con.forces.numpy(), jcs.forces, 1e-3, rel=True)
    _close(qfrc.numpy(), jqfrc, 1e-3, rel=True)
    _close(warm[0].numpy(), jwarm[0], 1e-3, rel=True)
    _close(warm[1].numpy(), jwarm[1], 1e-3, rel=True)
    assert float(np.abs(np.asarray(jcs.forces)).max()) > 0.0


def test_three_steps_match_jax(models):
    m, jm = models
    s, js = _states(_pile_state(m))
    w = constraints.init_warm(m, s)
    jw = jax.vmap(lambda st: jcon.init_warm(jm, st))(js)
    assert w[0].shape == jw[0].shape and w[1].shape == jw[1].shape
    jstep = jax.jit(jax.vmap(lambda st, ww: jdyn.step_warm(jm, st, ww, NCON,
                                                           ITERS)))
    for _ in range(3):
        s, w = dynamics.step_warm(m, s, w, NCON, ITERS)
        js, jw = jstep(js, jw)
    _close(s.qpos.numpy(), js.qpos, 2e-5)
    _close(s.qvel.numpy(), js.qvel, 1e-3)
    _close(w[0].numpy(), jw[0], 1e-3, rel=True)
