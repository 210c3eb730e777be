"""The port's control/ (PID bank, IK, Controller moves, introspection)
against the JAX package's, on the object fixture's arm submodel
(assets/ur5_2finger_objects.xml through both packages'
``load_arm_model``; JAX's compiled arrays carried across with
``carry.model_from_arrays``). The arm moves without objects, so every
roll is smooth and stays on one trajectory.

* ``pid_output``: four chained calls over seeded random gains, limits,
  setpoints and measurements (B=16), the first unprimed, with the output
  clip and the integral clamp active: ctrl and state within 1e-6.
* ``ik_solve``: 20 targets over the bin workspace (x in [-0.25, 0.25],
  y in [-0.77, -0.43], z in [0.91, 1.15]), the centre (0, -0.6, 1.1),
  the drop (0.6, 0, 1.15) and two unreachable targets, from the home
  pose: q5 within 1e-4 rad, err within 1e-5 m, ``ok`` equal (every
  target's JAX error lies more than 1e-3 m from the 0.02 m gate).
* The Controller's moves at B=2 (the home pose and a seeded perturbation
  of it), iterations=15 in both, chained as one sequence: ``move_group``
  on "All", "Arm", "Gripper" and a group made by ``create_group``,
  ``set_kp``, ``open_gripper`` (half and full), ``close_gripper``,
  ``grasp`` (inverted), ``stay``, ``move_ee`` (one target reachable, one
  not) and ``toss_it_from_the_ellbow`` (settle_steps=20): qpos and qvel
  of every move within 1e-4, ``success``, ``steps`` and ``ik_ok`` equal;
  the toss's qpos and qvel within 1e-4 of each scenario's largest entry
  (its 300 full-torque steps whip the arm to 67 rad/s and -18.7 rad; the
  packages part there by 1.5e-3 rad/s and 3.5e-4 rad, 2e-5 of the scale),
  the gains and groups equal. JAX's methods run as written, with their
  ``_run`` and ``_ik`` jitted once per static shape (one compile for the
  moves of one budget).
* ``show_model_info`` and ``display_current_values`` print the same text
  as JAX's (the port prints one scenario of its batch); ``joint_angle_plot``
  writes its PNG.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_rl_ur5_tpu.control import controller as jctl_mod
from mujoco_rl_ur5_tpu.control import introspect as jintro
from mujoco_rl_ur5_tpu.control import pid as jpid
from mujoco_rl_ur5_tpu.control.ik import ik_solve as jax_ik_solve
from mujoco_rl_ur5_tpu.scene.model import State as JState
from mujoco_rl_ur5_tpu.scene.reduce import load_arm_model as jax_load_arm
from mujoco_rl_ur5_tpu_torch import OBJECTS
from mujoco_rl_ur5_tpu_torch.carry import model_from_arrays
from mujoco_rl_ur5_tpu_torch.control import (
    Controller, introspect, pid, show_model_info,
)
from mujoco_rl_ur5_tpu_torch.control.ik import ik_solve
from mujoco_rl_ur5_tpu_torch.scene.model import ARRAY_FIELDS, State
from mujoco_rl_ur5_tpu_torch.scene.reduce import load_arm_model

HOME8 = np.array([0.0, -1.57, 1.57, -1.57, -1.57, 0.0, 0.3, 0.3])
B, ITERS, N = 2, 15, 20


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's CPU ops are small: one thread runs them faster here and
    leaves the other workers' cores alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



@pytest.fixture(scope="module")
def arm():
    jm = jax_load_arm(OBJECTS)
    host = load_arm_model(OBJECTS)
    m = model_from_arrays(host.topo, {n: np.asarray(getattr(jm, n))
                                      for n in ARRAY_FIELDS})
    rng = np.random.default_rng(11)
    q = np.tile(np.asarray(jm.qpos0, np.float64), (B, 1))
    q[:, :8] = HOME8
    q[1, :6] += 0.05 * rng.standard_normal(6)
    return jm, host, m, q.astype(np.float32)


# -- the PID bank ----------------------------------------------------------------


def test_pid_output_matches_jax():
    rng = np.random.default_rng(3)
    nu, nb, dt = 7, 16, 0.002
    lo = -rng.uniform(0.5, 2.0, nu)
    g = dict(kp=rng.uniform(5, 30, nu), ki=rng.uniform(50, 400, nu),
             kd=rng.uniform(0, 0.2, nu), out_lo=lo, out_hi=-lo)
    jp = jpid.PIDParams(**{k: jnp.asarray(v, jnp.float32)
                           for k, v in g.items()})
    tp = pid.PIDParams(**{k: torch.tensor(v, dtype=torch.float32)
                          for k, v in g.items()})
    js, ts = jpid.pid_init(nu, (nb,)), pid.pid_init(nu, nb)
    clipped = clamped = 0
    for _ in range(4):
        sp = rng.uniform(-1.5, 1.5, (nb, nu)).astype(np.float32)
        meas = (sp + rng.normal(0, 0.3, (nb, nu))).astype(np.float32)
        ju, js = jpid.pid_output(jp, js, jnp.asarray(sp), jnp.asarray(meas),
                                 dt)
        tu, ts = pid.pid_output(tp, ts, torch.from_numpy(sp),
                                torch.from_numpy(meas), dt)
        np.testing.assert_allclose(tu.numpy(), np.asarray(ju), atol=1e-6,
                                   rtol=0)
        for a, b in ((ts.integral, js.integral),
                     (ts.last_meas, js.last_meas)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                       rtol=0)
        np.testing.assert_array_equal(ts.primed.numpy(), np.asarray(js.primed))
        clipped += int((tu.abs() >= torch.from_numpy(-lo).float()).sum())
        clamped += int((ts.integral.abs()
                        >= torch.from_numpy(-lo).float()).sum())
    assert clipped > 0 and clamped > 0       # both limits were active
    g0 = pid.reference_gains()
    jg0 = jpid.reference_gains()
    for f in ("kp", "ki", "kd", "out_lo", "out_hi"):
        np.testing.assert_array_equal(getattr(g0, f).numpy(),
                                      np.asarray(getattr(jg0, f)))


# -- IK ---------------------------------------------------------------------------


def _targets():
    rng = np.random.default_rng(7)
    bin_ = np.stack([rng.uniform(-0.25, 0.25, 20), rng.uniform(-0.77, -0.43, 20),
                     rng.uniform(0.91, 1.15, 20)], -1)
    extra = [[0.0, -0.6, 1.1], [0.6, 0.0, 1.15], [2.0, 0.0, 1.0],
             [0.0, 0.0, 2.5]]
    return np.concatenate([bin_, extra]).astype(np.float32)


@pytest.fixture(scope="module")
def jax_ik(arm):
    jm = arm[0]
    chain = jctl_mod.ArmChain(jm)
    return jax.jit(jax.vmap(lambda p, q: jax_ik_solve(jm, chain, p, q)))


def test_ik_solve_matches_jax(arm, jax_ik):
    jm, host, m, q = arm
    tg = _targets()
    qp = np.tile(q[0], (len(tg), 1))
    jq, jerr, jok = jax_ik(jnp.asarray(tg), jnp.asarray(qp))
    c = Controller(m, device="cpu")
    tq, terr, tok = ik_solve(c.model, c.chain, torch.from_numpy(tg),
                             torch.from_numpy(qp))
    # ``ok`` is a threshold: held where JAX's error lies clear of 0.02
    clear = np.abs(np.asarray(jerr) - 0.02) > 1e-3
    assert clear.all()
    np.testing.assert_array_equal(tok.numpy()[clear], np.asarray(jok)[clear])
    # some bin targets miss the gate (the arm's reach and the vertical
    # gripper), the centre and the drop do not, the far targets fail
    assert tok[:20].any() and not tok[:20].all()
    assert tok[20:22].all() and not tok[22:].any()
    np.testing.assert_allclose(terr.numpy(), np.asarray(jerr), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-4, rtol=0)


# -- the Controller's moves -------------------------------------------------------


def _jax_controller(jm, jax_ik):
    """JAX's Controller with ``_run`` and ``_ik`` jitted (vmapped over the
    batch) once per static shape; every other line runs as written."""
    jc = jctl_mod.Controller(jm, iterations=ITERS)
    runs = {}

    def run(state, cstate, gmask, tolerance, max_steps,
            check_tolerance=True, record=False):
        key = (max_steps, check_tolerance)
        if key not in runs:
            runs[key] = jax.jit(jax.vmap(
                lambda s, c, g, tol: jctl_mod.Controller._run(
                    jc, s, c, g, tol, max_steps, check_tolerance),
                in_axes=(0, 0, None, None)))
        return runs[key](state, cstate, jnp.asarray(gmask),
                         jnp.float32(tolerance))

    def ik(state, position):
        # padded to the IK test's batch and passed as the IK test passes
        # its arguments: one compiled program for both
        p = np.zeros((len(_targets()), 3), np.float32)
        p[:B] = np.asarray(position)
        q = np.repeat(np.asarray(state.qpos)[:1], len(p), 0)
        q[:B] = np.asarray(state.qpos)
        return jax.tree.map(lambda a: a[:B],
                            jax_ik(jnp.asarray(p), jnp.asarray(q)))

    jc._run, jc._ik = run, ik
    return jc


def _same(res, jres, what, scaled=False):
    """qpos and qvel within 1e-4 (``scaled``: 1e-4 of each scenario's
    largest entry, at least 1e-4)."""
    for got, want in ((res.state.qpos, jres.state.qpos),
                      (res.state.qvel, jres.state.qvel)):
        want = np.asarray(want)
        tol = 1e-4 * (np.maximum(1.0, np.abs(want).max(1, keepdims=True))
                      if scaled else 1.0)
        err = np.abs(got.numpy() - want)
        assert (err <= tol).all(), (what, err.max(), (err / tol).max())
    np.testing.assert_allclose(res.ctrl.setpoints.numpy(),
                               np.asarray(jres.ctrl.setpoints), atol=1e-4,
                               rtol=0, err_msg=what)
    np.testing.assert_array_equal(res.success.numpy(),
                                  np.asarray(jres.success), err_msg=what)
    np.testing.assert_array_equal(res.steps.numpy(), np.asarray(jres.steps),
                                  err_msg=what)


def test_controller_moves_match_jax(arm, jax_ik):
    jm, host, m, q = arm
    jc = _jax_controller(jm, jax_ik)
    c = Controller(m, iterations=ITERS, device="cpu")
    nv, nu = m.topo.nv, m.topo.nu
    st = State(torch.from_numpy(q), torch.zeros(B, nv), torch.zeros(B, nu),
               torch.zeros(B))
    jst = JState(jnp.asarray(q), jnp.zeros((B, nv)), jnp.zeros((B, nu)),
                 jnp.zeros(B))
    cs = c.init(st.qpos)
    jcs = jax.vmap(lambda qq: jc.init(qpos0=qq))(jst.qpos)
    np.testing.assert_array_equal(cs.setpoints.numpy(),
                                  np.asarray(jcs.setpoints))

    c.create_group("Wrists", [3, 4, 5])
    jc.create_group("Wrists", [3, 4, 5])
    assert c.groups == jc.groups
    with pytest.raises(ValueError):
        c.create_group("bad", [1, 1])

    seen = set()
    f32 = np.float32
    moves = [
        ("All", lambda k, s, x, A: k.move_group(
            s, x, "All", A([0.15, -1.45, 1.45, -1.65, -1.5, 0.2, 0.1]),
            0.05, N)),
        ("Arm", lambda k, s, x, A: k.move_group(
            s, x, "Arm", A([0.2, -1.4, 1.5, -1.6, -1.55]), 0.05, N)),
        ("kp", None),
        ("Gripper", lambda k, s, x, A: k.move_group(
            s, x, "Gripper", A([-0.2]), 0.05, N)),
        ("Wrists", lambda k, s, x, A: k.move_group(
            s, x, "Wrists", A([-1.5, -1.6, 0.1]), 0.1, N)),
        ("open half", lambda k, s, x, A: k.open_gripper(s, x, half=True,
                                                        max_steps=N)),
        ("open", lambda k, s, x, A: k.open_gripper(s, x, max_steps=N)),
        ("close", lambda k, s, x, A: k.close_gripper(s, x, max_steps=N)),
        ("grasp", lambda k, s, x, A: k.grasp(s, x, max_steps=N)),
        ("stay", lambda k, s, x, A: k.stay(s, x, 40.0)),
        ("move_ee", lambda k, s, x, A: k.move_ee(
            s, x, A([[0.05, -0.55, 1.1], [2.0, 0.0, 1.0]]), max_steps=N)),
    ]
    for what, move in moves:
        if move is None:
            cs, jcs = c.set_kp(cs, 0, 10.0), jc.set_kp(jcs, 0, 10.0)
            np.testing.assert_array_equal(cs.params.kp.numpy(),
                                          np.asarray(jcs.params.kp))
            continue
        res = move(c, st, cs, lambda a: torch.tensor(np.asarray(a, f32)))
        jres = move(jc, jst, jcs, lambda a: jnp.asarray(a, f32))
        if what == "move_ee":
            np.testing.assert_array_equal(res.ik_ok.numpy(),
                                          np.asarray(jres.ik_ok))
            assert res.ik_ok.tolist() == [True, False]
        _same(res, jres, what)
        seen.update(zip(res.success.tolist(), res.steps.tolist()))
        st, cs, jst, jcs = res.state, res.ctrl, jres.state, jres.ctrl
    # some moves converge early, some run their whole budget
    assert {s for s, _ in seen} == {True, False}
    assert any(0 < n < N for _, n in seen)

    jtoss = jax.jit(jax.vmap(
        lambda s, x: jctl_mod.Controller(jm, iterations=ITERS)
        .toss_it_from_the_ellbow(s, x, settle_steps=N)))
    _same(c.toss_it_from_the_ellbow(st, cs, settle_steps=N),
          jtoss(jst, jcs), "toss", scaled=True)
    np.testing.assert_allclose(c.grasp_center(st).numpy(), np.asarray(
        jax.jit(jax.vmap(jc.grasp_center))(jst)), atol=1e-5, rtol=0)


# -- introspection ----------------------------------------------------------------


def test_introspection_prints_as_jax(arm, capsys, tmp_path):
    jm, host, m, q = arm
    c = Controller(m, device="cpu")
    jc = jctl_mod.Controller(jm)
    show_model_info(host, c)
    got = capsys.readouterr().out
    jintro.show_model_info(jm, jc)
    assert got == capsys.readouterr().out
    st = State(torch.from_numpy(q), torch.full((B, m.topo.nv), 0.25),
               torch.zeros(B, m.topo.nu), torch.zeros(B))
    cs = c.init(st.qpos)
    for b in range(B):
        introspect.display_current_values(m, st, cs, scenario=b)
        got = capsys.readouterr().out
        jst = JState(jnp.asarray(q[b]), jnp.full(m.topo.nv, 0.25),
                     jnp.zeros(m.topo.nu), jnp.zeros(()))
        jintro.display_current_values(jm, jst, jc.init(qpos0=jst.qpos))
        assert got == capsys.readouterr().out
    traj = np.cumsum(np.random.default_rng(0).normal(0, 0.01, (30, 7)), 0)
    path = str(tmp_path / "joints.png")
    assert introspect.joint_angle_plot(traj, traj[-1], 0.05,
                                       filename=path) == path
    assert os.path.getsize(path) > 1000
