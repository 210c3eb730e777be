"""The port's MPC pick policy (mpc/policy.py) and ``GraspEnv.step_mpc``
against the JAX package's, on the object fixture (JAX's compiled arrays
carried across with ``carry.model_from_arrays``; each package plans on its
own compile of the arm submodel), ncon=96, iterations=15, the planner at
H=4 knots of 2 substeps, w_ctrl=1.

The solver routes differ: JAX's CPU route plans each scenario with the
per-instance ``GraspMPC.track`` (vmapped); the port plans the batch with
``track_batch`` (the chain kernels' plain versions here, the kernels on
the card), which tests/test_torch_slice.py holds against JAX's batched
route. The two agree only where the horizon can make the move (a 0.09 rad
ramp parts the controls by 0.36, the feedback gains by 3.6 of 4.1), so
the policy is held with the solve taken out: JAX's move program (one
compile, which JAX's env also runs) records each tracking problem and its
plan, and the port's ``track_batch`` is replaced, call by call, by a check
that its problem is JAX's (x0 and q_refs within 1e-4, qd_refs within
1e-2) and JAX's plan (``carry.ilqr_from_arrays``). Everything else runs
as written: IK, the fallback, the wrist pin, the ramp, the execution
through the contact scene, the holds, the phase script and its masks.
Objects are parked 40 m away except where a scenario aims into the pile.

* ``execute`` of a plan carried across (B=2, H=4, substeps=4, seeded
  controls, knot states and feedback gains): qpos and qvel within 1e-4
  (in tests/test_torch_policy_execute.py, which runs beside this file
  under ``--dist loadfile``).
* ``hold`` (50 steps, the gripper closing or opening), ``move_to`` (B=4:
  targets 1 cm from each grasp centre with the wrist turned 0.05 rad, one
  out of reach that takes its fallback) and ``pick`` (B=4,
  close_steps=50, the grasp centre starting at the pre-grasp point):
  qpos, qvel and the PID state within 1e-4, the end-effector errors
  within 1e-5 m, ``grasped`` equal. Both report a grasp: the fingers
  close at about 0.25 rad/s, so no budget under ~1,400 steps brings them
  within 0.01 of the close setpoint, objects or not.
* ``move_to`` with the port's own planner on moves the horizon can make
  (B=4, the arm at rest at home, the grasp centre 3 mm away, the wrist
  turned 0.005 rad) against JAX's: the plans' controls within 5e-2, the
  end-effector errors within 1e-3 m, qpos within 1e-4 (the plans part by
  5e-4 in the controls, the speeds after the move by as much).
* ``step_mpc`` at budget_scale=0.005 (B=4; every hold 2 steps): (a) a
  floor pixel beyond the bin (skipped), (b) a pixel whose pre-grasp IK
  misses (the centre fallback; its depth set to 0.95 m in both inputs),
  (c) the bin's centre at depth 0.89 m (z = 1.11, so c2 = c1), (b) and
  (c) with the arm at the centre's IK solution, (d) the closest pixel of
  a dropped pile: reward, grasped and done equal, qpos, qvel and the PID
  state within 1e-4 (40 steps: one trajectory), (a) untouched. Then the
  port's own planner on the same inputs: finite states, boolean flags,
  rewards in {0, 1}, (a) untouched.
* Without a policy ``step_mpc`` raises; a GraspMPC on another device than
  the policy's raises (in tests/test_torch_policy_execute.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_rl_ur5_tpu.control.controller import CtrlState as JCtrlState
from mujoco_rl_ur5_tpu.control.pid import PIDParams as JPIDParams
from mujoco_rl_ur5_tpu.control.pid import PIDState as JPIDState
from mujoco_rl_ur5_tpu.control.pid import pid_init as jpid_init
from mujoco_rl_ur5_tpu.env.grasp_env import EnvState as JEnvState
from mujoco_rl_ur5_tpu.env.grasp_env import GraspEnv as JGraspEnv
from mujoco_rl_ur5_tpu.mpc.grasp_mpc import GraspMPC as JGraspMPC
from mujoco_rl_ur5_tpu.mpc.grasp_mpc import MPCWeights as JWeights
from mujoco_rl_ur5_tpu.scene.compile import compile_spec as jax_compile_spec
from mujoco_rl_ur5_tpu.scene.mjcf import parse_mjcf as jax_parse_mjcf
from mujoco_rl_ur5_tpu.scene.model import State as JState
from mujoco_rl_ur5_tpu.scene.reduce import load_arm_model as jax_load_arm
from mujoco_rl_ur5_tpu_torch import OBJECTS, carry
from mujoco_rl_ur5_tpu_torch.control.ik import ik_solve
from mujoco_rl_ur5_tpu_torch.env import GraspEnv
from mujoco_rl_ur5_tpu_torch.mpc import GraspMPC, MPCWeights
from mujoco_rl_ur5_tpu_torch.mpc.policy import GRIP_CLOSE, GRIP_OPEN
from mujoco_rl_ur5_tpu_torch.scene.compile import compile_file
from mujoco_rl_ur5_tpu_torch.scene.mjcf import JNT_FREE
from mujoco_rl_ur5_tpu_torch.scene.model import ARRAY_FIELDS

H, SUB, W = 4, 2, 32
# budget_scale=0.005: every hold of step_mpc is 2 steps (one JAX program)
KW = dict(ncon=96, iterations=15, image_width=W, image_height=W,
          budget_scale=0.005)
HOME8 = np.array([0.0, -1.57, 1.57, -1.57, -1.57, 0.0, 0.3, 0.3])


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's CPU ops are small: one thread runs them faster here and
    leaves the other workers' cores alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



@pytest.fixture(scope="module")
def scene():
    jm = jax_compile_spec(jax_parse_mjcf(OBJECTS))
    host = compile_file(OBJECTS)
    m = model_from = carry.model_from_arrays(
        host.topo, {n: np.asarray(getattr(jm, n)) for n in ARRAY_FIELDS})
    kw = dict(horizon=H, substeps=SUB)
    jmpc = JGraspMPC(jm, arm_model=jax_load_arm(OBJECTS), use_pallas=False,
                     weights=JWeights(w_ctrl=1.0), **kw)
    mpc = GraspMPC.from_scene(OBJECTS, device="cpu",
                              weights=MPCWeights(w_ctrl=1.0), **kw)
    jenv = JGraspEnv(jm, mpc=jmpc, **KW)
    env = GraspEnv(model_from, mpc=mpc, device="cpu", **KW)
    return jm, host, m, jenv, env


def _parked(m, n, seed):
    """n scenarios at the home pose (the arm joints of all but the first
    perturbed by a seeded 0.03 rad) with every object parked 40 m away."""
    t = m.topo
    rng = np.random.default_rng(seed)
    q = np.tile(m.qpos0.numpy().astype(np.float64), (n, 1))
    q[:, :8] = HOME8
    q[1:, :6] += 0.03 * rng.standard_normal((n - 1, 6))
    for k, j in enumerate(np.nonzero(t.jnt_type == JNT_FREE)[0]):
        qa = t.jnt_qposadr[j]
        q[:, qa: qa + 3] = [40 + 2 * k, 40, 5.0]
        q[:, qa + 3: qa + 7] = [1, 0, 0, 0]
    return torch.from_numpy(q.astype(np.float32))


def _jstate(st):
    return JState(*(jnp.asarray(getattr(st, f).numpy())
                    for f in ("qpos", "qvel", "ctrl", "time")))


def _jpid(ps):
    return JPIDState(*(jnp.asarray(getattr(ps, f).numpy())
                       for f in ("integral", "last_meas", "primed")))


def _jenv_state(es):
    p = es.ctl.params
    return JEnvState(
        sim=_jstate(es.sim),
        ctl=JCtrlState(pid=_jpid(es.ctl.pid),
                       setpoints=jnp.asarray(es.ctl.setpoints.numpy()),
                       params=JPIDParams(*(jnp.asarray(getattr(p, f).numpy())
                                           for f in ("kp", "ki", "kd",
                                                     "out_lo", "out_hi")))),
        rgb=jnp.asarray(es.rgb.numpy()), depth=jnp.asarray(es.depth.numpy()),
        key=jnp.zeros((es.rgb.shape[0], 2), jnp.uint32))


def _close(got, want, tol, what):
    err = np.abs(np.asarray(got) - np.asarray(want)).max()
    assert err <= tol, (what, err)


@pytest.fixture(scope="module")
def parked4(scene):
    jm, host, m, jenv, env = scene
    return env._settle(_parked(m, 4, 2))


@pytest.fixture(scope="module")
def jax_moves(scene):
    """JAX's move_to, vmapped and jitted once, that also returns the
    tracking problem it solved and its plan; JAX's env takes it as its own
    move program, so step_mpc and the tests share one compile. Returns the
    list of those (x0, q_refs, qd_refs, plan), one per call, in order."""
    jm, host, m, jenv, env = scene
    jpol, jmpc = jenv.policy, jenv.policy.mpc

    def move(st, ps, t, g, w, fb):
        seen = []

        def track(x0, q_refs, qd_refs=None, u_init=None):
            res = JGraspMPC.track(jmpc, x0, q_refs, qd_refs)
            seen.append((x0, q_refs, qd_refs, res))
            return res

        jmpc.track = track
        try:
            out = jpol.move_to(st, ps, t, g, wrist=w, fallback=fb)
        finally:
            del jmpc.track
        return out, seen[0]

    run, plans = jax.jit(jax.vmap(move)), []

    def mv(*args):
        out, plan = run(*args)
        plans.append(plan)
        return out

    jenv._mv = mv
    return plans


def _jax_plans(monkeypatch, mpc, plans):
    """The port's ``track_batch`` replaced by JAX's plans, in order: each
    call checks that its tracking problem (the ramp to the IK target) is
    the one JAX solved (x0 and q_refs within 1e-4, the trajectories' limit;
    qd_refs within 1e-2 rad/s: the ramp's speeds divide by its 16 ms) and
    returns JAX's plan."""
    def track_batch(x0, q_refs, qd_refs=None, u_init=None):
        jx0, jq, jqd, jres = plans.pop(0)
        _close(x0, jx0, 1e-4, "x0")
        _close(q_refs, jq, 1e-4, "q_refs")
        _close(qd_refs, jqd, 1e-2, "qd_refs")
        return carry.ilqr_from_arrays(jres)

    monkeypatch.setattr(mpc, "track_batch", track_batch)


def _same(st, ps, jst, jps, what):
    _close(st.qpos, jst.qpos, 1e-4, what + " qpos")
    _close(st.qvel, jst.qvel, 1e-4, what + " qvel")
    _close(ps.integral, jps.integral, 1e-4, what + " pid")


def test_hold_and_move_to_match_jax(scene, parked4, jax_moves, monkeypatch):
    jm, host, m, jenv, env = scene
    pol, es = env.policy, parked4
    st, ps = es.sim, es.ctl.pid
    grip = torch.tensor([GRIP_CLOSE, GRIP_OPEN, GRIP_CLOSE, GRIP_OPEN])
    jst, jps = jenv._hold_b(_jstate(st), _jpid(ps), jnp.asarray(grip.numpy()),
                            50)
    _same(*pol.hold(st, ps, grip, 50), jst, jps, "hold")
    # 1 cm from each grasp centre, the wrist turned by 0.05 rad; the last
    # target is out of reach and takes its fallback, 1 cm above the centre
    centre = env.ctl.grasp_center(st)
    targets = centre + torch.tensor([[0.01, 0.0, 0.0], [0.0, -0.01, 0.0],
                                     [0.0, 0.0, 0.01], [0.0, 0.0, 0.0]])
    targets[3] = torch.tensor([2.0, 0.0, 1.0])
    fb = targets.clone()
    fb[3] = centre[3] + torch.tensor([0.0, 0.0, 0.01])
    wrist = st.qpos[:, 5] + 0.05
    J = lambda a: jnp.asarray(np.asarray(a, np.float32))  # noqa: E731
    jst, jps, jerr = jenv._mv(_jstate(st), _jpid(ps), J(targets), J(grip),
                              J(wrist), J(fb))
    _jax_plans(monkeypatch, pol.mpc, jax_moves)
    tst, tps, err = pol.move_to(st, ps, targets, grip, wrist, fb)
    assert not jax_moves
    _same(tst, tps, jst, jps, "move_to")
    _close(err, jerr, 1e-5, "move_to end-effector error")
    assert (tst.qpos[:, :6] - st.qpos[:, :6]).abs().max() > 1e-3


def test_move_to_with_own_planner_matches_jax(scene, jax_moves):
    """The port's own ``track_batch`` on moves the horizon can make: the
    arm at rest at home, the grasp centre 3 mm away, the wrist turned by
    0.005 rad."""
    jm, host, m, jenv, env = scene
    pol = env.policy
    q = _parked(m, 4, 2)
    q[:, :8] = torch.from_numpy(HOME8.astype(np.float32))
    es = env._settle(q)
    st, ps = es.sim, es.ctl.pid
    grip = torch.tensor([GRIP_CLOSE, GRIP_OPEN, GRIP_CLOSE, GRIP_OPEN])
    targets = env.ctl.grasp_center(st) + 0.003 * torch.tensor(
        [[1.0, 0.0, 0.0], [0.0, -1.0, 0.0], [0.0, 0.0, 1.0], [0.7, 0.7, 0.0]])
    wrist = st.qpos[:, 5] + 0.005
    J = lambda a: jnp.asarray(np.asarray(a, np.float32))  # noqa: E731
    jst, jps, jerr = jenv._mv(_jstate(st), _jpid(ps), J(targets), J(grip),
                              J(wrist), J(targets))
    jplan = jax_moves.pop()[3]
    plans, track_batch = [], pol.mpc.track_batch

    def spy(*args, **kw):
        plans.append(track_batch(*args, **kw))
        return plans[-1]

    pol.mpc.track_batch = spy
    try:
        tst, tps, err = pol.move_to(st, ps, targets, grip, wrist, targets)
    finally:
        del pol.mpc.track_batch
    assert len(plans) == 1
    _close(plans[0].us, jplan.us, 5e-2, "move_to controls")
    _close(err, jerr, 1e-3, "move_to end-effector error")
    _close(tst.qpos, jst.qpos, 1e-4, "move_to, own planner qpos")
    assert (tst.qpos[:, :6] - st.qpos[:, :6]).abs().max() > 1e-3


def test_pick_matches_jax(scene, jax_moves, monkeypatch):
    jm, host, m, jenv, env = scene
    pol = env.policy
    # the arm starts with its grasp centre at the pre-grasp point (z = 1.1)
    coords = torch.tensor([[0.49, 0.11, 1.105], [0.4, 0.2, 0.98],
                           [0.45, 0.0, 1.05], [0.5, 0.15, 1.0]])
    q = _parked(m, 4, 5)
    pre = coords.clone()
    pre[:, 2] = 1.1
    q5, _, ok = ik_solve(env.model, env.ctl.chain, pre, q)
    assert ok.all()
    q[:, :5] = q5
    st = env._settle(q).sim
    # JAX's pick (mpc/policy.py pick) step by step through its programs
    low = coords.clone()
    low[:, 2] = torch.clamp_min(coords[:, 2] - 0.01, 0.91)
    J = lambda a: jnp.asarray(np.asarray(a, np.float32))  # noqa: E731
    op, cl = J([GRIP_OPEN] * 4), J([GRIP_CLOSE] * 4)

    def move(s, p, target, g):
        return jenv._mv(s, p, J(target), g, s.qpos[:, 5], J(target))

    jst, jps = _jstate(st), jpid_init(7, (4,))
    jst, jps, _ = move(jst, jps, pre, op)
    jst, jps, _ = move(jst, jps, low, op)
    jst, jps = jenv._hold_b(jst, jps, op, 50)
    jst, jps = jenv._hold_b(jst, jps, cl, 50)
    jst, jps, jerr = move(jst, jps, pre, cl)
    qg = np.asarray(jst.qpos)[:, pol.grip_qadr]
    jgrasped = np.all(np.abs(qg - GRIP_CLOSE) > 0.01, -1)
    _jax_plans(monkeypatch, pol.mpc, jax_moves)
    res = pol.pick(st, coords, close_steps=50)
    assert not jax_moves
    _same(res.state, res.pid, jst, jps, "pick")
    _close(res.ee_err, jerr, 1e-5, "pick end-effector error")
    # the fingers close at about 0.25 rad/s: 50 steps leave them far from
    # the close setpoint, so both report a grasp on the contact-free arm
    np.testing.assert_array_equal(res.grasped.numpy(), jgrasped)
    assert res.grasped.all()


def _step_mpc_inputs(env):
    q = _parked(env.model, 4, 3)
    q[3] = env._draw(torch.Generator().manual_seed(4), 1)[0]
    # (b) and (c) start with the arm at the IK solution of the centre
    # (0, -0.6, 1.1), wrist_3 at 0
    q[1:3, 5] = 0.0
    q5, _, ok = ik_solve(env.model, env.ctl.chain,
                         torch.tensor([[0.0, -0.6, 1.1]] * 2), q[1:3])
    assert ok.all()
    q[1:3, :5] = q5
    es = env._settle(q)
    d = es.depth.numpy().copy()
    floor = np.argwhere(d[0] > 1.3)
    floor = floor[floor[:, 0] >= W - 4][0]
    d[1, 29, 16], d[2, 16, 16] = 0.95, 0.89
    actions = torch.tensor([[floor[0] * W + floor[1], 0], [29 * W + 16, 2],
                            [16 * W + 16, 0], [int(np.argmin(d[3])), 3]])
    return es.replace(depth=torch.from_numpy(d)), actions


def test_step_mpc_matches_jax(scene, jax_moves, monkeypatch):
    jm, host, m, jenv, env = scene
    es, actions = _step_mpc_inputs(env)
    coords = env.decode_action(es, actions)[0].numpy()
    assert coords[0, 2] < 0.8 and coords[1, 1] < -0.85
    np.testing.assert_allclose(coords[2], [0.0, -0.6, 1.11], atol=1e-4)
    jes2, jreward, jdone, jinfo = jenv.step_mpc(_jenv_state(es),
                                                jnp.asarray(actions.numpy()))
    assert len(jax_moves) == 4
    with monkeypatch.context() as mp:
        _jax_plans(mp, env.policy.mpc, jax_moves)
        es2, reward, done, info = env.step_mpc(es, actions)
    assert not jax_moves
    np.testing.assert_array_equal(reward.numpy(), np.asarray(jreward))
    np.testing.assert_array_equal(info["grasped"].numpy(),
                                  np.asarray(jinfo["grasped"]))
    np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
    _same(es2.sim, es2.ctl.pid, jes2.sim, jes2.ctl.pid, "step_mpc")
    # (a) skipped: untouched; the others moved
    np.testing.assert_array_equal(es2.sim.qpos[0].numpy(),
                                  es.sim.qpos[0].numpy())
    assert (es2.sim.qpos[1:, :6] - es.sim.qpos[1:, :6]).abs().amax(1).min() \
        > 1e-3
    assert es2.rgb.shape == (4, W, W, 3) and es2.depth.shape == (4, W, W)

    # the port's own planner (track_batch): the same decisions, finite
    # states, rewards in {0, 1}
    es3, reward3, _, info3 = env.step_mpc(es, actions)
    assert torch.isfinite(es3.sim.qpos).all() and torch.isfinite(
        es3.sim.qvel).all()
    assert info3["grasped"].dtype == torch.bool
    assert set(reward3.tolist()) <= {0.0, 1.0}
    np.testing.assert_array_equal(es3.sim.qpos[0].numpy(),
                                  es.sim.qpos[0].numpy())
