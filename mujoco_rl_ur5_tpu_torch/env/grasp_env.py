"""The batched grasping environment: the reference's scripted
pick-and-place as a masked fixed-horizon phase machine, the port's
counterpart of the JAX package's env/grasp_env.py.

The reference's behaviour, as there:
  * action = [pixel index, rotation]; x = a0 % W, y = a0 // W;
  * the world target from the current observation's depth at that pixel
    (``pixel_2_world``);
  * the skip gate: world z < 0.8 or y > -0.3 gives reward 0 and no motion;
  * the 13-phase pick (``_move_and_grasp``'s table): pre-grasp at z = 1.1
    with the IK-miss centre fallback, wrist rotation, open half, descend
    to max(0.91, z - 0.01), stay 100 ms, grasp (success = the fingers did
    NOT converge), shoulder_pan Kp 10, to the centre and the drop bin, the
    final close check, open, settle 200 ms, rotate back, Kp 20;
  * the binary reward and a new RGB-D observation per step;
  * reset: the home pose, the free objects dropped from z in [1.0, 1.5]
    over the bin with uniform random orientations, settled for 1000 ms.

Every state carries a leading batch axis B; the JAX package writes one
scenario and vmaps it. The phase machine is one Python loop over the
phases and their step budgets (Python ints), with the phase decisions as
per-scenario masks on the device: nothing is read back to the host inside
a step, and every phase runs its full budget. The contact steps, the
observation and the MPC policy's solves run on the card through the
port's kernels, or on the CPU through their plain versions when the caller
asks for ``device="cpu"``. Random draws take an explicit
``torch.Generator``; the state carries no key.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from mujoco_rl_ur5_tpu_torch.control.controller import (
    Controller, CtrlState, select,
)
from mujoco_rl_ur5_tpu_torch.control.ik import ik_solve
from mujoco_rl_ur5_tpu_torch.physics import fk
from mujoco_rl_ur5_tpu_torch.render import make_camera, pixel_2_world
from mujoco_rl_ur5_tpu_torch.render.camera import Camera, depth_2_meters
from mujoco_rl_ur5_tpu_torch.render.raycast import render_rgbd
from mujoco_rl_ur5_tpu_torch.scene.mjcf import JNT_FREE
from mujoco_rl_ur5_tpu_torch.scene.model import Model, State, make_state

# wrist rotations in degrees (the action's second entry)
ROTATIONS = np.array([0.0, 30.0, 60.0, 90.0, -30.0, -60.0])
TABLE_HEIGHT = 0.91
HOME = np.array([0.0, -1.57, 1.57, -1.57, -1.57, 0.0, 0.3])
CENTER = (0.0, -0.6, 1.1)
DROP = (0.6, 0.0, 1.15)

# the phase table: tolerance, whether it is checked, the group (arm, all,
# gripper) and the gripper setpoint set at the phase's start (NaN: leave it)
ARM, ALL, GRIP = 0, 1, 2
PHASE_TOL = np.array([.05, .05, .05, .05, .01, 0.0, .01, .05, .01, .01, .05,
                      0.0, .05], np.float32)
PHASE_CHECK = (1, 1, 1, 1, 1, 0, 1, 1, 1, 1, 1, 0, 1)
PHASE_GROUP = (ARM, ARM, ALL, GRIP, ARM, ALL, GRIP, ARM, ARM, GRIP, GRIP,
               ALL, ALL)
PHASE_GRIP = np.full(13, np.nan, np.float32)
PHASE_GRIP[[3, 6, 9, 10]] = [0.0, -0.4, -0.4, 0.4]
# the phases that move the arm to an IK solution: phase -> IK problem
# (0: c1, 1: centre, 2: c2, 3: centre after the rotation, 4: drop)
PHASE_IK = {0: 0, 1: 1, 4: 2, 7: 3, 8: 4}
FLAGS = ("ik1_ok", "r1s", "pre_ok", "ik2_ok", "rd_s", "grasp_ok", "grasped")


@dataclass(eq=False)
class EnvState:
    """The batch's environment state."""

    sim: State
    ctl: CtrlState
    rgb: torch.Tensor     # (B, H, W, 3) uint8, the current observation
    depth: torch.Tensor   # (B, H, W) metric depth (the action's source)

    def replace(self, **kw) -> "EnvState":
        return dataclasses.replace(self, **kw)


class GraspEnv:
    """The batched environment bound to a compiled scene on ``device``."""

    def __init__(self, model: Model, ncon: int = 128,
                 iterations: int | None = None, image_width: int = 200,
                 image_height: int = 200, camera: str = "top_down",
                 demo: bool = False, budget_scale: float = 1.0, mpc=None,
                 device="cuda"):
        """``budget_scale`` scales every phase's step budget and the settle
        times (1.0: the reference's); ``iterations=None`` takes the scene's
        solver iterations. ``mpc`` (a GraspMPC on this scene's arm
        submodel, on the same device) enables ``step_mpc``, the MPC pick
        policy (mpc/policy.py)."""
        self.ctl = Controller(model, ncon=ncon, iterations=iterations,
                              device=device)
        self.model, self.device = self.ctl.model, self.ctl.device
        self.cam: Camera = make_camera(self.model, camera, image_width,
                                       image_height)
        self.W, self.H = image_width, image_height
        self.demo = demo
        self._scale = budget_scale
        t = model.topo
        free = np.nonzero(np.asarray(t.jnt_type) == JNT_FREE)[0]
        self.free_qadr = np.asarray(t.jnt_qposadr)[free]
        self.nobj = len(free)
        self.policy = None
        if mpc is not None:
            from mujoco_rl_ur5_tpu_torch.mpc.policy import MPCGraspPolicy

            self.policy = MPCGraspPolicy(self.model, mpc, ncon=ncon,
                                         iterations=iterations,
                                         device=device)

    def _steps(self, n: int) -> int:
        return max(2, int(round(n * self._scale)))

    def _ms_steps(self, ms: float) -> int:
        return max(1, int(round(ms / 1000.0 / self.ctl.dt)))

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    # -- observation ----------------------------------------------------------

    def observe(self, sim: State):
        """(rgb (B, H, W, 3) uint8, metric depth (B, H, W))."""
        rgb, dbuf = render_rgbd(self.model, fk(self.model, sim.qpos),
                                self.cam)
        return rgb, depth_2_meters(self.cam, dbuf)

    # -- reset ----------------------------------------------------------------

    def reset(self, generator: torch.Generator, batch: int) -> EnvState:
        """``batch`` randomized piles, drawn from ``generator`` (on its
        device) and settled."""
        return self._settle(self._draw(generator, batch))

    def _draw(self, generator: torch.Generator, batch: int) -> torch.Tensor:
        """The home pose and a random drop of every free object: qpos
        (batch, nq). x, y, z uniform over the bin and the drop heights,
        orientations normalised Gaussian quaternions (uniform on SO(3))."""
        dev = generator.device

        def uniform(lo, hi):
            return lo + (hi - lo) * torch.rand(batch, self.nobj,
                                               generator=generator,
                                               device=dev)

        xs, ys = uniform(-0.25, 0.25), uniform(-0.77, -0.43)
        zs = uniform(1.0, 1.5)
        quats = torch.randn(batch, self.nobj, 4, generator=generator,
                            device=dev)
        quats = quats / torch.linalg.vector_norm(quats, dim=-1, keepdim=True)
        qpos = self.model.qpos0.expand(batch, -1).clone()
        qpos[:, self.ctl.act_qadr] = self._tensor(HOME)
        qa = self.free_qadr
        for k, v in enumerate((xs, ys, zs, *quats.unbind(-1))):
            qpos[:, qa + k] = v.to(self.device, qpos.dtype)
        return qpos

    def _settle(self, qpos: torch.Tensor) -> EnvState:
        """Settle the drop ``qpos`` (B, nq) for 1000 ms (5000 in demo
        mode) holding the home pose, and observe it."""
        sim = make_state(self.model, qpos.shape[0], device=self.device)
        sim = sim.replace(qpos=qpos)
        res = self.ctl.stay(sim, self.ctl.init(qpos0=qpos),
                            (5000.0 if self.demo else 1000.0) * self._scale)
        rgb, depth = self.observe(res.state)
        return EnvState(sim=res.state, ctl=res.ctrl, rgb=rgb, depth=depth)

    # -- step -----------------------------------------------------------------

    def decode_action(self, es: EnvState, action: torch.Tensor):
        """Actions (B, 2) [pixel index, rotation] -> world grasp points
        (B, 3) and rotation indices (B,)."""
        action = action.to(self.device)
        x, y = action[:, 0] % self.W, action[:, 0] // self.W
        rows = torch.arange(action.shape[0], device=self.device)
        depth = es.depth[rows, y, x]
        coords = pixel_2_world(self.cam, x.to(depth.dtype),
                               y.to(depth.dtype), depth)
        return coords, action[:, 1]

    def step(self, es: EnvState, action: torch.Tensor):
        """One RL step = one scripted pick-and-place per scenario:
        (EnvState, reward (B,), done (B,), info). ``info["grasped"]`` as the
        JAX package's; ``info["phases"]`` the phase machine's seven flags
        (``FLAGS``), before the skip gate."""
        coords, rotation = self.decode_action(es, action)
        skip = (coords[:, 2] < 0.8) | (coords[:, 1] > -0.3)
        sim, ctl, flags = self._move_and_grasp(es.sim, es.ctl, coords,
                                               rotation)
        sim, ctl = select(skip, es.sim, sim), select(skip, es.ctl, ctl)
        grasped = flags["grasped"]
        reward = torch.where(skip, torch.zeros_like(coords[:, 0]),
                             grasped.to(coords.dtype))
        rgb, depth = self.observe(sim)
        es = es.replace(sim=sim, ctl=ctl, rgb=rgb, depth=depth)
        return es, reward, torch.zeros_like(skip), {
            "grasped": grasped & ~skip, "phases": flags}

    def step_mpc(self, es: EnvState, action: torch.Tensor):
        """One RL step with the MPC pick policy: the reference's phases
        with every arm move planned by iLQR (one batched tracking solve per
        move) and executed as TVLQR feedback through the contact scene,
        the gripper on the reference PID law (mpc/policy.py). The skip
        gate, the IK-miss centre fallback, the rotation action, the grasp
        test and the binary reward follow ``step``."""
        from mujoco_rl_ur5_tpu_torch.mpc.policy import GRIP_CLOSE, GRIP_OPEN

        if self.policy is None:
            raise ValueError("construct GraspEnv with mpc=GraspMPC(...) to "
                             "use step_mpc")
        pol, S = self.policy, self._steps
        coords, rotation = self.decode_action(es, action)
        B, f = coords.shape[0], coords.dtype
        skip = (coords[:, 2] < 0.8) | (coords[:, 1] > -0.3)
        wrist = torch.deg2rad(self._tensor(ROTATIONS))[rotation]
        open_sp = torch.full((B,), GRIP_OPEN, dtype=f, device=self.device)
        close_sp = torch.full_like(open_sp, GRIP_CLOSE)
        center = self._tensor(CENTER).expand(B, 3)
        drop = self._tensor(DROP).expand(B, 3)
        c1, c2 = coords.clone(), coords.clone()
        c1[:, 2] = 1.1
        c2[:, 2] = torch.clamp_min(coords[:, 2] - 0.01, TABLE_HEIGHT)

        def blocked(st):
            qg = st.qpos[:, pol.grip_qadr]
            return ((qg - GRIP_CLOSE).abs() > 0.01).all(-1)

        pid0 = es.ctl.pid
        # pre-grasp (IK miss: the centre), rotate, descend
        st, ps, _ = pol.move_to(es.sim, pid0, c1, open_sp, wrist, center)
        st, ps, e2 = pol.move_to(st, ps, c2, open_sp, wrist, c2)
        st, ps = pol.hold(st, ps, open_sp, S(50))         # stay 100 ms
        st, ps = pol.hold(st, ps, close_sp, S(300))       # grasp
        grasp_ok = (e2 < 0.05) & blocked(st)
        # transport (closed): the centre, then the drop bin, wrist back to 0
        st, ps, _ = pol.move_to(st, ps, center, close_sp, wrist, center)
        st, ps, _ = pol.move_to(st, ps, drop, close_sp,
                                torch.zeros_like(wrist), drop)
        # final check: the fingers still blocked after the transport
        st, ps = pol.hold(st, ps, close_sp, S(300))
        grasped = grasp_ok & blocked(st)
        st, ps = pol.hold(st, ps, open_sp, S(100))        # release
        sim, ps = select(skip, es.sim, st), select(skip, pid0, ps)
        reward = torch.where(skip, torch.zeros_like(e2), grasped.to(f))
        rgb, depth = self.observe(sim)
        es = es.replace(sim=sim, ctl=es.ctl.replace(pid=ps), rgb=rgb,
                        depth=depth)
        return es, reward, torch.zeros_like(skip), {
            "grasped": grasped & ~skip}

    # -- the phase machine ----------------------------------------------------

    def move_and_grasp(self, sim: State, ctl: CtrlState, coords, rotation):
        """The whole pick-and-place script: (State, CtrlState, grasped)."""
        st, ctl, flags = self._move_and_grasp(sim, ctl, coords, rotation)
        return st, ctl, flags["grasped"]

    def _phase_budgets(self) -> list:
        S, ms = self._steps, self._ms_steps
        return [S(1000), S(1000), S(500), S(1000), S(300),
                ms(100.0 * self._scale), S(300), S(1000), S(1200),
                S(100 if self.demo else 1000), S(1000),
                ms(200.0 * self._scale), S(500)]

    def _move_and_grasp(self, sim: State, ctl: CtrlState, coords, rotation):
        """The 13 phases (budgets scaled by budget_scale):

          0 pre-grasp c1       (Arm,  tol .05, <=1000)  IK miss: keep sp
          1 centre fallback    (Arm,  tol .05, <=1000)  skipped if IK ok
          2 rotate wrist_3     (All,  tol .05, <=500)   skipped if stuck
          3 open half          (Grip, tol .05, <=1000)  skipped if stuck
          4 descend c2         (Arm,  tol .01, <=300)   skipped if stuck
          5 stay 100 ms        (no tolerance check)     skipped if stuck
          6 grasp close        (Grip, tol .01, <=300)   skipped if stuck
          7 to centre, Kp0=10  (Arm,  tol .05, <=1000)
          8 to drop bin        (Arm,  tol .01, <=1200)
          9 final close        (Grip, tol .01, <=1000, 100 in demo mode)
                                                        only if grasp_ok
         10 open full          (Grip, tol .05, <=1000)
         11 settle 200 ms      (no tolerance check)     only if grasped
         12 rotate back        (All,  tol .05, <=500)   then Kp0=20

        At each phase's start the flags are updated from the previous
        phase's final ``done``, a skipped phase starts done (its state
        frozen), the setpoints and gains are set, and the solver's warm
        start is reset. The five IK problems are solved once before the
        loop, in one batch: phases 0 and 1 at the entry wrist angle,
        phases 4, 7 and 8 with wrist_3 at the rotation target (the
        solution depends on the entry state only through wrist_3).
        Returns (State, CtrlState, flags)."""
        C, model = self.ctl, self.model
        B, f = coords.shape[0], sim.qpos.dtype
        coords = coords.to(f)
        c1, c2 = coords.clone(), coords.clone()
        c1[:, 2] = 1.1
        c2[:, 2] = torch.clamp_min(coords[:, 2] - 0.01, TABLE_HEIGHT)
        center = self._tensor(CENTER).expand(B, 3)
        drop = self._tensor(DROP).expand(B, 3)
        wrist_target = torch.deg2rad(self._tensor(ROTATIONS))[
            rotation.to(self.device)]
        qp0 = sim.qpos
        qp_rot = qp0.clone()
        qp_rot[:, C.act_qadr[5]] = wrist_target
        q_ik, _, ok_ik = ik_solve(model, C.chain,
                                  torch.cat([c1, center, c2, center, drop]),
                                  torch.cat([qp0, qp0, qp_rot, qp_rot,
                                             qp_rot]))
        q_ik, ok_ik = q_ik.split(B), ok_ik.split(B)
        gmask = {k: C._gmask(ids) for k, ids in (
            (ARM, np.arange(5)), (ALL, np.arange(C.nu)), (GRIP, [6]))}

        false = torch.zeros(B, dtype=torch.bool, device=self.device)
        fl = dict.fromkeys(FLAGS, false)
        st, ps, params, sp = sim, ctl.pid, ctl.params, ctl.setpoints
        done = false
        for p, n in enumerate(self._phase_budgets()):
            # phase entry: ``done`` is the previous phase's final one
            if p == 0:
                fl["ik1_ok"] = ok_ik[0]
            elif p == 1:
                fl["r1s"] = done & fl["ik1_ok"]
            elif p == 2:
                fl["pre_ok"] = torch.where(fl["ik1_ok"], fl["r1s"],
                                           done & ok_ik[1])
            elif p == 4:
                fl["ik2_ok"] = ok_ik[2]
            elif p == 5:
                fl["rd_s"] = done & fl["ik2_ok"]
            elif p == 7:      # the close (6) ends: grasp() inverts it
                fl["grasp_ok"] = fl["pre_ok"] & fl["rd_s"] & ~done
            elif p == 10:     # the final check (9) ends: converged, no grasp
                fl["grasped"] = fl["grasp_ok"] & ~done
            # the reference's skipped phases start done (state frozen)
            done = (fl["ik1_ok"] if p == 1
                    else ~fl["pre_ok"] if 2 <= p <= 6
                    else ~fl["grasp_ok"] if p == 9
                    else ~fl["grasped"] if p == 11 else false)
            upd = ~done
            sp = sp.clone()
            if p in PHASE_IK:
                i = PHASE_IK[p]
                sp[:, :5] = torch.where((upd & ok_ik[i])[:, None], q_ik[i],
                                        sp[:, :5])
            if p in (2, 12):
                sp[:, 5] = torch.where(upd, wrist_target if p == 2
                                       else torch.zeros_like(wrist_target),
                                       sp[:, 5])
            if not np.isnan(PHASE_GRIP[p]):
                sp[:, 6] = torch.where(upd, sp.new_tensor(
                    float(PHASE_GRIP[p])), sp[:, 6])
            if p == 7:
                kp = params.kp.clone()
                kp[:, 0] = 10.0
                params = params.replace(kp=kp)
            # each phase starts with a cold constraint solver
            res = C._run(st, CtrlState(pid=ps, setpoints=sp, params=params),
                         gmask[PHASE_GROUP[p]], float(PHASE_TOL[p]), n,
                         check_tolerance=bool(PHASE_CHECK[p]), done=done)
            st, ps, done = res.state, res.ctrl.pid, res.success
        kp = params.kp.clone()
        kp[:, 0] = 20.0
        return st, CtrlState(pid=ps, setpoints=sp,
                             params=params.replace(kp=kp)), fl
