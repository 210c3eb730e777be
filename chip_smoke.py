#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py          (from the repository root; needs one GPU)

Phases, each printing its lines; any failure raises and exits non-zero:

  1. device: the card's name and power limit (nvidia-smi);
  2. build: the ten build units from csrc/, six of the batched solves (five
     kernels; rollout_closed once with the track costs and once with the
     reach costs) and the four collide kernels, one nvcc per source, in
     parallel, with the build time and ptxas's register and spill report;
  3. kernels: each kernel's wrapper at the shapes the main paths give it
     (B=4096, H=64, substeps=8), held against its plain PyTorch version on
     the same inputs on the card, output by output, with the tolerance
     stated; each timed with CUDA events beside the plain version and its
     bound. rollout_closed is held with both fused costs, and its costs also
     against the plain cost of the candidates it returned; ee_quad_gn's
     assembly into the full stage Hessians is timed beside it;
  4. main paths at B=4096, H=64, substeps=8, iters=6, each with every launch
     counter set to 0 just before and read just after:
     reach, GraspMPC.solve_batch_x on seeded world targets (rollout_open 1,
     lin_fd 7, rollout_closed 6, backward 7, ee_quad_gn 7 per cold solve):
     outputs finite, the cost rises in no scenario and falls in >= 99%, the
     end-effector error before and after; the solve's wall time and its
     device time by kernel under torch.profiler; a warm 2-iteration re-solve
     from the shifted plan (1 / 3 / 2 / 3 / 3);
     track, GraspMPC.track_batch on a seeded joint-space problem (1 / 7 / 6
     / 7 / 0), the same checks and times, and its warm re-solve;
  5. whole paths: solve_batch_x and track_batch at B=256, H=8, iters=2
     through the kernels against the same solves on the CPU, where every
     wrapper takes its plain version;
  6. per-instance: one GraspMPC.solve and one GraspMPC.track on the card at
     H=16, iters=2 (the generic optimizer, no kernel): finite, cost below
     the start's, wall time;
  7. the contact step (dynamics.step_warm) on the pile fixture at B=4096,
     ncon=128: a settle roll of 300 steps (iterations=30) from a seeded
     drop, with the share of objects in the bin, their rest heights on the
     bin floor and the speeds at the end; two 5-step rolls from the settled
     pile, which must agree to the bit; the four narrowphase kernels
     (box_box, hull_hull, box_hull, plane_hull) held against their plain
     versions at the shapes of the settled pile's step, timed beside their
     plain versions and bounds; the step at iterations=100 and 30 (25
     steps per call from the seeded drop, as bench.py's bench_dynamics
     times them, median of 3 calls, which must end in the same state),
     every launch counter set to 0 before a call and read after (one
     launch of each collide kernel per step); one step of the settled pile
     under torch.profiler;
  8. the whole contact step through the kernels against the plain path on
     the CPU at B=64, iterations=30: one step's qacc, active contacts and
     forces, and 25 steps' qpos by statistics, with limits read between
     the sound runs (and two plain rolls one ulp apart) and two planted
     faults and a TF32 control, each of which must be caught.

    python3 chip_smoke.py --dump-settle PATH   also writes the settle roll's
                                               fastest scenarios to PATH

The last three lines are the kernel table as JSON (nine kernels), the card's
name and power limit, and the device line as JSON.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# card peaks (NVIDIA H100 SXM data sheet, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12       # float32 outside the tensor cores

B, H, SUBSTEPS, ITERS = 4096, 64, 8, 6
NCON, STEPS, SETTLE = 128, 25, 300       # the contact step's cell
COLLIDE = ("box_box", "hull_hull", "box_hull", "plane_hull")
COLLIDE_TOL = 2e-5        # kernel vs plain, per active slot (float32 order)
HOME = np.array([0.0, -1.57, 1.57, -1.57, -1.57, 0.0, 0.0, 0.0])


def log(msg: str) -> None:
    print(msg, flush=True)


def tracking_problem(batch: int, horizon: int, seed: int, reach=None):
    """Seeded start states near home, each tracking a straight joint-space
    line over the H+1 knots: to a target posture near home (spread 0.3 rad)
    or, with ``reach``, to one ``reach`` rad from the start."""
    rng = np.random.default_rng(seed)
    x0 = np.concatenate([HOME + 0.05 * rng.standard_normal((batch, 8)),
                         0.05 * rng.standard_normal((batch, 8))], -1)
    if reach is None:
        target = HOME + 0.3 * rng.standard_normal((batch, 8))
        target[:, 6:] = np.clip(target[:, 6:], -0.3, 0.3)   # knuckles
    else:
        target = x0[:, :8] + reach * rng.standard_normal((batch, 8))
    s = np.linspace(0.0, 1.0, horizon + 1)[None, :, None]
    q_refs = x0[:, None, :8] * (1 - s) + target[:, None] * s
    return x0.astype(np.float32), q_refs.astype(np.float32)


def reach_problem(batch: int, seed: int):
    """Seeded start states near home and world grasp-center targets within
    0.1 m of (0, -0.6, 1.0)."""
    rng = np.random.default_rng(seed)
    x0 = np.concatenate([HOME + 0.05 * rng.standard_normal((batch, 8)),
                         0.05 * rng.standard_normal((batch, 8))], -1)
    targets = np.array([0.0, -0.6, 1.0]) + 0.1 * rng.uniform(
        -1.0, 1.0, (batch, 3))
    return x0.astype(np.float32), targets.astype(np.float32)


def event_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` runs (after one warm-up)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def check(name: str, err: float, tol: float, what: str) -> None:
    ok = err <= tol and np.isfinite(err)
    log(f"  {name}: {what} = {err:.3e} (tolerance {tol:.3e}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: {what} {err:.3e} > {tol:.3e}")


def backward_flops(nx: int, nu: int) -> int:
    """Floating-point operations of one Riccati step of csrc/lqr_backward.cu
    (an FMA counts 2), from its loops."""
    fma = (nx * nu * nx                        # SL = S L
           + nu * nx + nx * nx                 # Qu, Qx
           + nu * (nu + 1) // 2 * nx           # Quu (upper triangle)
           + nu * nx * nx                      # Qux = (S L)' F
           + nu * (nu - 1) * (nu + 1) // 6     # Cholesky
           + (nx + 1) * nu * (nu - 1)          # nx + 1 two-sided solves
           + nx * nx * nx                      # T = S F
           + nx * (nx + 1) // 2 * (nx + 2 * nu)    # S update
           + nx * (nu + nu * (nu + 1)))        # s update
    other = (nu + nx + nu * (nu + 1) // 2 + nu   # additions of U, r, q, reg
             + 3 * nu                          # pivots: sub, sqrt, reciprocal
             + (nx + 1) * 4 * nu               # solve: sub and mul per row
             + nx * (nx + 1) // 2 * 3)         # S: X add, half-sum
    return 2 * fma + other


def timed_ms(fn, reps: int = 3) -> float:
    """Median wall time of ``fn`` (synchronised) over ``reps`` runs, in ms."""
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls) * 1e3


def key_is_ours(key: str) -> bool:
    """Whether a profiler row is one of the port's hand-written kernels."""
    return any(key.startswith(k) or f" {k}" in key for k in (
        "rollout_open_kernel", "lin_fd_kernel", "rollout_closed_kernel",
        "riccati_backward_kernel", "ee_quad_gn_kernel"))


def profile_solve(solve) -> None:
    """Where a cold solve's time goes: device time by kernel name under
    torch.profiler, and the device's busy share of the solve's wall time
    (the profiler's own host cost is inside that wall time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solve()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side kernel events only: the ops that launch them carry the
    # same time again as their "self device time"
    rows = [(e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    if not rows:
        log("  profile: the profiler recorded no device time (not measured)")
        return
    log(f"  profile: cold solve under torch.profiler, wall {wall_ms:.1f} ms, "
        f"device busy {busy:.1f} ms ({busy / wall_ms:.1%})")
    # the twelve largest, and the port's own kernels wherever they rank
    for ms, count, key in rows[:12] + [r for r in rows[12:]
                                       if key_is_ours(r[2])]:
        log(f"    {ms:9.3f} ms {count:5d}x  {key[:90]}")


def collide_flops(kernel: str, V: int, F: int) -> tuple:
    """Floating-point operations of one (pair, scenario) of a collide
    function: (what the function needs, what the kernel executes). What it
    needs: a pose from a quaternion 36; a vertex to world 18, once per hull;
    a face to world 20 and its separation and comparison 2; per (face,
    vertex) pair one dot and one min 6; per vertex of the deepest-vertex
    pass a dot, a subtraction and a comparison 7; an output point 7; a box
    corner tested against a box 59; a SAT axis 60 (a cross axis 78). The
    deepest-vertex pass of hull-hull and box-hull runs on the side whose
    face lost, which the data decide: it is counted on the smaller side.
    The kernel moves every vertex to world again for each face and each
    output slot (24 and 25 per vertex), which keeps its registers few."""
    pose = 2 * 36
    if kernel == "box_box":
        n = pose + (16 + 8) * 59 + 6 * 60 + 9 * 78 + 9 * 24
        return n, n
    if kernel == "plane_hull":
        return (pose + 5 + V * 25 + 8 * 7, pose + 5 + V * 25 + 8 * 25)
    if kernel == "hull_hull":
        return (pose + 2 * V * 18 + 2 * F * 22 + 2 * F * V * 6 + V * 7
                + 8 * 7,
                pose + 2 * F * (22 + V * 24) + V * 25 + 8 * 25)
    return (pose + (8 + V) * 18 + (6 + F) * 22 + (8 * F + 6 * V) * 6 + 8 * 7
            + 8 * 7,
            pose + F * (22 + 8 * 24) + 6 * (22 + V * 24) + 8 * 25 + 8 * 25)


def drop_state(model, batch: int, seed: int):
    """The pile at rest at qpos0 (a 3 x 3 grid of objects per 0.1 m layer
    above the bin) with seeded per-object x/y offsets of up to 3 mm and
    orientations, every object of a scenario raised by one seeded height of
    up to 0.1 m, on the card."""
    from mujoco_rl_ur5_tpu_torch.scene.mjcf import JNT_FREE
    from mujoco_rl_ur5_tpu_torch.scene.model import make_state
    t = model.topo
    rng = np.random.default_rng(seed)
    q = np.tile(model.qpos0.cpu().numpy().astype(np.float64), (batch, 1))
    dz = rng.uniform(0.0, 0.1, batch)
    for j in np.nonzero(t.jnt_type == JNT_FREE)[0]:
        qa = t.jnt_qposadr[j]
        q[:, qa: qa + 2] += rng.uniform(-0.003, 0.003, (batch, 2))
        q[:, qa + 2] += dz
        quat = rng.normal(size=(batch, 4))
        q[:, qa + 3: qa + 7] = quat / np.linalg.norm(quat, axis=1,
                                                     keepdims=True)
    state = make_state(model, batch)
    return state.replace(qpos=torch.from_numpy(q.astype(np.float32)).cuda())


def pile_stats(model, state) -> dict:
    """Objects inside the bin's walls, the gap between the bin floor (z =
    0.86) and the lowest point of each in-bin object whose lowest point is
    within 5 mm of it, the largest speeds of the objects and of the arm
    (which no controller holds: it falls and swings): each object's linear
    speed (m/s) and angular speed (rad/s) apart, the largest of each and
    how many objects exceed 1 m/s and 10 rad/s."""
    from mujoco_rl_ur5_tpu_torch.ops.spatial import quat_rotate
    from mujoco_rl_ur5_tpu_torch.physics import collision
    from mujoco_rl_ur5_tpu_torch.physics.constraints import collision_poses
    from mujoco_rl_ur5_tpu_torch.physics.kinematics import fk
    t = model.topo
    cpos, cquat = collision_poses(model, fk(model, state.qpos))
    objs = [t.geom_id(f"object_{i}_geom") for i in range(40)]
    low = []
    for g in objs:
        if t.geom_meshid[g] >= 0:
            verts = quat_rotate(cquat[:, g, None], model.hull_verts[
                int(t.geom_meshid[g])]) + cpos[:, g, None]
        else:
            verts = collision._box_corners(cpos[:, g], cquat[:, g],
                                           model.col_size[g])
        low.append(verts[..., 2].amin(-1))
    low = torch.stack(low, 1)
    c = cpos[:, objs]
    inside = ((c[..., 0].abs() < 0.16) & ((c[..., 1] + 0.6).abs() < 0.16)
              & (c[..., 2] > 0.86) & (c[..., 2] < 1.0))
    on_floor = inside & ((low - 0.86).abs() < 5e-3)
    v = state.qvel[:, 8:].reshape(-1, 40, 6)
    lin, ang = v[..., :3].norm(dim=-1), v[..., 3:].norm(dim=-1)
    return {"in_bin": float(inside.float().mean()),
            "floor_gap_mean": float((low - 0.86)[on_floor].mean()),
            "on_floor": int(on_floor.sum()),
            "max_lin": float(lin.max()), "max_ang": float(ang.max()),
            "max_lin_in_bin": float((lin * inside).max()),
            "max_ang_in_bin": float((ang * inside).max()),
            "max_qvel_arm": float(state.qvel[:, :8].abs().max()),
            "lin_over_1": int((lin > 1.0).sum()),
            "ang_over_10": int((ang > 10.0).sum()),
            "finite": bool(torch.isfinite(state.qpos).all()
                           and torch.isfinite(state.qvel).all())}


def contact_step(log, dump_settle=None) -> dict:
    """Phases 7 and 8 (see the module docstring); returns the four collide
    kernels' rows of the kernel table. With ``dump_settle`` (a path), the
    settle roll also keeps a snapshot every 50 steps and writes, for the
    four scenarios with the fastest objects at its end by linear speed and
    the four by angular speed, their snapshots and their objects' largest
    linear and angular speed after every step (numpy .npz)."""
    import dataclasses

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mujoco_rl_ur5_tpu_torch import PILE
    from mujoco_rl_ur5_tpu_torch.physics import (
        collision, constraints, cuda_collide, dynamics,
    )
    from mujoco_rl_ur5_tpu_torch.physics.kinematics import fk
    from mujoco_rl_ur5_tpu_torch.scene.compile import load_model

    model = load_model(PILE)
    t = model.topo
    wrappers = {k: getattr(cuda_collide, f"{k}_batched") for k in COLLIDE}
    log(f"contact step: pile fixture nq={t.nq} nv={t.nv} ntree={t.ntree} "
        f"ncand={constraints.n_candidates(model)} B={B} ncon={NCON}")

    # 7a. settle roll from a seeded drop
    drop = drop_state(model, B, seed=5)
    drop_warm = constraints.init_warm(model, drop)
    state, warm = drop, drop_warm
    snaps, speeds = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(SETTLE):
        if dump_settle and i % 50 == 0:
            snaps.append((state.qpos.clone(), state.qvel.clone(),
                          warm[0].clone(), warm[1].clone()))
        state, warm = dynamics.step_warm(model, state, warm, NCON, 30)
        if dump_settle:
            v = state.qvel[:, 8:].reshape(B, 40, 6)
            speeds.append(torch.stack([v[..., :3].norm(dim=-1).amax(-1),
                                       v[..., 3:].norm(dim=-1).amax(-1)], -1))
    torch.cuda.synchronize()
    st = pile_stats(model, state)
    log(f"  settle: {SETTLE} steps (iterations=30) in "
        f"{time.perf_counter() - t0:.1f} s; objects in the bin "
        f"{st['in_bin']:.2%}; {st['on_floor']} on the bin floor, mean gap "
        f"{st['floor_gap_mean'] * 1e3:.3f} mm (margin 1 mm; 0 = touching); "
        f"objects' largest speed {st['max_lin']:.3f} m/s and "
        f"{st['max_ang']:.3f} rad/s (in the bin {st['max_lin_in_bin']:.3f}"
        f" m/s, {st['max_ang_in_bin']:.3f} rad/s), {st['lin_over_1']} over "
        f"1 m/s and {st['ang_over_10']} over 10 rad/s of {40 * B}; the "
        f"arm's largest |qvel| (no control, falling) "
        f"{st['max_qvel_arm']:.3f}")
    if not st["finite"]:
        raise AssertionError("the settle roll went non-finite")
    if dump_settle:
        speeds = torch.stack(speeds, 1)                  # (B, SETTLE, 2)
        top = torch.cat([torch.argsort(speeds[:, -1, k], descending=True)[:4]
                         for k in (0, 1)])
        np.savez(dump_settle, scenario=top.cpu().numpy(),
                 speed=speeds[top].cpu().numpy(),
                 snap_step=np.arange(0, SETTLE, 50),
                 **{f"{k}": torch.stack([sn[j][top] for sn in snaps], 1)
                    .cpu().numpy() for j, k in enumerate(
                        ("qpos", "qvel", "warm_f", "warm_s"))})
        log(f"  settle: wrote scenarios {top.tolist()} to {dump_settle}")
        del snaps, speeds

    # the step repeats to the bit: two 5-step rolls from the settled pile
    rolls = []
    for _ in range(2):
        s, w = state, warm
        for _ in range(5):
            s, w = dynamics.step_warm(model, s, w, NCON, 30)
        rolls.append((s.qpos, s.qvel, *w))
    same = all(torch.equal(a, b) for a, b in zip(*rolls))
    log(f"  determinism: two 5-step rolls of the settled pile end in the "
        f"same qpos, qvel and warm state to the bit: {same}")
    if not same:
        raise AssertionError("the contact step does not repeat to the bit")
    del rolls

    # 7b. the four kernels against their plain versions at the step's shapes
    log(f"  collide kernels vs plain at the settled pile's shapes (tolerance "
        f"{COLLIDE_TOL:g} per active slot, after a per-(pair, scenario) sort "
        f"by dist)")
    cpos, cquat = constraints.collision_poses(model, fk(model, state.qpos))
    hulls = constraints.hulls(model)
    rows = {}
    for t1, t2, g1, g2, _ in constraints.pair_groups(model, cpos):
        wrapper = cuda_collide.BATCHED.get((t1, t2))
        if wrapper is None:             # plane-box: plain torch, no kernel
            continue
        name = wrapper.__name__[: -len("_batched")]
        args = (cpos, cquat, model.col_size, hulls, g1, g2)
        got = wrapper(*args)
        wrapper.plain(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = wrapper.plain(*args)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        order_g = torch.argsort(got[2], dim=-1, stable=True)
        order_w = torch.argsort(want[2], dim=-1, stable=True)
        gd, wd = got[2].gather(-1, order_g), want[2].gather(-1, order_w)
        gp, gn, wp, wn = (x.gather(-2, o[..., None].expand(x.shape))
                          for x, o in ((got[0], order_g), (got[1], order_g),
                                       (want[0], order_w),
                                       (want[1], order_w)))
        act = wd < 1.0
        err = torch.stack([(gd - wd).abs(), (gp - wp).abs().amax(-1),
                           (gn - wn).abs().amax(-1)], -1).amax(-1)
        bad_slot = (act & (err > COLLIDE_TOL)) | (~act & (gd < 1.0))
        live = act.any(-1)
        bad = int(bad_slot.any(-1).sum())
        max_err = float(err[act].max()) if bool(act.any()) else 0.0
        ms = event_ms(lambda: wrapper(*args), 20)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                wrapper(*args)
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and f"{name}_kernel" in e.key]
        # per recorded launch: the profiler may drop events of a short run
        dev_ms = (sum(e.self_device_time_total for e in ev)
                  / max(sum(e.count for e in ev), 1) / 1e3)
        n = g1.shape[1]
        V, F = model.hull_verts.shape[1], model.hull_fnorm.shape[1]
        need, executed = collide_flops(name, V, F)
        ops = B * n * need
        nbyte = nbytes(cpos, cquat, g1.int(), g2.int(), *got)
        t_bytes = nbyte / PEAK_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_F32_FLOP_PER_S * 1e3
        rows[name] = {
            "name": name, "route": "cuda",
            "source": f"mujoco_rl_ur5_tpu_torch/csrc/collide_{name}.cu",
            "replaces": "mujoco_rl_ur5_tpu/physics/pallas_collide.py:" + {
                "box_box": "675", "hull_hull": "689", "box_hull": "703",
                "plane_hull": "715"}[name],
            "launches": None, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "device_ms": dev_ms}
        log(f"  {name}: {n} pairs x {B}, {int(live.sum())} (pair, scenario) "
            f"entries with an active slot, {bad} outside the tolerance; max "
            f"|kernel - plain| {max_err:.3e}; {ms:.3f} ms (device "
            f"{dev_ms:.3f} ms), plain {plain_ms:.2f} ms, bound "
            f"{max(t_bytes, t_ops):.4f} ms ({ops:.3e} ops needed, "
            f"{nbyte:.3e} bytes; the kernel executes "
            f"{B * n * executed:.3e} ops)")
        if bad > 1e-4 * max(int(live.sum()), 1):
            raise AssertionError(f"{name}: {bad} entries outside the "
                                 f"tolerance")

    # 7c. the step at full width, through the kernels. Every call starts
    # from the seeded drop, as bench.py's bench_dynamics times its roll
    # from the scene's rest state (the work per step does not depend on
    # the state: fixed shapes, fixed iterations). Not from the settled
    # pile: there, a 100-iteration solve can diverge in a rare scenario,
    # in the JAX package's step as in the port's (ROADMAP.md Queue 3)
    def call(iters):
        for wr in wrappers.values():
            wr.launches = 0
        s, w = drop, drop_warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STEPS):
            s, w = dynamics.step_warm(model, s, w, NCON, iters)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = {k: wr.launches for k, wr in wrappers.items()}
        if set(n.values()) != {STEPS}:
            raise AssertionError(f"launches {n} over {STEPS} steps")
        if not bool(torch.isfinite(s.qpos).all()
                    and torch.isfinite(s.qvel).all()):
            raise AssertionError("the contact step went non-finite")
        return wall, n, s

    for iters in (100, 30):
        walls, ends = [], []
        for _ in range(3):
            wall, n, s = call(iters)
            walls.append(wall)
            ends.append(s)
        if iters == 100:
            for k in COLLIDE:
                rows[k]["launches"] = n[k]
        med = statistics.median(walls)
        same = all(torch.equal(e.qpos, ends[0].qpos)
                   and torch.equal(e.qvel, ends[0].qvel) for e in ends)
        log(f"  step iterations={iters}: {STEPS} steps of {B} per call, "
            f"median of 3 calls {med:.3f} s ({med / STEPS * 1e3:.1f} ms per "
            f"step), {B * STEPS / med:.0f} scenario-steps/s; launches per "
            f"call {n}; the three calls end in the same state to the bit: "
            f"{same}")
        if not same:
            raise AssertionError("the three calls end in different states")
        del ends

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        dynamics.step_warm(model, state, warm, NCON, 100)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    busy = sum(e.self_device_time_total for e in ev) / 1e3
    log(f"  one step (iterations=100) under torch.profiler: wall "
        f"{wall_ms:.1f} ms, device busy {busy:.1f} ms ({busy / wall_ms:.1%}),"
        f" {sum(e.count for e in ev)} kernel launches")
    ev.sort(key=lambda e: -e.self_device_time_total)
    for e in ev[:12] + [e for e in ev[12:] if "collide" in e.key
                        or any(f"{k}_kernel" in e.key for k in COLLIDE)]:
        log(f"    {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x  "
            f"{e.key[:90]}")

    # 8. the whole step through the kernels against the plain path (CPU),
    # B=64, iterations=30, from the settled pile. The narrowphase agrees to
    # the bit; FK, the solver's sums and the plain plane-box group round
    # otherwise on the two devices, and thirty FISTA iterations leave the
    # solve unconverged, so its op order shows. The settled pile is chaotic
    # where contacts start and end: a candidate at the activity threshold
    # can enter one path's contact set only. Both paths repeat to the bit,
    # so every reading below is the same on every run of this script.
    # Each limit lies between the sound readings (the card against the
    # CPU, and the CPU against itself with every velocity one float32 ulp
    # off) and the faulty ones: two planted faults (hull tables 1% too
    # large; the box-hull group's contacts dropped) and a control in lower
    # precision (TF32 matrix products on the card). Readings (H100 80GB HBM3),
    # sound / smallest faulty: qacc 2.9e-5 / 2.0e-2 (TF32), forces 5.1e-6 /
    # 1.8e-4 (TF32), active contacts 0 / 0.29, median |dqpos| 2.2e-8 /
    # 9.4e-6 (TF32), mean height 3.5e-6 / 3.8e-4 m (hull tables; TF32
    # 8.3e-6, too close to tell), 25-step active contacts 3.8e-3 / 0.70
    # (the dropped group; the other two stay inside the sound band). Every
    # fault and the control must exceed at least one limit
    Bc, it_c = 64, 30
    cpu_model = load_model(PILE, device="cpu")
    ncand = constraints.n_candidates(model)
    obj_z = [t.jnt_qposadr[t.joint_id(f"free_joint_{i}")] + 2
             for i in range(40)]
    sg = state.replace(qpos=state.qpos[:Bc].clone(),
                       qvel=state.qvel[:Bc].clone(), ctrl=state.ctrl[:Bc],
                       time=state.time[:Bc])
    wg = (warm[0][:Bc].clone(), warm[1][:Bc].clone())
    sc = sg.replace(qpos=sg.qpos.cpu(), qvel=sg.qvel.cpu(), ctrl=sg.ctrl.cpu(),
                    time=sg.time.cpu())
    wc = (wg[0].cpu(), wg[1].cpu())
    sign = torch.ones_like(sc.qvel)
    sign.view(-1)[1::2] = -1.0
    su = sc.replace(qvel=torch.nextafter(sc.qvel, sc.qvel + sign))
    log(f"whole contact step: B={Bc} iterations={it_c}, kernels vs plain "
        f"(CPU)")

    def active_set(con):                 # (Bc, ncand) bool
        return torch.zeros(Bc, ncand, dtype=torch.bool).scatter(
            1, con.sel.cpu(), con.active.cpu())

    def roll(m, s, w):
        for _ in range(STEPS):
            s, w = dynamics.step_warm(m, s, w, NCON, it_c)
        return s

    qa_c, _, con_c, wn_c = dynamics.forward_warm(cpu_model, sc, wc, NCON,
                                                 it_c)
    t0 = time.perf_counter()
    end_c = roll(cpu_model, sc, wc)
    na_end_c = int(dynamics.forward(cpu_model, end_c, NCON, it_c)[2]
                   .active.sum())
    log(f"  plain 25-step roll on the CPU: {time.perf_counter() - t0:.1f} s")

    def readings(m, s, w):
        """One step and 25 steps of (m, s, w) against the CPU's plain
        path from the settled pile."""
        qa, _, con, wn = dynamics.forward_warm(m, s, w, NCON, it_c)
        end = roll(m, s, w)
        na, na_c = int(con.active.sum()), int(con_c.active.sum())
        na_end = int(dynamics.forward(m, end, NCON, it_c)[2].active.sum())
        dq = (end.qpos.cpu() - end_c.qpos).abs()
        return {
            "sets": float((active_set(con) != active_set(con_c)).any(-1)
                          .float().mean()),
            "qacc": float((qa.cpu() - qa_c).abs().max() / qa_c.abs().max()),
            "forces": float((wn[0].cpu() - wn_c[0]).abs().max()
                            / wn_c[0].abs().max().clamp_min(1e-12)),
            "active": abs(na - na_c) / max(na_c, 1),
            "median": float(dq.median()),
            "height": float((end.qpos[:, obj_z].cpu()
                             - end_c.qpos[:, obj_z]).mean().abs()),
            "active25": abs(na_end - na_end_c) / max(na_end_c, 1),
            "q99": float(torch.quantile(dq.flatten().double(), 0.99)),
        }

    box_mesh = (collision.GEOM_BOX, collision.GEOM_MESH)
    box_hull = cuda_collide.BATCHED[box_mesh]

    def dropped(*args):
        p, n, d = box_hull(*args)
        return p, n, torch.full_like(d, 1e10)

    large = dataclasses.replace(model, hull_verts=model.hull_verts * 1.01,
                                hull_fdist=model.hull_fdist * 1.01)
    read = {"kernels vs plain": readings(model, sg, wg),
            "plain vs plain, one ulp": readings(cpu_model, su, wc),
            "fault: hull tables 1% large": readings(large, sg, wg)}
    cuda_collide.BATCHED[box_mesh] = dropped
    try:
        read["fault: box-hull group dropped"] = readings(model, sg, wg)
    finally:
        cuda_collide.BATCHED[box_mesh] = box_hull
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        read["control: TF32 products"] = readings(model, sg, wg)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    limits = {"qacc": 1e-3, "forces": 3e-5, "active": 5e-3,
              "median": 5e-7, "height": 3e-5, "active25": 5e-2}
    what = {"sets": "share of scenarios whose active contacts differ",
            "qacc": "one step: max |dqacc| / max |qacc|",
            "forces": "one step: max |dforce| / max |force| (candidates)",
            "active": "one step: active contacts, relative difference",
            "median": "25 steps: median |dqpos|",
            "height": "25 steps: |mean object height difference| (m)",
            "active25": "25 steps: active contacts, relative difference",
            "q99": "25 steps: 99th percentile |dqpos|"}
    for key, text in what.items():
        lim = f" (limit {limits[key]:.1e})" if key in limits else ""
        log(f"  {text}{lim}: " + "; ".join(
            f"{run} {r[key]:.3e}" for run, r in read.items()))
    for run in ("kernels vs plain", "plain vs plain, one ulp"):
        for key, lim in limits.items():
            check(f"{run}", read[run][key], lim, what[key])
    for run, r in read.items():
        caught = [k for k, lim in limits.items() if not r[k] <= lim]
        log(f"  {run}: over the limits in {caught or 'none'}")
        if run.startswith(("fault", "control")) and not caught:
            raise AssertionError(f"{run}: no check sees it")
    return rows


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dump-settle", metavar="PATH", help="also write the "
                    "settle roll's four fastest scenarios (snapshots every 50 "
                    "steps, object speeds per step) to PATH (.npz)")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs the port on an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mujoco_rl_ur5_tpu_torch import ASSET, _build
    from mujoco_rl_ur5_tpu_torch.mpc import cuda_lqr
    from mujoco_rl_ur5_tpu_torch.mpc.cuda_ilqr import (
        ALPHAS, REG, ilqr_chain_batch,
    )
    from mujoco_rl_ur5_tpu_torch.mpc.grasp_mpc import (
        EE_OFFSET, GraspMPC, MPCWeights,
    )
    from mujoco_rl_ur5_tpu_torch.physics import cuda_chain as cc

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} | torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    dev = torch.device("cuda")

    # 2. build
    mpc = GraspMPC.from_scene(ASSET, horizon=H, substeps=SUBSTEPS,
                              iters=ITERS, device="cuda")
    from mujoco_rl_ur5_tpu_torch.physics import cuda_collide
    srcs = mpc.kernel_sources() + cuda_collide.kernel_sources()
    t0 = time.perf_counter()
    _build.build_many(srcs)
    log(f"build: {len(srcs)} units in {time.perf_counter() - t0:.1f} s")
    variants = {2: " (track costs)", 3: " (reach costs)"}
    for i, src in enumerate(srcs):
        for line in _build.ptxas_report(src):
            log(f"  ptxas {src.name}{variants.get(i, '')}: {line}")

    plan, nx, nu, nq, w = mpc.plan, mpc.nx, mpc.nu, mpc.nq, mpc.w
    x0_np, q_refs_np = tracking_problem(B, H, seed=0)
    x0 = torch.from_numpy(x0_np).to(dev)
    q_refs = torch.from_numpy(q_refs_np).to(dev)
    qd_refs = torch.zeros_like(q_refs)
    refs = (q_refs[:, :-1], qd_refs[:, :-1])
    term_ref = (q_refs[:, -1], qd_refs[:, -1])
    sref = torch.cat(refs, -1).contiguous()
    tref = torch.cat(term_ref, -1).contiguous()
    u_hold = mpc._hold_init(x0)
    xr_np, tg_np = reach_problem(B, seed=2)
    xr0 = torch.from_numpy(xr_np).to(dev)
    targets = torch.from_numpy(tg_np).to(dev)
    ur_hold = mpc._hold_init(xr0)
    reach_cost, reach_quad, reach_term_quad, reach_kc = \
        mpc._reach_closures(targets)
    sub_ops = cc.substep_header(plan).ops["substep"]
    track_ops = cc.cost_header(mpc._k_track, plan.nv, nu, nx, nx).ops
    reach_ops = cc.cost_header(mpc._k_reach, plan.nv, nu, 0, 3).ops
    quad_cfg = (mpc.ee_slot, EE_OFFSET, w.w_ee_run, w.w_orient, w.w_posture,
                mpc.home)
    quad_ops = cc.ee_quad_header(plan, *cc._quad_cfg(*quad_cfg)).ops["quad"]
    A = len(ALPHAS)
    table = {}

    def record(name, source, replaces, err, ms, plain_ms, ops, nbyte):
        t_bytes = nbyte / PEAK_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_F32_FLOP_PER_S * 1e3
        table[name] = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": None, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}
        log(f"  {name}: {ms:.3f} ms on the card, plain {plain_ms:.1f} ms, "
            f"bound {max(t_bytes, t_ops):.4f} ms "
            f"({ops:.3e} ops, {nbyte:.3e} bytes)")

    # 3. kernels against their plain versions, at the main paths' shapes.
    # The card contracts multiply-adds and has its own sinf/cosf, so a kernel
    # and its plain f32 version differ by their roundoff; lin_fd divides it
    # by eps=1e-3 and the line search feeds it back through gains of ~60.
    # The check, for each output on its own: against the plain version run in
    # float64 on the same inputs, the kernel's error is at most twice the
    # plain f32 version's (plus 1e-6 of the output's scale)
    log(f"kernels: B={B} H={H} substeps={SUBSTEPS}")

    def compare(name, outs, kern, plain_fn, args64):
        """Hold every output (named in ``outs``) of a kernel by that rule,
        each at its own plain-f32 error; returns (largest direct difference
        over the outputs, the plain version's ms)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = plain_fn()
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        ref = plain_fn(*args64)
        errs = [(float((k.double() - r).abs().max() / r.abs().max()),
                 float((p.double() - r).abs().max() / r.abs().max()),
                 float((k - p).abs().max()))
                for k, p, r in zip(kern, plain, ref)]
        for out, (ek, ep, diff) in zip(outs, errs):
            log(f"  {name} {out}: max |kernel - plain| {diff:.3e}; error vs "
                f"float64 (max |d|/max|ref|): kernel {ek:.3e}, plain {ep:.3e}")
        for out, (ek, ep, _) in zip(outs, errs):
            check(f"{name} {out}", ek, 2 * ep + 1e-6,
                  "kernel error vs float64")
        return max(e[2] for e in errs), plain_ms

    def f64(*ts):
        return [t.double() if torch.is_tensor(t) else t for t in ts]

    xs = cc.rollout_open(plan, SUBSTEPS, x0, u_hold)
    diff, plain_ms = compare(
        "rollout_open", ("xs",), (xs,),
        lambda *a: (cc.rollout_open_plain(plan, SUBSTEPS,
                                          *(a or (x0, u_hold))),),
        f64(x0, u_hold))
    record("rollout_open", "mujoco_rl_ur5_tpu_torch/csrc/chain_rollout_open.cu",
           "mujoco_rl_ur5_tpu/physics/pallas_chain.py:530", diff,
           event_ms(lambda: cc.rollout_open(plan, SUBSTEPS, x0, u_hold), 10),
           plain_ms, B * H * SUBSTEPS * sub_ops, nbytes(x0, u_hold, xs))

    xk, uk = xs[:, :-1].contiguous(), u_hold
    lin = cc.lin_fd(plan, 1, xk, uk)
    diff, plain_ms = compare(
        "lin_fd", ("F", "L"), lin, lambda *a: cc.lin_fd_plain(plan, 1, *(a or (xk, uk))),
        f64(xk, uk))
    record("lin_fd", "mujoco_rl_ur5_tpu_torch/csrc/chain_lin_fd.cu",
           "mujoco_rl_ur5_tpu/physics/pallas_chain.py:759", diff,
           event_ms(lambda: cc.lin_fd(plan, 1, xk, uk), 10), plain_ms,
           B * H * ((nx + nu + 1) * sub_ops + (nx + nu) * nx * 2),
           nbytes(xk, uk, *lin))
    del lin

    F, L = cc.lin_fd_fast(plan, SUBSTEPS, xk, uk)
    X, q, U, r = mpc._track_quad(xk, uk, refs)
    XH, qH = mpc._track_term_quad(xs[:, -1], term_ref)
    reg = torch.full((B,), REG, device=dev)
    bargs = (F, L, X, q, U, r, XH, qH, reg)
    g = cuda_lqr.backward(*bargs)
    diff, plain_ms = compare(
        "backward", ("K", "d", "S", "s"), g,
        lambda *a: cuda_lqr.backward_plain(*(a or bargs)),
        f64(*bargs))
    record("backward", "mujoco_rl_ur5_tpu_torch/csrc/lqr_backward.cu",
           "mujoco_rl_ur5_tpu/mpc/pallas_lqr.py:90", diff,
           event_ms(lambda: cuda_lqr.backward(*bargs), 10), plain_ms,
           B * H * backward_flops(nx, nu),
           nbytes(F, L, q, r, XH, qH, reg, *g)
           + B * H * (nx * nx + nu * nu) * 4)      # X and U at full size

    law_ops = nu * (2 + 3 * nx) + 2 * nu

    def closed(name, cost, total, cost_ops, x_0, xbar, ubar, gains, s_ref,
               t_ref):
        """Hold rollout_closed with one fused cost pair against its plain
        version, and its fused costs against ``total``, the plain cost in
        float64 of the candidates the kernel itself returned (which takes the
        rollout's sensitivity out of the cost's check: 2e-5 relative, f32
        roundoff over H+1 terms); returns (difference, kernel ms, plain ms,
        ops, bytes)."""
        ckw = dict(cost=cost, sref=s_ref, tref=t_ref)
        ckw64 = dict(cost=cost, sref=None if s_ref is None else s_ref.double(),
                     tref=t_ref.double())
        cargs = (x_0, xbar, ubar, gains.K, gains.d)
        out = cc.rollout_closed(plan, SUBSTEPS, *cargs, ALPHAS, **ckw)
        diff, plain_ms = compare(
            name, ("xs", "us", "costs"), out,
            lambda *a: (cc.rollout_closed_plain(plan, SUBSTEPS, *a, ALPHAS,
                                                **ckw64) if a else
                        cc.rollout_closed_plain(plan, SUBSTEPS, *cargs, ALPHAS,
                                                **ckw)),
            f64(*cargs))
        want = torch.stack([total(out[0][:, a].double(), out[1][:, a].double())
                            for a in range(A)], 1)
        check(f"{name} costs", float(((out[2] - want) / want).abs().max()),
              2e-5, "max relative error vs the plain cost of its own xs, us")
        ms = event_ms(lambda: cc.rollout_closed(plan, SUBSTEPS, *cargs, ALPHAS,
                                                **ckw), 5)
        ops = A * B * (H * (SUBSTEPS * sub_ops + law_ops + cost_ops["stage"])
                       + cost_ops["term"])
        ins = [t for t in (x_0, xbar[:, :H], ubar, gains.K, gains.d, s_ref,
                           t_ref) if t is not None]
        return diff, ms, plain_ms, ops, nbytes(*ins, *out)

    diff, ms, plain_ms, ops, nbyte = closed(
        "rollout_closed (track costs)", mpc._k_track,
        lambda xa, ua: (mpc._track_stage(xa[:, :-1], ua, refs).sum(-1)
                        + mpc._track_term(xa[:, -1], term_ref)),
        track_ops, x0, xs, u_hold, g, sref, tref)
    log(f"  rollout_closed (track costs): {ms:.3f} ms on the card, plain "
        f"{plain_ms:.1f} ms, bound "
        f"{max(ops / PEAK_F32_FLOP_PER_S, nbyte / PEAK_BYTES_PER_S) * 1e3:.4f}"
        f" ms ({ops:.3e} ops, {nbyte:.3e} bytes)")
    del g, F, L, X, U, xk, xs

    # the reach path's two: ee_quad_gn, and rollout_closed with the reach
    # costs (an FK inside every stage cost)
    xs = cc.rollout_open(plan, SUBSTEPS, xr0, ur_hold)
    xk, uk = xs[:, :-1].contiguous(), ur_hold
    Xq, gq = cc.ee_quad_gn(plan, *quad_cfg, xk, targets)
    diff, plain_ms = compare(
        "ee_quad_gn", ("Xq", "gq"), (Xq, gq),
        lambda *a: cc.ee_quad_gn_plain(plan, *quad_cfg, *(a or (xk, targets))),
        f64(xk, targets))
    record("ee_quad_gn", "mujoco_rl_ur5_tpu_torch/csrc/chain_ee_quad_gn.cu",
           "mujoco_rl_ur5_tpu/physics/pallas_chain.py:885", diff,
           event_ms(lambda: cc.ee_quad_gn(plan, *quad_cfg, xk, targets), 10),
           plain_ms, B * H * quad_ops,
           nbytes(xk[..., :nq], targets, Xq, gq))     # it reads the q half only
    quad_ms = event_ms(lambda: reach_quad(xk, uk), 10)
    log(f"  ee_quad_gn with the assembly of X (B,H,{nx},{nx}), g, U, r around "
        f"it (_reach_quad_batch_kernel): {quad_ms:.3f} ms, of which the "
        f"assembly {quad_ms - table['ee_quad_gn']['ms']:.3f} ms")
    del Xq, gq

    F, L = cc.lin_fd_fast(plan, SUBSTEPS, xk, uk)
    X, q, U, r = reach_quad(xk, uk)
    XH, qH = reach_term_quad(xs[:, -1])
    g = cuda_lqr.backward(F, L, X, q, U, r, XH, qH, reg)
    del F, L, X, U
    diff, ms, plain_ms, ops, nbyte = closed(
        "rollout_closed (reach costs)", mpc._k_reach, reach_cost, reach_ops,
        xr0, xs, ur_hold, g, None, targets)
    record("rollout_closed",
           "mujoco_rl_ur5_tpu_torch/csrc/chain_rollout_closed.cu",
           "mujoco_rl_ur5_tpu/physics/pallas_chain.py:579", diff, ms,
           plain_ms, ops, nbyte)
    del g, xk, xs

    # 4. the main paths at full width
    names = ("rollout_open", "lin_fd", "rollout_closed", "backward",
             "ee_quad_gn")
    counters = (cc.rollout_open, cc.lin_fd, cc.rollout_closed,
                cuda_lqr.backward, cc.ee_quad_gn)

    def counted(what, solve, expected):
        """Run ``solve`` with the launch counts set to 0 just before and
        read just after; they must equal ``expected`` and the outputs must
        be finite. Returns (result, wall seconds, counts)."""
        torch.cuda.synchronize()
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        res = solve()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = tuple(c.launches for c in counters)
        log(f"  {what} launches {'/'.join(names)} = {n}")
        if n != expected:
            raise AssertionError(f"{what} launched {n}, expected {expected}")
        for t in (res.xs, res.us, res.cost, *res.gains):
            if not bool(torch.isfinite(t).all()):
                raise AssertionError(f"{what} returned non-finite values")
        return res, wall, n

    def fell(what, cost, c0):
        share = float((cost < c0).float().mean())
        log(f"  {what} cost: start median {float(c0.median()):.3f} -> solved "
            f"median {float(cost.median()):.3f}; fell in {share:.1%} of "
            f"scenarios, rose in {int((cost > c0).sum())}")
        if not bool((cost <= c0).all()) or share < 0.99:
            raise AssertionError(f"{what} did not lower the cost")

    def rates(what, solve, first_s=None):
        ms = timed_ms(solve)
        first = ("" if first_s is None
                 else f" (first call {first_s * 1e3:.1f} ms)")
        log(f"  {what}: {ms:.1f} ms per call of {B}{first}, "
            f"{B / ms * 1e3:.1f} solves/s")

    cold = (1, ITERS + 1, ITERS, ITERS + 1)
    log(f"main path (reach): solve_batch_x B={B} H={H} substeps={SUBSTEPS} "
        f"iters={ITERS}")
    res, cold_s, n = counted("cold reach solve",
                             lambda: mpc.solve_batch_x(xr0, targets),
                             cold + (ITERS + 1,))
    for name, c in zip(names, n):
        table[name]["launches"] = c
    xs_hold = cc.rollout_open(plan, SUBSTEPS, xr0, ur_hold)
    fell("reach", res.cost, reach_cost(xs_hold, ur_hold))

    def ee_err(x):
        return float((mpc.ee_pos(x[:, -1, :nq]) - targets).norm(dim=-1)
                     .median())

    log(f"  end-effector error at the last knot, median: gravity hold "
        f"{ee_err(xs_hold):.4f} m -> solved {ee_err(res.xs):.4f} m")
    del xs_hold
    rates("cold reach solve", lambda: mpc.solve_batch_x(xr0, targets), cold_s)
    profile_solve(lambda: mpc.solve_batch_x(xr0, targets))

    def warm_reach(u):
        return ilqr_chain_batch(plan, SUBSTEPS, reach_cost, reach_quad,
                                reach_term_quad, xr0, u, reach_kc, iters=2)

    u_warm = torch.cat([res.us[:, 1:], res.us[:, -1:]], 1).contiguous()
    wres, _, _ = counted("warm 2-iteration reach re-solve",
                         lambda: warm_reach(u_warm), (1, 3, 2, 3, 3))
    rates("warm reach re-solve", lambda: warm_reach(u_warm))
    log(f"  warm reach re-solve cost median {float(wres.cost.median()):.3f} "
        f"vs cold {float(res.cost.median()):.3f}")
    del res, wres

    log(f"main path (track): track_batch B={B} H={H} substeps={SUBSTEPS} "
        f"iters={ITERS}")
    res, cold_s, _ = counted("cold track solve",
                             lambda: mpc.track_batch(x0, q_refs), cold + (0,))
    xs_hold = cc.rollout_open(plan, SUBSTEPS, x0, u_hold)
    fell("track", res.cost,
         mpc._track_stage(xs_hold[:, :-1], u_hold, refs).sum(-1)
         + mpc._track_term(xs_hold[:, -1], term_ref))
    del xs_hold
    rates("cold track solve", lambda: mpc.track_batch(x0, q_refs), cold_s)
    profile_solve(lambda: mpc.track_batch(x0, q_refs))

    warm_mpc = GraspMPC.from_scene(ASSET, horizon=H, substeps=SUBSTEPS,
                                   iters=2, device="cuda")
    u_warm = torch.cat([res.us[:, 1:], res.us[:, -1:]], 1).contiguous()
    wres, _, _ = counted(
        "warm 2-iteration track re-solve",
        lambda: warm_mpc.track_batch(x0, q_refs, u_init=u_warm),
        (1, 3, 2, 3, 0))
    rates("warm track re-solve",
          lambda: warm_mpc.track_batch(x0, q_refs, u_init=u_warm))
    log(f"  warm track re-solve cost median {float(wres.cost.median()):.3f} "
        f"vs cold {float(res.cost.median()):.3f}")
    del res, wres

    # 5. the whole paths through the kernels against the plain versions.
    # Both solvers linearize by forward differences in f32 (see lin_fd). At
    # the default w_ctrl=1e-3 and a 128 ms horizon the solved controls are
    # barely determined (a 3e-7 rad change of x0 moves the track cost by
    # 2e-3 on the CPU); at w_ctrl=1 the same change moves the cost by
    # 1.6e-4 and the controls by 1e-2. Tolerances: cost 1e-3 relative,
    # controls 5e-2 absolute
    Bs, Hs, iters_s = 256, 8, 2
    small = dict(horizon=Hs, substeps=SUBSTEPS, iters=iters_s,
                 weights=MPCWeights(w_ctrl=1.0))
    on_card = GraspMPC.from_scene(ASSET, device="cuda", **small)
    on_cpu = GraspMPC.from_scene(ASSET, device="cpu", **small)
    xs0, qs = tracking_problem(Bs, Hs, seed=1, reach=0.02)
    xr, tg = reach_problem(Bs, seed=3)
    for what, args in (("solve_batch_x", (xr, tg)), ("track_batch", (xs0, qs))):
        log(f"whole path: {what} B={Bs} H={Hs} substeps={SUBSTEPS} "
            f"iters={iters_s} w_ctrl=1, kernels vs plain (CPU)")
        rk = getattr(on_card, what)(*(torch.from_numpy(a).to(dev)
                                      for a in args))
        rp = getattr(on_cpu, what)(*(torch.from_numpy(a) for a in args))
        err = float(((rk.cost.cpu() - rp.cost).abs() / rp.cost.abs()).max())
        check(what, err, 1e-3, "max |dcost|/cost")
        err = float((rk.us.cpu() - rp.us).abs().max())
        check(what, err, 5e-2, "max |du|")

    # 6. the per-instance solves (generic optimizer, autodiff Jacobians, no
    # kernel: thousands of small launches per knot, bound by launch latency)
    Hi = 16
    log(f"per-instance: solve and track H={Hi} substeps={SUBSTEPS} iters=2")
    one = GraspMPC.from_scene(ASSET, horizon=Hi, substeps=SUBSTEPS, iters=2,
                              device="cuda")
    xi, ti = xr0[0], targets[0]
    ui = one._hold_init(xi)
    xs_hold = cc.rollout_open(plan, SUBSTEPS, xi[None], ui[None])
    qi = torch.from_numpy(tracking_problem(1, Hi, seed=4)[1][0]).to(dev)
    qi = qi - qi[0] + xi[:nq]                 # the line starts at this state
    starts = {
        "solve": one._reach_closures(ti[None])[0](xs_hold, ui[None])[0],
        "track": (one._track_stage(xs_hold[0, :-1], ui,
                                   (qi[:-1], torch.zeros_like(qi[:-1])))
                  .sum(-1) + one._track_term(
                      xs_hold[0, -1], (qi[-1], torch.zeros_like(qi[-1]))))}
    for what, args in (("solve", (xi, ti)), ("track", (xi, qi))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ri = getattr(one, what)(*args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for t in (ri.xs, ri.us, ri.cost, *ri.gains):
            if not bool(torch.isfinite(t).all()):
                raise AssertionError(f"{what} returned non-finite values")
        log(f"  {what}: {wall * 1e3:.0f} ms; cost {float(starts[what]):.3f} "
            f"-> {float(ri.cost):.3f}")
        if ri.xs.shape != (Hi + 1, nx) or ri.us.shape != (Hi, nu):
            raise AssertionError(f"{what} returned the wrong shapes")
        if not float(ri.cost) < float(starts[what]):
            raise AssertionError(f"{what} did not lower the cost")

    # 7-8. the contact step
    table.update(contact_step(log, opts.dump_settle))

    print(json.dumps({"kernels": [table[name] for name in names + COLLIDE]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
