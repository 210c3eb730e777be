#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py          (from the repository root; needs one GPU)

Phases, each printing its lines; any failure raises and exits non-zero:

  1. device: the card's name and power limit (nvidia-smi);
  2. build: the fourteen build units from csrc/, seven of the batched
     solves (five kernels; rollout_closed with the track costs, with the
     reach costs and without costs), the six collide kernels and the ray
     cast, one nvcc
     per source, in parallel, with the build time and ptxas's register,
     stack and spill report (lqr_backward and the six team collide
     kernels, box_box, hull_hull, box_hull, plane_hull, sphere_hull and
     capsule_hull, must spill nothing, the six collide kernels use no
     stack), and the resident blocks per SM, threads and shared memory per
     block of the twelve redesigned kernels (lqr_backward, rollout_closed,
     lin_fd, rollout_open, ee_quad_gn, the six team collide kernels and
     the ray cast; the hull kernels and the ray cast at the object pile's
     table sizes);
  3. kernels: each kernel's wrapper at the shapes the main paths give it
     (B=4096, H=64, substeps=8), held against its plain PyTorch version on
     the same inputs on the card, output by output, with the tolerance
     stated; each timed with CUDA events beside the plain version and its
     bound (rollout_open and rollout_closed at B=4096: the plain version
     run once, in float64, which is both the reference and the plain
     time, the kernel held to twice the plain f32 version's error measured
     on these seeded inputs); rollout_closed without fused costs (the
     line search of a solve whose costs are not fused) is held against
     the same plain run as rollout_closed with the track costs. lin_fd is
     held as the solver calls it (lin_fd_fast: one launch
     that differences one substep and composes the knot's Jacobians, from
     the solver's strided view of its states), must launch nothing but its
     kernel, and is timed beside the kernel without its composition and
     the composition in torch after it; the full-knot differences (lin_fd)
     are held over one substep and, at B=509, over eight. rollout_closed is
     held with both fused costs, and its costs also against the plain cost
     of the candidates it returned. ee_quad_gn writes the full stage
     blocks X (B, H, 16, 16) and g (B, H, 16) from the solver's strided
     view of its states: held whole, with exact zeros off the blocks and
     w_vel on the velocity diagonal, it must launch nothing but its kernel,
     and the reach quadratization around it (_reach_quad_batch_kernel) is
     timed beside it. rollout_open (a team of 8 lanes
     per scenario) is held at B=4096 and B=509, twice to the bit and timed
     on the device, beside the latency floors of the one-thread substep
     and (a hand-counted estimate) the team's. The redesigned kernels are
     also held at a ragged batch (B=509; H=8 for rollout_open and
     rollout_closed, whose plain versions are launch-bound; ee_quad_gn at
     B=509 over all knots), called twice on the same inputs (equal to
     the bit), timed on the device under torch.profiler and printed beside
     their earlier times;
  4. main paths at B=4096, H=64, substeps=8, iters=6, each with every launch
     counter set to 0 just before and read just after:
     reach, GraspMPC.solve_batch_x on seeded world targets (rollout_open 1,
     lin_fd 7, rollout_closed 6, backward 7, ee_quad_gn 7 per cold solve):
     outputs finite, the cost rises in no scenario and falls in >= 99%, the
     end-effector error before and after; the solve's wall time and its
     device time by kernel under torch.profiler, where the solver's
     lin_fd_fast calls must run no torch matrix product and launch no
     cuBLAS gemm; a warm 2-iteration re-solve from the shifted plan
     (1 / 3 / 2 / 3 / 3);
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
     plain versions and bounds, with three planted faults which the
     comparison must flag
     (box_box with the box sizes 0.1% small, box_hull with the rows of the
     most faces, every prism, one face short, plane_hull with every row one
     vertex short);
     the step at iterations=100 and 30 (25
     steps per call from the seeded drop, as bench.py's bench_dynamics
     times them, median of 3 calls, which must end in the same state),
     every launch counter set to 0 before a call and read after (one
     launch of each collide kernel per step); one step of the settled pile
     under torch.profiler;
  8. the whole contact step through the kernels against the plain path on
     the CPU at B=64, iterations=30: one step's qacc, active contacts and
     forces, and 25 steps' qpos by statistics, with limits read between
     the sound runs (and two plain rolls one ulp apart) and two planted
     faults and a TF32 control, each of which must be caught;
  9. the object pile (assets/ur5_2finger_objects.xml: spheres, boxes,
     cylinders, capsules, mesh finger pads) at B=4096, ncon=128: a 300-step
     settle (iterations=30) from a seeded drop with the share of objects in
     the bin by family, the rest gap and the largest speeds; two 5-step
     rolls that must agree to the bit; all six collide kernels against
     their plain versions at the settled pile's shapes, timed beside their
     plain versions and bounds, with three planted faults which the
     comparison must flag (hull_hull with the finger pad's face count one
     short, sphere_hull and capsule_hull with every row one face short; the
     pad meets no box, so box_hull's fault runs in phase 7); the step at
     iterations=100
     (median of 3 calls of 25 steps from the seeded drop, one launch of
     each collide kernel per step, the calls equal to the bit); one step
     at B=64, iterations=30 against the CPU's plain path with phase 8's
     one-step limits, beside the CPU against itself one ulp off;
 10. the settled pile's RGB-D observation from the top_down camera at
     200 x 200: the ray-cast kernel (a block per 16 x 16 tile, the geoms
     culled per tile) against its plain version on 16 frames (geom id, s*
     and normal on every pixel equal to the bit, and the kernel's survivor
     lists equal to the plain cull's), a planted fault (one visible geom
     hidden in the kernel's call only) that the geom check must catch,
     render_rgbd timed at B=256 and B=4096 with its launch count, its
     device time and the kernel's under torch.profiler, the kernel's time,
     the survivors per tile and two bounds (the surviving (tile, geom)
     pairs' work, and every visible geom on every ray), the kernel held
     against its plain version to the bit again at each of these batches
     (every frame of B=256, the last 16 frames of B=4096), a second
     planted fault at B=256 (the bounding radii 5% small in the kernel's
     call only) that the bit check must catch, a render with the arm
     panned so that the finger pads hang over the bin (equal to the plain
     cast to the bit; every branch of the cast must win pixels), and a
     geometric check of one frame: each hit pixel back-projects onto the
     surface of the geom that won it, and the floor reads the camera's
     height;
 11. the grasping environment and the MPC pick policy on the object pile:
     the four chain kernels generated from the object fixture's arm plan
     (GraspMPC.from_scene(OBJECTS), rollout_open, lin_fd_fast, backward
     and rollout_closed with the track costs) against their plain versions
     by phase 3's rule at B=64, H=16; GraspEnv.step through the kernels
     against the same env on the CPU from one draw (B=4, budget_scale=0.005:
     2 settle and 46 phase steps, iterations=30, ncon=128, 200 x 200): every
     phase flag, reward and grasped equal, qpos within 1e-4, the winning
     geom of the observation on >= 99.9% of the pixels and, where it
     agrees, each hit within 1e-4 m along its surface normal, each collide
     kernel launched once per contact step and the ray cast once; the same
     step again equal to the bit; bench.py's bench_env at B=64, the reset
     at its quick scale (0.1) and the pick at half of it (0.05; one pick
     per scenario at its closest pixel): resets/s, picks/s, the wall per
     contact step, the launches of
     every kernel, with the card's name and power limit, and no scenario's
     state non-finite but those witnessed to diverge in the JAX package
     too (DIVERGES); step_mpc at B=64 with that plan at H=4 (substeps=8,
     iters=6): its wall time and launches, finite states and rewards in
     {0, 1};
 12. the learning path: one GraspAgent.train_step at the reference's
     widths (200 x 200 x 4, 6 rotations, batch 12, seeded transitions) on
     the card against the CPU from the same weights, TF32 off: in float32
     the logits at the actions (1e-4 of their largest), the loss (1e-5
     relative) and the BatchNorm running statistics (1e-5 of each
     tensor's largest entry); in float64 the same and every gradient (1e-3
     of its tensor's norm: in float32 the BatchNorm backward's roundoff
     alone moves a gradient by 2e-2 of its norm, printed beside it); the
     first-index argmax on a map with planted ties; train_step's time in
     float32 and bfloat16 (CUDA events, median of 10) with its products'
     and convolutions' FLOP count and bound, its loss falling on the
     batch; the Trainer (learn/train.py) on the object pile at B=16, 1
     episode x 3 env steps, budget_scale=0.01, iterations=30, the agent at
     its defaults (bfloat16, batch 12, memory 2000): 48 steps and
     transitions, rewards in {0, 1}, two finite losses, each collide kernel
     launched once per contact step and the ray cast once per observe,
     the wall per reset, env step and learn and transitions/s; its
     checkpoint saved and restored equal to the bit, and a learn step from
     the restored state;
 13. the last modules: (a) the batched solver with the JAX solver's
     options: lin_fd over the full knot at 6 substeps (no power of two)
     at B=4096, H=64 against its plain version by phase 3's rule (which
     holds rollout_closed without fused costs at the main path's shapes),
     then GraspMPC(substeps=6).track_batch at B=4096, H=64 and line searches
     of 3 and 9 alphas without fused costs (two launches per iteration
     for 9), their launches counted and their costs falling, and
     track_batch at 6 substeps card vs CPU by phase 5's rule; (b) the
     reacher (ReacherEnv.reach_ik) at B=4096, 500 contact-free steps: no
     kernel launched, the converged share, the median distance and the
     wall, the first two converged and the first two unconverged
     scenarios against the CPU's plain path; (c) what the gym
     wrapper runs, without gymnasium (this machine has none): GraspEnv at
     B=1 (200 x 200, budget_scale=0.01, iterations=30), reset and one
     step with their launches, and the 1000 x 1000 side-camera capture
     through the ray cast, bit-equal to the plain cast; (d) parallel/ with
     one NCCL rank: dp_train_step and a train_step from the 1 x 1
     tensor-parallel placement against train_step (200 x 200 x 4, batch
     12, float64: float32 steps on the card do not repeat to the bit;
     loss, parameters, gradients and BatchNorm statistics within 1e-6 of
     each tensor's norm), and
     dp_env_reset/dp_env_rollout at B=16 equal to env.reset/env.step to
     the bit; (e) examples/example.py --budget-scale 0.01 --skip-toss
     to "Finished." (the toss is 300 steps at any budget; the CPU tests
     run it).

Each phase's wall time and the whole run's are printed as it ends.

    python3 chip_smoke.py --dump-settle PATH   also writes the settle roll's
                                               fastest scenarios to PATH
    python3 chip_smoke.py --solve-times ROOT   only times phase 4's solves and
                                               the reach quadratization with
                                               the package of the checkout at
                                               ROOT (to compare two trees in
                                               one call: old, new, new, old)

The last three lines are the kernel table as JSON (twelve kernels), the
card's name and power limit, and the device line as JSON.
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
PEAK_BF16_FLOP_PER_S = 989e12     # bfloat16 on the tensor cores, dense
# cycles per dependent level of a latency floor: an f32 (fused) arithmetic
# operation, and an exchange between lanes (a shuffle, or a shared-memory
# store, barrier and load); taken as 4 and 30, the order of the dependent
# latencies of recent NVIDIA GPUs (an assumption, not a measurement)
OP_CYCLES, EX_CYCLES = 4, 30

B, H, SUBSTEPS, ITERS = 4096, 64, 8, 6
# The plain versions of rollout_open and rollout_closed are launch-bound
# loops over the knots (their float32 and float64 runs take the same time:
# 33-46 s each at H=64 on an H100 whose host was slow). At the main path's
# B=4096, H=64 phase 3 runs each once, in float64: that run is the
# reference and its time the plain version's; the kernel's error against it
# is held to twice the plain float32 version's own error on these seeded
# inputs (measured with both runs on an H100 80GB HBM3 at 700 W) plus 1e-6
# of the output's scale, as everywhere else in the phase. Per output: xs;
# xs, us, costs.
OPEN_F32_ERR = (4.136e-05,)
CLOSED_F32_ERR = {"track": (2.566e-03, 9.386e-03, 4.087e-05),
                  "reach": (8.141e-03, 2.113e-02, 9.153e-04)}
NCON, STEPS, SETTLE = 128, 25, 300       # the contact step's cell
COLLIDE = ("box_box", "hull_hull", "box_hull", "plane_hull")
OBJ_COLLIDE = COLLIDE + ("sphere_hull", "capsule_hull")
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


def compare(name, outs, kern, plain_fn, args64, also=(), f32_err=None):
    """Hold every output (named in ``outs``) of a kernel against its plain
    version run in float64 on the same inputs: the kernel's error is at most
    twice the plain f32 version's (plus 1e-6 of the output's scale), each
    output on its own. With ``f32_err`` (that error, per output, measured
    on these seeded inputs) the plain version runs once, in float64, and
    that run is timed. ``also``: (name, outputs) of other kernels of the
    same function held the same way against the leading outputs of the
    same plain runs. Returns (the largest direct difference over the
    outputs of ``kern`` from the plain version, the plain version's
    ms)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = plain_fn(*(args64 if f32_err else ()))
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    ref = plain if f32_err else plain_fn(*args64)

    def hold(name, kern):
        errs = [(float((k.double() - r).abs().max() / r.abs().max()),
                 f32_err[i] if f32_err else
                 float((p.double() - r).abs().max() / r.abs().max()),
                 float((k.double() - p).abs().max()))
                for i, (k, p, r) in enumerate(zip(kern, plain, ref))]
        for out, (ek, ep, diff) in zip(outs, errs):
            log(f"  {name} {out}: max |kernel - plain"
                f"{' (float64)' if f32_err else ''}| {diff:.3e}; error vs "
                f"float64 (max |d|/max|ref|): kernel {ek:.3e}, plain "
                f"{ep:.3e}{' (measured on these inputs)' if f32_err else ''}")
        for out, (ek, ep, _) in zip(outs, errs):
            check(f"{name} {out}", ek, 2 * ep + 1e-6,
                  "kernel error vs float64")
        return max(e[2] for e in errs)
    diff = hold(name, kern)
    for other, got in also:
        hold(other, got)
    return diff, plain_ms


def f64(*ts):
    return [t.double() if torch.is_tensor(t) else t for t in ts]


def backward_flops(nx: int, nu: int) -> int:
    """Floating-point operations one Riccati step needs (an FMA counts 2):
    the products and the one 7 x 7 factorization of the plain recursion.
    csrc/lqr_backward.cu executes a little more (each of a scenario's 16
    lanes factors Quu and solves for d itself)."""
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


def device_ms(fn, kernel: str, reps: int = 20):
    """Device time per launch of the kernel named ``kernel`` over ``reps``
    calls of ``fn`` under torch.profiler (None where the profiler recorded
    none of its launches: "not measured")."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and kernel in e.key
          and e.self_device_time_total]
    if not ev:
        return None
    return (sum(e.self_device_time_total for e in ev)
            / sum(e.count for e in ev) / 1e3)


def device_kernels(fn, reps: int = 1) -> dict:
    """{kernel name: launches} on the card during ``reps`` calls of ``fn``
    under torch.profiler (the profiler may drop the events of a single
    short call: take several)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total}


def spill_bytes(report: list) -> int:
    """Spill stores plus loads in a ptxas report (``_build.ptxas_report``)."""
    import re
    return sum(int(a) + int(b) for ln in report for a, b in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln))


def stack_bytes(report: list) -> int:
    """Stack frame bytes in a ptxas report (``_build.ptxas_report``)."""
    import re
    return sum(int(a) for ln in report
               for a in re.findall(r"(\d+) bytes stack frame", ln))


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


LIN_SPAN = "chip_smoke: lin_fd_fast"
MATMULS = ("aten::matmul", "aten::bmm", "aten::mm", "aten::baddbmm",
           "aten::addmm")


def check_lin_spans(prof) -> None:
    """What the solver's lin_fd_fast calls (each inside a LIN_SPAN range)
    ran: no torch matrix product on the host, and on the card, inside the
    device range the profiler records for each span, only the lin_fd
    kernel (no cuBLAS gemm). Fails otherwise."""
    from torch.autograd import DeviceType

    def inside(e):
        while e is not None:
            if e.name == LIN_SPAN:
                return True
            e = e.cpu_parent
        return False

    evs = prof.events()
    host = [e for e in evs if e.device_type == DeviceType.CPU]
    spans = sum(e.name == LIN_SPAN for e in host)
    matmuls = sum(e.name in MATMULS for e in host if inside(e))
    dev = [e for e in evs if e.device_type == DeviceType.CUDA]
    windows = [e.time_range for e in dev if e.name == LIN_SPAN]
    kernels = {}
    for e in dev:
        r = e.time_range
        if e.name != LIN_SPAN and any(w.start <= r.start and r.end <= w.end
                                      for w in windows):
            kernels[e.name] = kernels.get(e.name, 0) + 1
    gemm = sum(n for k, n in kernels.items() if "gemm" in k.lower())
    ours = sum(n for k, n in kernels.items() if "lin_fd_kernel" in k)
    solve_gemm = sum(e.count for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA
                     and "gemm" in e.key.lower())
    log(f"  lin_fd_fast in this solve: {spans} calls, {matmuls} torch matrix "
        f"products beneath them; on the card, within their {len(windows)} "
        f"ranges, {ours} lin_fd launches and {gemm} cuBLAS gemm ("
        + (", ".join(f"{k[:40]} x{n}" for k, n in kernels.items())
           or "no kernel") + f"); the whole solve launched {solve_gemm} "
        "gemm elsewhere")
    if windows:
        ok = len(windows) == spans and ours == spans == sum(kernels.values())
    else:
        log("  (the profiler recorded no device range for the spans: the "
            "card side is not measured)")
        ok = True
    if spans != ITERS + 1 or matmuls or not ok:
        raise AssertionError("lin_fd_fast ran more than its one kernel")


def profile_solve(solve, lin_check=False) -> None:
    """Where a cold solve's time goes: device time by kernel name under
    torch.profiler, and the device's busy share of the solve's wall time
    (the profiler's own host cost is inside that wall time). With
    ``lin_check``, the solver's lin_fd_fast runs inside a LIN_SPAN range
    and ``check_lin_spans`` holds what it launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from mujoco_rl_ur5_tpu_torch.mpc import cuda_ilqr
    inner = cuda_ilqr.lin_fd_fast

    def spanned(*args):
        with record_function(LIN_SPAN):
            return inner(*args)

    torch.cuda.synchronize()
    if lin_check:
        cuda_ilqr.lin_fd_fast = spanned
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            solve()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        cuda_ilqr.lin_fd_fast = inner
    # device-side kernel events only: the ops that launch them carry the
    # same time again as their "self device time"
    rows = [(e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total
            and e.key != LIN_SPAN]    # the span's device range: no kernel
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
    if lin_check:
        check_lin_spans(prof)


def collide_flops(kernel: str, V: int, F: int, team: int = 1,
                  vpad: int = 0) -> tuple:
    """Floating-point operations of one (pair, scenario) of a collide
    function: (what the function needs, what the kernel executes). What it
    needs: a pose from a quaternion 36; a vertex to world 18, once per hull;
    a face to world 20 and its separation and comparison 2; per (face,
    vertex) pair one dot and one min 6; per vertex of the deepest-vertex
    pass a dot, a subtraction and a comparison 7; an output point 7; a box
    corner tested against a box 59; a SAT axis 60 (a cross axis 78); the
    edge contact and the box-box outputs 216. The deepest-vertex pass of
    hull-hull and box-hull runs on the side whose face lost, which the data
    decide: it is counted on the smaller side. A sphere probe scores a
    center against a face 7 and writes a contact 12; a capsule's hull
    centre is a masked sum 24 per vertex, its five probe centres 48. The
    team kernels (``team`` lanes per instance) move each vertex and face to
    world once, loop over the real ones only and compute each SAT axis
    once, but every lane forms both poses, the team reduces its faces' or
    axes' extrema (3 per step and lane), and ranks replace the top-k: the
    deepest pass of hull-hull, box-hull and plane-hull ranks at least 8
    vertices against each other as 64-bit keys (a key 4 per lane and
    vertex, a comparison 3 per pair; box-hull's counted on the box),
    box-box ranks each way's 8 corners (3 per pair), and the winning face
    moves to world once more (20; capsule-hull's five, one per probe).
    Plane-hull's lanes each form the plane's offset (5); capsule-hull moves
    all ``vpad`` vertices of the table row (the padded ones too, for the
    plain version's masked sum), three lanes sum one coordinate each (an
    addition per vertex, a multiplication by 0 per padded one), every lane
    forms the probe centres, and the team reduces five maxima;
    sphere-hull's lanes each form the hull's pose (its centre is the
    sphere's position, no rotation) and the team reduces one maximum. Call
    it with the hulls' real vertex and face counts (``vpad`` the table's
    padded width)."""
    pose = 2 * 36
    steps = 3 * (team.bit_length() - 1)     # one team reduction, per lane
    Vx = max(V, 8)
    ranks = Vx * 7 + team * Vx * 4 + Vx * Vx * 3 + 8 * 7
    if kernel == "sphere_hull":
        return (36 + F * (20 + 7) + 12,
                team * 36 + F * (20 + 7) + team * steps + 20 + 12)
    if kernel == "capsule_hull":
        return (pose + V * 24 + 4 + 48 + F * (20 + 5 * 7) + 5 * 12,
                team * pose + vpad * 18 + 3 * vpad + 3 * (vpad - V)
                + team * (4 + 48)
                + F * (20 + 5 * 7) + 5 * team * steps + 5 * (20 + 12))
    if kernel == "box_box":
        n = pose + 16 * 59 + 6 * 60 + 9 * 78 + 216
        return n, (team * pose + 16 * 59 + 2 * 8 * 8 * 3 + 6 * 60 + 9 * 78
                   + team * steps + 216)
    if kernel == "plane_hull":
        return (pose + 5 + V * 25 + 8 * 7,
                team * (pose + 5) + Vx * 18 + ranks)
    if kernel == "hull_hull":
        return (pose + 2 * V * 18 + 2 * F * 22 + 2 * F * V * 6 + V * 7
                + 8 * 7,
                team * pose + 2 * Vx * 18 + 2 * F * 22 + 20
                + 2 * F * V * 6 + 2 * steps + ranks)
    # box-hull: the box's 8 vertices and 6 faces against the hull's V, F
    n = (pose + (8 + V) * 18 + (6 + F) * 22 + (8 * F + 6 * V) * 6 + 8 * 7
         + 8 * 7)
    return n, (team * pose + (8 + Vx) * 18 + (6 + F) * 22 + 20
               + (8 * F + 6 * V) * 6 + 2 * steps + 8 * 7 + team * 8 * 4
               + 8 * 8 * 3 + 8 * 7)


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
    from mujoco_rl_ur5_tpu_torch.scene.mjcf import GEOM_CYLINDER
    t = model.topo
    cpos, cquat = collision_poses(model, fk(model, state.qpos))
    objs = [t.geom_id(f"object_{i}_geom") for i in range(40)]
    low = []
    for g in objs:
        size = model.col_size[g]
        if t.geom_meshid[g] >= 0:
            verts = quat_rotate(cquat[:, g, None], model.hull_verts[
                int(t.geom_meshid[g])]) + cpos[:, g, None]
            low.append(verts[..., 2].amin(-1))
        elif int(model.col_type[g]) == collision.GEOM_BOX:
            verts = collision._box_corners(cpos[:, g], cquat[:, g], size)
            low.append(verts[..., 2].amin(-1))
        else:                                     # sphere or capsule
            axis_z = collision._zaxis(cquat[:, g], cpos)[..., 2]
            half = (axis_z.abs() * size[1] if int(model.col_type[g])
                    == collision.GEOM_CAPSULE else 0.0)
            low.append(cpos[:, g, 2] - half - size[0])
    low = torch.stack(low, 1)
    c = cpos[:, objs]
    inside = ((c[..., 0].abs() < 0.16) & ((c[..., 1] + 0.6).abs() < 0.16)
              & (c[..., 2] > 0.86) & (c[..., 2] < 1.0))
    on_floor = inside & ((low - 0.86).abs() < 5e-3)
    v = state.qvel[:, 8:].reshape(-1, 40, 6)
    lin, ang = v[..., :3].norm(dim=-1), v[..., 3:].norm(dim=-1)
    family = {}
    for g, i in zip(objs, range(40)):
        family.setdefault(int(t.geom_type[g]), []).append(i)
    names = {collision.GEOM_SPHERE: "spheres", collision.GEOM_BOX: "boxes",
             GEOM_CYLINDER: "cylinders", collision.GEOM_CAPSULE: "capsules"}
    return {"in_bin": float(inside.float().mean()),
            "in_bin_by_family": {names[k]: float(inside[:, v].float().mean())
                                 for k, v in sorted(family.items())},
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


def settle(log, model, state, warm, dump=None):
    """The settle roll: SETTLE steps at iterations=30 from ``state``, and
    the pile's statistics at its end (``pile_stats``); returns the settled
    state and warm start. With ``dump`` (a path), the roll also keeps a
    snapshot every 50 steps and writes, for the four scenarios with the
    fastest objects at its end by linear speed and the four by angular
    speed, their snapshots and their objects' largest linear and angular
    speed after every step (numpy .npz)."""
    from mujoco_rl_ur5_tpu_torch.physics import dynamics
    Bs = state.qpos.shape[0]
    snaps, speeds = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(SETTLE):
        if dump and i % 50 == 0:
            snaps.append((state.qpos.clone(), state.qvel.clone(),
                          warm[0].clone(), warm[1].clone()))
        state, warm = dynamics.step_warm(model, state, warm, NCON, 30)
        if dump:
            v = state.qvel[:, 8:].reshape(Bs, 40, 6)
            speeds.append(torch.stack([v[..., :3].norm(dim=-1).amax(-1),
                                       v[..., 3:].norm(dim=-1).amax(-1)], -1))
    torch.cuda.synchronize()
    st = pile_stats(model, state)
    log(f"  settle: {SETTLE} steps (iterations=30) in "
        f"{time.perf_counter() - t0:.1f} s; objects in the bin "
        f"{st['in_bin']:.2%} (" + ", ".join(
            f"{k} {v:.2%}" for k, v in st["in_bin_by_family"].items())
        + f"); {st['on_floor']} on the bin floor, mean gap "
        f"{st['floor_gap_mean'] * 1e3:.3f} mm (margin 1 mm; 0 = touching); "
        f"objects' largest speed {st['max_lin']:.3f} m/s and "
        f"{st['max_ang']:.3f} rad/s (in the bin {st['max_lin_in_bin']:.3f}"
        f" m/s, {st['max_ang_in_bin']:.3f} rad/s), {st['lin_over_1']} over "
        f"1 m/s and {st['ang_over_10']} over 10 rad/s of {40 * Bs}; the "
        f"arm's largest |qvel| (no control, falling) "
        f"{st['max_qvel_arm']:.3f}")
    if not st["finite"]:
        raise AssertionError("the settle roll went non-finite")
    if dump:
        speeds = torch.stack(speeds, 1)                  # (B, SETTLE, 2)
        top = torch.cat([torch.argsort(speeds[:, -1, k], descending=True)[:4]
                         for k in (0, 1)])
        np.savez(dump, scenario=top.cpu().numpy(),
                 speed=speeds[top].cpu().numpy(),
                 snap_step=np.arange(0, SETTLE, 50),
                 **{f"{k}": torch.stack([sn[j][top] for sn in snaps], 1)
                    .cpu().numpy() for j, k in enumerate(
                        ("qpos", "qvel", "warm_f", "warm_s"))})
        log(f"  settle: wrote scenarios {top.tolist()} to {dump}")
    return state, warm


def collide_diff(got, want) -> tuple:
    """A collide kernel's outputs against its plain version's: per active
    slot (dist < 1) within COLLIDE_TOL after a per-(pair, scenario) sort by
    dist, and no inactive plain slot active in the kernel's. Returns (the
    (pair, scenario) entries outside, the entries with an active slot, the
    largest difference over the active slots)."""
    order_g = torch.argsort(got[2], dim=-1, stable=True)
    order_w = torch.argsort(want[2], dim=-1, stable=True)
    gd, wd = got[2].gather(-1, order_g), want[2].gather(-1, order_w)
    gp, gn, wp, wn = (x.gather(-2, o[..., None].expand(x.shape))
                      for x, o in ((got[0], order_g), (got[1], order_g),
                                   (want[0], order_w), (want[1], order_w)))
    act = wd < 1.0
    err = torch.stack([(gd - wd).abs(), (gp - wp).abs().amax(-1),
                       (gn - wn).abs().amax(-1)], -1).amax(-1)
    bad_slot = (act & (err > COLLIDE_TOL)) | (~act & (gd < 1.0))
    live = int(act.any(-1).sum())
    max_err = float(err[act].max()) if bool(act.any()) else 0.0
    return int(bad_slot.any(-1).sum()), live, max_err


def collide_rows(log, model, state, faults=()) -> dict:
    """Each collide kernel of the model's groups against its plain version
    at the shapes of ``state``'s step (``collide_diff``: at most 0.01% of
    the entries outside), timed with CUDA events beside its plain version
    and its bound; for the kernels named in ``faults``, once more with a
    planted fault which the comparison must flag: hull-hull and box-hull
    with every hull row of the most faces one face short (the object
    pile's finger pad; each of the box pile's prisms, which lose their
    bottom caps), sphere-hull and capsule-hull with every row one face
    short, plane-hull with every row one vertex short, box-box with the box sizes 0.1%
    small. Returns their rows of the kernel table (launches still None)."""
    from mujoco_rl_ur5_tpu_torch.physics import (
        collision, constraints, cuda_collide,
    )
    from mujoco_rl_ur5_tpu_torch.physics.kinematics import fk
    B = state.qpos.shape[0]
    log(f"  collide kernels vs plain at the settled pile's shapes (tolerance "
        f"{COLLIDE_TOL:g} per active slot, after a per-(pair, scenario) sort "
        f"by dist)")
    cpos, cquat = constraints.collision_poses(model, fk(model, state.qpos))
    hulls = constraints.hulls(model)
    teams = {"box_box": cuda_collide.BOX_TEAM,
             **{k: cuda_collide.HULL_TEAM for k in cuda_collide.TEAM}}
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
        bad, live, max_err = collide_diff(got, want)
        ms = event_ms(lambda: wrapper(*args), 20)
        # per recorded launch: the profiler may drop events of a short run,
        # or all of them (then "not measured": None)
        dev_ms = device_ms(lambda: wrapper(*args), f"{name}_kernel")
        n = g1.shape[1]
        V, F = model.hull_verts.shape[1], model.hull_fnorm.shape[1]
        # what is needed: the hulls' real vertices and faces in these pairs
        # (their mean over the hull sides of every entry)
        Vr, Fr = V, F
        sides = [g for g, ty in ((g1, t1), (g2, t2))
                 if ty == collision.GEOM_MESH]
        if sides:
            mesh = torch.cat([hulls.meshid[g].flatten() for g in sides])
            Vr = float(model.hull_vmask[mesh].sum(-1).mean())
            Fr = float((model.hull_fdist[mesh] < 1e9).sum(-1).float().mean())
        need = collide_flops(name, Vr, Fr)[0]
        executed = collide_flops(name, Vr, Fr, teams[name], V)[1]
        ops = B * n * need
        nbyte = nbytes(cpos, cquat, g1.int(), g2.int(), *got)
        t_bytes = nbyte / PEAK_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_F32_FLOP_PER_S * 1e3
        rows[name] = {
            "name": name, "route": "cuda",
            "source": f"mujoco_rl_ur5_tpu_torch/csrc/collide_{name}.cu",
            "replaces": "mujoco_rl_ur5_tpu/physics/pallas_collide.py:" + {
                "box_box": "675", "hull_hull": "689", "box_hull": "703",
                "plane_hull": "715", "sphere_hull": "727",
                "capsule_hull": "739"}[name],
            "launches": None, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "device_ms": dev_ms}
        dev = "not measured" if dev_ms is None else f"{dev_ms:.3f} ms"
        log(f"  {name}: {n} pairs x {B}, {live} (pair, scenario) "
            f"entries with an active slot, {bad} outside the tolerance; max "
            f"|kernel - plain| {max_err:.3e}; {ms:.3f} ms (device "
            f"{dev}), plain {plain_ms:.2f} ms, bound "
            f"{max(t_bytes, t_ops):.4f} ms ({ops:.3e} ops needed, "
            f"{nbyte:.3e} bytes; the kernel executes "
            f"{B * n * executed:.3e} ops)")
        if bad > 1e-4 * max(live, 1):
            raise AssertionError(f"{name}: {bad} entries outside the "
                                 f"tolerance")
        if name not in faults:
            continue
        size = model.col_size
        if name == "box_box":
            what = "the box sizes 0.1% small"
            size, faulty_hulls = size * 0.999, hulls
        elif name == "plane_hull":
            what = "every row one vertex short"
            faulty_hulls = hulls._replace(nvert=hulls.nvert - 1)
        else:
            short = hulls.nface.clone()
            if name in ("sphere_hull", "capsule_hull"):
                what, most = "every row one face short", slice(None)
            else:
                most = (short == short.max()).nonzero().flatten().tolist()
                what = (f"every row of the most faces, {int(short.max())}, "
                        f"one face short: rows {most[0]}-{most[-1]}, "
                        f"{len(most)}")
            short[most] -= 1
            faulty_hulls = hulls._replace(nface=short)
        faulty = wrapper(cpos, cquat, size, faulty_hulls, g1, g2)
        bad_f, _, err_f = collide_diff(faulty, want)
        caught = bad_f > 1e-4 * max(live, 1)
        log(f"  {name}, planted fault ({what}): {bad_f} entries outside "
            f"the tolerance, max |kernel - plain| {err_f:.3e}: "
            + ("caught" if caught else "NOT caught"))
        if not caught:
            raise AssertionError(f"{name}'s planted fault was not caught")
    return rows


def first_scenarios(state, warm, n: int):
    """The first ``n`` scenarios of a card state and warm start, on the card
    and on the CPU, and the CPU state with every velocity one float32 ulp
    off (alternately up and down)."""
    sg = state.replace(qpos=state.qpos[:n].clone(),
                       qvel=state.qvel[:n].clone(), ctrl=state.ctrl[:n],
                       time=state.time[:n])
    wg = (warm[0][:n].clone(), warm[1][:n].clone())
    sc = sg.replace(qpos=sg.qpos.cpu(), qvel=sg.qvel.cpu(), ctrl=sg.ctrl.cpu(),
                    time=sg.time.cpu())
    wc = (wg[0].cpu(), wg[1].cpu())
    sign = torch.ones_like(sc.qvel)
    sign.view(-1)[1::2] = -1.0
    su = sc.replace(qvel=torch.nextafter(sc.qvel, sc.qvel + sign))
    return sg, wg, sc, wc, su


def rolls_agree(log, model, state, warm) -> None:
    """The step repeats to the bit: two 5-step rolls (iterations=30) from
    ``state`` end in the same qpos, qvel and warm state."""
    from mujoco_rl_ur5_tpu_torch.physics import dynamics
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


def timed_steps(log, model, drop, drop_warm, iters, wrappers) -> dict:
    """Three calls of STEPS steps from the seeded drop, each with the
    collide kernels' launch counts set to 0 just before and read just
    after (one launch of each per step): the median wall time, and the
    calls' end states equal to the bit. Returns the last call's counts."""
    from mujoco_rl_ur5_tpu_torch.physics import dynamics
    walls, ends = [], []
    for _ in range(3):
        for wr in wrappers.values():
            wr.launches = 0
        s, w = drop, drop_warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STEPS):
            s, w = dynamics.step_warm(model, s, w, NCON, iters)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        n = {k: wr.launches for k, wr in wrappers.items()}
        if set(n.values()) != {STEPS}:
            raise AssertionError(f"launches {n} over {STEPS} steps")
        if not bool(torch.isfinite(s.qpos).all()
                    and torch.isfinite(s.qvel).all()):
            raise AssertionError("the contact step went non-finite")
        ends.append(s)
    med = statistics.median(walls)
    same = all(torch.equal(e.qpos, ends[0].qpos)
               and torch.equal(e.qvel, ends[0].qvel) for e in ends)
    log(f"  step iterations={iters}: {STEPS} steps of {B} per call, median "
        f"of 3 calls {med:.3f} s ({med / STEPS * 1e3:.1f} ms per step), "
        f"{B * STEPS / med:.0f} scenario-steps/s; launches per call {n}; "
        f"the three calls end in the same state to the bit: {same}")
    if not same:
        raise AssertionError("the three calls end in different states")
    return n


def profile_step(log, model, state, warm) -> None:
    """One step (iterations=100) under torch.profiler: wall, device busy
    share, launches, and device time by kernel (the twelve largest and the
    collide kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mujoco_rl_ur5_tpu_torch.physics import dynamics
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
    for e in ev[:12] + [e for e in ev[12:] if any(
            f"{k}_kernel" in e.key for k in OBJ_COLLIDE)]:
        log(f"    {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x  "
            f"{e.key[:90]}")


def contact_step(log, dump_settle=None) -> dict:
    """Phases 7 and 8 (see the module docstring); returns the four collide
    kernels' rows of the kernel table. ``dump_settle``: see ``settle``."""
    import dataclasses

    from mujoco_rl_ur5_tpu_torch import PILE
    from mujoco_rl_ur5_tpu_torch.physics import (
        collision, constraints, cuda_collide, dynamics,
    )
    from mujoco_rl_ur5_tpu_torch.scene.compile import load_model

    model = load_model(PILE)
    t = model.topo
    wrappers = {k: getattr(cuda_collide, f"{k}_batched") for k in COLLIDE}
    log(f"contact step: pile fixture nq={t.nq} nv={t.nv} ntree={t.ntree} "
        f"ncand={constraints.n_candidates(model)} B={B} ncon={NCON}")

    # 7a. settle roll from a seeded drop
    drop = drop_state(model, B, seed=5)
    drop_warm = constraints.init_warm(model, drop)
    state, warm = settle(log, model, drop, drop_warm, dump_settle)

    rolls_agree(log, model, state, warm)

    # 7b. the four kernels against their plain versions at the step's
    # shapes, and the planted faults of box-box, box-hull (the object
    # pile's row of the most faces, the finger pad's, meets no box; here
    # every prism loses its last face, its bottom cap: one prism's cap
    # alone decides too few box-hull entries to cross the 0.01% limit) and
    # plane-hull
    rows = collide_rows(log, model, state,
                       faults=("box_box", "box_hull", "plane_hull"))

    # 7c. the step at full width, through the kernels. Every call starts
    # from the seeded drop, as bench.py's bench_dynamics times its roll
    # from the scene's rest state (the work per step does not depend on
    # the state: fixed shapes, fixed iterations). Not from the settled
    # pile: there, a 100-iteration solve can diverge in a rare scenario,
    # in the JAX package's step as in the port's (ROADMAP.md Queue 3)
    for iters in (100, 30):
        n = timed_steps(log, model, drop, drop_warm, iters, wrappers)
        if iters == 100:
            for k in COLLIDE:
                rows[k]["launches"] = n[k]

    profile_step(log, model, state, warm)

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
    sg, wg, sc, wc, su = first_scenarios(state, warm, Bc)
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


# the arm turned so that the finger pads hang level over the bin
# phase 11: the object arm's chain kernels (B, H), the env held against
# the CPU (B), bench_env's batches (B=16, its reference-comparison point,
# is left out: the call's time) and quick budget scale
ENV_PLAN, ENV_CHECK, ENV_BATCHES, ENV_SCALE = (64, 16), 4, (64,), 0.1
# The call has a time limit, and on a slow host (207 ms of wall per contact
# step) this script took 1,362.6 s with every path at its earlier depth.
# Two paths run shallower: 11e's planner at H=4 (formerly the 11a plan's
# H=16; step_mpc runs H x substeps contact steps per move at any budget
# scale: 68 s at H=8 there), and 11d's pick at PICK_SCALE, half the quick
# scale, from the reset at the quick scale (447 contact steps, formerly
# 895: 185 s there). The reset is the witnessed one (DIVERGES), and
# phase 0 keeps 50 steps, past the witnessed divergence at step 39
STEP_MPC_H, PICK_SCALE = 4, 0.05
# the scenarios of the seeded pick at B (its generator's seed) whose
# contact step diverges in the JAX package as on the card
# (scripts/torch_env_witness.py found the step)
DIVERGES = {64: (0,)}
PADS_OVER_BIN = (-1.42, -1.08, 0.348, -1.739, 3.142, 0.671, 0.0, 0.0)
IMAGE = 200                  # the reference's observation, bench.py:139
RENDER_FRAMES = (256, 4096)  # bench_render's batch; every scenario
# ray cast, kernel vs plain where the geom agrees: s* relative, normal
# absolute; the share of pixels whose geom may differ
CAST_TOL = {"gid": 1e-4, "s": 1e-6, "n": 1e-5}
# the env's observation, card vs CPU after one step from one state: the
# hit's offset along the surface normal (m), held to the state's own limit
# (qpos within 1e-4): a surface moves with the state that it renders
CAST_DISP = 1e-4
# f32 operations of one ray against one visible geom of each branch (its
# frame change 15 and the z-buffer compare 1 included): plane, sphere, box,
# capsule, cylinder; a hull 19 + 27 per real face; the winner's hit point
# and unit normal 16 and world normal 15 once per pixel
RAY_OPS = (23, 47, 58, 121, 66)
RAY_OPS_HULL, RAY_OPS_FACE, RAY_OPS_PIXEL = 19, 27, 31


def object_pile(log):
    """Phase 9 (see the module docstring): returns the six collide
    kernels' rows of the kernel table, the device model and the settled
    state."""
    from mujoco_rl_ur5_tpu_torch import OBJECTS
    from mujoco_rl_ur5_tpu_torch.physics import (
        constraints, cuda_collide, dynamics,
    )
    from mujoco_rl_ur5_tpu_torch.scene.compile import load_model

    model = load_model(OBJECTS)
    t = model.topo
    wrappers = {k: getattr(cuda_collide, f"{k}_batched") for k in OBJ_COLLIDE}
    log(f"object pile: nq={t.nq} nv={t.nv} ntree={t.ntree} hull tables "
        f"{t.hull_maxv} x {t.hull_maxf} ncand={constraints.n_candidates(model)}"
        f" B={B} ncon={NCON}")

    # 9a. settle roll from a seeded drop
    drop = drop_state(model, B, seed=5)
    drop_warm = constraints.init_warm(model, drop)
    state, warm = settle(log, model, drop, drop_warm)
    rolls_agree(log, model, state, warm)

    # 9b. the six collide kernels at the settled pile's shapes, and the
    # planted faults of hull-hull, sphere-hull and capsule-hull (the pile's
    # spheres and capsules)
    rows = collide_rows(log, model, state,
                       faults=("hull_hull", "sphere_hull", "capsule_hull"))
    if set(rows) != set(OBJ_COLLIDE):
        raise AssertionError(f"collide groups {sorted(rows)}, expected "
                             f"{sorted(OBJ_COLLIDE)}")

    # 9c. the step at the reference's solver setting, from the seeded drop
    n = timed_steps(log, model, drop, drop_warm, 100, wrappers)
    for k in OBJ_COLLIDE:
        rows[k]["launches"] = n[k]
    profile_step(log, model, state, warm)

    # 9d. one step through the kernels against the CPU's plain path, B=64,
    # iterations=30, from the settled pile, with phase 8's one-step limits
    # and the CPU against itself with every velocity one float32 ulp off
    Bc, it_c = 64, 30
    cpu_model = load_model(OBJECTS, device="cpu")
    sg, wg, sc, wc, su = first_scenarios(state, warm, Bc)
    qa_c, _, con_c, wn_c = dynamics.forward_warm(cpu_model, sc, wc, NCON,
                                                 it_c)

    def one_step(m, s, w):
        qa, _, con, wn = dynamics.forward_warm(m, s, w, NCON, it_c)
        na, na_c = int(con.active.sum()), int(con_c.active.sum())
        return {"qacc": float((qa.cpu() - qa_c).abs().max()
                              / qa_c.abs().max()),
                "forces": float((wn[0].cpu() - wn_c[0]).abs().max()
                                / wn_c[0].abs().max().clamp_min(1e-12)),
                "active": abs(na - na_c) / max(na_c, 1)}

    read = {"kernels vs plain": one_step(model, sg, wg),
            "plain vs plain, one ulp": one_step(cpu_model, su, wc)}
    limits = {"qacc": 1e-3, "forces": 3e-5, "active": 5e-3}
    log(f"whole object-pile step: B={Bc} iterations={it_c}, kernels vs "
        f"plain (CPU)")
    for key, lim in limits.items():
        log(f"  one step {key} (limit {lim:.1e}): " + "; ".join(
            f"{run} {r[key]:.3e}" for run, r in read.items()))
        check("kernels vs plain", read["kernels vs plain"][key], lim,
              f"one step: {key}")
    return rows, model, state


def surface_distance(model, gpos, gquat, gid, world):
    """Distance of world points (P, 3) from the surface of geom gid (P,)
    (poses gpos (G, 3), gquat (G, 4) of one frame), by type."""
    from mujoco_rl_ur5_tpu_torch.ops.spatial import quat_rotate_inv
    from mujoco_rl_ur5_tpu_torch.scene.mjcf import (
        GEOM_BOX, GEOM_CAPSULE, GEOM_CYLINDER, GEOM_MESH, GEOM_PLANE,
        GEOM_SPHERE,
    )
    t = model.topo
    p = quat_rotate_inv(gquat[gid], world - gpos[gid])
    size = model.geom_size[gid]
    gt = torch.as_tensor(t.geom_type, device=p.device)[gid]
    r, hl = size[:, 0], size[:, 1]
    x, y, z = p.unbind(-1)
    q = p.abs() - size
    box = q.clamp_min(0).norm(dim=-1) + q.amax(-1).clamp_max(0)
    cap = (p - torch.stack([0 * x, 0 * y, torch.maximum(torch.minimum(
        z, hl), -hl)], -1)).norm(dim=-1) - r
    dc = torch.stack([torch.hypot(x, y) - r, z.abs() - hl], -1)
    cyl = dc.clamp_min(0).norm(dim=-1) + dc.amax(-1).clamp_max(0)
    row = torch.as_tensor(t.geom_meshid, device=p.device)[gid].clamp_min(0)
    fn, fd = model.hull_fnorm[row], model.hull_fdist[row]
    hull = ((fn * p[:, None]).sum(-1) - fd).amax(-1)
    out = torch.full_like(x, float("inf"))
    for ty, v in ((GEOM_PLANE, z), (GEOM_SPHERE, p.norm(dim=-1) - r),
                  (GEOM_BOX, box), (GEOM_CAPSULE, cap),
                  (GEOM_CYLINDER, cyl), (GEOM_MESH, hull)):
        out = torch.where(gt == ty, v, out)
    return out


def observation(log, model, state) -> dict:
    """Phase 10 (see the module docstring): returns the ray cast's row of
    the kernel table."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mujoco_rl_ur5_tpu_torch.physics.kinematics import fk, geom_poses
    from mujoco_rl_ur5_tpu_torch.render import camera, cuda_raycast, raycast

    t = model.topo
    cast = cuda_raycast.cast_rays
    cam = camera.make_camera(model, "top_down", IMAGE, IMAGE)
    dn = cam.dirs
    N = dn.shape[0]
    cull = raycast.render_tables(model, cam).cull
    T = cull.planes.shape[0]
    log(f"observation: top_down camera at {IMAGE} x {IMAGE}, near "
        f"{cam.near:.5f} m, far {cam.far:.3f} m, {t.ngeom} geoms, {T} tiles "
        f"of {raycast.TILE} x {raycast.TILE} pixels")

    def compare(a, b):
        same = a[1] == b[1]
        hit = same & (b[0] < raycast.BIG / 2)
        s_rel = float(((a[0] - b[0]).abs() / b[0].abs())[hit].max())
        n_abs = float((a[2] - b[2]).abs().amax(-1)[same].max())
        return 1.0 - float(same.float().mean()), s_rel, n_abs

    def bit_equal(what, got, want):
        """s*, geom id and normal equal to the plain cast's to the bit."""
        equal = all(torch.equal(a, b) for a, b in zip(got, want))
        log(f"  {what}: s*, geom id and normal equal to the plain cast to "
            f"the bit: {equal}")
        if not equal:
            raise AssertionError(f"{what}: the ray cast differs from its "
                                 "plain version")

    def changed(a, b):
        """Pixels where any output of two casts differs."""
        return int(((a[0] != b[0]) | (a[1] != b[1])
                    | (a[2] != b[2]).any(-1)).sum())

    # 10a. the kernel against its plain version on 16 frames of the pile,
    # and its survivor lists against the plain cull's
    par, code, faces = raycast.geom_table(model, fk(model, state.qpos[:16]),
                                          cam)
    got = cast(par, code, faces, dn, cull, survivors=True)
    want = cast.plain(par, code, faces, dn)
    bit_equal(f"ray cast vs plain, 16 frames x {N} pixels", got[:3], want)
    lists = cuda_raycast.survivor_lists(
        raycast.tile_survivors_plain(par, code, cull))
    same_lists = all(torch.equal(a, b) for a, b in zip(got[3:], lists))
    log(f"  the kernel's survivor lists equal the plain cull's: {same_lists}")
    if not same_lists:
        raise AssertionError("the kernel culls otherwise than its plain "
                             "version")
    diff, s_rel, n_abs = compare(got, want)
    check("raycast", diff, CAST_TOL["gid"], "share of pixels whose geom "
          "differs")
    check("raycast", s_rel, CAST_TOL["s"], "max |ds*| / s* where the geom "
          "agrees")
    check("raycast", n_abs, CAST_TOL["n"], "max |dnormal| where the geom "
          "agrees")
    wins = torch.bincount(want[1].flatten().long(), minlength=t.ngeom)
    objs = [t.geom_id(f"object_{i}_geom") for i in range(40)]
    planted = objs[int(wins[objs].argmax())]
    code_f = code.clone()
    code_f[planted, 0] = -1
    fault = compare(cast(par, code_f, faces, dn, cull), want)[0]
    log(f"  planted fault: geom {t.geom_names[planted]} ({int(wins[planted])}"
        f" pixels) hidden in the kernel's call only: {fault:.3e} of the "
        f"pixels change geom (limit {CAST_TOL['gid']:.0e}): "
        f"{'caught' if fault > CAST_TOL['gid'] else 'MISSED'}")
    if not fault > CAST_TOL["gid"]:
        raise AssertionError("the geom check misses a hidden geom")
    max_err = max(s_rel, n_abs)
    del got, want

    # 10b. render_rgbd at bench_render's batch and over every scenario
    npix = torch.zeros(T, device=dn.device)
    tx_n = -(-IMAGE // raycast.TILE)
    for k in range(T):
        ty, tx = divmod(k, tx_n)
        npix[k] = ((min(IMAGE, (ty + 1) * raycast.TILE) - ty * raycast.TILE)
                   * (min(IMAGE, (tx + 1) * raycast.TILE)
                      - tx * raycast.TILE))

    def geom_ops(code):
        """f32 operations of one ray against each geom (0 if hidden)."""
        nface = (faces[:, :, 3] < 1e9).sum(-1).tolist()
        return torch.tensor([0 if c < 0 else RAY_OPS[c] if c < 5
                             else RAY_OPS_HULL + RAY_OPS_FACE * nface[r]
                             for c, r in code.tolist()],
                            dtype=torch.float64, device=dn.device)

    def cost(Bt, code, keep):
        """Operations and bytes of one cast of Bt frames: every visible
        geom on every ray, and (the bound) the surviving (tile, geom)
        pairs' rays only; each with the winner's normal once per pixel."""
        per = geom_ops(code)
        full = Bt * N * (float(per.sum()) + RAY_OPS_PIXEL)
        culled = (float((keep.double().sum(0) * per).sum(-1) @ npix.double())
                  + Bt * N * RAY_OPS_PIXEL)
        nbyte = (Bt * t.ngeom * 16 * 4 + code.numel() * 4 + faces.numel() * 4
                 + N * 12 + T * 16 * 4 + t.ngeom * 4 + Bt * N * 20)
        return full, culled, nbyte

    def bound_ms(ops, nbyte):
        return max(ops / PEAK_F32_FLOP_PER_S, nbyte / PEAK_BYTES_PER_S) * 1e3

    row = None
    for Bt in RENDER_FRAMES:
        kin = fk(model, state.qpos[:Bt])
        cast.launches = 0
        rgb, dbuf = raycast.render_rgbd(model, kin, cam)
        torch.cuda.synchronize()
        launches = cast.launches
        if launches != 1:
            raise AssertionError(f"render_rgbd launched the ray cast "
                                 f"{launches} times")
        if rgb.shape != (Bt, IMAGE, IMAGE, 3) or not bool(
                (torch.isfinite(dbuf) & (dbuf >= 0) & (dbuf <= 1)).all()):
            raise AssertionError("render_rgbd: wrong shape or depth")
        wall = timed_ms(lambda: raycast.render_rgbd(model, kin, cam), 10)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            raycast.render_rgbd(model, kin, cam)
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total]
        busy = sum(e.self_device_time_total for e in ev) / 1e3
        dev_ms = sum(e.self_device_time_total for e in ev
                     if "raycast_kernel" in e.key) / 1e3
        tb = raycast.geom_table(model, kin, cam)
        keep = raycast.tile_survivors_plain(tb[0], tb[1], cull)
        full, culled, nbyte = cost(Bt, tb[1], keep)
        bound, bound_full = bound_ms(culled, nbyte), bound_ms(full, nbyte)
        got = cast(*tb, dn, cull, survivors=True)
        count = got[3]
        if not torch.equal(count, keep.sum(-1, dtype=torch.int32)):
            raise AssertionError(f"B={Bt}: the kernel's survivor counts "
                                 "differ from the plain cull's")
        got = got[:3]
        ms = event_ms(lambda: cast(*tb, dn, cull), 10 if Bt <= 256 else 3)
        log(f"  render_rgbd B={Bt}: {wall:.2f} ms, {Bt / wall * 1e3:.0f} "
            f"frames/s ({IMAGE} x {IMAGE} RGB-D); ray-cast launches "
            f"{launches}; device {busy:.2f} ms ({busy / wall:.1%} of the "
            f"wall time), the kernel {dev_ms:.3f} ms")
        log(f"  ray cast B={Bt}: {ms:.3f} ms (device {dev_ms:.3f} ms); "
            f"survivors per tile mean {float(count.float().mean()):.2f}, "
            f"largest {int(count.max())} of {int((tb[1][:, 0] >= 0).sum())} "
            f"visible; bound {bound:.4f} ms ({culled:.3e} ops of the "
            f"surviving pairs, {nbyte:.3e} bytes), every visible geom on "
            f"every ray {bound_full:.4f} ms ({full:.3e} ops)")
        if Bt == RENDER_FRAMES[0]:
            # the camera's tables made anew in every call (as a fresh
            # camera would), against the kept ones timed above
            fresh = timed_ms(lambda: (cam.tables.clear(), raycast.render_rgbd(
                model, kin, cam)), 10)
            log(f"  render_rgbd B={Bt} with the tables made in the call: "
                f"{fresh:.2f} ms ({fresh - wall:+.2f} ms)")
            cull = raycast.render_tables(model, cam).cull
        # the kernel at this batch against its plain version: every frame
        # at bench_render's batch, the last 16 frames over every scenario
        if Bt == RENDER_FRAMES[0]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = cast.plain(*tb, dn)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            held = "every frame"
        else:
            got = tuple(x[-16:] for x in got)
            want = cast.plain(tb[0][-16:], tb[1], tb[2], dn)
            held = f"frames {Bt - 16}-{Bt - 1}"
        diff, s_rel, n_abs = compare(got, want)
        bit_equal(f"ray cast vs plain at B={Bt}, {held}", got, want)
        check("raycast", diff, CAST_TOL["gid"], f"B={Bt}: share of pixels "
              "whose geom differs")
        check("raycast", s_rel, CAST_TOL["s"], f"B={Bt}: max |ds*| / s* "
              "where the geom agrees")
        check("raycast", n_abs, CAST_TOL["n"], f"B={Bt}: max |dnormal| where "
              "the geom agrees")
        max_err = max(max_err, s_rel, n_abs)
        if Bt == RENDER_FRAMES[0]:
            # a planted fault: the bounding radii 5% small (beyond the
            # cull's 0.1% and 0.1 mm per m margins) in the kernel's call
            # only; the bit check must see the geoms it wrongly drops
            shrunk = cull._replace(radius=cull.radius * 0.95)
            n_bad = changed(cast(*tb, dn, shrunk), want)
            log(f"  planted fault: bounding radii 5% small in the kernel's "
                f"call only: {n_bad} pixels of {Bt} frames change: "
                f"{'caught' if n_bad else 'MISSED'}")
            if not n_bad:
                raise AssertionError("the bit check misses radii 5% small")
            row = {"name": "raycast", "route": "cuda",
                   "source": "mujoco_rl_ur5_tpu_torch/csrc/raycast.cu",
                   "replaces": "mujoco_rl_ur5_tpu/render/pallas_raycast.py:50",
                   "launches": None, "max_abs_err": max_err, "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": bound,
                   "bound_by": ("operations" if culled / PEAK_F32_FLOP_PER_S
                                >= nbyte / PEAK_BYTES_PER_S else "bytes"),
                   "library_ms": None, "device_ms": dev_ms,
                   "bound_every_geom_ms": bound_full}
            log(f"  ray cast alone B={Bt}: {ms:.3f} ms (device "
                f"{dev_ms:.3f} ms), plain {plain_ms:.1f} ms, bound "
                f"{bound:.4f} ms ({bound_full:.4f} ms with every geom on "
                f"every ray); the design before this one (PERF.md): 4.349 ms "
                f"(device 4.351)")
        else:
            row["launches"] = launches
            row["B4096_ms"], row["B4096_device_ms"] = ms, dev_ms
            log(f"  ray cast B={Bt}: the design before this one (PERF.md): "
                f"device 69.0 ms")
        del kin, rgb, dbuf, tb, keep, got, want
    row["max_abs_err"] = max_err

    # 10c. the arm panned so that the pads hang over the bin: the hull
    # branch runs under the cull
    qp = state.qpos[:16].clone()
    qp[:, :8] = torch.tensor(PADS_OVER_BIN, device=qp.device)
    kin = fk(model, qp)
    rgb, dbuf = raycast.render_rgbd(model, kin, cam)
    par, code, faces = raycast.geom_table(model, kin, cam)
    s, gid, nrm = cast(par, code, faces, dn, cull)
    bit_equal("panned arm, 16 frames", (s, gid, nrm),
              cast.plain(par, code, faces, dn))
    hit = s < raycast.BIG / 2
    per = torch.bincount(code[gid.long(), 0][hit].long(), minlength=6)
    names = ("plane", "sphere", "box", "capsule", "cylinder", "hull")
    log("  panned arm, 16 frames: pixels won per branch " + ", ".join(
        f"{k} {int(v)}" for k, v in zip(names, per)))
    if not bool((per > 0).all()):
        raise AssertionError("a branch of the ray cast wins no pixel")
    # 10d. geometry of frame 0: every hit pixel back-projects onto the
    # surface of the geom that won it; the floor reads the camera's height
    H = W = IMAGE
    depth = camera.depth_2_meters(cam, dbuf[0]).flip(0, 1)    # unflipped
    PY, PX = torch.meshgrid(torch.arange(H, device=qp.device),
                            torch.arange(W, device=qp.device), indexing="ij")
    world = camera.pixel_2_world(cam, PX, PY, depth).reshape(-1, 3)
    g0, h0 = gid[0].long(), hit[0]
    gpos, gquat = geom_poses(model, kin)
    dist = surface_distance(model, gpos[0], gquat[0], g0, world).abs()
    img = torch.where(h0, g0, -1).reshape(H, W)
    edge = torch.zeros_like(img, dtype=torch.bool)
    edge[1:] |= img[1:] != img[:-1]
    edge[:-1] |= img[:-1] != img[1:]
    edge[:, 1:] |= img[:, 1:] != img[:, :-1]
    edge[:, :-1] |= img[:, :-1] != img[:, 1:]
    edge = edge.flatten()
    inner, rim = h0 & ~edge, h0 & edge
    floor = h0 & (g0 == t.geom_id("floor"))
    floor_err = float((depth.flatten()[floor] - 2.0).abs().max())
    log(f"  geometry, frame 0: {int(inner.sum())} inner and {int(rim.sum())}"
        f" silhouette hit pixels, {int(floor.sum())} on the floor")
    check("geometry", float(dist[inner].max()), 1e-3, "inner pixels' "
          "distance to the surface they hit (m)")
    check("geometry", float(dist[rim].max()), 2e-3, "silhouette pixels' "
          "distance to the surface they hit (m)")
    check("geometry", floor_err, 1e-4, "floor pixels' |depth - 2 m| (m)")
    return row


def launch_counters() -> dict:
    """Every kernel wrapper of the port by kernel name (each counts its
    launches in ``.launches``)."""
    from mujoco_rl_ur5_tpu_torch.mpc import cuda_lqr
    from mujoco_rl_ur5_tpu_torch.physics import cuda_chain as cc
    from mujoco_rl_ur5_tpu_torch.physics import cuda_collide
    from mujoco_rl_ur5_tpu_torch.render import cuda_raycast
    w = {"rollout_open": cc.rollout_open, "lin_fd": cc.lin_fd,
         "rollout_closed": cc.rollout_closed, "backward": cuda_lqr.backward,
         "ee_quad_gn": cc.ee_quad_gn}
    w.update({k: getattr(cuda_collide, f"{k}_batched") for k in OBJ_COLLIDE})
    w["raycast"] = cuda_raycast.cast_rays
    return w


def counted(wrappers: dict, fn):
    """Run ``fn`` (synchronised) with every launch count set to 0 just
    before and read just after: (its result, wall seconds, {kernel:
    launches})."""
    for wr in wrappers.values():
        wr.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t0,
            {k: wr.launches for k, wr in wrappers.items()})


def closest_pixels(depth: torch.Tensor) -> torch.Tensor:
    """bench.py's env actions: each scenario's closest pixel, rotation
    b % 6."""
    B = depth.shape[0]
    pix = depth.reshape(B, -1).argmin(1).cpu()
    return torch.stack([pix, torch.arange(B) % 6], 1)


def grasp_env(log, smi: str) -> None:
    """Phase 11 (see the module docstring)."""
    from mujoco_rl_ur5_tpu_torch import OBJECTS
    from mujoco_rl_ur5_tpu_torch.env import GraspEnv
    from mujoco_rl_ur5_tpu_torch.env.grasp_env import FLAGS
    from mujoco_rl_ur5_tpu_torch.mpc import cuda_lqr
    from mujoco_rl_ur5_tpu_torch.mpc.cuda_ilqr import ALPHAS, REG
    from mujoco_rl_ur5_tpu_torch.mpc.grasp_mpc import GraspMPC
    from mujoco_rl_ur5_tpu_torch.physics import cuda_chain as cc
    from mujoco_rl_ur5_tpu_torch.physics.kinematics import fk
    from mujoco_rl_ur5_tpu_torch.render import cuda_raycast, raycast
    from mujoco_rl_ur5_tpu_torch.scene.compile import compile_file

    dev = "cuda"
    wrappers = launch_counters()
    chain = ("rollout_open", "lin_fd", "rollout_closed", "backward")
    env_kw = dict(ncon=NCON, iterations=30, image_width=IMAGE,
                  image_height=IMAGE)

    # 11a. the chain kernels generated from the object fixture's arm plan,
    # held by phase 3's rule
    Bm, Hm = ENV_PLAN
    mpc = GraspMPC.from_scene(OBJECTS, horizon=Hm, substeps=SUBSTEPS,
                              iters=ITERS, device=dev)
    log(f"object fixture's arm plan: {len(mpc.kernel_sources())} build "
        f"units in {mpc.build_kernels():.1f} s; its chain kernels against "
        f"their plain versions, B={Bm} H={Hm} substeps={SUBSTEPS}")
    plan = mpc.plan
    x0_np, q_np = tracking_problem(Bm, Hm, seed=6)
    x0 = torch.from_numpy(x0_np).to(dev)
    q_refs = torch.from_numpy(q_np).to(dev)
    qd_refs = torch.zeros_like(q_refs)
    refs, term = (q_refs[:, :-1], qd_refs[:, :-1]), (q_refs[:, -1],
                                                     qd_refs[:, -1])
    sref = torch.cat(refs, -1).contiguous()
    tref = torch.cat(term, -1).contiguous()
    u = mpc._hold_init(x0)
    xs = cc.rollout_open(plan, SUBSTEPS, x0, u)
    compare("rollout_open", ("xs",), (xs,), lambda *a: (
        cc.rollout_open_plain(plan, SUBSTEPS, *(a or (x0, u))),), f64(x0, u))
    xk = xs[:, :-1].contiguous()
    compare("lin_fd_fast", ("F", "L"), cc.lin_fd_fast(plan, SUBSTEPS,
                                                      xs[:, :-1], u),
            lambda *a: cc.lin_fd_fast_plain(plan, SUBSTEPS, *(a or (xk, u))),
            f64(xk, u))
    F, L = cc.lin_fd_fast(plan, SUBSTEPS, xs[:, :-1], u)
    bargs = tuple(t.contiguous() for t in (
        F, L, *mpc._track_quad(xk, u, refs),
        *mpc._track_term_quad(xs[:, -1], term))) + (
        torch.full((Bm,), REG, device=dev),)
    g = cuda_lqr.backward(*bargs)
    compare("backward", ("K", "d", "S", "s"), g,
            lambda *a: cuda_lqr.backward_plain(*(a or bargs)), f64(*bargs))
    cargs = (x0, xs, u, g.K, g.d)
    ckw = dict(cost=mpc._k_track, sref=sref, tref=tref)
    out = cc.rollout_closed(plan, SUBSTEPS, *cargs, ALPHAS, **ckw)
    compare("rollout_closed (track costs)", ("xs", "us", "costs"), out,
            lambda *a: cc.rollout_closed_plain(
                plan, SUBSTEPS, *(a or cargs), ALPHAS,
                **(dict(cost=mpc._k_track, sref=sref.double(),
                        tref=tref.double()) if a else ckw)), f64(*cargs))
    want = torch.stack([
        mpc._track_stage(out[0][:, a, :-1].double(), out[1][:, a].double(),
                         (refs[0].double(), refs[1].double())).sum(-1)
        + mpc._track_term(out[0][:, a, -1].double(),
                          (term[0].double(), term[1].double()))
        for a in range(len(ALPHAS))], 1)
    check("rollout_closed (track costs) costs",
          float(((out[2] - want) / want).abs().max()), 2e-5,
          "max relative error vs the plain cost of its own xs, us")
    del F, L, bargs, g, out, want

    # 11b. the environment through the kernels against the same env on the
    # CPU (every wrapper's plain version): one draw, B=4, 2 settle and 46
    # phase steps from a seeded drop (one trajectory)
    host = compile_file(OBJECTS)
    small = dict(env_kw, budget_scale=0.005)
    env_g = GraspEnv(host, device=dev, **small)
    env_c = GraspEnv(host, device="cpu", **small)
    qpos = env_c._draw(torch.Generator().manual_seed(7), ENV_CHECK)
    es_g, es_c = env_g._settle(qpos.to(dev)), env_c._settle(qpos)
    d = es_c.depth.numpy()
    floor = np.argwhere(d[0] > 1.3)
    floor = floor[floor[:, 0] >= IMAGE - 10][0]           # beyond the bin
    acts = closest_pixels(es_c.depth)
    acts[0, 0] = int(floor[0]) * IMAGE + int(floor[1])
    steps = sum(env_g._phase_budgets())
    log(f"grasping env (GraspEnv.step), object pile, B={ENV_CHECK}, "
        f"budget_scale="
        f"0.005 ({steps} phase steps), iterations=30, ncon={NCON}, "
        f"{IMAGE} x {IMAGE}: kernels vs the CPU's plain path")
    (es2, rew, _, info), wall, n = counted(
        wrappers, lambda: env_g.step(es_g, acts.to(dev)))
    es2c, rewc, _, infoc = env_c.step(es_c, acts)
    for k in FLAGS:
        log(f"  flag {k}: card {info['phases'][k].tolist()}, CPU "
            f"{infoc['phases'][k].tolist()}")
        if not torch.equal(info["phases"][k].cpu(), infoc["phases"][k]):
            raise AssertionError(f"flag {k} differs between card and CPU")
    log(f"  reward: card {rew.tolist()}, CPU {rewc.tolist()}; grasped "
        f"{info['grasped'].tolist()}")
    if not (torch.equal(rew.cpu(), rewc)
            and torch.equal(info["grasped"].cpu(), infoc["grasped"])):
        raise AssertionError("reward or grasped differ between card and CPU")
    check("env step", float((es2.sim.qpos.cpu() - es2c.sim.qpos).abs().max()),
          1e-4, "max |qpos card - qpos CPU|")
    casts = []
    for env, sim in ((env_g, es2.sim), (env_c, es2c.sim)):
        tab = raycast.render_tables(env.model, env.cam)
        par = raycast.geom_table(env.model, fk(env.model, sim.qpos),
                                 env.cam)[0]
        casts.append([x.cpu() for x in cuda_raycast.cast_rays(
            par, tab.code, tab.faces, env.cam.dirs, tab.cull)])
    (s_g, gid_g, _), (s_c, gid_c, n_c) = casts
    same = gid_g == gid_c
    share = float(same.float().mean())
    ddiff = float((es2.depth.cpu() - es2c.depth).abs().flip(1, 2).reshape(
        same.shape)[same].max())
    # a pose difference moves a surface along its normal; the ray's depth
    # moves by that over |n.d| (large where the ray grazes a face)
    ndot = (n_c * env_c.cam.dirs).sum(-1).abs()
    disp = float(((s_g - s_c).abs() * ndot)[same].max())
    log(f"  observation: the winning geom agrees on {share:.4%} of the "
        f"pixels (limit 99.9%); where it does, max |depth card - depth CPU| "
        f"{ddiff:.3e} m")
    if share < 0.999:
        raise AssertionError("the observations' geoms differ")
    check("observation", disp, CAST_DISP, "max |s card - s CPU| x |n.d| "
          "where the geom agrees (m): the surface's offset along its normal")
    log(f"  launches in the card's step ({wall:.2f} s): {n}")
    for k in OBJ_COLLIDE:
        if n[k] != steps:
            raise AssertionError(f"{k}: {n[k]} launches over {steps} "
                                 f"contact steps")
    if n["raycast"] != 1:
        raise AssertionError("the step's observation launched no ray cast")

    # 11c. determinism: the same step again, equal to the bit
    again = env_g.step(es_g, acts.to(dev))
    same = (all(torch.equal(a, b) for a, b in (
        (again[0].sim.qpos, es2.sim.qpos), (again[0].sim.qvel, es2.sim.qvel),
        (again[0].rgb, es2.rgb), (again[0].depth, es2.depth),
        (again[1], rew))) and all(torch.equal(again[3]["phases"][k],
                                              info["phases"][k])
                                  for k in FLAGS))
    log(f"  determinism: a second step from the same EnvState equals the "
        f"first to the bit: {same}")
    if not same:
        raise AssertionError("GraspEnv.step does not repeat to the bit")
    del env_g, env_c, es_g, es_c, es2, es2c, again

    # 11d. bench.py's bench_env at its quick scale: reset, then one full
    # pick per scenario at each scenario's closest pixel
    for Bt in ENV_BATCHES:
        env = GraspEnv(host, device=dev, budget_scale=ENV_SCALE, **env_kw)
        gen = torch.Generator(device=dev).manual_seed(Bt)
        es, reset_s, _ = counted(wrappers, lambda: env.reset(gen, Bt))
        acts = closest_pixels(es.depth).to(dev)
        env = GraspEnv(host, device=dev, budget_scale=PICK_SCALE, **env_kw)
        (es2, rew, _, info), step_s, n = counted(wrappers,
                                                 lambda: env.step(es, acts))
        steps = sum(env._phase_budgets())
        if not set(rew.tolist()) <= {0.0, 1.0}:
            raise AssertionError("env.step gave a reward outside {0, 1}")
        # the contact model can diverge in a pile (ROADMAP Queue 3): the
        # witnessed scenarios do in the JAX package too, from the card's
        # recorded state (tests/test_torch_env_divergence.py); any other
        # that goes non-finite fails the run
        ok = (torch.isfinite(es2.sim.qpos).all(1)
              & torch.isfinite(es2.sim.qvel).all(1))
        lost = (~ok).nonzero().flatten().tolist()
        log(f"  scenarios whose state went non-finite in the pick: {lost} "
            f"(witnessed: {list(DIVERGES.get(Bt, ()))})")
        if set(lost) - set(DIVERGES.get(Bt, ())):
            raise AssertionError(f"env.step: scenarios {lost} went "
                                 f"non-finite")
        log(f"env (bench_env: reset at its quick scale {ENV_SCALE}, the "
            f"pick at {PICK_SCALE}) B={Bt}, iterations=30, "
            f"ncon={NCON}, {IMAGE} x {IMAGE} ({smi}): reset {reset_s:.2f} s "
            f"({Bt / reset_s:.2f} resets/s), step {step_s:.2f} s "
            f"({Bt / step_s:.3f} picks/s), {steps} contact steps: "
            f"{step_s / steps * 1e3:.1f} ms of wall per contact step; "
            f"reward mean {float(rew.mean()):.3f} ({float(rew[ok].mean()):.3f} "
            f"over the finite ones); launches per step "
            f"{n}")
        for k in OBJ_COLLIDE + ("raycast",):
            if n[k] < 1:
                raise AssertionError(f"env.step launched no {k}")
        del env, es, es2

    # 11e. the MPC pick policy: step_mpc at B=64 with 11a's plan at H=4
    Bp, Hm = ENV_BATCHES[-1], STEP_MPC_H
    mpc = GraspMPC.from_scene(OBJECTS, horizon=Hm, substeps=SUBSTEPS,
                              iters=ITERS, device=dev)
    mpc.build_kernels()
    env = GraspEnv(host, mpc=mpc, device=dev, budget_scale=ENV_SCALE,
                   **env_kw)
    es = env.reset(torch.Generator(device=dev).manual_seed(3), Bp)
    acts = closest_pixels(es.depth).to(dev)
    (es2, rew, _, info), wall, n = counted(
        wrappers, lambda: env.step_mpc(es, acts))
    log(f"env.step_mpc B={Bp}, GraspMPC H={Hm} substeps={SUBSTEPS} "
        f"iters={ITERS}, budget_scale={ENV_SCALE} ({smi}): {wall:.2f} s, "
        f"reward "
        f"mean {float(rew.mean()):.3f}; launches {n}")
    if not (bool(torch.isfinite(es2.sim.qpos).all())
            and bool(torch.isfinite(es2.sim.qvel).all())
            and set(rew.tolist()) <= {0.0, 1.0}):
        raise AssertionError("step_mpc returned non-finite states or a "
                             "reward outside {0, 1}")
    for k in chain + OBJ_COLLIDE + ("raycast",):
        if n[k] < 1:
            raise AssertionError(f"step_mpc launched no {k}")


# phase 12: the learning path. 12a: the learner at the reference's widths
# and batch (200 x 200 x 4 input, 6 rotations, batch 12), one train_step
# on the card against the CPU from the same weights, float32 with TF32 off;
# 12b: the Trainer on the object pile, B=16, 1 episode x 3 env steps at
# budget_scale 0.01 (learning at steps 2 and 3); 12c: its checkpoint
LEARN_SEED, LEARN_TIMED = 12, 10
TRAIN_ENVS, TRAIN_STEPS, TRAIN_SCALE = 16, 3, 0.01
# card vs CPU: the train-mode logits at the actions (of their largest), the
# loss (relative), each gradient (of its tensor's norm), each BatchNorm
# running statistic (of its tensor's largest entry)
LEARN_TOL = {"logits": 1e-4, "loss": 1e-5, "grad": 1e-3, "stats": 1e-5}


def one_train_step(agent, ts, args) -> dict:
    """``agent.train_step`` once (synchronised): the logits at the actions,
    the loss, every gradient and BatchNorm statistic after it (float64 on
    the host), and the wall seconds."""
    seen = {}
    loss_of = agent.loss

    def loss(*a, **k):
        out = loss_of(*a, **k)
        seen["q"] = out[1].detach()
        return out

    agent.loss = loss
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts, value = agent.train_step(ts, *args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        del agent.loss
    return {"q": seen["q"].cpu().double(), "loss": float(value),
            "wall": wall,
            "grads": {n: p.grad.detach().cpu().double()
                      for n, p in ts.model.named_parameters()},
            "stats": {n: b.cpu().double()
                      for n, b in ts.model.named_buffers()}}


def learning(log, smi: str) -> None:
    """Phase 12 (see the module docstring)."""
    import copy
    import tempfile

    from torch.utils.flop_counter import FlopCounterMode

    from mujoco_rl_ur5_tpu_torch import OBJECTS
    from mujoco_rl_ur5_tpu_torch.learn.agent import (
        COUNTERS, REPLAY, AgentConfig, GraspAgent,
    )
    from mujoco_rl_ur5_tpu_torch.learn.networks import count_parameters
    from mujoco_rl_ur5_tpu_torch.learn.train import Trainer
    from mujoco_rl_ur5_tpu_torch.utils.config import (
        Config, EnvConfig, SceneConfig, SolverConfig, TrainConfig,
    )

    # 12a. one train_step on the card and on the CPU from the same weights,
    # in float32 and in float64. The gradients are held in float64: in
    # float32 the BatchNorm backward's cancellation leaves the CPU's own
    # gradient up to 1.9e-2 of a tensor's norm from its float64 gradient at
    # this batch (printed below), beyond any limit that would catch a fault
    cfg = AgentConfig(dtype="float32")
    on_cpu, on_card = GraspAgent(cfg, device="cpu"), GraspAgent(cfg)
    ts_cpu = on_cpu.init(torch.Generator().manual_seed(LEARN_SEED))
    nb, hw = cfg.batch_size, cfg.height * cfg.width
    rng = np.random.default_rng(LEARN_SEED)
    s = torch.from_numpy(rng.uniform(
        0, 1, (nb, cfg.height, cfg.width, 4)).astype(np.float32))
    a = torch.from_numpy(rng.integers(0, on_cpu.n_actions, nb))
    r = torch.from_numpy((rng.uniform(size=nb) > 0.5).astype(np.float32))
    log(f"learner (GraspAgent.train_step): {count_parameters(ts_cpu.model)} "
        f"parameters, {nb} x {cfg.height} x {cfg.width} x 4, "
        f"{cfg.rotations} rotations, TF32 off: card vs CPU")
    res = {}
    for dtype in (torch.float32, torch.float64):
        for where, agent in (("card", on_card), ("CPU", on_cpu)):
            model = copy.deepcopy(ts_cpu.model).to(agent.device, dtype)
            res[where, dtype] = one_train_step(
                agent, agent.state_for(model),
                (s.to(agent.device), a.to(agent.device),
                 r.to(agent.device)))
        card, cpu = res["card", dtype], res["CPU", dtype]
        name = str(dtype).split(".")[1]
        log(f"  {name}: one train_step, card {card['wall']:.3f} s (first "
            f"call), CPU {cpu['wall']:.2f} s; loss card {card['loss']:.9f}, "
            f"CPU {cpu['loss']:.9f}")
        check(f"learner {name} logits", float(
            (card["q"] - cpu["q"]).abs().max() / cpu["q"].abs().max()),
            LEARN_TOL["logits"], "max |q card - q CPU| / max |q| at the "
            "actions, train mode")
        check(f"learner {name} loss", abs(card["loss"] / cpu["loss"] - 1),
              LEARN_TOL["loss"], "|loss card / loss CPU - 1|")
        for of, what, scale in (
                ("stats", "stats", lambda t: t.abs().max().clamp_min(1e-30)),
                ("grads", "grad", lambda t: t.norm())):
            errs = {n: float((card[of][n] - cpu[of][n]).abs().max()
                             / scale(cpu[of][n]))
                    for n in cpu[of] if cpu[of][n].is_floating_point()}
            worst = max(errs, key=errs.get)
            if dtype == torch.float32 and of == "grads":
                log(f"  float32 grads, card vs CPU (not held: float32's "
                    f"own roundoff, see the float64 check): largest "
                    f"{errs[worst]:.3e} of the norm of {worst}")
                continue
            check(f"learner {name} {of} ({worst})", errs[worst],
                  LEARN_TOL[what], "card vs CPU, largest over the tensors"
                  + (" (of the tensor's norm)" if of == "grads" else
                     " (of the tensor's largest entry)"))
    g64 = res["CPU", torch.float64]["grads"]
    for where in ("card", "CPU"):
        g32 = res[where, torch.float32]["grads"]
        e = {n: float((g32[n] - g64[n]).abs().max() / g64[n].norm())
             for n in g64}
        n = max(e, key=e.get)
        log(f"  float32 gradient on the {where} vs the CPU's float64: "
            f"largest {e[n]:.3e} of the norm of {n}")
    # the greedy action's tie rule on the card: the first flat index
    q = torch.randn(4, cfg.rotations * hw, generator=torch.Generator()
                    .manual_seed(LEARN_SEED))
    top = float(q.max()) + 1
    for row, cols in enumerate(((5, 77, 3 * hw), (0, hw - 1), (2 * hw + 9,
                                                               2 * hw + 8),
                                (6 * hw - 1, 4 * hw))):
        q[row, list(cols)] = top
    first = [min(c) for c in ((5, 77, 3 * hw), (0, hw - 1),
                              (2 * hw + 9, 2 * hw + 8), (6 * hw - 1, 4 * hw))]
    got = q.cuda().argmax(1).tolist()
    log(f"  argmax with planted ties: card {got}, CPU "
        f"{q.argmax(1).tolist()}, first index {first}")
    if got != first or q.argmax(1).tolist() != first:
        raise AssertionError("argmax does not take the first tied index")
    del res, card, cpu, ts_cpu
    # train_step's time at batch 12 (CUDA events, median of LEARN_TIMED
    # after a warm-up), float32 and bfloat16, on the same batch: the loss
    # must stay finite and fall
    args = (s.cuda(), a.cuda(), r.cuda())
    for dtype in ("float32", "bfloat16"):
        agent = GraspAgent(AgentConfig(dtype=dtype))
        ts = agent.init(torch.Generator().manual_seed(LEARN_SEED))
        ts, first_loss = agent.train_step(ts, *args)
        times, losses = [], [float(first_loss)]
        for _ in range(LEARN_TIMED):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            ts, loss = agent.train_step(ts, *args)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
            losses.append(float(loss))
        # the step's matrix products and convolutions (FlopCounterMode),
        # against the card's peak for the dtype
        with FlopCounterMode(display=False) as flops:
            ts, _ = agent.train_step(ts, *args)
        ops, ms = flops.get_total_flops(), statistics.median(times)
        peak = (PEAK_F32_FLOP_PER_S if dtype == "float32"
                else PEAK_BF16_FLOP_PER_S)
        log(f"  train_step {dtype}, batch {nb} ({smi}): "
            f"{ms:.2f} ms (median of {LEARN_TIMED}, "
            f"CUDA events; range {min(times):.2f}-{max(times):.2f}); "
            f"{ops / 1e9:.1f} GFLOP of products and convolutions: "
            f"{ops / ms / 1e9:.1f} TFLOP/s, bound {ops / peak * 1e3:.2f} ms "
            f"at {peak / 1e12:.0f} TFLOP/s; loss {losses[0]:.4f} -> "
            f"{losses[-1]:.4f} over {len(losses)} steps on the batch")
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise AssertionError(f"train_step {dtype}: the loss is not "
                                 f"finite and falling: {losses}")
        del agent, ts

    # 12b. the Trainer on the object pile through the kernels
    tcfg = Config(
        scene=SceneConfig(path=OBJECTS),
        solver=SolverConfig(ncon=NCON, iterations=30),
        env=EnvConfig(image_width=IMAGE, image_height=IMAGE,
                      budget_scale=TRAIN_SCALE),
        train=TrainConfig(episodes=1, steps_per_episode=TRAIN_STEPS,
                          batch_envs=TRAIN_ENVS, seed=LEARN_SEED))
    tr = Trainer(tcfg)
    env, agent = tr.env, tr.agent
    walls = {"reset": [], "step": [], "learn": []}
    losses = []

    def timed(what, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            walls[what].append(time.perf_counter() - t0)
            if what == "learn":
                losses.append(None if out[1] is None else float(out[1]))
            return out
        return run

    env.reset = timed("reset", env.reset)
    env.step = timed("step", env.step)
    agent.learn = timed("learn", agent.learn)
    wrappers = launch_counters()
    (ts, buf), wall, n = counted(wrappers, lambda: tr.run(verbose=False))
    settle = env._ms_steps(1000.0 * TRAIN_SCALE)
    steps = settle + TRAIN_STEPS * sum(env._phase_budgets())
    rewards = buf.rewards[:buf.size]
    moved = TRAIN_ENVS * TRAIN_STEPS
    log(f"Trainer (learn/train.py) on the object pile: B={TRAIN_ENVS}, 1 "
        f"episode x {TRAIN_STEPS} env steps, budget_scale={TRAIN_SCALE} "
        f"({settle} settle + {TRAIN_STEPS} x {sum(env._phase_budgets())} "
        f"contact steps), iterations=30, ncon={NCON}, {IMAGE} x {IMAGE}, "
        f"the agent at its defaults (bfloat16, batch {agent.cfg.batch_size}, "
        f"memory {agent.cfg.memory_size}) ({smi}):")
    log(f"  wall {wall:.2f} s: reset {walls['reset'][0]:.2f} s, env steps "
        f"{', '.join(f'{t:.2f}' for t in walls['step'])} s, learn "
        f"{', '.join(f'{t * 1e3:.1f}' for t in walls['learn'])} ms; "
        f"{moved / wall:.3f} transitions/s over the run, "
        f"{TRAIN_ENVS / statistics.median(walls['step']):.3f} per second "
        f"of env step; "
        f"{statistics.median(walls['step']) / (steps - settle) * TRAIN_STEPS * 1e3:.1f}"
        f" ms of wall per contact step")
    log(f"  step {ts.step}, replay size {buf.size}, rewards "
        f"{rewards.tolist()}, losses {losses}, counters "
        f"{ {k: getattr(ts, k).tolist() for k in COUNTERS} }")
    log(f"  launches over the run: {n} (expected: each collide kernel "
        f"{steps}, the ray cast {1 + TRAIN_STEPS})")
    if ts.step != moved or buf.size != moved:
        raise AssertionError(f"Trainer: step {ts.step}, size {buf.size}, "
                             f"expected {moved}")
    if not (bool(torch.isfinite(rewards).all())
            and set(rewards.tolist()) <= {0.0, 1.0}):
        raise AssertionError("Trainer: a reward outside {0, 1}")
    trained = [x for x in losses if x is not None]
    if len(trained) != TRAIN_STEPS - 1 or not np.isfinite(trained).all():
        raise AssertionError(f"Trainer: learn gave losses {losses}")
    for k in OBJ_COLLIDE:
        if n[k] != steps:
            raise AssertionError(f"{k}: {n[k]} launches over {steps} "
                                 f"contact steps")
    if n["raycast"] != 1 + TRAIN_STEPS:
        raise AssertionError(f"the ray cast launched {n['raycast']} times "
                             f"over {1 + TRAIN_STEPS} observes")

    # 12c. the checkpoint round trip, to the bit
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ckpt.pt")
        t0 = time.perf_counter()
        agent.save(path, ts, buf)
        save_s, size = time.perf_counter() - t0, os.path.getsize(path)
        fresh = agent.init(torch.Generator().manual_seed(LEARN_SEED + 1))
        t0 = time.perf_counter()
        ts2, buf2 = agent.restore(path, fresh, agent.memory.init())
        load_s = time.perf_counter() - t0
    same = {
        "parameters and statistics": all(
            torch.equal(x, y) for x, y in zip(
                ts.model.state_dict().values(),
                ts2.model.state_dict().values())),
        "optimiser state": all(
            torch.equal(ts.optimizer.state[p][k], ts2.optimizer.state[q][k])
            for p, q in zip(ts.model.parameters(), ts2.model.parameters())
            for k in ts.optimizer.state[p]),
        "counters and step": ts2.step == ts.step and all(
            torch.equal(getattr(ts, k), getattr(ts2, k)) for k in COUNTERS),
        "replay": (buf2.position, buf2.size) == (buf.position, buf.size)
        and all(torch.equal(getattr(buf, f), getattr(buf2, f))
                for f in REPLAY)}
    log(f"  checkpoint: {size / 2**20:.1f} MiB, save {save_s:.2f} s, "
        f"restore {load_s:.2f} s; equal to the bit: {same}")
    if not all(same.values()):
        raise AssertionError("the checkpoint round trip is not exact")
    # the restored state trains on
    ts2, loss = agent.learn(ts2, buf2, torch.Generator(
        device=agent.device).manual_seed(LEARN_SEED))
    log(f"  a learn step from the restored state: loss {float(loss):.4f}")
    if not np.isfinite(float(loss)):
        raise AssertionError("the restored state does not train")


# phase 13: the last modules. 13a: the batched solver with the JAX
# solver's options (substeps=6, no power of two: lin_fd over the full knot;
# a line search of 3 and of 9 alphas without fused costs); 13b: the reacher
# at full width; 13c: what the gym wrapper runs (GraspEnv at B=1 and the
# 1000 x 1000 side capture); 13d: parallel/ with one rank on NCCL; 13e: the
# controller walkthrough
SUB6, ALPHAS3 = 6, (1.0, 0.5, 0.25)
ALPHAS9 = (1.0, 0.8, 0.6, 0.5, 0.4, 0.3, 0.25, 0.1, 0.03)
REACH_B, REACH_STEPS, REACH_CHECK = 4096, 500, 2
# the reacher card vs CPU on REACH_CHECK converged and as many unconverged
# scenarios (tests/test_torch_reacher.py's limits against JAX): steps, qpos
# (rad; a one-ulp change of the start moves the CPU's own qpos by 1.5e-4
# after 500 steps), dist (m)
REACH_TOL = {"steps": 1, "qpos": 1e-3, "dist": 1e-4}
GYM_SCALE, GYM_ITERS, SIDE = 0.01, 30, 1000
# the walkthrough: every motion at 1% of its steps, without the toss (300
# raw-torque steps and a settle at any scale: at 0.05, 615 contact steps
# took 164 s on an H100, at 0.01 with the toss 97 s)
WALK_SCALE = 0.01
DP_ENVS, DP_SCALE = 16, 0.003
DP_TOL = 1e-6           # dp_train_step vs train_step in float64, of each
                        # tensor's norm


def last_modules(log, smi: str) -> None:
    """Phase 13 (see the module docstring)."""
    import contextlib
    import copy
    import io
    import socket
    import tempfile

    import torch.distributed as dist

    from mujoco_rl_ur5_tpu_torch import ASSET, OBJECTS, REACHER
    from mujoco_rl_ur5_tpu_torch.env import GraspEnv, ReacherEnv
    from mujoco_rl_ur5_tpu_torch.examples import example
    from mujoco_rl_ur5_tpu_torch.learn.agent import AgentConfig, GraspAgent
    from mujoco_rl_ur5_tpu_torch.mpc.cuda_ilqr import ilqr_chain_batch
    from mujoco_rl_ur5_tpu_torch.mpc.grasp_mpc import GraspMPC, MPCWeights
    from mujoco_rl_ur5_tpu_torch.parallel import (
        dp_env_reset, dp_env_rollout, dp_train_step, initialize_multihost,
        make_mesh, shard_batch, tp_param_shardings, tp_place_train_state,
    )
    from mujoco_rl_ur5_tpu_torch.parallel.mesh import tree_map
    from mujoco_rl_ur5_tpu_torch.physics import cuda_chain as cc
    from mujoco_rl_ur5_tpu_torch.physics.kinematics import fk
    from mujoco_rl_ur5_tpu_torch.render import cuda_raycast, raycast
    from mujoco_rl_ur5_tpu_torch.render.camera import make_camera
    from mujoco_rl_ur5_tpu_torch.scene.compile import compile_file

    dev = "cuda"
    wrappers = launch_counters()
    chain = ("rollout_open", "lin_fd", "rollout_closed", "backward",
             "ee_quad_gn")

    def expect(what, n, want):
        """Every counted kernel launched as ``want`` says (0 elsewhere)."""
        got = {k: v for k, v in n.items() if v}
        log(f"  {what} launches: {got or 'none'}")
        if got != {k: v for k, v in want.items() if v}:
            raise AssertionError(f"{what} launched {got}, expected {want}")

    def finite(what, *ts):
        if not all(bool(torch.isfinite(t).all()) for t in ts):
            raise AssertionError(f"{what}: non-finite values")

    # 13a. the repaired solver
    mpc6 = GraspMPC.from_scene(ASSET, horizon=H, substeps=SUB6, iters=ITERS,
                               device=dev)
    plan = mpc6.plan
    log(f"the batched solver with JAX's options: substeps={SUB6} (lin_fd "
        f"over the full knot: fast_lin {mpc6.fast_lin}), B={B} H={H} "
        f"iters={ITERS} ({smi})")
    x0_np, q_np = tracking_problem(B, H, seed=13)
    x0 = torch.from_numpy(x0_np).to(dev)
    q_refs = torch.from_numpy(q_np).to(dev)
    u = mpc6._hold_init(x0)
    xs = cc.rollout_open(plan, SUB6, x0, u)
    xk = xs[:, :-1].contiguous()
    diff, plain_ms = compare(
        f"lin_fd ({SUB6} substeps)", ("F", "L"),
        cc.lin_fd(plan, SUB6, xs[:, :-1], u),
        lambda *a: cc.lin_fd_plain(plan, SUB6, *(a or (xk, u))), f64(xk, u))
    ms = event_ms(lambda: cc.lin_fd(plan, SUB6, xs[:, :-1], u), 5)
    log(f"  lin_fd at {SUB6} substeps, B={B} H={H}: {ms:.3f} ms per call "
        f"(CUDA events), plain {plain_ms:.1f} ms; max |kernel - plain| "
        f"{diff:.3e}")
    del xk
    # the solves through the counters
    refs = (q_refs[:, :-1], torch.zeros_like(q_refs[:, :-1]))
    term = (q_refs[:, -1], torch.zeros_like(q_refs[:, -1]))

    def total_cost(xs_, us_):
        return (mpc6._track_stage(xs_[:, :-1], us_, refs).sum(-1)
                + mpc6._track_term(xs_[:, -1], term))

    start = total_cost(xs, u)

    def fell(what, res):
        finite(what, res.xs, res.us, res.cost, *res.gains)
        share = float((res.cost < start).float().mean())
        log(f"  {what}: cost median {float(start.median()):.3f} -> "
            f"{float(res.cost.median()):.3f}, fell in {share:.1%}")
        if not bool((res.cost <= start).all()) or share < 0.99:
            raise AssertionError(f"{what} did not lower the cost")

    res, wall, n = counted(wrappers, lambda: mpc6.track_batch(x0, q_refs))
    log(f"  GraspMPC(substeps={SUB6}).track_batch: {wall * 1e3:.1f} ms "
        f"(first call) ({smi})")
    expect("track_batch", n, dict(zip(chain, (1, ITERS + 1, ITERS,
                                              ITERS + 1, 0))))
    fell("track_batch", res)
    for alphas in (ALPHAS3, ALPHAS9):
        launches = ITERS * -(-len(alphas) // 8)
        res, wall, n = counted(wrappers, lambda: ilqr_chain_batch(
            plan, SUB6, total_cost,
            lambda xs_, us_: mpc6._track_quad(xs_, us_, refs),
            lambda xH: mpc6._track_term_quad(xH, term), x0,
            mpc6._hold_init(x0), None, iters=ITERS, alphas=alphas,
            fast_lin=False))
        log(f"  ilqr_chain_batch, {len(alphas)} alphas without fused costs:"
            f" {wall * 1e3:.1f} ms")
        expect(f"{len(alphas)}-alpha line search", n, dict(zip(
            chain, (1, ITERS + 1, launches, ITERS + 1, 0))))
        fell(f"{len(alphas)}-alpha line search", res)
    del res, xs, u
    # the whole path at substeps=6, card vs CPU (phase 5's rule)
    small = dict(horizon=8, substeps=SUB6, iters=2,
                 weights=MPCWeights(w_ctrl=1.0))
    xs0, qs = tracking_problem(64, 8, seed=14, reach=0.02)
    rk = GraspMPC.from_scene(ASSET, device=dev, **small).track_batch(
        torch.from_numpy(xs0).to(dev), torch.from_numpy(qs).to(dev))
    rp = GraspMPC.from_scene(ASSET, device="cpu", **small).track_batch(
        torch.from_numpy(xs0), torch.from_numpy(qs))
    log(f"  track_batch at substeps={SUB6}, B=64 H=8 iters=2 w_ctrl=1, "
        "kernels vs plain (CPU)")
    check("track_batch (6 substeps)", float(
        ((rk.cost.cpu() - rp.cost).abs() / rp.cost.abs()).max()), 1e-3,
        "max |dcost|/cost")
    check("track_batch (6 substeps)", float(
        (rk.us.cpu() - rp.us).abs().max()), 5e-2, "max |du|")

    # 13b. the reacher at full width: IK, then 500 masked PID steps
    rhost = compile_file(REACHER)
    renv = ReacherEnv(rhost, device=dev)
    es = renv.reset(torch.Generator(device=dev).manual_seed(13), REACH_B)
    (esr, info), wall, n = counted(
        wrappers, lambda: renv.reach_ik(es, max_steps=REACH_STEPS))
    finite("reach_ik", esr.sim.qpos, info["dist"])
    conv = float(info["converged"].float().mean())
    log(f"reacher (ReacherEnv.reach_ik) B={REACH_B}, {REACH_STEPS} steps, "
        f"ncon=0 ({smi}): {wall:.2f} s, "
        f"{REACH_B * REACH_STEPS / wall:.0f} scenario-steps/s; IK ok "
        f"{float(info['ik_ok'].float().mean()):.1%}, converged {conv:.1%}, "
        f"median distance {float(info['dist'].median()):.4f} m (converged: "
        f"{float(info['dist'][info['converged']].median()):.4f} m)")
    expect("reach_ik (contact-free: no collide kernel)", n, {})
    # the first scenarios that converged during the loop (not at step 0,
    # as where the IK failed and the setpoints stay home) and the first
    # that did not, against the CPU: the masked freeze and the per-scenario
    # step count on both sides of it
    cv = (info["converged"] & (info["steps"] > 0)).nonzero().flatten()[
        :REACH_CHECK]
    nc = (~info["converged"]).nonzero().flatten()[:REACH_CHECK]
    if len(cv) < REACH_CHECK or len(nc) < REACH_CHECK:
        raise AssertionError("reach_ik: too few converged or unconverged "
                             "scenarios to compare")
    idx = torch.cat([cv, nc])
    esk = tree_map(lambda t: t[idx].cpu(), es)
    t0 = time.perf_counter()
    esc, infoc = ReacherEnv(rhost, device="cpu").reach_ik(
        esk, max_steps=REACH_STEPS)
    log(f"  scenarios {idx.tolist()} (converged, then not) on the CPU's "
        f"plain path: {time.perf_counter() - t0:.1f} s; steps card "
        f"{info['steps'][idx].tolist()}, CPU {infoc['steps'].tolist()}")
    for key in ("ik_ok", "converged"):
        if not torch.equal(info[key][idx].cpu(), infoc[key]):
            raise AssertionError(f"reach_ik {key} differs card vs CPU")
    check("reach_ik", float((info["steps"][idx].cpu()
                             - infoc["steps"]).abs().max()),
          REACH_TOL["steps"], "max |steps card - steps CPU|")
    check("reach_ik", float((esr.sim.qpos[idx].cpu()
                             - esc.sim.qpos).abs().max()),
          REACH_TOL["qpos"], "max |qpos card - qpos CPU|")
    check("reach_ik", float((info["dist"][idx].cpu()
                             - infoc["dist"]).abs().max()),
          REACH_TOL["dist"], "max |dist card - dist CPU|")
    del es, esr, info

    # 13c. what the gym wrapper runs: GraspEnv at B=1 and the side capture
    ohost = compile_file(OBJECTS)
    genv = GraspEnv(ohost, ncon=NCON, iterations=GYM_ITERS,
                    image_width=IMAGE, image_height=IMAGE,
                    budget_scale=GYM_SCALE, device=dev)
    gen = torch.Generator(device=dev).manual_seed(13)
    es, w_reset, n = counted(wrappers, lambda: genv.reset(gen, 1))
    settle = genv._ms_steps(1000.0 * GYM_SCALE)
    expect("reset", n, {**{c: settle for c in OBJ_COLLIDE}, "raycast": 1})
    act = closest_pixels(es.depth)
    (es1, rew, _, inf), w_step, n = counted(wrappers,
                                            lambda: genv.step(es, act))
    steps = sum(genv._phase_budgets())
    expect("step", n, {**{c: steps for c in OBJ_COLLIDE}, "raycast": 1})
    finite("the env at B=1", es1.sim.qpos, es1.depth)
    log(f"gym wrapper's path (GraspEnv, B=1, {IMAGE} x {IMAGE}, "
        f"budget_scale={GYM_SCALE}, iterations={GYM_ITERS}) ({smi}): reset "
        f"{w_reset:.2f} s ({settle} contact steps), step {w_step:.2f} s "
        f"({steps} contact steps), reward {float(rew[0])}, grasped "
        f"{bool(inf['grasped'][0])}")
    side = make_camera(genv.model, "side", SIDE, SIDE)
    kin = fk(genv.model, es1.sim.qpos)
    (rgb, _), wall, n = counted(
        wrappers, lambda: raycast.render_rgbd(genv.model, kin, side))
    expect(f"side capture {SIDE} x {SIDE}", n, {"raycast": 1})
    par, code, faces = raycast.geom_table(genv.model, kin, side)
    got = cuda_raycast.cast_rays(par, code, faces, side.dirs,
                                 raycast.render_tables(genv.model,
                                                       side).cull)
    want = cuda_raycast.cast_rays.plain(par, code, faces, side.dirs)
    equal = all(torch.equal(a, b) for a, b in zip(got, want))
    hit = float((want[0] < raycast.BIG / 2).float().mean())
    log(f"  side capture ({SIDE} x {SIDE}, render_rgbd): {wall * 1e3:.1f} ms;"
        f" {hit:.1%} of the rays hit; s*, geom id and normal equal to the "
        f"plain cast to the bit: {equal}")
    if not equal:
        raise AssertionError("the side capture's cast differs from plain")
    if rgb.shape != (1, SIDE, SIDE, 3):
        raise AssertionError(f"side capture shape {tuple(rgb.shape)}")
    log("  the gymnasium layer itself (GrasperEnv, gymnasium.make, the "
        "5-tuple) is held on the CPU only (tests/test_torch_gym_wrapper.py): "
        "this machine has no gymnasium")
    del got, want, es, es1, kin

    # 13d. parallel/ with one rank on NCCL (a local TCP store)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    if not initialize_multihost(f"127.0.0.1:{port}", 1, 0, device=dev):
        raise AssertionError("initialize_multihost did not start a group")
    try:
        mesh = make_mesh()
        log(f"parallel/ on one card: {dist.get_backend()} process group of "
            f"{dist.get_world_size()} rank, mesh "
            f"{dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))} ({smi}); "
            "one card shows one rank: the two-rank runs are held on the CPU "
            "with gloo (tests/test_torch_parallel.py)")
        # float64: the card's float32 train_step does not repeat to the
        # bit (atomics in its backward; the first AdamW step maps a
        # gradient entry near zero to +-lr), and its repeats part by 4.9e-5
        # to 6.8e-5 of a parameter's norm on an H100, beyond the 1e-6 limit
        cfg = AgentConfig(dtype="float32")
        agent = GraspAgent(cfg, device=dev)
        model0 = agent.init(torch.Generator().manual_seed(
            LEARN_SEED)).model.double()
        rng = np.random.default_rng(LEARN_SEED)
        nb = cfg.batch_size
        batch = (torch.from_numpy(rng.uniform(0, 1, (
            nb, cfg.height, cfg.width, 4))).to(dev),
            torch.from_numpy(rng.integers(0, agent.n_actions, nb)).to(dev),
            torch.from_numpy((rng.uniform(size=nb) > 0.5).astype(
                np.float32)).to(dev))

        def rel(a, b):
            return float((a - b).norm() / b.norm().clamp_min(1e-300))

        def held(model, name):
            """The parameter ``name``: the tensor the optimizer steps (where
            the tensor-parallel placement parametrizes it, the placed
            original) and its value as its layer reads it."""
            mod_name, _, leaf = name.rpartition(".")
            mod = model.get_submodule(mod_name)
            plist = getattr(getattr(mod, "parametrizations", None), leaf,
                            None)
            return (mod._parameters[leaf] if plist is None
                    else plist.original), getattr(mod, leaf)

        def whole(t):
            return t.full_tensor() if hasattr(t, "full_tensor") else t

        def errors(ts, loss):
            """Loss (relative), parameters, gradients and BatchNorm
            statistics (each of its tensor's norm) against ``ref``."""
            got = {k: held(ts.model, k) for k in rp}
            return {
                "loss": abs(float(loss) - float(l_ref)) / abs(float(l_ref)),
                "parameters": max(rel(v.detach(), rp[k].detach())
                                  for k, (_, v) in got.items()),
                "gradients": max(rel(whole(p.grad), rp[k].grad)
                                 for k, (p, _) in got.items()),
                "BatchNorm statistics": max(
                    rel(b, rb[k]) for k, b in ts.model.named_buffers()
                    if b.is_floating_point())}

        ref, l_ref = agent.train_step(agent.state_for(copy.deepcopy(model0)),
                                      *batch)
        rp, rb = dict(ref.model.named_parameters()), dict(
            ref.model.named_buffers())
        dp = errors(*dp_train_step(agent, mesh)(
            agent.state_for(copy.deepcopy(model0)),
            *shard_batch(mesh, batch)))
        log(f"  dp_train_step, {cfg.height} x {cfg.width} x 4, batch {nb}, "
            "float64, vs train_step:")
        def what(k):
            return f"{k} error ({'relative' if k == 'loss' else 'of the norm'})"

        for k, v in dp.items():
            check("dp_train_step", v, DP_TOL, what(k))
        tp_mesh = make_mesh(data=1, model=1)
        sharded = [k for k, v in tp_param_shardings(tp_mesh, model0).items()
                   if "Shard" in repr(v[1])]
        tp = tp_place_train_state(agent, tp_mesh,
                                  agent.state_for(copy.deepcopy(model0)))
        tp = errors(*agent.train_step(tp, *batch))
        log(f"  tp_place_train_state on a 1 x 1 mesh: {len(sharded)} weights "
            "placed Shard(0) over 'model'; one train_step from it:")
        for k, v in tp.items():
            check("tp train_step", v, DP_TOL, what(k))
        del ref, agent, model0, batch
        denv = GraspEnv(ohost, ncon=NCON, iterations=GYM_ITERS,
                        image_width=IMAGE, image_height=IMAGE,
                        budget_scale=DP_SCALE, device=dev)

        def gen():
            return torch.Generator(device=dev).manual_seed(13)

        t0 = time.perf_counter()
        es_full = denv.reset(gen(), DP_ENVS)
        es_dp = dp_env_reset(denv, mesh)(gen(), DP_ENVS)
        act = closest_pixels(es_full.depth)
        st_full = denv.step(es_full, act)
        st_dp = dp_env_rollout(denv, mesh)(es_dp, act)
        def leaves(tree):
            out = []
            tree_map(out.append, tree)
            return out

        def same(a, b):
            la, lb = leaves(a), leaves(b)
            return len(la) == len(lb) and all(
                torch.equal(x, y) for x, y in zip(la, lb))

        same_reset, same_step = same(es_full, es_dp), same(st_full, st_dp)
        log(f"  dp_env_reset / dp_env_rollout, B={DP_ENVS}, budget_scale="
            f"{DP_SCALE}: {time.perf_counter() - t0:.1f} s; equal to "
            f"env.reset / env.step to the bit: {same_reset} / {same_step}")
        if not (same_reset and same_step):
            raise AssertionError("the sharded env differs from the env")
    finally:
        dist.destroy_process_group()

    # 13e. the controller walkthrough on the card
    buf = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp:
        with contextlib.redirect_stdout(buf):
            _, wall, n = counted(wrappers, lambda: example.main(
                ["--budget-scale", str(WALK_SCALE), "--device", dev,
                 "--skip-toss",
                 "--plot", os.path.join(tmp, "trajectory.png")]))
    lines = buf.getvalue().splitlines()
    log(f"walkthrough (examples/example.py --budget-scale {WALK_SCALE} "
        f"--skip-toss) "
        f"({smi}): "
        f"{wall:.1f} s, launches {({k: v for k, v in n.items() if v})}")
    for line in lines:
        if "->" in line or "plot" in line or line == "Finished.":
            log(f"  {line}")
    if not lines or lines[-1] != "Finished.":
        raise AssertionError("the walkthrough did not finish")


def timed_solves(mpc, xr0, targets, x0, q_refs, first=None,
                 lin_check=False) -> dict:
    """Phase 4's solves at the shapes of ``mpc`` (B=4096, H=64, substeps=8,
    iters=6): the cold reach solve (solve_batch_x), its warm 2-iteration
    re-solve, the cold track solve (track_batch) and its warm re-solve,
    each warm one from its cold solve's controls shifted by a knot. Each
    runs once through ``first(what, solve, launches)``, which returns the
    result and the call's wall seconds (phase 4 counts the launches and
    checks the result there; by default it only times the call), then is
    timed (median of 3 synchronised calls), and each cold one once more
    under torch.profiler (with ``lin_check``, also holding what its
    lin_fd_fast calls launched). Returns {what: ms per call}."""
    from mujoco_rl_ur5_tpu_torch import ASSET
    from mujoco_rl_ur5_tpu_torch.mpc.cuda_ilqr import ilqr_chain_batch

    def once(what, solve, launches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    first = first or once
    reach_cost, reach_quad, reach_term_quad, reach_kc = \
        mpc._reach_closures(targets)
    warm_mpc = type(mpc).from_scene(ASSET, horizon=H, substeps=SUBSTEPS,
                                    iters=2, device="cuda")
    cold = (1, ITERS + 1, ITERS, ITERS + 1)
    out = {}

    def run(what, solve, launches, cold_solve=False):
        res, first_s = first(what, solve, launches)
        out[what] = timed_ms(solve)
        log(f"  {what}: {out[what]:.1f} ms per call of {B} (first call "
            f"{first_s * 1e3:.1f} ms), {B / out[what] * 1e3:.1f} solves/s")
        if cold_solve:
            profile_solve(solve, lin_check)
        return torch.cat([res.us[:, 1:], res.us[:, -1:]], 1).contiguous()

    u_warm = run("cold reach solve", lambda: mpc.solve_batch_x(xr0, targets),
                 cold + (ITERS + 1,), True)
    run("warm reach re-solve", lambda: ilqr_chain_batch(
        mpc.plan, SUBSTEPS, reach_cost, reach_quad, reach_term_quad, xr0,
        u_warm, reach_kc, iters=2), (1, 3, 2, 3, 3))
    u_track = run("cold track solve", lambda: mpc.track_batch(x0, q_refs),
                  cold + (0,), True)
    run("warm track re-solve",
        lambda: warm_mpc.track_batch(x0, q_refs, u_init=u_track),
        (1, 3, 2, 3, 0))
    return out


def solve_times(root: str) -> int:
    """--solve-times: phase 4's timed solves (timed_solves) with the package
    of the checkout at ``root``."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import mujoco_rl_ur5_tpu_torch as port
    if os.path.dirname(os.path.dirname(os.path.abspath(port.__file__))) != root:
        raise RuntimeError(f"imported {port.__file__}, not the package at "
                           f"{root}")
    from mujoco_rl_ur5_tpu_torch import ASSET
    from mujoco_rl_ur5_tpu_torch.mpc.grasp_mpc import GraspMPC

    dev = torch.device("cuda")
    mpc = GraspMPC.from_scene(ASSET, horizon=H, substeps=SUBSTEPS,
                              iters=ITERS, device="cuda")
    log(f"solve times of {root}: built in {mpc.build_kernels():.1f} s")
    xr0, targets = (torch.from_numpy(a).to(dev)
                    for a in reach_problem(B, seed=2))
    x0, q_refs = (torch.from_numpy(a).to(dev)
                  for a in tracking_problem(B, H, seed=0))
    out = timed_solves(mpc, xr0, targets, x0, q_refs)
    log(f"solve times of {root} (ms per call of {B}, median of 3): "
        + ", ".join(f"{k} {v:.1f}" for k, v in out.items()))
    # the reach quadratization as the solver calls it, on the gravity
    # hold's rollout: X, g, U, r of every knot (CUDA events, 20 calls)
    from mujoco_rl_ur5_tpu_torch.physics import cuda_chain as cc
    u = mpc._hold_init(xr0)
    xs = cc.rollout_open(mpc.plan, SUBSTEPS, xr0, u)
    quad_ms = event_ms(
        lambda: mpc._reach_quad_batch_kernel(xs[:, :-1], u, targets), 20)
    log(f"reach quadratization of {root} (_reach_quad_batch_kernel, "
        f"B={B}, H={H}): {quad_ms:.4f} ms per call")
    return 0


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dump-settle", metavar="PATH", help="also write the "
                    "settle roll's four fastest scenarios (snapshots every 50 "
                    "steps, object speeds per step) to PATH (.npz)")
    ap.add_argument("--solve-times", metavar="ROOT", help="only time phase "
                    "4's cold and warm solves with the package of the "
                    "checkout at ROOT (for example an earlier tree unpacked "
                    "under build/), and exit")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs the port on an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if opts.solve_times:
        return solve_times(opts.solve_times)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mujoco_rl_ur5_tpu_torch import ASSET, _build
    from mujoco_rl_ur5_tpu_torch.mpc import cuda_lqr
    from mujoco_rl_ur5_tpu_torch.mpc.cuda_ilqr import ALPHAS, REG
    from mujoco_rl_ur5_tpu_torch.mpc.grasp_mpc import (
        EE_OFFSET, GraspMPC, MPCWeights,
    )
    from mujoco_rl_ur5_tpu_torch.physics import cuda_chain as cc

    clock = [time.perf_counter()] * 2

    def stamp(what):
        now = time.perf_counter()
        log(f"[{what}: {now - clock[1]:.1f} s; run {now - clock[0]:.1f} s]")
        clock[1] = now

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    sm_mhz = int(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    log(f"device: {kind} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | largest SM clock {sm_mhz} MHz")
    dev = torch.device("cuda")

    # 2. build
    mpc = GraspMPC.from_scene(ASSET, horizon=H, substeps=SUBSTEPS,
                              iters=ITERS, device="cuda")
    from mujoco_rl_ur5_tpu_torch.physics import cuda_collide
    from mujoco_rl_ur5_tpu_torch.render import cuda_raycast
    # rollout_closed without fused costs (phases 3 and 13a) builds with the
    # rest
    srcs = (mpc.kernel_sources() + cuda_collide.kernel_sources()
            + cuda_raycast.kernel_sources()
            + [cc._closed_src(mpc.plan, None, 0, 0)])
    t0 = time.perf_counter()
    _build.build_many(srcs)
    log(f"build: {len(srcs)} units in {time.perf_counter() - t0:.1f} s")
    variants = {2: " (track costs)", 3: " (reach costs)",
                len(srcs) - 1: " (no costs)"}
    for i, src in enumerate(srcs):
        for line in _build.ptxas_report(src):
            log(f"  ptxas {src.name}{variants.get(i, '')}: {line}")
    # the redesigned kernels: resident blocks per SM (the card's occupancy
    # calculator), threads and shared memory per block (the hull kernels'
    # and the ray cast's at the object pile's table sizes)
    from mujoco_rl_ur5_tpu_torch import OBJECTS
    from mujoco_rl_ur5_tpu_torch.scene.compile import compile_file
    from mujoco_rl_ur5_tpu_torch.scene.mjcf import GEOM_MESH
    host = compile_file(OBJECTS)
    tables = tuple(host.hull_verts.shape[:2]) + (host.hull_fnorm.shape[1],)
    occ_args = {"lqr_backward": (), "chain_lin_fd": (),
                "chain_rollout_closed": (len(ALPHAS),),
                "chain_rollout_open": (), "chain_ee_quad_gn": (),
                "collide_hull_hull": tables, "collide_box_hull": tables,
                "collide_plane_hull": tables, "collide_sphere_hull": tables,
                "collide_capsule_hull": tables,
                "collide_box_box": (),
                "raycast": (host.topo.ngeom, host.hull_fnorm.shape[1],
                            int((host.topo.geom_type == GEOM_MESH).sum()))}
    for i, src in enumerate(srcs):
        if src.name not in occ_args:
            continue
        blocks, threads, smem = _build.occupancy(src, *occ_args[src.name])
        log(f"  occupancy {src.name}{variants.get(i, '')}: {blocks} resident "
            f"blocks of {threads} threads per SM, {smem} bytes of shared "
            f"memory per block")
    del host
    # no spill; and no stack frame for the six team collide kernels
    for what, src in (("lqr_backward", cuda_lqr.SOURCE),
                      *((k, cuda_collide.source(k))
                        for k in ("box_box", *cuda_collide.TEAM))):
        report = _build.ptxas_report(src)
        spills, stack = spill_bytes(report), stack_bytes(report)
        if spills or (what != "lqr_backward" and stack):
            raise AssertionError(f"{what} spills {spills} bytes, stack "
                                 f"{stack} bytes")
    stamp("phases 1-2")

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
    reach_cost, reach_quad, reach_term_quad, _ = mpc._reach_closures(targets)
    sub_ops = cc.substep_header(plan).ops["substep"]
    track_ops = cc.cost_header(mpc._k_track, plan.nv, nu, nx, nx).ops
    reach_ops = cc.cost_header(mpc._k_reach, plan.nv, nu, 0, 3).ops
    quad_cfg = (mpc.ee_slot, EE_OFFSET, w.w_ee_run, w.w_orient, w.w_posture,
                w.w_vel, mpc.home)
    quad_ops = cc.ee_quad_header(plan, *cc._quad_cfg(*quad_cfg)).ops["quad"]
    A = len(ALPHAS)
    table = {}

    def record(name, source, replaces, err, ms, plain_ms, ops, nbyte,
               dev_ms=None, earlier="", plain64=False):
        t_bytes = nbyte / PEAK_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_F32_FLOP_PER_S * 1e3
        table[name] = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": None, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}
        dev = ""
        if dev_ms is not None or earlier:
            table[name]["device_ms"] = dev_ms
            dev = (" (device " + ("not measured" if dev_ms is None
                                  else f"{dev_ms:.3f} ms") + ")")
        log(f"  {name}: {ms:.3f} ms on the card{dev}, plain"
            f"{' (float64)' if plain64 else ''} {plain_ms:.1f} ms, bound "
            f"{max(t_bytes, t_ops):.4f} ms ({ops:.3e} ops, {nbyte:.3e} "
            f"bytes){earlier}")

    def repeats(name, fn, first):
        """The kernel gives the same outputs to the bit when called again on
        the same inputs."""
        again = fn()
        same = all(torch.equal(a, b) for a, b in zip(first, again))
        log(f"  {name}: a second call on the same inputs gives the same "
            f"outputs to the bit: {same}")
        if not same:
            raise AssertionError(f"{name} does not repeat to the bit")

    # 3. kernels against their plain versions, at the main paths' shapes.
    # The card contracts multiply-adds and has its own sinf/cosf, so a kernel
    # and its plain f32 version differ by their roundoff; lin_fd divides it
    # by eps=1e-3 and the line search feeds it back through gains of ~60.
    # The check, for each output on its own: against the plain version run in
    # float64 on the same inputs, the kernel's error is at most twice the
    # plain f32 version's (plus 1e-6 of the output's scale)
    log(f"kernels: B={B} H={H} substeps={SUBSTEPS}")

    # rollout_open, held by that rule at B=4096 (its plain version once, in
    # float64: OPEN_F32_ERR) and at a ragged B=509 (over H=8 knots: its
    # plain version is launch-bound, as rollout_closed's),
    # called twice (equal to the bit), timed with CUDA events and on the
    # device. Its latency floors: H x substeps dependent substeps of the
    # critical path's levels, at OP_CYCLES per arithmetic level and
    # EX_CYCLES per exchange (shuffle, or shared-memory round trip), at the
    # card's largest SM clock: the one-thread substep's depth from the
    # emitter (chain_substep.cuh; a floor for the function), and the team
    # design's from a hand count (cc.team_depth: a floor for this design)
    rb = (x0[:509], u_hold[:509, :8].contiguous())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = {B: cc.rollout_open_plain(plan, SUBSTEPS, *f64(x0, u_hold))}
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    plain = {B: ref[B], 509: cc.rollout_open_plain(plan, SUBSTEPS, *rb)}
    ref[509] = cc.rollout_open_plain(plan, SUBSTEPS, *f64(*rb))
    arith, exch = cc.team_depth(plan)
    levels = cc.substep_header(plan).ops["depth"]
    floor = H * SUBSTEPS * levels * OP_CYCLES / (sm_mhz * 1e3)
    team_floor = (H * SUBSTEPS * (arith * OP_CYCLES + exch * EX_CYCLES)
                  / (sm_mhz * 1e3))
    log(f"  rollout_open latency floors at {sm_mhz} MHz, {OP_CYCLES} cycles "
        f"per arithmetic level and {EX_CYCLES} per exchange: one thread "
        f"{levels} levels per substep, {floor:.4f} ms; this team design "
        f"(hand-counted) {arith} levels and {exch} exchanges, "
        f"{team_floor:.4f} ms")

    def run_open(*a):
        return cc.rollout_open(plan, SUBSTEPS, *(a or (x0, u_hold)))

    xs = run_open()
    for bb, got in ((B, xs), (509, run_open(*rb))):
        r = ref[bb]
        ek = float((got.double() - r).abs().max() / r.abs().max())
        ep = (OPEN_F32_ERR[0] if bb == B else
              float((plain[bb].double() - r).abs().max() / r.abs().max()))
        d = float((got.double() - plain[bb]).abs().max())
        log(f"  rollout_open xs, B={bb}, H={got.shape[1] - 1}: max |kernel "
            f"- plain{' (float64)' if bb == B else ''}| {d:.3e}; "
            f"error vs float64: kernel {ek:.3e}, plain {ep:.3e}"
            + (" (measured on these inputs)" if bb == B else ""))
        check(f"rollout_open xs, B={bb}", ek, 2 * ep + 1e-6,
              "kernel error vs float64")
        if bb == B:
            diff = d
    repeats("rollout_open", lambda: (run_open(),), (xs,))
    ms = event_ms(run_open, 10)
    dev_ms = device_ms(run_open, "rollout_open_kernel")
    log(f"  rollout_open (team of {cc.OPEN_TEAM}): {ms:.3f} ms per call, "
        "device " + ("not measured" if dev_ms is None else f"{dev_ms:.3f} ms")
        + f", {(dev_ms or ms) / floor:.1f}x the one-thread latency floor")
    record("rollout_open", "mujoco_rl_ur5_tpu_torch/csrc/chain_rollout_open.cu",
           "mujoco_rl_ur5_tpu/physics/pallas_chain.py:530", diff, ms,
           plain_ms, B * H * SUBSTEPS * sub_ops, nbytes(x0, u_hold, xs),
           dev_ms, "; the one-thread kernel before this design, "
           "batch-fastest with its transposes: 2.488 ms per call (device "
           "2.428)", plain64=True)
    del plain, ref, rb

    xk, uk = xs[:, :-1].contiguous(), u_hold
    # lin_fd: the full-knot differences (the kernel with its composition
    # off), over one substep at full size, over all substeps at a ragged
    # batch from the solver's strided view of its states
    lin = cc.lin_fd(plan, 1, xk, uk)
    compare("lin_fd (one substep)", ("F", "L"), lin,
            lambda *a: cc.lin_fd_plain(plan, 1, *(a or (xk, uk))),
            f64(xk, uk))
    del lin
    rb = (xs[:509, :-1], uk[:509])
    compare(f"lin_fd (B=509, {SUBSTEPS} substeps)", ("F", "L"),
            cc.lin_fd(plan, SUBSTEPS, *rb),
            lambda *a: cc.lin_fd_plain(plan, SUBSTEPS, *(a or rb)), f64(*rb))

    # lin_fd_fast, as the solver calls it: one launch that differences one
    # substep and composes the knot's F = A^s, L = (I + ... + A^{s-1}) Bm
    def fast(*a):
        return cc.lin_fd_fast(plan, SUBSTEPS, *(a or (xs[:, :-1], uk)))

    F, L = fast()
    diff, plain_ms = compare(
        "lin_fd_fast", ("F", "L"), (F, L),
        lambda *a: cc.lin_fd_fast_plain(plan, SUBSTEPS, *(a or (xk, uk))),
        f64(xk, uk))
    repeats("lin_fd_fast", fast, (F, L))
    r509 = fast(*rb)
    compare("lin_fd_fast (B=509)", ("F", "L"), r509,
            lambda *a: cc.lin_fd_fast_plain(plan, SUBSTEPS, *(a or rb)),
            f64(*rb))
    repeats("lin_fd_fast (B=509)", lambda: fast(*rb), r509)
    del r509, rb
    launched = device_kernels(fast)
    log(f"  lin_fd_fast launches on the card, one call: {launched}")
    if len(launched) != 1 or "lin_fd_kernel" not in next(iter(launched)):
        raise AssertionError("lin_fd_fast launched more than its kernel")
    one_ms = event_ms(lambda: cc.lin_fd(plan, 1, xk, uk), 10)
    unfused_ms = event_ms(lambda: cc.compose_substeps(
        *cc.lin_fd(plan, 1, xk, uk), SUBSTEPS), 10)
    rounds = SUBSTEPS.bit_length() - 1
    record("lin_fd", "mujoco_rl_ur5_tpu_torch/csrc/chain_lin_fd.cu",
           "mujoco_rl_ur5_tpu/physics/pallas_chain.py:759", diff,
           event_ms(fast, 10), plain_ms,
           B * H * ((nx + nu + 1) * sub_ops + (nx + nu) * nx * 2
                    + (2 * rounds - 1) * nx ** 3 * 2 + nx * nx * nu * 2),
           nbytes(xk, uk, F, L), device_ms(fast, "lin_fd_kernel"),
           f"; in this call the kernel at one substep without its "
           f"composition {one_ms:.3f} ms, and with the composition after it "
           f"in torch (the design before) {unfused_ms:.3f} ms; the kernel "
           f"before this design (PERF.md): 1.637 ms per call (device "
           f"0.896) plus 5.3 ms of cuBLAS gemm for the composition")

    X, q, U, r = mpc._track_quad(xk, uk, refs)
    XH, qH = mpc._track_term_quad(xs[:, -1], term_ref)
    reg = torch.full((B,), REG, device=dev)
    # at full size and contiguous, as the solver hands them over
    bargs = tuple(t.contiguous() for t in (F, L, X, q, U, r, XH, qH)) + (reg,)
    g = cuda_lqr.backward(*bargs)
    diff, plain_ms = compare(
        "backward", ("K", "d", "S", "s"), g,
        lambda *a: cuda_lqr.backward_plain(*(a or bargs)),
        f64(*bargs))
    repeats("backward", lambda: cuda_lqr.backward(*bargs), g)
    # a ragged batch (509: no multiple of the 8 scenarios of a block)
    rb = tuple(t[:509].contiguous() for t in bargs)
    compare("backward (B=509)", ("K", "d", "S", "s"), cuda_lqr.backward(*rb),
            lambda *a: cuda_lqr.backward_plain(*(a or rb)), f64(*rb))
    del rb
    record("backward", "mujoco_rl_ur5_tpu_torch/csrc/lqr_backward.cu",
           "mujoco_rl_ur5_tpu/mpc/pallas_lqr.py:90", diff,
           event_ms(lambda: cuda_lqr.backward(*bargs), 10), plain_ms,
           B * H * backward_flops(nx, nu), nbytes(*bargs, *g),
           device_ms(lambda: cuda_lqr.backward(*bargs),
                     "riccati_backward_kernel"),
           "; the one-thread-per-scenario kernel before it: 10.380 ms per "
           "call (device 8.51)")

    law_ops = nu * (2 + 3 * nx) + 2 * nu

    def closed(name, cost, total, cost_ops, x_0, xbar, ubar, gains, s_ref,
               t_ref, f32_err, no_cost=False):
        """Hold rollout_closed with one fused cost pair against its plain
        version, and its fused costs against ``total``, the plain cost in
        float64 of the candidates the kernel itself returned (which takes the
        rollout's sensitivity out of the cost's check: 2e-5 relative, f32
        roundoff over H+1 terms); with ``no_cost``, rollout_closed without
        fused costs too, against the same plain runs' xs and us. Returns
        (difference, kernel ms, plain ms, ops, bytes)."""
        ckw = dict(cost=cost, sref=s_ref, tref=t_ref)
        ckw64 = dict(cost=cost, sref=None if s_ref is None else s_ref.double(),
                     tref=t_ref.double())
        cargs = (x_0, xbar, ubar, gains.K, gains.d)

        def run():
            return cc.rollout_closed(plan, SUBSTEPS, *cargs, ALPHAS, **ckw)

        def run_bare():
            return cc.rollout_closed(plan, SUBSTEPS, *cargs, ALPHAS)
        out = run()
        also = ()
        if no_cost:
            bare = run_bare()
            if len(bare) != 2:
                raise AssertionError("rollout_closed without costs returned "
                                     "costs")
            also = (("rollout_closed (no costs)", bare),)
        diff, plain_ms = compare(
            name, ("xs", "us", "costs"), out,
            lambda *a: (cc.rollout_closed_plain(plan, SUBSTEPS, *a, ALPHAS,
                                                **ckw64) if a else
                        cc.rollout_closed_plain(plan, SUBSTEPS, *cargs, ALPHAS,
                                                **ckw)),
            f64(*cargs), also, f32_err)
        if no_cost:
            repeats("rollout_closed (no costs)", run_bare, bare)
            log(f"  rollout_closed without costs, {A} alphas, B={B} H={H}: "
                f"{event_ms(run_bare, 5):.3f} ms per call")
            del bare
        want = torch.stack([total(out[0][:, a].double(), out[1][:, a].double())
                            for a in range(A)], 1)
        check(f"{name} costs", float(((out[2] - want) / want).abs().max()),
              2e-5, "max relative error vs the plain cost of its own xs, us")
        repeats(name, run, out)
        # a ragged batch (509: 15 blocks of 32 scenarios and one of 29) over
        # the first 8 knots
        rargs = (x_0[:509].contiguous(), xbar[:509, :Hr + 1].contiguous(),
                 *(t[:509, :Hr].contiguous()
                   for t in (ubar, gains.K, gains.d)))
        rkw = dict(cost=cost, tref=t_ref[:509].contiguous(),
                   sref=None if s_ref is None
                   else s_ref[:509, :Hr].contiguous())
        rkw64 = dict(cost=cost, tref=rkw["tref"].double(),
                     sref=None if s_ref is None else rkw["sref"].double())
        compare(f"{name} (B=509, H={Hr})", ("xs", "us", "costs"),
                cc.rollout_closed(plan, SUBSTEPS, *rargs, ALPHAS, **rkw),
                lambda *a: cc.rollout_closed_plain(
                    plan, SUBSTEPS, *(a or rargs), ALPHAS,
                    **(rkw64 if a else rkw)), f64(*rargs))
        ms, dev_ms = event_ms(run, 5), device_ms(run, "rollout_closed_kernel")
        ops = A * B * (H * (SUBSTEPS * sub_ops + law_ops + cost_ops["stage"])
                       + cost_ops["term"])
        ins = [t for t in (x_0, xbar[:, :H], ubar, gains.K, gains.d, s_ref,
                           t_ref) if t is not None]
        return diff, ms, plain_ms, ops, nbytes(*ins, *out), dev_ms

    Hr = 8
    diff, ms, plain_ms, ops, nbyte, dev_ms = closed(
        "rollout_closed (track costs)", mpc._k_track,
        lambda xa, ua: (mpc._track_stage(xa[:, :-1], ua, refs).sum(-1)
                        + mpc._track_term(xa[:, -1], term_ref)),
        track_ops, x0, xs, u_hold, g, sref, tref, CLOSED_F32_ERR["track"],
        no_cost=True)
    log(f"  rollout_closed (track costs): {ms:.3f} ms on the card (device "
        + ("not measured" if dev_ms is None else f"{dev_ms:.3f} ms")
        + f"), plain (float64) {plain_ms:.1f} ms, bound "
        f"{max(ops / PEAK_F32_FLOP_PER_S, nbyte / PEAK_BYTES_PER_S) * 1e3:.4f}"
        f" ms ({ops:.3e} ops, {nbyte:.3e} bytes); the batch-fastest kernel "
        "before it: 3.413 ms per call (device 2.66)")
    del g, F, L, X, U, xk, xs

    # the reach path's two: ee_quad_gn, and rollout_closed with the reach
    # costs (an FK inside every stage cost). ee_quad_gn writes the solver's
    # full stage blocks from its strided view of the states (xs[:, :-1]):
    # held whole by phase 3's rule, with exact zeros off the blocks and
    # w_vel on the velocity diagonal, at B=4096 and at a ragged B=509
    # (no multiple of a block's 128 instances), twice to the bit, and one
    # call must launch nothing but its kernel
    xs = cc.rollout_open(plan, SUBSTEPS, xr0, ur_hold)
    xk, uk = xs[:, :-1], ur_hold

    def quad(*a):
        return cc.ee_quad_gn(plan, *quad_cfg, *(a or (xk, targets)))

    def exact_blocks(what, X, g, x):
        vel = torch.zeros(nq, nq, device=dev)
        vel.diagonal()[:] = w.w_vel
        ok = (not bool(X[..., :nq, nq:].any())
              and not bool(X[..., nq:, :nq].any())
              and torch.equal(X[..., nq:, nq:], vel.expand_as(X[..., nq:,
                                                                nq:]))
              and torch.equal(g[..., nq:], w.w_vel * x[..., nq:]))
        log(f"  {what}: zeros off the blocks, w_vel on the velocity "
            f"diagonal and w_vel qd exact: {ok}")
        if not ok:
            raise AssertionError(f"{what}: the constant blocks are not exact")

    X, gq = quad()
    diff, plain_ms = compare(
        "ee_quad_gn", ("X", "g"), (X, gq),
        lambda *a: cc.ee_quad_gn_plain(plan, *quad_cfg, *(a or (xk, targets))),
        f64(xk, targets))
    exact_blocks("ee_quad_gn", X, gq, xk)
    repeats("ee_quad_gn", quad, (X, gq))
    rb = (xk[:509], targets[:509].contiguous())
    r509 = quad(*rb)
    compare("ee_quad_gn (B=509)", ("X", "g"), r509,
            lambda *a: cc.ee_quad_gn_plain(plan, *quad_cfg, *(a or rb)),
            f64(*rb))
    exact_blocks("ee_quad_gn (B=509)", *r509, rb[0])
    repeats("ee_quad_gn (B=509)", lambda: quad(*rb), r509)
    del r509, rb
    # one launch of its kernel per call, and no other kernel: over `reps`
    # calls the profiler must see ee_quad_gn_kernel alone, at most `reps`
    # times (it may drop the events of such short calls: 50 more calls
    # where it saw none), and the wrapper count one launch per call
    for reps in (10, 50):
        n0 = cc.ee_quad_gn.launches
        launched = device_kernels(quad, reps)
        counted = cc.ee_quad_gn.launches - n0 - 1    # past the warm-up call
        if launched:
            break
    log(f"  ee_quad_gn launches on the card, {reps} calls: {launched}; the "
        f"wrapper counted {counted}")
    if (len(launched) != 1 or "ee_quad_gn_kernel" not in next(iter(launched))
            or not 1 <= next(iter(launched.values())) <= reps
            or counted != reps):
        raise AssertionError("ee_quad_gn launched more than its kernel")
    # the bound without the assembly: the q half read, the Gauss-Newton
    # block and g's first nq entries written (the kernel before this design)
    bare = nbytes(xk[..., :nq], targets, X[..., :nq, :nq], gq[..., :nq])
    record("ee_quad_gn", "mujoco_rl_ur5_tpu_torch/csrc/chain_ee_quad_gn.cu",
           "mujoco_rl_ur5_tpu/physics/pallas_chain.py:885", diff,
           event_ms(quad, 10), plain_ms, B * H * quad_ops,
           nbytes(xk, targets, X, gq), device_ms(quad, "ee_quad_gn_kernel"),
           f"; bound without the assembly {bare / PEAK_BYTES_PER_S * 1e3:.4f}"
           " ms; the kernel before this design, batch-fastest with its "
           "transposes: 0.143 ms per call (device 0.0316)")
    quad_ms = event_ms(lambda: reach_quad(xk, uk), 10)
    log(f"  reach quadratization X (B,H,{nx},{nx}), g, U, r "
        f"(_reach_quad_batch_kernel: ee_quad_gn, U's expand and w_ctrl us):"
        f" {quad_ms:.3f} ms, of which around the kernel "
        f"{quad_ms - table['ee_quad_gn']['ms']:.3f} ms")
    del X, gq

    F, L = cc.lin_fd_fast(plan, SUBSTEPS, xk, uk)
    X, q, U, r = reach_quad(xk, uk)
    XH, qH = reach_term_quad(xs[:, -1])
    g = cuda_lqr.backward(*(t.contiguous() for t in (F, L, X, q, U, r, XH,
                                                     qH)), reg)
    del F, L, X, U
    diff, ms, plain_ms, ops, nbyte, dev_ms = closed(
        "rollout_closed (reach costs)", mpc._k_reach, reach_cost, reach_ops,
        xr0, xs, ur_hold, g, None, targets, CLOSED_F32_ERR["reach"])
    record("rollout_closed",
           "mujoco_rl_ur5_tpu_torch/csrc/chain_rollout_closed.cu",
           "mujoco_rl_ur5_tpu/physics/pallas_chain.py:579", diff, ms,
           plain_ms, ops, nbyte, dev_ms,
           "; the batch-fastest kernel before it: 3.486 ms per call "
           "(device 2.72)", plain64=True)
    del g, xk, xs

    stamp("phase 3")

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

    xs_hold = cc.rollout_open(plan, SUBSTEPS, xr0, ur_hold)
    start = {"reach": reach_cost(xs_hold, ur_hold)}

    def ee_err(x):
        return float((mpc.ee_pos(x[:, -1, :nq]) - targets).norm(dim=-1)
                     .median())

    hold_err = ee_err(xs_hold)
    xs_hold = cc.rollout_open(plan, SUBSTEPS, x0, u_hold)
    start["track"] = (mpc._track_stage(xs_hold[:, :-1], u_hold, refs).sum(-1)
                      + mpc._track_term(xs_hold[:, -1], term_ref))
    del xs_hold
    cold_cost = {}

    def first(what, solve, launches):
        """Phase 4's checks of each solve's first run."""
        res, wall, n = counted(what, solve, launches)
        path = what.split()[1]
        if what.startswith("cold"):
            if path == "reach":
                for name, c in zip(names, n):
                    table[name]["launches"] = c
                log(f"  end-effector error at the last knot, median: "
                    f"gravity hold {hold_err:.4f} m -> solved "
                    f"{ee_err(res.xs):.4f} m")
            fell(path, res.cost, start[path])
            cold_cost[path] = float(res.cost.median())
        else:
            log(f"  {what} cost median {float(res.cost.median()):.3f} vs "
                f"cold {cold_cost[path]:.3f}")
        return res, wall

    log(f"main paths (reach: solve_batch_x, track: track_batch) B={B} H={H} "
        f"substeps={SUBSTEPS} iters={ITERS}")
    timed_solves(mpc, xr0, targets, x0, q_refs, first, lin_check=True)

    stamp("phase 4")

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

    stamp("phases 5-6")

    # 7-8. the contact step
    contact_step(log, opts.dump_settle)
    stamp("phases 7-8")

    # 9. the object pile, every collide kernel
    rows, obj_model, settled = object_pile(log)
    table.update(rows)
    stamp("phase 9")

    # 10. its RGB-D observation
    table["raycast"] = observation(log, obj_model, settled)
    stamp("phase 10")
    del obj_model, settled

    # 11. the grasping environment and the MPC pick policy
    grasp_env(log, smi)
    stamp("phase 11")

    # 12. the learning path
    learning(log, smi)
    stamp("phase 12")

    # 13. the last modules: the repaired solver, the reacher, the gym
    # wrapper's path, parallel/ and the walkthrough
    last_modules(log, smi)
    stamp("phase 13")

    print(json.dumps({"kernels": [table[name] for name in
                                  names + OBJ_COLLIDE + ("raycast",)]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
