#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py          (from the repository root; needs one GPU)

Phases, each printing its lines; any failure raises and exits non-zero:

  1. device: the card's name and power limit (nvidia-smi);
  2. build: the six build units of the batched solves from csrc/ (five
     kernels; rollout_closed once with the track costs and once with the
     reach costs), one nvcc per source, in parallel, with the build time and
     ptxas's register and spill report;
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
     the start's, wall time.

The last three lines are the kernel table as JSON, the card's name and power
limit, and the device line as JSON.
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


def main() -> int:
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
    build_s = mpc.build_kernels()
    srcs = mpc.kernel_sources()
    log(f"build: {len(srcs)} units in {build_s:.1f} s")
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

    print(json.dumps({"kernels": [table[name] for name in names]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
