#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py          (from the repository root; needs one GPU)

Phases, each printing its lines; any failure raises and exits non-zero:

  1. device: the card's name and power limit (nvidia-smi);
  2. build: every CUDA kernel of the main path from csrc/ (one nvcc per
     source, in parallel), with the build time and ptxas's register and
     spill report;
  3. kernels: each kernel's wrapper at the shapes the main path gives it
     (B=4096, H=64, substeps=8), held against its plain PyTorch version on
     the same inputs on the card, with the tolerance stated; each timed with
     CUDA events beside the plain version and its bound;
  4. main path: GraspMPC.track_batch at B=4096, H=64, substeps=8, iters=6
     on a seeded joint-space tracking problem, with every launch counter set
     to 0 just before and read just after (1 / 7 / 6 / 7 per cold solve);
     outputs finite, cost below the start's; the solve's wall time, and its
     device time by kernel under torch.profiler; then a warm 2-iteration
     re-solve from the shifted plan (1 / 3 / 2 / 3);
  5. whole path: track_batch at B=256, H=8, iters=2 through the kernels
     against the same solve on the CPU, where every wrapper takes its plain
     version.

The last two lines are the kernel table and the device line as JSON.
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
    for ms, count, key in rows[:12]:
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
    from mujoco_rl_ur5_tpu_torch.mpc.cuda_ilqr import ALPHAS, REG
    from mujoco_rl_ur5_tpu_torch.mpc.grasp_mpc import GraspMPC, MPCWeights
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
    log(f"build: {len(mpc.kernel_sources())} kernels in {build_s:.1f} s")
    for src in mpc.kernel_sources():
        for line in _build.ptxas_report(src):
            log(f"  ptxas {src.name}: {line}")

    plan, nx, nu = mpc.plan, mpc.nx, mpc.nu
    x0_np, q_refs_np = tracking_problem(B, H, seed=0)
    x0 = torch.from_numpy(x0_np).to(dev)
    q_refs = torch.from_numpy(q_refs_np).to(dev)
    qd_refs = torch.zeros_like(q_refs)
    refs = (q_refs[:, :-1], qd_refs[:, :-1])
    term_ref = (q_refs[:, -1], qd_refs[:, -1])
    sref = torch.cat(refs, -1).contiguous()
    tref = torch.cat(term_ref, -1).contiguous()
    u_hold = mpc.hold_ctrl(x0[:, :8])[:, None].expand(-1, H, -1).contiguous()
    sub_ops = cc.substep_header(plan).ops["substep"]
    cost_ops = cc.cost_header(mpc._k_track, plan.nv, nu, nx, nx).ops
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
            "library_ms": None, "ops": ops, "bytes": nbyte}
        log(f"  {name}: {ms:.3f} ms on the card, plain {plain_ms:.1f} ms, "
            f"bound {max(t_bytes, t_ops):.4f} ms "
            f"({ops:.3e} ops, {nbyte:.3e} bytes)")

    # 3. kernels against their plain versions, at the main path's shapes.
    # The card contracts multiply-adds and has its own sinf/cosf, so a kernel
    # and its plain f32 version differ by their roundoff; lin_fd divides it
    # by eps=1e-3 and the line search feeds it back through gains of ~60.
    # The check: against the plain version run in float64 on the same
    # inputs, the kernel's error is at most twice the plain f32 version's
    # (plus 1e-6 of the output's scale)
    log(f"kernels: B={B} H={H} substeps={SUBSTEPS}")

    def compare(name, kern, plain_fn, args64):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = plain_fn()
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        ref = plain_fn(*args64)
        ek = max(float((k.double() - r).abs().max() / r.abs().max())
                 for k, r in zip(kern, ref))
        ep = max(float((p.double() - r).abs().max() / r.abs().max())
                 for p, r in zip(plain, ref))
        diff = max(float((k - p).abs().max()) for k, p in zip(kern, plain))
        log(f"  {name}: max |kernel - plain| {diff:.3e}; error vs float64 "
            f"(max |d|/max|ref|): kernel {ek:.3e}, plain {ep:.3e}")
        check(name, ek, 2 * ep + 1e-6, "kernel error vs float64")
        return diff, plain_ms

    def f64(*ts):
        return [t.double() if torch.is_tensor(t) else t for t in ts]

    xs = cc.rollout_open(plan, SUBSTEPS, x0, u_hold)
    diff, plain_ms = compare(
        "rollout_open", (xs,),
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
        "lin_fd", lin, lambda *a: cc.lin_fd_plain(plan, 1, *(a or (xk, uk))),
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
        "backward", g, lambda *a: cuda_lqr.backward_plain(*(a or bargs)),
        f64(*bargs))
    record("backward", "mujoco_rl_ur5_tpu_torch/csrc/lqr_backward.cu",
           "mujoco_rl_ur5_tpu/mpc/pallas_lqr.py:90", diff,
           event_ms(lambda: cuda_lqr.backward(*bargs), 10), plain_ms,
           B * H * backward_flops(nx, nu),
           nbytes(F, L, q, r, XH, qH, reg, *g)
           + B * H * (nx * nx + nu * nu) * 4)      # X and U at full size

    ckw = dict(cost=mpc._k_track, sref=sref, tref=tref)
    cargs = (x0, xs, u_hold, g.K, g.d)
    out = cc.rollout_closed(plan, SUBSTEPS, *cargs, ALPHAS, **ckw)
    ckw64 = dict(cost=mpc._k_track, sref=sref.double(), tref=tref.double())
    diff, plain_ms = compare(
        "rollout_closed", out,
        lambda *a: (cc.rollout_closed_plain(plan, SUBSTEPS, *a, ALPHAS,
                                            **ckw64) if a else
                    cc.rollout_closed_plain(plan, SUBSTEPS, *cargs, ALPHAS,
                                            **ckw)),
        f64(*cargs))
    law_ops = nu * (2 + 3 * nx) + 2 * nu
    record("rollout_closed",
           "mujoco_rl_ur5_tpu_torch/csrc/chain_rollout_closed.cu",
           "mujoco_rl_ur5_tpu/physics/pallas_chain.py:579", diff,
           event_ms(lambda: cc.rollout_closed(plan, SUBSTEPS, *cargs, ALPHAS,
                                              **ckw), 5), plain_ms,
           A * B * (H * (SUBSTEPS * sub_ops + law_ops + cost_ops["stage"])
                    + cost_ops["term"]),
           nbytes(x0, xs[:, :H], u_hold, g.K, g.d, sref, tref, *out))
    del out, g, F, L, X, U, xk

    # 4. the main path at full width
    counters = (cc.rollout_open, cc.lin_fd, cc.rollout_closed,
                cuda_lqr.backward)

    def reset():
        for c in counters:
            c.launches = 0

    def counts():
        return tuple(c.launches for c in counters)

    def start_cost(u):
        x = cc.rollout_open(plan, SUBSTEPS, x0, u)
        return (mpc._track_stage(x[:, :-1], u, refs).sum(-1)
                + mpc._track_term(x[:, -1], term_ref))

    log(f"main path: track_batch B={B} H={H} substeps={SUBSTEPS} "
        f"iters={ITERS}")
    torch.cuda.synchronize()
    reset()
    t0 = time.perf_counter()
    res = mpc.track_batch(x0, q_refs)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    n = counts()
    log(f"  launches rollout_open/lin_fd/rollout_closed/backward = {n}")
    if n != (1, ITERS + 1, ITERS, ITERS + 1):
        raise AssertionError(f"cold solve launched {n}, expected "
                             f"{(1, ITERS + 1, ITERS, ITERS + 1)}")
    for name, c in zip(("rollout_open", "lin_fd", "rollout_closed",
                        "backward"), n):
        table[name]["launches"] = c
    for t in (res.xs, res.us, res.cost, *res.gains):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError("track_batch returned non-finite values")
    c0 = start_cost(u_hold)
    fell = float((res.cost < c0).float().mean())
    log(f"  cost: start median {float(c0.median()):.3f} -> solved median "
        f"{float(res.cost.median()):.3f}; fell in {fell:.1%} of scenarios")
    if not bool((res.cost <= c0).all()) or fell < 0.99:
        raise AssertionError("track_batch did not lower the cost")
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        mpc.track_batch(x0, q_refs)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    log(f"  cold solve: {wall * 1e3:.1f} ms per call of {B} "
        f"(first call {cold_s * 1e3:.1f} ms), {B / wall:.1f} solves/s")

    profile_solve(lambda: mpc.track_batch(x0, q_refs))

    warm_mpc = GraspMPC.from_scene(ASSET, horizon=H, substeps=SUBSTEPS,
                                   iters=2, device="cuda")
    u_warm = torch.cat([res.us[:, 1:], res.us[:, -1:]], 1).contiguous()
    reset()
    wres = warm_mpc.track_batch(x0, q_refs, u_init=u_warm)
    torch.cuda.synchronize()
    n = counts()
    log(f"  warm 2-iteration re-solve launches = {n}")
    if n != (1, 3, 2, 3):
        raise AssertionError(f"warm re-solve launched {n}")
    if not bool(torch.isfinite(wres.us).all()):
        raise AssertionError("warm re-solve returned non-finite controls")
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        warm_mpc.track_batch(x0, q_refs, u_init=u_warm)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    log(f"  warm re-solve: {wall * 1e3:.1f} ms per call, "
        f"{B / wall:.1f} solves/s; cost median "
        f"{float(wres.cost.median()):.3f} vs cold {float(res.cost.median()):.3f}")
    del res, wres

    # 5. the whole path through the kernels against the plain versions
    Bs, Hs, iters_s = 256, 8, 2
    log(f"whole path: track_batch B={Bs} H={Hs} substeps={SUBSTEPS} "
        f"iters={iters_s} w_ctrl=1, kernels vs plain (CPU)")
    xs0, qs = tracking_problem(Bs, Hs, seed=1, reach=0.02)
    small = dict(horizon=Hs, substeps=SUBSTEPS, iters=iters_s,
                 weights=MPCWeights(w_ctrl=1.0))
    rk = GraspMPC.from_scene(ASSET, device="cuda", **small).track_batch(
        torch.from_numpy(xs0).to(dev), torch.from_numpy(qs).to(dev))
    rp = GraspMPC.from_scene(ASSET, device="cpu", **small).track_batch(
        torch.from_numpy(xs0), torch.from_numpy(qs))
    # both solvers linearize by forward differences in f32 (see lin_fd).
    # At the default w_ctrl=1e-3 and a 128 ms horizon the solved controls
    # are barely determined (a 3e-7 rad change of x0 moves the cost by 2e-3
    # on the CPU); at w_ctrl=1 the same change moves the cost by 1.6e-4 and
    # the controls by 1e-2
    err = float(((rk.cost.cpu() - rp.cost).abs() / rp.cost.abs()).max())
    check("track_batch", err, 1e-3, "max |dcost|/cost")
    err = float((rk.us.cpu() - rp.us).abs().max())
    check("track_batch", err, 5e-2, "max |du|")

    kernels = [{k: v for k, v in table[name].items()
                if k not in ("ops", "bytes")}
               for name in ("rollout_open", "lin_fd", "rollout_closed",
                            "backward")]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
