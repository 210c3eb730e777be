"""Find where a scenario of the port's grasping environment goes non-finite
on the card, and witness that contact step on other routes.

    python scripts/torch_env_witness.py [--batch 64] [--seed 64]
        [--scenario 0] [--out build/witness]

Runs ``chip_smoke.py`` phase 11d's pick (bench_env's quick scale:
budget_scale=0.1, iterations=30, ncon=128, 200 x 200; the draw from a CUDA
generator seeded with ``--seed``; each scenario's closest pixel) with every
call of ``dynamics.step_warm`` recorded for one scenario. It reports the
first contact step whose result is non-finite, the scenario's speeds
before it, and that step again from the same input on the card at B=1
(kernels), on the card with every collide kernel replaced by its plain
version, and on the CPU; then the whole pick again with the plain
collide versions on the card, compared step by step. It writes the
scenario's settled state, action and the inputs of the steps before the
fault to ``<out>/witness.pt`` for a replay on the CPU
(``tests/``-style: the port's plain path, or the JAX package's dynamics).
Needs one NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

KEEP = 40          # inputs kept before the first non-finite step


def log(msg: str) -> None:
    print(msg, flush=True)


def row(x, s):
    return x[s:s + 1].clone()


def finite(*ts) -> bool:
    return all(bool(torch.isfinite(t).all()) for t in ts)


class Recorder:
    """Wraps dynamics.step_warm: keeps scenario ``s``'s input of every call
    (state and warm start) and its output's finiteness and speed."""

    def __init__(self, step_warm, s: int):
        self.inner, self.s = step_warm, s
        self.inputs, self.stats = [], []

    def __call__(self, model, state, warm, ncon=0, iterations=30):
        s = self.s
        self.inputs.append((
            [row(getattr(state, f), s) for f in ("qpos", "qvel", "ctrl",
                                                 "time")],
            None if warm is None else tuple(row(w, s) for w in warm)))
        out, warm2 = self.inner(model, state, warm, ncon=ncon,
                                iterations=iterations)
        self.stats.append(torch.stack([
            torch.isfinite(out.qpos[s]).all().float(),
            torch.isfinite(out.qvel[s]).all().float(),
            torch.isfinite(state.ctrl[s]).all().float(),
            state.qvel[s].abs().max(), out.qvel[s].abs().max()]))
        return out, warm2


def one_step(model, inp, ncon, iterations, dev):
    from mujoco_rl_ur5_tpu_torch.physics import dynamics
    from mujoco_rl_ur5_tpu_torch.scene.model import State

    (qpos, qvel, ctrl, t), warm = inp
    st = State(qpos=qpos.to(dev), qvel=qvel.to(dev), ctrl=ctrl.to(dev),
               time=t.to(dev))
    w = None if warm is None else tuple(x.to(dev) for x in warm)
    return dynamics.step_warm(model.to(dev), st, w, ncon=ncon,
                              iterations=iterations)


class PlainCollide:
    """Every collide wrapper of the contact step replaced by its plain
    version (on CUDA tensors too) while the context is open."""

    def __enter__(self):
        from mujoco_rl_ur5_tpu_torch.physics import cuda_collide
        self.saved = dict(cuda_collide.BATCHED)
        for k, w in self.saved.items():
            cuda_collide.BATCHED[k] = w.plain
        return self

    def __exit__(self, *exc):
        from mujoco_rl_ur5_tpu_torch.physics import cuda_collide
        cuda_collide.BATCHED.update(self.saved)


def run_pick(env, es, acts, s):
    from mujoco_rl_ur5_tpu_torch.physics import dynamics

    rec = Recorder(dynamics.step_warm, s)
    dynamics.step_warm = rec
    try:
        t0 = time.perf_counter()
        es2, rew, _, info = env.step(es, acts)
        if es2.sim.qpos.is_cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        dynamics.step_warm = rec.inner
    return rec, es2, rew, wall


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seed", type=int, default=64)
    ap.add_argument("--scenario", type=int, default=0)
    ap.add_argument("--out", default="build/witness")
    ap.add_argument("--device", default="cuda", help="cpu: a dry run of "
                    "the script on the plain path")
    ap.add_argument("--scale", type=float, default=0.1)
    a = ap.parse_args()
    dev = a.device
    if dev == "cuda" and not torch.cuda.is_available():
        print("torch_env_witness: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from mujoco_rl_ur5_tpu_torch import OBJECTS
    from mujoco_rl_ur5_tpu_torch.env import GraspEnv
    from mujoco_rl_ur5_tpu_torch.scene.compile import compile_file

    kw = dict(ncon=128, iterations=30, image_width=200, image_height=200,
              budget_scale=a.scale)
    s, B = a.scenario, a.batch
    host = compile_file(OBJECTS)
    env = GraspEnv(host, device=dev, **kw)
    budgets = env._phase_budgets()
    gen = torch.Generator(device=dev).manual_seed(a.seed)
    drawn = env._draw(gen, B)
    es = env._settle(drawn)
    pix = es.depth.reshape(B, -1).argmin(1).cpu()
    acts = torch.stack([pix, torch.arange(B) % 6], 1).to(dev)
    log(f"B={B} seed={a.seed}: settled; scenario {s}: action "
        f"{acts[s].tolist()}, settled state finite "
        f"{finite(es.sim.qpos[s], es.sim.qvel[s])}")

    rec, es2, rew, wall = run_pick(env, es, acts, s)
    stats = torch.stack(rec.stats).cpu()
    lost = (~(torch.isfinite(es2.sim.qpos).all(1)
              & torch.isfinite(es2.sim.qvel).all(1))).nonzero().flatten()
    log(f"pick (kernels): {wall:.1f} s, {len(rec.stats)} contact steps; "
        f"non-finite scenarios at the end {lost.tolist()}")
    # the first call whose input is non-finite: the previous one's output
    # was taken
    bad_in = [k for k in range(len(rec.inputs))
              if not finite(*rec.inputs[k][0][:3])]
    bad_out = (stats[:, 0] * stats[:, 1] == 0).nonzero().flatten().tolist()
    log(f"scenario {s}: first step with a non-finite output "
        f"{bad_out[:1]}, first with a non-finite input {bad_in[:1]}")
    bounds = [sum(budgets[:p + 1]) for p in range(len(budgets))]
    save = dict(seed=a.seed, batch=B, scenario=s, kw=kw,
                drawn=row(drawn, s).cpu(), action=acts[s].cpu(),
                settled={f: row(getattr(es.sim, f), s).cpu()
                         for f in ("qpos", "qvel", "ctrl", "time")},
                ctl={"pid": {f: row(getattr(es.ctl.pid, f), s).cpu()
                             for f in es.ctl.pid.__dataclass_fields__},
                     "setpoints": row(es.ctl.setpoints, s).cpu(),
                     "params": {f: row(getattr(es.ctl.params, f), s).cpu()
                                for f in es.ctl.params.__dataclass_fields__}},
                stats=stats, budgets=budgets)
    if bad_in:
        k = bad_in[0] - 1
        phase = next(p for p, b in enumerate(bounds) if k < b)
        log(f"the fault: contact step {k} (phase {phase}, step "
            f"{k - (bounds[phase - 1] if phase else 0)} of {budgets[phase]})")
        lo = max(0, k - KEEP + 1)
        log("  step: max|qvel| in -> out, ctrl finite")
        for j in range(max(0, k - 12), k + 1):
            log(f"  {j}: {stats[j, 3]:.4g} -> {stats[j, 4]:.4g}, "
                f"{bool(stats[j, 2])}")
        inp = rec.inputs[k]
        save.update(fault_step=k, fault_phase=phase, first=lo,
                    inputs=[([x.cpu() for x in i[0]],
                             None if i[1] is None else
                             tuple(w.cpu() for w in i[1]))
                            for i in rec.inputs[lo:k + 1]])
        ncon, it = env.ctl.ncon, env.ctl.iterations
        for what, d, plain in (("card B=1, kernels", "cuda", False),
                               ("card B=1, plain collide", "cuda", True),
                               ("CPU B=1, plain", "cpu", True)):
            if d == "cuda" and dev != "cuda":
                continue
            with PlainCollide() if plain else contextlib.nullcontext():
                out, _ = one_step(env.model, inp, ncon, it, d)
            log(f"  step {k} again, {what}: finite "
                f"{finite(out.qpos, out.qvel)}, max|qvel| "
                f"{float(out.qvel.abs().max()):.4g}")
    del rec
    # the whole pick with the plain collide versions on the card
    with PlainCollide():
        rec_p, es2p, rewp, wall_p = run_pick(env, es, acts, s)
    stats_p = torch.stack(rec_p.stats).cpu()
    lost_p = (~(torch.isfinite(es2p.sim.qpos).all(1)
                & torch.isfinite(es2p.sim.qvel).all(1))).nonzero().flatten()
    def bits(x, y):
        return torch.allclose(x, y, rtol=0, atol=0, equal_nan=True)

    same = [bits(x, y) for x, y in ((es2p.sim.qpos, es2.sim.qpos),
                                    (es2p.sim.qvel, es2.sim.qvel))]
    fin = torch.isfinite(es2.sim.qpos) & torch.isfinite(es2p.sim.qpos)
    log(f"pick (plain collide on the card): {wall_p:.1f} s; non-finite "
        f"scenarios {lost_p.tolist()}; final qpos, qvel equal to the "
        f"kernels' to the bit (NaN equal to NaN): {same}; max |dqpos| where "
        f"both finite "
        f"{float((es2p.sim.qpos - es2.sim.qpos)[fin].abs().max()):.3e}; "
        f"rewards equal {torch.equal(rew, rewp)}; scenario {s}'s per-step "
        f"stats equal {bits(stats, stats_p)}")
    os.makedirs(a.out, exist_ok=True)
    torch.save(save, os.path.join(a.out, "witness.pt"))
    log(f"wrote {os.path.join(a.out, 'witness.pt')}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
