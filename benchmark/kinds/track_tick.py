"""One receding-horizon tick per unit: a warm ``GraspMPC.track_batch`` with
``iters`` iterations from a shifted plan.

Set-up draws a ``pool`` of seeded tracking problems (start states near
home, straight joint-space references over the H+1 knots to postures near
home), solves each cold with ``cold_iters`` iterations, and shifts each
plan by one knot: the start becomes the plan's next state, the controls
and references move up one knot (the last repeated). Each call ticks the
next problem of the pool from its shifted plan.

The check covers the start and the tick apart (``arm.py``'s numbers). The
reference solves each sampled problem cold itself and is held against the
program's cold plans: ``start_states``, ``start_cost``, and ``start_plan``
as the median over the sampled rows (a few rows' cold solves land far
apart in float32 and float64 alike: see PERF.md). Then it rolls out the
tick's controls from the program's own shifted plan, as the window's call
started, and holds the tick's ``states`` and ``cost``; and it ticks that
shifted plan itself, as many iterations, to hold the tick's solver:

  stall  of the cost the reference's own tick takes off the shifted
         plan's, the share that the program's tick leaves on (the
         reference's costs of the three plans), the median over the rows
         whose reference tick lowers the cost: 0 where the program's tick
         does as well as the reference's, 1 where it returns its start.

``check`` names the ``rows`` kept and the ``calls`` compared.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import arm
from benchmark.generators import rng, tracking_problem
from benchmark.reference import THREADS, as_reference
from benchmark.verdict import sample, verdict

MEDIAN = ("start_plan", "stall")     # numbers taken as the median over rows


def shift(xs, us, q_refs):
    """A plan one knot on: (start, controls, references)."""
    return (xs[:, 1].contiguous(),
            torch.cat([us[:, 1:], us[:, -1:]], 1).contiguous(),
            torch.cat([q_refs[:, 1:], q_refs[:, -1:]], 1).contiguous())


class Work:
    def __init__(self, cfg: dict, tr: dict, seed: int, device: str,
                 bench: str):
        self.cfg, self.tr, self.bench = cfg, tr, bench
        B, H = tr["batch"], cfg["horizon"]
        gen = rng(seed, 1)
        pool = [tracking_problem(B, H, gen) for _ in range(tr["pool"])]
        self.x0_np = np.stack([p[0] for p in pool])
        self.qr_np = np.stack([p[1] for p in pool])
        self.rows_np = np.sort(rng(seed, 2).choice(
            B, tr["check"]["rows"], replace=False))
        self.rows = torch.from_numpy(self.rows_np).to(device)
        cold = arm.planner(cfg, bench, tr["cold_iters"], device)
        self.mpc = arm.sibling(cold, tr["iters"])
        self.ticks, self.start = [], []
        for x0, qr in zip(self.x0_np, self.qr_np):
            x0 = torch.from_numpy(x0).to(device)
            qr = torch.from_numpy(qr).to(device)
            res = cold.track_batch(x0, qr)
            self.start.append(arm.rows_of(res, self.rows))
            self.ticks.append(shift(res.xs, res.us, qr))
        del cold
        self.kept = []
        self.call(0)                                      # warm-up

    def call(self, i: int) -> None:
        x1, u1, q1 = self.ticks[i % len(self.ticks)]
        self.res = self.mpc.track_batch(x1, q1, u_init=u1)

    def keep(self, i: int) -> None:
        self.kept.append((i % len(self.ticks),
                          arm.rows_of(self.res, self.rows)))

    def free(self) -> None:
        self.kept = [(p, [t.cpu() for t in a]) for p, a in self.kept]
        self.start = [[t.cpu() for t in a] for a in self.start]
        del self.mpc, self.res, self.ticks

    def check(self, gen: np.random.Generator, control: bool = False):
        return verdict(self.numbers(gen, control), self.tr["limits"])

    def numbers(self, gen: np.random.Generator, control: bool = False):
        """{name: the number of each sampled row}, of the program's
        answers or, with ``control``, of the control's: the start's
        prefixed ``start_``; ``start_plan`` and ``stall`` as their medians
        over the rows (``stall`` over the rows whose reference tick lowers
        the cost, 0 where there are none: the start is then the tick's
        right answer)."""
        torch.set_num_threads(THREADS)
        calls = sample(gen, [k[0] for k in self.kept],
                       self.tr["check"]["calls"])
        pools = [self.kept[c][0] for c in calls]
        x0 = torch.cat([torch.from_numpy(self.x0_np[p, self.rows_np])
                        for p in pools]).double()
        qr = torch.cat([torch.from_numpy(self.qr_np[p, self.rows_np])
                        for p in pools]).double()
        ref = arm.reference(self.cfg, self.bench)
        cold_iters, iters = self.tr["cold_iters"], self.tr["iters"]
        with torch.inference_mode():
            if control:
                start = as_reference(*arm.solve_as_control(
                    self.cfg, self.bench, lambda a, dt: a.track(qr.to(dt)),
                    x0, None, cold_iters))
                x1, u1, q1 = shift(start[0], start[1], qr)
                tick = as_reference(*arm.solve_as_control(
                    self.cfg, self.bench, lambda a, dt: a.track(q1.to(dt)),
                    x1, u1, iters))
            else:
                start = as_reference(*[torch.cat([self.start[p][j]
                                                for p in pools])
                                     for j in range(3)])
                tick = as_reference(*[torch.cat([self.kept[c][1][j]
                                               for c in calls])
                                    for j in range(3)])
                x1, u1, q1 = shift(start[0], start[1], qr)
            problem = ref.track(qr)
            own = ref.solve(problem, x0, ref.hold(x0), cold_iters)
            first = arm.judge(ref, problem, x0, start, own)
            problem = ref.track(q1)
            then = arm.judge(ref, problem, x1, tick)
            own = ref.solve(problem, x1, u1, iters)
            c_start = problem[0](ref.rollout(x1, u1), u1)
            c_tick = problem[0](ref.rollout(x1, tick[1]), tick[1])
            gain = c_start - own.cost
            then["stall"] = torch.where(
                gain > 0, (c_tick - own.cost) / gain.clamp_min(1e-300),
                float("nan")).numpy()
        out = {**{"start_" + k: v for k, v in first.items()}, **then}
        for k in MEDIAN:
            v = out[k][~np.isnan(out[k])]
            out[k] = np.array([np.median(v) if len(v) else 0.0])
        return out
