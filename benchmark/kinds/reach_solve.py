"""Cold batched reach solves: ``GraspMPC.solve_batch_x`` from the gravity
hold, one call per unit.

Traffic parameters: ``batch`` scenarios per call, ``iters`` solver
iterations, ``pool`` batches of seeded inputs (start states near home,
grasp-centre targets within 0.1 m of (0, -0.6, 1.0)) that the calls take
in turn, and ``check``: the ``rows`` of each call that are kept and the
``calls`` whose kept rows the reference solves after the window.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import arm
from benchmark.generators import reach_problem, rng
from benchmark.reference import THREADS, as_reference
from benchmark.verdict import sample, verdict


class Work:
    def __init__(self, cfg: dict, tr: dict, seed: int, device: str,
                 bench: str):
        self.cfg, self.tr, self.bench = cfg, tr, bench
        self.iters, B = tr["iters"], tr["batch"]
        gen = rng(seed, 1)
        pool = [reach_problem(B, gen) for _ in range(tr["pool"])]
        self.x0_np = np.stack([p[0] for p in pool])
        self.tg_np = np.stack([p[1] for p in pool])
        self.rows_np = np.sort(rng(seed, 2).choice(
            B, tr["check"]["rows"], replace=False))
        self.mpc = arm.planner(cfg, bench, self.iters, device)
        self.x0 = torch.from_numpy(self.x0_np).to(device)
        self.tg = torch.from_numpy(self.tg_np).to(device)
        self.rows = torch.from_numpy(self.rows_np).to(device)
        self.kept = []
        self.mpc.solve_batch_x(self.x0[0], self.tg[0])      # warm-up

    def call(self, i: int) -> None:
        p = i % len(self.x0)
        self.res = self.mpc.solve_batch_x(self.x0[p], self.tg[p])

    def keep(self, i: int) -> None:
        self.kept.append((i % len(self.x0), arm.rows_of(self.res, self.rows)))

    def free(self) -> None:
        self.kept = [(p, [t.cpu() for t in a]) for p, a in self.kept]
        del self.mpc, self.res, self.x0, self.tg

    def check(self, gen: np.random.Generator, control: bool = False):
        return verdict(self.numbers(gen, control), self.tr["limits"])

    def numbers(self, gen: np.random.Generator, control: bool = False):
        """{name: the number of each sampled item}, of the program's
        answers or, with ``control``, of the control's."""
        torch.set_num_threads(THREADS)
        calls = sample(gen, [k[0] for k in self.kept],
                       self.tr["check"]["calls"])
        pools = [self.kept[c][0] for c in calls]
        x0 = torch.cat([torch.from_numpy(self.x0_np[p, self.rows_np])
                        for p in pools]).double()
        tg = torch.cat([torch.from_numpy(self.tg_np[p, self.rows_np])
                        for p in pools]).double()
        ref = arm.reference(self.cfg, self.bench)
        with torch.inference_mode():
            if control:
                answers = arm.solve_as_control(
                    self.cfg, self.bench, lambda a, dt: a.reach(tg.to(dt)),
                    x0, None, self.iters)
            else:
                answers = [torch.cat([self.kept[c][1][j] for c in calls])
                           for j in range(3)]
            answers = as_reference(*answers)
            problem = ref.reach(tg)
            own = ref.solve(problem, x0, ref.hold(x0), self.iters)
            return arm.judge(ref, problem, x0, answers, own)
