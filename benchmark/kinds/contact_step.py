"""Contact steps of a pile: ``dynamics.step_warm`` over every scenario, one
step per unit.

Traffic parameters: ``batch`` scenarios, a ``pool`` of seeded drops that
are stepped in turn (``lift`` and ``lower``: see ``generators.drop_qpos``;
lowered so that the pile's bottom layer meets the bin floor within the
stretch), ``steps_per_drop`` steps of each before the next drop replaces
it (a reset: the warm start begins again at zero), so every run covers
the same stretch of the fall however fast the program is; the
configuration gives ``ncon`` and the solver's ``iterations``.

The contact step is chaotic, so the check follows the program step by
step: for a sample of the window's steps (``check.calls``) and of
scenarios (``check.rows``, kept every step) the reference steps from the
program's own state before that step and is held against the velocities
the program returned. The number, the largest over the sampled (step,
scenario) items:

  qacc    the velocity change's error over the step's largest velocity
          change: the step's acceleration, relative, through collide,
          assembly, the contact solver's net forces and the dynamics.

The returned warm start (facet forces) is not compared: a pyramidal cone
gives one contact force from other facet combinations, so the facets'
gap swings from seed to seed (PERF.md).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import pile
from benchmark.generators import rng
from benchmark.manifest import scene
from benchmark.reference import THREADS, as_reference
from benchmark.reference.precision import tf32
from benchmark.verdict import verdict


class Work:
    def __init__(self, cfg: dict, tr: dict, seed: int, device: str,
                 bench: str):
        from mujoco_rl_ur5_tpu_torch.physics import constraints, cuda_collide
        self.cfg, self.tr, self.bench = cfg, tr, bench
        B = tr["batch"]
        self.ncon, self.iters = cfg["ncon"], cfg["iterations"]
        self.spd = tr["steps_per_drop"]
        self.drops_np = pile.drops(cfg, bench, tr, seed)
        self.rows_np = np.sort(rng(seed, 2).choice(
            B, tr["check"]["rows"], replace=False))
        self.model = pile.program(cfg, bench, device,
                                  cuda_collide.kernel_sources())
        self.constraints = constraints
        self.drops = torch.from_numpy(self.drops_np).to(device)
        self.rows = torch.from_numpy(self.rows_np).to(device)
        self.kept = []
        self.state, self.warm = self.fresh(0)
        self.step()                                        # warm-up

    def fresh(self, p: int):
        from mujoco_rl_ur5_tpu_torch.scene.model import State
        t = self.model.topo
        q = self.drops[p].clone()
        z = q.new_zeros
        state = State(qpos=q, qvel=z(q.shape[0], t.nv), ctrl=z(q.shape[0],
                                                              t.nu),
                      time=z(q.shape[0]))
        return state, self.constraints.init_warm(self.model, state)

    def step(self):
        from mujoco_rl_ur5_tpu_torch.physics import dynamics
        self.state, self.warm = dynamics.step_warm(
            self.model, self.state, self.warm, self.ncon, self.iters)

    def call(self, i: int) -> None:
        if i % self.spd == 0:
            self.state, self.warm = self.fresh((i // self.spd)
                                               % len(self.drops))
        self.pre = (self.state, self.warm)
        self.step()

    def keep(self, i: int) -> None:
        r = self.rows
        s0, w0 = self.pre
        self.kept.append([s0.qpos[r], s0.qvel[r], w0[0][r], w0[1][r],
                          self.state.qvel[r]])

    def free(self) -> None:
        self.kept = [[t.cpu() for t in k] for k in self.kept]
        del self.model, self.drops, self.state, self.warm, self.pre

    def check(self, gen: np.random.Generator, control: bool = False):
        return verdict(self.numbers(gen, control), self.tr["limits"])

    def numbers(self, gen: np.random.Generator, control: bool = False):
        """{name: the number of each sampled item}, of the program's
        answers or, with ``control``, of the control's."""
        from benchmark.reference.physics import dynamics
        from benchmark.reference.scene.model import State
        torch.set_num_threads(THREADS)
        calls = np.sort(gen.choice(len(self.kept), min(
            self.tr["check"]["calls"], len(self.kept)), replace=False))
        cols = [torch.cat([self.kept[c][j] for c in calls])
                for j in range(5)]
        q0, v0, wf0, ws0, v1 = as_reference(*cols)
        model = pile.reference_model(self.cfg, self.bench)

        def step(m, dtype):
            z = q0.new_zeros
            s = State(qpos=q0.to(dtype), qvel=v0.to(dtype),
                      ctrl=z(q0.shape[0], m.topo.nu, dtype=dtype),
                      time=z(q0.shape[0], dtype=dtype))
            s2, w2 = dynamics.step_warm(m, s, (wf0.to(dtype), ws0.to(dtype)),
                                        self.ncon, self.iters)
            return as_reference(s2.qvel)[0]

        with torch.inference_mode():
            if control:
                from benchmark.reference.scene.compile import load_model
                m32 = load_model(scene(self.cfg, self.bench),
                                 device="cpu")
                with tf32():
                    v1 = step(m32, torch.float32)
            rv = step(model, torch.float64)
        return {"qacc": ((v1 - rv).abs().amax(-1)
                         / (rv - v0).abs().amax(-1)).numpy()}
