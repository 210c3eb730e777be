"""A run whose timed path is broken underneath must come out not correct.

Each test skips the look for a card and drives the rest of a run at a tiny
size on the CPU (``run_cell``), with one fault planted in the program for
each that the cell can have: a step or solve that returns its state
unchanged, and an answer altered where it is produced. The tick's is also
planted in the warm calls alone (``warm_unchanged``), which leaves the
set-up's cold solves sound. (The observation
keeps no state; no cell takes an average over its batch or exchanges
anything between chips.)"""

from __future__ import annotations

import pytest
import torch

from benchmark.run import run_cell
from benchmark.tests.tiny import tiny_bench

SEED = 2 ** 31 + 99


def solver_faults(monkeypatch, method: str, fault: str):
    from mujoco_rl_ur5_tpu_torch.mpc.grasp_mpc import GraspMPC
    orig = getattr(GraspMPC, method)

    def broken(self, *a, **kw):
        if fault == "unchanged" or (        # no iteration: the start plan
                fault == "warm_unchanged" and kw.get("u_init") is not None):
            iters, self.iters = self.iters, 0
            try:
                return orig(self, *a, **kw)
            finally:
                self.iters = iters
        res = orig(self, *a, **kw)
        res.us[:, 0, 0] += 0.05             # one control of every row
        return res
    monkeypatch.setattr(GraspMPC, method, broken)


def step_faults(monkeypatch, fault: str):
    from mujoco_rl_ur5_tpu_torch.physics import dynamics
    orig = dynamics.step_warm

    def broken(model, state, warm, ncon, iterations):
        if fault == "unchanged":
            return state, warm
        s, w = orig(model, state, warm, ncon, iterations)
        qvel = s.qvel.clone()
        qvel[:, -1] += 1e-2                 # one velocity of every scenario
        return s.replace(qvel=qvel), w
    monkeypatch.setattr(dynamics, "step_warm", broken)


def render_faults(monkeypatch):
    from mujoco_rl_ur5_tpu_torch.render import raycast
    orig = raycast.render_rgbd

    def broken(model, kin, cam, *a):
        rgb, depth = orig(model, kin, cam, *a)
        return rgb, depth + 1e-2 * (depth > 0.5)   # the far half moved
    monkeypatch.setattr(raycast, "render_rgbd", broken)


@pytest.mark.parametrize("cell,fault", [
    ("arm_reach_b4096", "unchanged"), ("arm_reach_b4096", "altered"),
    ("arm_track_tick_b4096", "unchanged"),
    ("arm_track_tick_b4096", "warm_unchanged"),
    ("arm_track_tick_b4096", "altered"),
    ("pile_settle_b4096", "unchanged"), ("pile_settle_b4096", "altered"),
    ("pile_observe_b4096", "altered")])
def test_fault_is_not_correct(tmp_path, monkeypatch, cell, fault):
    torch.manual_seed(0)
    bench = tiny_bench(tmp_path)
    if cell == "arm_reach_b4096":
        solver_faults(monkeypatch, "solve_batch_x", fault)
    elif cell == "arm_track_tick_b4096":
        solver_faults(monkeypatch, "track_batch", fault)
    elif cell == "pile_settle_b4096":
        step_faults(monkeypatch, fault)
    else:
        render_faults(monkeypatch)
    out = run_cell(cell, SEED, 0.0, False, bench=bench, device="cpu")
    assert not out["correct"], out["compared"]
