"""What the two grasp-MPC kinds share: the program's planner built from the
configuration, the answers kept from the window, and their comparison with
the plain reference (``reference/mpc/ilqr.py``, float64 on the CPU).

A batched solve's answers for a scenario are its states xs, controls us
and cost (and feedback gains, which no number here compares: see
PERF.md). Rows are independent, so the reference solves a sample of rows
at the cell's horizon, substeps and iterations. The numbers compared,
each the largest over the sampled rows:

  states  the program's xs against the reference's rollout of the
          program's own us from the same start, over the largest |x|
          (the chain kernels' dynamics and the line search's rollout);
  cost    the program's cost against the reference's cost of that
          rollout, relative (the fused costs);
  plan    how much higher the reference's cost of the program's plan is
          than that of the reference's own solve from the same inputs,
          relative (the solver: linearization, quadratization, Riccati
          pass, line search and schedule).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.manifest import scene
from benchmark.reference.mpc import ilqr as ref_ilqr
from benchmark.reference.precision import tf32

def planner(cfg: dict, bench: str, iters: int, device: str):
    """The program's GraspMPC on the configuration's scene, with every
    kernel of its path built (or taken from the build cache)."""
    from mujoco_rl_ur5_tpu_torch.mpc.grasp_mpc import GraspMPC
    mpc = GraspMPC.from_scene(scene(cfg, bench), horizon=cfg["horizon"],
                              substeps=cfg["substeps"], iters=iters,
                              device=device)
    if device == "cuda":
        mpc.build_kernels()
    return mpc


def sibling(mpc, iters: int):
    """A second planner on the same compiled models and kernels with
    another iteration count."""
    return type(mpc)(mpc.full, horizon=mpc.H, substeps=mpc.substeps,
                     iters=iters, arm_model=mpc.arm, device=mpc.device)


def rows_of(res, rows: torch.Tensor) -> tuple:
    """The kept part of a batched solve: (xs, us, cost) of ``rows``."""
    return res.xs[rows], res.us[rows], res.cost[rows]


def reference(cfg: dict, bench: str, control: bool = False) -> ref_ilqr.Arm:
    """The reference's arm: float64, or, for the control, float32 with its
    matrix products in TF32."""
    return ref_ilqr.Arm(scene(cfg, bench), cfg["horizon"], cfg["substeps"],
                        **({"dtype": np.float32, "tf32": True} if control
                           else {}))


def solve_as_control(cfg: dict, bench: str, problem_of, x0, u_init,
                     iters: int):
    """The control in the program's place: the reference solve computed in
    float32 with every matrix product in TF32 (``reference.precision``).
    ``problem_of(arm, dtype)`` gives the problem. Returns answers as
    ``rows_of`` gives them."""
    arm = reference(cfg, bench, control=True)
    x0 = x0.float()
    with tf32():
        res = arm.solve(problem_of(arm, torch.float32), x0,
                        arm.hold(x0) if u_init is None else u_init.float(),
                        iters)
    return rows_of(res, torch.arange(x0.shape[0]))


def judge(arm: ref_ilqr.Arm, problem, x0, answers, own=None) -> dict:
    """The numbers of the module docstring, per row: ``answers`` the
    program's (xs, us, cost) of the rows, ``own`` the reference's own
    solve of the same rows (a ``ref_ilqr.Result``; None: no ``plan``);
    all float64."""
    xs, us, cost = answers
    total, _, _ = problem
    roll = arm.rollout(x0, us)
    c_roll = total(roll, us)
    out = {
        "states": ((xs - roll).abs().amax((-2, -1))
                   / roll.abs().amax((-2, -1))),
        "cost": (cost - c_roll).abs() / c_roll.abs(),
    }
    if own is not None:
        out["plan"] = (c_roll - own.cost) / own.cost.abs()
    return {k: v.numpy() for k, v in out.items()}
