"""A copy of the benchmark at a size a CPU test run can hold."""

from __future__ import annotations

import json
import os
import shutil

from benchmark import manifest

TINY_CONFIG = {"ur5_arm_mpc": {"horizon": 4},
               "ur5_object_pile": {"iterations": 5, "ncon": 16,
                                   "width": 32, "height": 32}}
TINY_TRAFFIC = {"batch": 4, "pool": 2, "trace_units": 2,
                "steps_per_drop": 2, "check": {"rows": 2, "calls": 2}}
# A 4-knot solve is more sensitive to float32 finite differences than the
# cells' 64-knot one: the program's plan reads up to 2e-2 above the float64
# reference's on the CPU at this size (4e-7 for its states). The plan
# numbers get this limit at the tiny size; every other limit is the cell's.
TINY_PLAN_LIMIT = 0.05


def edit(path: str, **kw) -> None:
    with open(path) as f:
        d = json.load(f)
    d.update(kw)
    with open(path, "w") as f:
        json.dump(d, f)


def copy_bench(tmp) -> str:
    """benchmark/ and BENCHMARK.json copied under ``tmp``; returns the
    copy's benchmark folder."""
    root = os.path.join(str(tmp), "checkout")
    shutil.copytree(manifest.HERE, os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(manifest.ROOT, "BENCHMARK.json"), root)
    return os.path.join(root, "benchmark")


def tiny_bench(tmp) -> str:
    """A copy with every configuration and traffic mix cut to a tiny size
    (horizon 4, 5 solver iterations, 32 x 32 images, 4 scenarios), with
    the cells' limits but TINY_PLAN_LIMIT."""
    bench = copy_bench(tmp)
    for name, kw in TINY_CONFIG.items():
        edit(os.path.join(bench, "configs", f"{name}.json"), **kw)
    for f in os.listdir(os.path.join(bench, "traffic")):
        path = os.path.join(bench, "traffic", f)
        with open(path) as fh:
            limits = json.load(fh)["limits"]
        for k in limits:
            if k.endswith("plan"):
                limits[k] = TINY_PLAN_LIMIT
        edit(path, limits=limits, **TINY_TRAFFIC)
    return bench
