"""The control of every cell's check must come out not correct.

The control is the plain reference put in the program's place and computed
in TF32, the precision below the configurations' float32 with TF32 off
(``reference/precision.py``): its answers for the window's sampled items
are judged by the cell's own check against the float64 reference. On the
chip, at the cell's own size (``readings`` below), it is read beside the
program's own readings on the same seeds and must fail the cell's limits;
here, on the CPU, at a size a test run can hold, the program's answers
must pass them and the control must read ten times the program's on one
number at least.

    python3 -m benchmark.tests.test_control <cell> <seconds> <seed> ...

prints, per seed, the program's readings and, for the first three seeds,
the control's: one JSON line each (on a machine with the card).
"""

from __future__ import annotations

import json
import os
import sys

import pytest

from benchmark.tests.tiny import tiny_bench


def readings(cell: str, seed: int, seconds: float, bench=None,
             device="cuda", control=True) -> dict:
    """Set the cell up, run its unit for ``seconds`` (at least once), and
    return {"program": ..., "control": ...} readings, each {name: largest
    value} with "failed" items, from the same sampled items, and each
    item's numbers ("program_items", "control_items")."""
    import time

    import torch

    from benchmark import manifest
    from benchmark.generators import rng
    bench = bench or manifest.HERE
    root = os.path.dirname(bench)
    man = manifest.load(root)
    c = manifest.cell(man, cell)
    cfg = manifest.config(man, c["config"], root)
    tr = manifest.traffic(c["traffic"], bench)
    work = manifest.kind(tr["kind"], bench).Work(cfg, tr, seed, device,
                                                 bench)
    start, i = time.perf_counter(), 0
    while i == 0 or time.perf_counter() - start < seconds:
        work.call(i)
        if device == "cuda":
            torch.cuda.synchronize()
        work.keep(i)
        i += 1
    work.free()
    from benchmark.verdict import verdict
    out = {}
    for name, ctl in (("program", False),) + ((("control", True),)
                                             if control else ()):
        numbers = work.numbers(rng(seed, 9), control=ctl)
        vals, failed = verdict(numbers, tr["limits"])
        out[name] = {k: v for k, (v, _) in vals.items()}
        out[name]["failed"] = failed
        out[name + "_items"] = {k: [float(x) for x in v]
                                for k, v in numbers.items()}
        out[name + "_correct"] = failed == 0 and all(
            v <= lim for v, lim in vals.values())
    return out


@pytest.mark.parametrize("cell", ["arm_reach_b4096", "pile_settle_b4096",
                                  "pile_observe_b4096",
                                  "arm_track_tick_b4096"])
def test_control_separates_and_program_passes(tmp_path, cell):
    bench = tiny_bench(tmp_path)
    r = readings(cell, 2 ** 31 + 7, 0.0, bench=bench, device="cpu")
    assert r["program_correct"], r
    # at 4 knots and 32 x 32 pixels the errors have less to grow over
    # than at the cell's size, where the control fails its limits
    # (test_control_fails_on_the_card): here it reads ten times the
    # program's on one number at least
    ratio = max(r["control"][k] / max(r["program"][k], 1e-30)
                for k in r["control"] if k != "failed")
    assert ratio >= 10, r


@pytest.mark.chip
@pytest.mark.parametrize("cell", ["arm_reach_b4096", "pile_settle_b4096",
                                  "pile_observe_b4096",
                                  "arm_track_tick_b4096"])
def test_control_fails_on_the_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cell's own size")
    r = readings(cell, 2 ** 31 + 11, 3.0)
    assert r["program_correct"], r
    assert not r["control_correct"], r


if __name__ == "__main__":
    cell, seconds, *seeds = sys.argv[1:]
    for k, s in enumerate(seeds):
        r = readings(cell, int(s), float(seconds), control=k < 3)
        print(json.dumps({"cell": cell, "seed": int(s), **r}), flush=True)
