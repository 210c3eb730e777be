"""A later change adds a configuration, a traffic mix and a per-layer
metric as new files and new entries only: in a copy of the benchmark,
dummies of each are added, no file that was there is edited but
BENCHMARK.json, and the harness finds and runs them by name."""

from __future__ import annotations

import json
import os

from benchmark.run import run_cell
from benchmark.tests.tiny import tiny_bench

READER = '''"""dummy.frames_seen: frames rendered in the traced stretch."""


def read(run):
    return float(run.units * run.work.tr["batch"])
'''


def test_added_files_are_found_by_name(tmp_path):
    bench = tiny_bench(tmp_path)
    before = {os.path.join(d, f): open(os.path.join(d, f), "rb").read()
              for d, _, fs in os.walk(bench) for f in fs}
    with open(os.path.join(bench, "configs", "ur5_object_pile.json")) as f:
        cfg = json.load(f)
    cfg.update(name="dummy_pile", width=16, height=16)
    with open(os.path.join(bench, "configs", "dummy_pile.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bench, "traffic", "observe_b4096.json")) as f:
        tr = json.load(f)
    tr.update(batch=3, pool=1)
    with open(os.path.join(bench, "traffic", "dummy_observe.json"),
              "w") as f:
        json.dump(tr, f)
    with open(os.path.join(bench, "metrics", "dummy.frames_seen.py"),
              "w") as f:
        f.write(READER)
    root = os.path.dirname(bench)
    man_path = os.path.join(root, "BENCHMARK.json")
    with open(man_path) as f:
        man = json.load(f)
    man["configs"].append({"name": "dummy_pile", "source": "https://x.y/z",
                           "file": "benchmark/configs/dummy_pile.json",
                           "reduced": [], "why": "a dummy"})
    man["workloads"].append({"name": "dummy_cell", "config": "dummy_pile",
                             "traffic": "dummy_observe", "chips": 1,
                             "why": "a dummy"})
    for m in man["end_to_end"]:
        if m["name"] == "frames_per_s":
            m["workloads"].append("dummy_cell")
    man["per_layer"].append({"name": "dummy.frames_seen", "unit": "frames",
                             "better": "higher", "source": "host_clock",
                             "layer": "render entry",
                             "moves": "frames_per_s",
                             "workloads": ["dummy_cell"]})
    with open(man_path, "w") as f:
        json.dump(man, f)
    after = {os.path.join(d, f): open(os.path.join(d, f), "rb").read()
             for d, _, fs in os.walk(bench) for f in fs
             if "__pycache__" not in d}
    assert all(after[p] == b for p, b in before.items()
               if "__pycache__" not in p)

    out = run_cell("dummy_cell", 5, 0.0, False, bench=bench, device="cpu")
    assert out["correct"] and set(out["metrics"]) == {"frames_per_s",
                                                      "setup_s"}
    out = run_cell("dummy_cell", 5, 0.0, True, bench=bench, device="cpu")
    assert out["metrics"]["dummy.frames_seen"]["value"] == 2 * 3.0
    assert out["correct"]
