"""Finding a cell's parts by name.

``BENCHMARK.json`` at the checkout's root names every configuration, cell
and metric. Each part lives in a file of its own under this folder, found
by its name alone, so that a later change adds a configuration, a traffic
mix or a per-layer metric as new files and new entries:

  configs/<config>.json    a configuration: its source, sizes and scene
  traffic/<traffic>.json   a traffic mix: the ``kind`` of work (a module of
                           kinds/ that generates it) and its parameters
  metrics/<metric>.py      a per-layer metric's reader: ``read(run)``
"""

from __future__ import annotations

import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}$")


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(manifest: dict, workload: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def config(manifest: dict, name: str, root: str = ROOT) -> dict:
    entry = next(c for c in manifest["configs"] if c["name"] == name)
    with open(os.path.join(root, entry["file"])) as f:
        return json.load(f)


def scene(cfg: dict, bench: str = HERE) -> str:
    """The scene file a configuration loads (under ``scenes/``)."""
    return os.path.join(bench, cfg["scene"])


def traffic(name: str, bench: str = HERE) -> dict:
    with open(os.path.join(bench, "traffic", f"{name}.json")) as f:
        return json.load(f)


def metrics_of(manifest: dict, workload: str) -> tuple:
    """(end-to-end, per-layer) metric entries that this cell reports."""
    def mine(m):
        return "workloads" not in m or workload in m["workloads"]
    return ([m for m in manifest["end_to_end"] if mine(m)],
            [m for m in manifest["per_layer"] if mine(m)])


def reader(name: str, bench: str = HERE):
    """The module of a per-layer metric's reader, from its file by name."""
    path = os.path.join(bench, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kind(name: str, bench: str = HERE):
    """The generator module of a traffic kind, from kinds/<name>.py."""
    path = os.path.join(bench, "kinds", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_kind_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
