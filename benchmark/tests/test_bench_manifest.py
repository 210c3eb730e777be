"""BENCHMARK.json against the benchmark's contract, and every part it
names found by name under benchmark/."""

from __future__ import annotations

import json
import os

import pytest

from benchmark import manifest

MAN = manifest.load()
E2E = {m["name"]: m for m in MAN["end_to_end"]}
CELLS = {w["name"]: w for w in MAN["workloads"]}
TEXT = 200


def reported(cell: str) -> set:
    e2e, per_layer = manifest.metrics_of(MAN, cell)
    return {m["name"] for m in e2e}, {m["name"] for m in per_layer}


def test_top_level_keys_and_command():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(MAN["command"]) <= 32
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert len(p) <= 200 and not p.startswith("/") and ".." not in p
        assert set(p) <= set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRST"
                             "UVWXYZ0123456789_.-/")
        assert not p.endswith("_torch")
    for word in MAN["command"]:
        assert 1 <= len(word) <= TEXT and "\n" not in word
        assert not word.startswith("/") and ".." not in word
    assert os.path.getsize(os.path.join(manifest.ROOT, "BENCHMARK.json")) \
        <= 64 * 1024


def test_run_seconds_fit_the_full_check():
    s = MAN["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    # 24 cells: 2 + 14 x 24 runs of s + 60 s, 2 x 90 s per cell, 1200 spare
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_and_units(kind):
    names = [e["name"] for e in MAN[kind]]
    assert len(names) == len(set(names))
    for e in MAN[kind]:
        assert manifest.NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert manifest.UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for k in ("why", "layer") + (("source",) if kind == "configs"
                                     else ()):
            if k in e:
                assert 1 <= len(e[k]) <= TEXT and "\n" not in e[k] \
                    and "\t" not in e[k]


def test_entry_keys():
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16
        assert all(manifest.NAME.match(k) for k in c["reduced"])
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        assert manifest.NAME.match(w["config"])
        assert manifest.NAME.match(w["traffic"])
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= TEXT and "\n" not in m["layer"]


def test_cells():
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert four <= max(1, len(CELLS) // 4)
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}
    for name in CELLS:
        assert manifest.NAME.match(name)
        e2e, per_layer = reported(name)
        assert "setup_s" in e2e and len(e2e) >= 2 and per_layer, name


def test_setup_s_everywhere():
    s = E2E["setup_s"]
    assert "workloads" not in s and s["bound"] <= 0.25


def test_moves_names_an_end_to_end_metric_of_every_cell_it_lists():
    for m in MAN["per_layer"]:
        assert m["moves"] in E2E, m["name"]
        cells = m.get("workloads", [c for c in CELLS
                                    if m["moves"] in reported(c)[0]])
        for c in cells:
            assert c in CELLS
            assert m["moves"] in reported(c)[0], (m["name"], c)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_parts_found_by_name(cell):
    w = CELLS[cell]
    cfg = manifest.config(MAN, w["config"])
    entry = next(c for c in MAN["configs"] if c["name"] == w["config"])
    assert entry["file"].startswith(MAN["paths"][0] + "/")
    assert cfg["name"] == w["config"] and cfg["reduced"] == entry["reduced"]
    assert os.path.exists(os.path.join(manifest.HERE, cfg["scene"]))
    tr = manifest.traffic(w["traffic"])
    assert hasattr(manifest.kind(tr["kind"]), "Work")
    e2e, per_layer = reported(cell)
    for key in ("rate_metric", "latency_metric"):
        if key in tr:
            assert tr[key] in e2e
    assert e2e - {"setup_s"} <= {tr.get("rate_metric"),
                                 tr.get("latency_metric")}
    for m in per_layer:
        assert callable(manifest.reader(m).read)


def test_config_files_are_distinct():
    files = [c["file"] for c in MAN["configs"]]
    sources = [c["source"] for c in MAN["configs"]]
    assert len(files) == len(set(files))
    assert len(sources) == len(set(sources))
    for c in MAN["configs"]:
        with open(os.path.join(manifest.ROOT, c["file"])) as f:
            assert json.load(f)["source"] == c["source"]
