"""The readers of the program's spans and counters (``benchmark/spans.py``
and the metrics whose ``source`` is ``program_span`` or
``program_counter``).

* A traced run of each cell at a tiny size on the CPU reports each such
  metric of the cell as a finite number in its range, but the device
  interval ``collide.ms_per_step``, which has nothing to read without a
  card and is left out of the line.
* The readers read a recorder filled by hand: host shares and self times,
  counter ratios.
* Against a program without ``mujoco_rl_ur5_tpu_torch.trace`` (an older
  commit) ``during`` raises nothing and every reader returns None.
"""

from __future__ import annotations

import math
import sys
import types

import pytest
import torch

from benchmark import manifest, spans
from benchmark.run import run_cell
from benchmark.tests.tiny import tiny_bench

SEED = 2 ** 31 + 17
MAN = manifest.load()
OURS = [m for m in MAN["per_layer"]
        if m["source"] in ("program_span", "program_counter")]
DEVICE_ONLY = {"collide.ms_per_step"}
PCT = {m["name"] for m in OURS if m["unit"] == "%"}


def cells():
    return sorted({c for m in OURS for c in m["workloads"]})


@pytest.mark.parametrize("cell", cells())
def test_traced_tiny_run_reports_the_span_metrics(tmp_path, cell):
    torch.manual_seed(0)
    out = run_cell(cell, SEED, 0.0, True, bench=tiny_bench(tmp_path),
                   device="cpu")
    assert out["correct"], out["compared"]
    mine = [m["name"] for m in OURS if cell in m["workloads"]]
    assert mine
    for name in mine:
        if name in DEVICE_ONLY:
            assert name not in out["metrics"]
            continue
        v = out["metrics"][name]["value"]
        assert math.isfinite(v) and v >= 0, (name, v)
        if name in PCT:
            assert v <= 100.0, (name, v)


def _span(name, parent, start, end):
    s = types.SimpleNamespace(name=name, parent=parent, start_ns=start,
                              end_ns=end, events=None)
    s.host_ns = end - start
    return s


class _Rec:
    """A recorder's reading side, filled by hand."""

    def __init__(self, spans_, counts):
        self.spans, self._counts = spans_, counts

    def self_host_ns(self, name):
        mine = {i for i, s in enumerate(self.spans) if s.name == name}
        return (sum(self.spans[i].host_ns for i in mine)
                - sum(s.host_ns for s in self.spans if s.parent in mine))

    def device_ms(self, name):
        return None

    def counts(self):
        return dict(self._counts)


def _reader(name):
    return manifest.reader(name)


def test_readers_of_a_recorder_filled_by_hand(monkeypatch):
    ms = 1_000_000
    rec = _Rec([_span("mpc.solve", -1, 0, 10 * ms),
                _span("ilqr.solve", 0, 1 * ms, 9 * ms),
                _span("chain.lin_fd", 1, 2 * ms, 5 * ms),
                _span("fk", -1, 20 * ms, 22 * ms),
                _span("render", -1, 22 * ms, 30 * ms),
                _span("render.cast", 4, 23 * ms, 24 * ms)],
               {"ilqr.accepted": 3, "ilqr.tried": 4,
                "constraints.live_rows": 1, "constraints.rows": 8})
    monkeypatch.setattr(spans, "_HELD", [rec, 40 * ms])
    run = types.SimpleNamespace(units=2, plain_s=0.040)
    assert _reader("host_busy_pct.mpc").read(run) == pytest.approx(50.0)
    # 10 ms of the solve less 3 ms of lin_fd, over 2 calls
    assert _reader("mpc.host_ms_per_solve").read(run) == pytest.approx(3.5)
    assert _reader("ilqr.accepted_pct").read(run) == pytest.approx(75.0)
    assert _reader("constraints.live_rows_pct").read(run) == \
        pytest.approx(12.5)
    assert _reader("kinematics.host_ms_per_call").read(run) == \
        pytest.approx(1.0)
    assert _reader("render.host_ms_per_call").read(run) == \
        pytest.approx(3.5)
    assert _reader("collide.ms_per_step").read(run) is None


def test_a_program_without_spans_reads_none(monkeypatch):
    import mujoco_rl_ur5_tpu_torch as port
    monkeypatch.setitem(sys.modules, "mujoco_rl_ur5_tpu_torch.trace", None)
    monkeypatch.delattr(port, "trace", raising=False)
    with spans.during(None):
        pass
    assert spans.recorder() is None
    run = types.SimpleNamespace(units=2, plain_s=1.0)
    for m in OURS:
        r = _reader(m["name"])
        with r.during(None):
            pass
        assert r.read(run) is None, m["name"]
