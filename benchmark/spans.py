"""The program's own spans and counters (``mujoco_rl_ur5_tpu_torch/trace.py``)
over the stretch of a traced run that goes without the profiler.

Every reader of a span or counter enters ``during`` around that stretch,
as the readers of CUDA events do; the program's recording blocks nest, so
the readers share one recorder, which ``recorder()`` hands to ``read``. A
program without the module records nothing, and its readers return None.
Recording stays off in the profiled stretches: a span there would add a
profiler range to the device's operations and split its idle gaps."""

from __future__ import annotations

import contextlib
import time

_HELD = [None, 0]          # the recorder, and the stretch's wall in ns


@contextlib.contextmanager
def during(work):
    try:
        from mujoco_rl_ur5_tpu_torch import trace
    except ImportError:
        _HELD[:] = [None, 0]
        yield
        return
    with trace.recording() as rec:
        _HELD[:] = [rec, 0]
        start = time.time_ns()
        try:
            yield
        finally:
            _HELD[1] = time.time_ns() - start


def recorder():
    """The recorder of the last stretch ``during`` covered, or None."""
    return _HELD[0]


def host_busy_pct():
    """100 x the host time inside the program's root spans over the wall
    of the stretch they ran in (the stretch of ``run.plain_s``, timed on the
    spans' own clock, ``time.time_ns``), or None without spans."""
    rec, wall_ns = _HELD
    roots = [s for s in rec.spans if s.parent < 0] if rec else []
    if not roots or not wall_ns:
        return None
    return 100.0 * sum(s.host_ns for s in roots) / wall_ns


def self_ms_per_unit(run, names: set):
    """Host ms per unit spent in the spans named ``names`` less their child
    spans, or None where none was recorded."""
    rec = recorder()
    if rec is None or not any(s.name in names for s in rec.spans):
        return None
    return sum(rec.self_host_ns(n) for n in names) * 1e-6 / run.units


def ratio_pct(useful: str, tried: str):
    """100 x counter ``useful`` over counter ``tried``, or None where
    ``tried`` was not counted."""
    rec = recorder()
    n = rec.counts() if rec else {}
    if not n.get(tried):
        return None
    return 100.0 * n.get(useful, 0) / n[tried]
