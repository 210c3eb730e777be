"""The port's spans and counters (mujoco_rl_ur5_tpu_torch/trace.py).

* Off (outside ``trace.recording()``) a span is one shared no-op context
  and nothing is kept.
* Recording keeps each span's name, parent and call id, and its host
  times; self time is a span's time less its children's.
* Under torch.profiler each span is also a profiler event of the same
  name, on the same clock: the event lies within the span's recorded
  host interval.
* A tensor counter is summed on its device with no read to the host until
  the recorder's ``counts()``.
* A small reach and track solve, a contact step of the pile and an
  observation give the same bits with recording on as off, and record the
  spans of the layers they pass through, nested as the calls nest.
* ``utils.torch_trace``'s Chrome trace shows the spans.
"""

import dataclasses
import json
import types
from unittest import mock

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mujoco_rl_ur5_tpu_torch import ASSET, OBJECTS, PILE, trace
from mujoco_rl_ur5_tpu_torch.mpc.grasp_mpc import GraspMPC
from mujoco_rl_ur5_tpu_torch.physics import constraints, dynamics
from mujoco_rl_ur5_tpu_torch.physics.kinematics import fk
from mujoco_rl_ur5_tpu_torch.render import camera
from mujoco_rl_ur5_tpu_torch.render.raycast import render_rgbd
from mujoco_rl_ur5_tpu_torch.scene.compile import load_model
from mujoco_rl_ur5_tpu_torch.scene.mjcf import JNT_FREE
from mujoco_rl_ur5_tpu_torch.scene.model import State
from mujoco_rl_ur5_tpu_torch.utils import torch_trace

HOME = np.array([0.0, -1.57, 1.57, -1.57, -1.57, 0.0, 0.0, 0.0])
B, ITERS = 3, 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clock(*ticks):
    """A stand-in for the time module whose time_ns returns ``ticks``."""
    return mock.patch.object(trace, "time",
                             types.SimpleNamespace(time_ns=iter(ticks)
                                                   .__next__))


def _tree(rec):
    """[(name, parent's name or None, call id)] in the order opened."""
    return [(s.name, rec.spans[s.parent].name if s.parent >= 0 else None,
             s.call) for s in rec.spans]


def test_off_records_nothing():
    @trace.spanned("f")
    def f(x):
        return x + 1

    assert trace.span("a") is trace.span("b", device=True)
    with trace.span("a"):
        trace.count("n", 3)
        trace.count("n", torch.ones(4))
        assert f(1) == 2
    assert trace._REC is None
    with trace.recording() as rec:
        pass
    assert rec.spans == [] and rec.counts() == {}
    assert trace._REC is None


def test_nesting_parents_calls_and_self_time():
    @trace.spanned("a")
    def a(inner):
        if inner:
            with trace.span("b"):
                pass

    with _clock(0, 10, 20, 25, 40, 50, 60, 100, 200, 210):
        with trace.recording() as rec:
            with trace.span("root"):
                a(True)
                with trace.recording() as again:       # nests: same one
                    a(False)
            assert again is rec and trace._REC is rec
            with trace.span("root"):
                pass
    assert trace._REC is None
    assert _tree(rec) == [("root", None, 0), ("a", "root", 0),
                          ("b", "a", 0), ("a", "root", 0),
                          ("root", None, 1)]
    assert [(s.start_ns, s.end_ns) for s in rec.spans] == [
        (0, 100), (10, 40), (20, 25), (50, 60), (200, 210)]
    assert rec.host_ns("a") == 40 and rec.self_host_ns("a") == 35
    assert rec.host_ns("root") == 110 and rec.self_host_ns("root") == 70
    assert rec.self_host_ns("b") == 5 and rec.host_ns("none") == 0
    assert rec.device_ms("a") is None          # no span asked for events


def test_a_span_closes_when_its_work_raises():
    @trace.spanned("boom")
    def boom():
        raise ValueError("inside")

    with trace.recording() as rec:
        with pytest.raises(ValueError, match="inside"):
            with trace.span("outer"):
                boom()
        with trace.span("after"):
            pass
    assert _tree(rec) == [("outer", None, 0), ("boom", "outer", 0),
                          ("after", None, 1)]
    assert all(s.end_ns >= s.start_ns for s in rec.spans)


def test_spans_are_profiler_events_on_the_same_clock():
    a = torch.ones(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            trace.recording() as rec:
        for _ in range(3):
            with trace.span("outer"):
                with trace.span("inner"):
                    a @ a
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name() in ("outer", "inner")]
    assert [e.name() for e in sorted(events, key=lambda e: e.start_ns())] \
        == [s.name for s in rec.spans]
    slack = 20_000                                       # ns
    for e, s in zip(sorted(events, key=lambda e: e.start_ns()), rec.spans):
        assert s.start_ns - slack <= e.start_ns() <= e.end_ns() \
            <= s.end_ns + slack, (s.name, e.start_ns(), s.start_ns)


def test_tensor_counters_accumulate_without_a_host_read():
    masks = [torch.tensor([True, False, True]), torch.tensor(4),
             torch.ones(2, 3, dtype=torch.bool)]
    reads = {m: mock.patch.object(torch.Tensor, m, side_effect=AssertionError(
        f"Tensor.{m} while counting")) for m in
        ("item", "tolist", "__bool__", "__int__", "__float__", "cpu",
         "numpy")}
    with trace.recording() as rec:
        for r in reads.values():
            r.start()
        try:
            for m in masks:
                trace.count("live", m)
            trace.count("live", 2)
            trace.count("rows", 5)
        finally:
            for r in reads.values():
                r.stop()
    assert rec.counts() == {"live": 2 + 4 + 6 + 2, "rows": 5}


# -- the program's spans ------------------------------------------------------


@pytest.fixture(scope="module")
def mpc():
    return GraspMPC.from_scene(ASSET, horizon=3, substeps=2, iters=ITERS,
                               device="cpu")


def _arm_inputs(mpc):
    rng = np.random.default_rng(4)
    x0 = torch.from_numpy(np.concatenate(
        [HOME + 0.05 * rng.standard_normal((B, 8)),
         0.05 * rng.standard_normal((B, 8))], -1).astype(np.float32))
    targets = torch.tensor([[0.0, -0.6, 1.0]] * B) + torch.from_numpy(
        0.05 * rng.standard_normal((B, 3)).astype(np.float32))
    q_refs = x0[:, None, :8].expand(B, mpc.H + 1, 8).contiguous()
    return x0, targets, q_refs


def _leaves(v):
    if isinstance(v, torch.Tensor):
        return [v]
    if isinstance(v, (tuple, list)):
        return [x for item in v for x in _leaves(item)]
    if dataclasses.is_dataclass(v):
        return _leaves([getattr(v, f.name) for f in dataclasses.fields(v)])
    return []


def _same(a, b):
    """Every tensor of ``a`` equals its counterpart in ``b`` to the bit."""
    la, lb = _leaves(a), _leaves(b)
    assert la and len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


def _solver_tree(kernel_quad: bool) -> list:
    per_expand = [("chain.lin_fd", "ilqr.expand", 0)] + (
        [("chain.ee_quad_gn", "ilqr.expand", 0)] if kernel_quad else []) \
        + [("chain.backward", "ilqr.expand", 0)]
    it = ([("ilqr.expand", "ilqr.solve", 0)] + per_expand
          + [("ilqr.line_search", "ilqr.solve", 0),
             ("chain.rollout_closed", "ilqr.line_search", 0),
             ("ilqr.accept", "ilqr.solve", 0)])
    return ([("mpc.solve", None, 0), ("ilqr.solve", "mpc.solve", 0),
             ("chain.rollout_open", "ilqr.solve", 0)] + it * ITERS
            + [("ilqr.expand", "ilqr.solve", 0)] + per_expand)


@pytest.mark.parametrize("mode", ["reach", "track"])
def test_solve_records_its_layers_and_keeps_its_bits(mpc, mode):
    x0, targets, q_refs = _arm_inputs(mpc)
    solve = ((lambda: mpc.solve_batch_x(x0, targets)) if mode == "reach"
             else (lambda: mpc.track_batch(x0, q_refs)))
    off = solve()
    with trace.recording() as rec:
        on = solve()
    _same(off, on)
    assert _tree(rec) == _solver_tree(kernel_quad=mode == "reach")
    n = rec.counts()
    assert n["ilqr.tried"] == B * ITERS
    assert 0 <= n["ilqr.accepted"] <= n["ilqr.tried"]
    assert rec.self_host_ns("ilqr.expand") < rec.host_ns("ilqr.expand")
    assert 0 < rec.self_host_ns("mpc.solve") < rec.host_ns("mpc.solve")


def test_contact_step_records_collide_inside_constraints():
    m = load_model(PILE, device="cpu")
    t = m.topo
    q = np.tile(m.qpos0.numpy().astype(np.float64), (2, 1))
    for j in np.nonzero(t.jnt_type == JNT_FREE)[0]:
        q[:, t.jnt_qposadr[j] + 2] -= 0.1           # into the bin's floor
    s = State(torch.from_numpy(q.astype(np.float32)), torch.zeros(2, t.nv),
              torch.zeros(2, t.nu), torch.zeros(2))
    w = constraints.init_warm(m, s)
    off = dynamics.step_warm(m, s, w, 16, 5)
    with trace.recording() as rec:
        on = dynamics.step_warm(m, s, w, 16, 5)
    _same(off, on)
    assert _tree(rec) == [("step", None, 0), ("fk", "step", 0),
                          ("constraints", "step", 0),
                          ("collide", "constraints", 0)]
    n = rec.counts()
    assert n["constraints.rows"] == 2 * 16 * constraints.NFACET
    assert 0 < n["constraints.live_rows"] <= n["constraints.rows"]
    assert rec.device_ms("collide") is None            # no card here


def test_observation_records_fk_then_render():
    m = load_model(OBJECTS, device="cpu")
    cam = camera.make_camera(m, "top_down", 24, 20)
    q = m.qpos0[None].expand(2, -1).contiguous()
    off = render_rgbd(m, fk(m, q), cam)
    with trace.recording() as rec:
        on = render_rgbd(m, fk(m, q), cam)
    _same(off, on)
    assert _tree(rec) == [("fk", None, 0), ("render", None, 1),
                          ("render.cast", "render", 1)]
    assert rec.self_host_ns("render") < rec.host_ns("render")


def test_torch_trace_shows_the_spans(mpc, tmp_path, capsys):
    x0, targets, _ = _arm_inputs(mpc)
    with torch_trace(str(tmp_path)):
        mpc.solve_batch_x(x0, targets)
    assert "trace written" in capsys.readouterr().out
    names = {e.get("name") for e in json.loads(
        (tmp_path / "trace.json").read_text())["traceEvents"]}
    assert {"mpc.solve", "ilqr.solve", "ilqr.expand", "chain.backward"} \
        <= names
    assert trace._REC is None
