"""render.epilogue_ms: device ms per observation call of the render
entry outside its ray cast: the span of each of the program's own calls
of ``render/raycast.py``'s ``render_rgbd`` in the stretch of the traced
run that goes without the profiler, between two CUDA events recorded on
the stream around the call, less the device time per call of the
program's own kernels in the traced window (the ray cast; the FK before
the call is outside the span): the geom table, shading, depth encoding
and flips, with what the device waits on the host in between. Without the
function (or a card) there is nothing to read."""

import contextlib
import os

from benchmark.device import kernel_name, own_kernels

SPANS = []


@contextlib.contextmanager
def during(work):
    import torch
    from mujoco_rl_ur5_tpu_torch.render import raycast
    orig = getattr(raycast, "render_rgbd", None)
    if orig is None or not torch.cuda.is_available():
        yield
        return

    def timed(*a, **kw):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        out = orig(*a, **kw)
        e.record()
        SPANS.append((s, e))
        return out

    raycast.render_rgbd = timed
    try:
        yield
    finally:
        raycast.render_rgbd = orig


def read(run):
    import torch

    import mujoco_rl_ur5_tpu_torch as port
    if not SPANS:
        return None
    torch.cuda.synchronize()
    ms = sum(s.elapsed_time(e) for s, e in SPANS)
    SPANS.clear()
    ours = own_kernels(os.path.dirname(port.__file__))
    cast = sum(run.trace.time_by_name(lambda n: kernel_name(n) in ours)
               .values())
    return (ms - cast * 1e3) / run.units
