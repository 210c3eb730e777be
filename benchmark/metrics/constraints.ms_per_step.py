"""constraints.ms_per_step: device ms per contact step of the assembly and
contact solver: the program's own calls of ``constraint_forces`` (as
``physics/dynamics.py``'s ``step_warm`` makes them) in the stretch of the
traced run that goes without the profiler, each between two CUDA events
recorded on the stream around the call: the span from its first
operation's start to its last one's end, with what the device waits on
the host in between. Without the function (or a card) there is nothing
to read."""

import contextlib

SPANS = []


@contextlib.contextmanager
def during(work):
    import torch
    from mujoco_rl_ur5_tpu_torch.physics import dynamics
    orig = getattr(dynamics, "constraint_forces", None)
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

    dynamics.constraint_forces = timed
    try:
        yield
    finally:
        dynamics.constraint_forces = orig


def read(run):
    import torch
    if not SPANS:
        return None
    torch.cuda.synchronize()
    ms = sum(s.elapsed_time(e) for s, e in SPANS)
    SPANS.clear()
    return ms / run.units
