"""kinematics.host_ms_per_call: host ms per observation call in the FK
that the observation starts with: the host time of the program's root
``fk`` spans (an ``fk`` inside another layer's span is that layer's),
its own work and any wait in it for the device, over the stretch of the
traced run that goes without the profiler."""

from benchmark.spans import during, recorder  # noqa: F401


def read(run):
    rec = recorder()
    fk = [s for s in rec.spans if s.name == "fk" and s.parent < 0] \
        if rec else []
    if not fk:
        return None
    return sum(s.host_ns for s in fk) * 1e-6 / run.units
