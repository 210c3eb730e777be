"""collide.ms_per_step: device ms per contact step of the collide layer:
the program's ``collide`` span (poses, broadphase cap, the narrowphase
kernels and plain groups, the candidates' concatenation), between the two
CUDA events it records on the stream at entry and exit, with what the
device waits on the host in between, over the stretch of the traced run
that goes without the profiler. Without a card there is nothing to
read."""

from benchmark.spans import during, recorder  # noqa: F401


def read(run):
    rec = recorder()
    ms = rec.device_ms("collide") if rec else None
    return None if ms is None else ms / run.units
