"""render.host_ms_per_call: host ms per observation call in the render
entry's own code: the self time of the program's ``render`` spans (geom
table, shading, depth encoding, flips) less the ray-cast wrapper's span
(``render.cast``) inside them, its own work and any wait in it for the
device, over the stretch of the traced run that goes without the
profiler."""

from benchmark.spans import during, self_ms_per_unit  # noqa: F401


def read(run):
    return self_ms_per_unit(run, {"render"})
