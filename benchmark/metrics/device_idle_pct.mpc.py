"""device_idle_pct.mpc: the share of the card's time left idle over a
stretch of solves run without the profiler: 1 - the device's busy time
over ``trace_units`` calls of the traced window (the union of
torch.profiler's device intervals) / the host clock's wall time of as many
synchronised calls run before it without the profiler, whose cost on the
host (microseconds a launch, while it records and after) stays out of the
share."""


def read(run):
    if not run.trace.launches():
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.plain_s)
