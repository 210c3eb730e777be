"""host_busy_pct.render: the share of a stretch of observations run without
the profiler (the stretch whose wall is device_idle_pct.render's) that the
host spends inside the program's root spans (fk and render): 100 x their
summed host time over the stretch's wall, both on the spans' clock
(``time.time_ns``). A span's host time is the host's wall time in it:
its own work and any wait in it for the device (a synchronizing copy or
read, a full launch queue). The rest is the harness's own code and its
wait for the device after each call."""

from benchmark.spans import during, host_busy_pct  # noqa: F401


def read(run):
    return host_busy_pct()
