"""mpc.host_ms_per_solve: host ms per solve call in the MPC entry and the
batched iLQR's own code: the self time of the ``mpc.*`` and ``ilqr.*``
spans (the solve, its expand, line search and accept phases) less the
chain kernels' wrapper spans (``chain.*``) inside them, over the stretch
of the traced run that goes without the profiler. It holds the plain-torch
costs and quadratizations and the iteration bookkeeping, whose launches
the host enqueues, and any wait of the host for the device inside that
code (a synchronizing copy or read)."""

from benchmark.spans import during, recorder, self_ms_per_unit  # noqa: F401


def read(run):
    rec = recorder()
    names = {s.name for s in rec.spans
             if s.name.startswith(("mpc.", "ilqr."))} if rec else set()
    return self_ms_per_unit(run, names)
