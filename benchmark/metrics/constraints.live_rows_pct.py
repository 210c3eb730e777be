"""constraints.live_rows_pct: the share of the contact solver's facet rows
(B x ncon x NFACET slots, the counter ``constraints.rows``) that hold a
live row of an active contact (the counter ``constraints.live_rows``, the
row mask summed on the device), over the stretch of the traced run that
goes without the profiler. The rest is padding that the solver's batched
products still carry."""

from benchmark.spans import during, ratio_pct  # noqa: F401


def read(run):
    return ratio_pct("constraints.live_rows", "constraints.rows")
