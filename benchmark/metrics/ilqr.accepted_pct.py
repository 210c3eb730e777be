"""ilqr.accepted_pct: the share of the batched iLQR's scenario-iterations
whose line search improved the plan: 100 x the counter ``ilqr.accepted``
(each iteration's improved scenarios, summed on the device) / the counter
``ilqr.tried`` (B per iteration), over the stretch of the traced run that
goes without the profiler. An iteration that is not accepted is work the
solve spent and kept nothing of."""

from benchmark.spans import during, ratio_pct  # noqa: F401


def read(run):
    return ratio_pct("ilqr.accepted", "ilqr.tried")
