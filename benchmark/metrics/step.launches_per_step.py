"""step.launches_per_step: operations the card ran per contact step (the
program's own kernels, torch's and cuBLAS's, copies and sets), counted by
torch.profiler over the traced stretch."""


def read(run):
    n = run.trace.launches()
    return n / run.units if n else None
