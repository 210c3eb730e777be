"""mpc.launches_per_solve: operations the card ran per solve call (the
program's own kernels, torch's and cuBLAS's, copies and sets), counted by
torch.profiler over the traced stretch."""


def read(run):
    n = run.trace.launches()
    return n / run.units if n else None
