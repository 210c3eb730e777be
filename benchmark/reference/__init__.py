"""The benchmark's plain reference: frozen copies of the program's plain
paths (scene compiler, chain and contact dynamics, ray cast and render
epilogue, Riccati pass) and a plain batched iLQR (``ilqr.py``). It imports
nothing of the program and takes nothing the program made: every model,
plan and state is rebuilt here from the frozen scene files under
``benchmark/scenes/`` and from the inputs the benchmark generated."""

import torch

DTYPE = torch.float64
THREADS = 4         # the CPU threads the reference runs on


def as_reference(*ts):
    """Answers of the program (or the control) as the reference compares
    them: float64 tensors on the CPU."""
    return [torch.as_tensor(t).to("cpu", DTYPE) for t in ts]
