"""chain_roofline: the least time the card needs for a solve's chain
work (rollouts, linearizations, stage quadratizations, Riccati passes;
``counts/chain.py``, from the cell's shapes) over the device time of the
kernels that did it.

Attribution: the device time, in the traced stretch, of every kernel that
the program's own CUDA sources (``csrc/``) declare, whatever its name; the
solve launches no other kernel of the program. PyTorch's and cuBLAS's
kernels (the plain-torch terminal quadratization, costs and glue) are not
counted here: they show in device_idle_pct.mpc and the launches."""

import os

from benchmark.counts import chain
from benchmark.device import bound_s, kernel_name, own_kernels


def read(run):
    import mujoco_rl_ur5_tpu_torch as port
    ours = own_kernels(os.path.dirname(port.__file__))
    t = sum(run.trace.time_by_name(lambda n: kernel_name(n) in ours)
            .values())
    if not t:
        return None
    cfg, tr = run.work.cfg, run.work.tr
    mode = "reach" if tr["kind"] == "reach_solve" else "track"
    parts = chain.solve_work(mode, tr["batch"], cfg["horizon"],
                             cfg["substeps"], tr["iters"],
                             len(cfg["alphas"]), cfg["nx"], cfg["nu"])
    return 100.0 * run.units * chain.solve_bound_s(parts, bound_s) / t
