"""The benchmark of the PyTorch/CUDA port, one cell per run.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout with one NVIDIA GPU. A cell (an entry of
``BENCHMARK.json``'s ``workloads``) names a configuration and a traffic
mix; ``manifest.py`` finds their files by name, and the mix's ``kind``
names the generator under ``kinds/`` that sets the cell up and runs one
unit of its work. Every cell is a closed loop with one client: each call
waits for the synchronised result of the one before.

With ``--trace 0`` the run sets up (inputs from ``--seed``, every shape the
cell uses warmed, the kernels built or taken from their cache under
``build/kernels``), then calls the unit until ``--seconds`` have passed,
and reports the cell's end-to-end metrics. With ``--trace 1`` it runs
three stretches of ``trace_units`` calls instead: without the profiler,
timed by the host's clock, with what the metrics' readers instrument
(``during``: CUDA events around the program's own calls), since the
profiler slows the host's launches while it records and after; under
torch.profiler recording the device's operations (the traced window: the
device's busy and window seconds, the device-time metrics); and under the
profiler recording the host's operations too, for the breakdown's idle
gaps. It reports the cell's per-layer metrics, each read by its file
under ``metrics/``.
Either way, once the window has closed and the peak memory has been read,
the answers kept from the window are compared with the plain reference
under ``reference/`` (see each kind's ``check``), and the numbers compared
are printed beside their limits, last on standard error and last in the
result's line. The result is the last line of standard output, one JSON
object. A run whose process holds JAX or the JAX package, after the
window or after the comparison, prints no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "mujoco_rl_ur5_tpu"}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> set:
    """Top-level names of loaded modules that this process must not hold,
    compared whole (the port's name begins with the JAX package's)."""
    return {m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN


def refuse_forbidden(when: str) -> None:
    """Ends the run, with no result, if the process holds a forbidden
    module, naming it on standard error."""
    found = forbidden_modules()
    if found:
        log(f"the run holds {sorted(found)} in sys.modules {when}")
        raise SystemExit(f"forbidden modules loaded {when}")


def p95_ms(walls: list) -> float:
    """The 95th percentile of the calls' wall times in ms, over every call
    of the window."""
    ms = [w * 1e3 for w in walls]
    if len(ms) < 2:
        return max(ms)
    return statistics.quantiles(ms, n=100, method="inclusive")[94]


class Run:
    """What a per-layer metric's reader reads: the cell's work object, the
    trace of the profiled stretch, its first unit's index, its number of
    units and wall seconds, and the wall seconds of as many units run
    before it without the profiler."""

    def __init__(self, work, trace, first: int, units: int,
                 window_s: float, plain_s: float):
        self.work, self.trace, self.first = work, trace, first
        self.units, self.window_s, self.plain_s = units, window_s, plain_s


def number(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             bench: str = None, device: str = "cuda", chips: int = 1,
             t0: float = T0) -> dict:
    """Set up the cell, run its window (or traced stretch), read the
    metrics and check the answers. Returns the result object."""
    import torch

    from benchmark import manifest

    bench = bench or manifest.HERE
    man = manifest.load(os.path.dirname(bench))
    cell = manifest.cell(man, workload)
    cfg = manifest.config(man, cell["config"], os.path.dirname(bench))
    tr = manifest.traffic(cell["traffic"], bench)
    e2e, per_layer = manifest.metrics_of(man, workload)
    kind = manifest.kind(tr["kind"], bench)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    work = kind.Work(cfg, tr, seed, device, bench)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    setup_s = time.perf_counter() - t0
    log(f"{workload}: set up in {setup_s:.3f} s")

    readers = ({m["name"]: manifest.reader(m["name"], bench)
                for m in per_layer} if trace else {})
    walls = []
    if trace:
        from torch.profiler import ProfilerActivity, profile
        n = tr["trace_units"]
        ops = (ProfilerActivity.CUDA if device == "cuda"
               else ProfilerActivity.CPU)

        def stretch(first):
            for i in range(first, first + n):
                work.call(i)
                sync()
                work.keep(i)
        with contextlib.ExitStack() as hooks:
            for r in readers.values():
                if hasattr(r, "during"):
                    hooks.enter_context(r.during(work))
            start = time.perf_counter()
            stretch(0)
            plain_s = time.perf_counter() - start
        with profile(activities=[ops]) as prof:
            start = time.perf_counter()
            stretch(n)
            window = time.perf_counter() - start
        with profile(activities=list({ProfilerActivity.CPU: 0,
                                      ops: 0})) as host_prof:
            stretch(2 * n)
        calls, done = n, 3 * n
    else:
        start = time.perf_counter()
        i = 0
        while True:
            a = time.perf_counter()
            work.call(i)
            sync()
            b = time.perf_counter()
            walls.append(b - a)
            work.keep(i)
            i += 1
            if b - start >= seconds:
                break
        window = b - start
        calls = done = len(walls)
    peak = (torch.cuda.max_memory_allocated() if device == "cuda" else 0)
    refuse_forbidden("after the window")

    m_unit = {m["name"]: m["unit"] for m in per_layer}
    metrics, dev = {}, {"platform": "gpu" if device == "cuda" else device,
                        "kind": (torch.cuda.get_device_name(0)
                                 if device == "cuda" else device),
                        "count": chips, "memory_peak_bytes": int(peak)}
    breakdown = None
    if trace:
        from benchmark.device import Trace
        tr_obj = Trace(prof)
        host = Trace(host_prof)
        del prof, host_prof
        run = Run(work, tr_obj, n, calls, window, plain_s)
        for name, r in readers.items():
            v = r.read(run)
            if v is not None:
                metrics[name] = {"value": v, "unit": m_unit[name]}
        dev["busy_s"] = tr_obj.busy_s()
        dev["window_s"] = window
        breakdown = {"device_ops": tr_obj.top_ops(10),
                     "idle_gaps": host.idle_gaps(10)}
    else:
        values = {"setup_s": setup_s}
        rate = tr.get("rate_metric")
        if rate:
            values[rate] = tr["batch"] * calls / window
        lat = tr.get("latency_metric")
        if lat:
            values[lat] = p95_ms(walls)
        for m in e2e:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    log(f"{workload}: {calls} calls in {window:.3f} s; peak "
        f"{peak / 2**30:.3f} GiB; " + ", ".join(
            f"{k} {v['value']:.6g} {v['unit']}" for k, v in metrics.items()))

    work.free()
    if device == "cuda":
        torch.cuda.empty_cache()
    from benchmark.generators import rng
    readings, failed = work.check(rng(seed, 9))
    refuse_forbidden("after the comparison")
    correct = failed == 0 and all(
        number(v) is not None and v <= lim for v, lim in readings.values())
    for k, (v, lim) in readings.items():
        log(f"compared {k}: {v:.6e} (limit {lim:.6e}) "
            f"{'ok' if number(v) is not None and v <= lim else 'FAIL'}")
    out = {"correct": bool(correct), "attempted": int(done * tr["batch"]),
           "failed": int(failed), "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["compared"] = {k: {"value": number(v), "limit": lim}
                       for k, (v, lim) in readings.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    opts = ap.parse_args(argv)
    import torch
    from benchmark import manifest
    chips = manifest.cell(manifest.load(), opts.workload).get("chips", 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"benchmark: the cell needs {chips} CUDA device(s); "
            f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
            f"{torch.cuda.device_count()} device(s)")
        return 3
    from benchmark.device import power_limit
    log(f"device: {power_limit()}")
    out = run_cell(opts.workload, opts.seed, opts.seconds, bool(opts.trace),
                   chips=chips)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
