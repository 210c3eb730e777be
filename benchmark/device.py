"""The card: its published peaks, its name and power limit, and what a
torch.profiler trace says about a stretch of work.

The peaks are NVIDIA's H100 SXM data sheet's, at the full 700 W power
limit; every roofline share is stated against them, with the card's power
limit (``nvidia-smi``) printed beside it.
"""

from __future__ import annotations

import glob
import os
import re
import subprocess

import numpy as np

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12       # float32 outside the tensor cores


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "not read"


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of operations over
    the f32 peak and bytes over the memory peak."""
    return max(ops / PEAK_F32_FLOP_PER_S, nbytes / PEAK_BYTES_PER_S)


def own_kernels(package_dir: str) -> set:
    """Names of the program's hand-written CUDA kernels: every function its
    sources under csrc/ declare ``__global__``."""
    names = set()
    for path in glob.glob(os.path.join(package_dir, "csrc", "*.cu*")):
        with open(path) as f:
            text = f.read()
        names.update(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)",
            text))
    return names


def kernel_name(key: str) -> str:
    """A profiler kernel name's function name, without return type,
    template arguments or parameters."""
    head = key.split("(")[0].split("<")[0].strip()
    return head.split()[-1].split("::")[-1] if head else key


class Trace:
    """The device side of a torch.profiler run: every operation the card ran
    (kernels, copies, sets) as intervals in microseconds, and the host's
    operations beside them."""

    def __init__(self, prof):
        from torch.autograd import DeviceType
        evs = prof.events()
        dev = [e for e in evs if e.device_type == DeviceType.CUDA
               and e.time_range.end > e.time_range.start]
        self.names = [e.name for e in dev]
        self.start = np.array([e.time_range.start for e in dev], np.float64)
        self.end = np.array([e.time_range.end for e in dev], np.float64)
        host = [e for e in evs if e.device_type == DeviceType.CPU]
        self.host_names = [e.name for e in host]
        self.host_start = np.array([e.time_range.start for e in host],
                                   np.float64)
        self.host_end = np.array([e.time_range.end for e in host],
                                 np.float64)

    def launches(self) -> int:
        return len(self.names)

    def _union(self):
        """The merged busy intervals, sorted."""
        if not len(self.start):
            return np.zeros((0, 2))
        order = np.argsort(self.start)
        s, e = self.start[order], self.end[order]
        reach = np.maximum.accumulate(e)
        new = np.r_[True, s[1:] > reach[:-1]]
        idx = np.nonzero(new)[0]
        ends = np.r_[reach[idx[1:] - 1], reach[-1]]
        return np.stack([s[idx], ends], 1)

    def busy_s(self) -> float:
        u = self._union()
        return float((u[:, 1] - u[:, 0]).sum()) * 1e-6

    def time_by_name(self, select=None) -> dict:
        """Device seconds by operation name (optionally only the names
        ``select`` keeps)."""
        out = {}
        for n, s, e in zip(self.names, self.start, self.end):
            if select is None or select(n):
                out[n] = out.get(n, 0.0) + (e - s) * 1e-6
        return out

    def top_ops(self, n: int = 10) -> list:
        return sorted(([k, v] for k, v in self.time_by_name().items()),
                      key=lambda r: -r[1])[:n]

    def idle_gaps(self, n: int = 10, longest: int = 400) -> list:
        """The longest idle gaps between device operations, grouped by the
        innermost host operation running at each gap's middle: [name,
        seconds] of the ``n`` largest groups, over the ``longest`` gaps."""
        u = self._union()
        if len(u) < 2:
            return []
        gaps = np.stack([u[:-1, 1], u[1:, 0]], 1)
        gaps = gaps[np.argsort(gaps[:, 0] - gaps[:, 1])[:longest]]
        out = {}
        for a, b in gaps:
            mid = 0.5 * (a + b)
            inside = np.nonzero((self.host_start <= mid)
                                & (self.host_end >= mid))[0]
            if len(inside):
                k = inside[np.argmin(self.host_end[inside]
                                     - self.host_start[inside])]
                name = self.host_names[k]
            else:
                name = "(host outside any profiled operation)"
            out[name] = out.get(name, 0.0) + (b - a) * 1e-6
        return sorted(([k, v] for k, v in out.items()),
                      key=lambda r: -r[1])[:n]
