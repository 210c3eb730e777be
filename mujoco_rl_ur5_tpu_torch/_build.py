"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

Each kernel is one ``csrc/*.cu`` file with a plain C entry point. Sources
that depend on the model (the generated substep and cost headers of
physics/cuda_chain.py) are written next to the static source into a build
directory keyed by a hash of everything that goes into the compile, so a
library is built once per distinct source and reused after. The build
directory is ``build/kernels`` at the repository root (listed in
.gitignore), or ``$MUJOCO_RL_UR5_TORCH_BUILD``.

Builds happen at first use; ``build_many`` starts one nvcc per source at
once, which is how ``GraspMPC.build_kernels`` and ``chip_smoke.py`` build
the whole path. The compiler's ``-Xptxas -v`` report (registers, spills) is
kept in ``ptxas.log`` beside each library.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from dataclasses import dataclass, field

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.environ.get(
    "MUJOCO_RL_UR5_TORCH_BUILD",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 "build", "kernels"))
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


@dataclass
class KernelSource:
    """One library: a static ``csrc`` file, the generated headers it
    includes, and the C entry point with its ctypes argument types."""

    name: str                      # csrc/<name>.cu
    entry: str                     # its extern "C" launcher
    argtypes: tuple
    headers: dict = field(default_factory=dict)   # file name -> text
    flags: tuple = ()              # nvcc flags beyond NVCC_FLAGS

    @functools.cached_property
    def text(self) -> str:
        with open(os.path.join(CSRC, self.name + ".cu")) as f:
            return f.read()

    @functools.cached_property
    def key(self) -> str:
        h = hashlib.sha256(" ".join(NVCC_FLAGS + self.flags).encode())
        h.update(self.text.encode())
        for n in sorted(self.headers):
            h.update(n.encode() + b"\0" + self.headers[n].encode())
        return f"{self.name}-{h.hexdigest()[:16]}"


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                           "built on a machine with the CUDA toolkit")
    return path


def build_many(sources: list[KernelSource]) -> list[ctypes.CDLL]:
    """Build (in parallel, one nvcc each) and load every library not yet
    built; returns the loaded libraries in order."""
    todo = []
    for src in sources:
        key = src.key
        if key in _loaded:
            continue
        d = os.path.join(BUILD_DIR, key)
        so = os.path.join(d, "lib.so")
        if not os.path.exists(so):
            os.makedirs(d, exist_ok=True)
            cu = os.path.join(d, src.name + ".cu")
            with open(cu, "w") as f:
                f.write(src.text)
            for n, text in src.headers.items():
                with open(os.path.join(d, n), "w") as f:
                    f.write(text)
            tmp = os.path.join(d, f"lib.so.tmp{os.getpid()}")
            log = open(os.path.join(d, "ptxas.log"), "w")
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, *src.flags, "-I", d, "-o", tmp, cu],
                stdout=log, stderr=subprocess.STDOUT)
            todo.append((src, key, so, tmp, proc, log))
    for *_, proc, log in todo:
        proc.wait()
        log.close()
    for src, key, so, tmp, proc, log in todo:
        rc = proc.returncode
        if rc != 0:
            with open(log.name) as f:
                raise RuntimeError(f"nvcc failed for {src.name} "
                                   f"(exit {rc}):\n{f.read()[-4000:]}")
        os.replace(tmp, so)
    out = []
    for src in sources:
        key = src.key
        if key not in _loaded:
            lib = ctypes.CDLL(os.path.join(BUILD_DIR, key, "lib.so"))
            fn = getattr(lib, src.entry)
            fn.argtypes = list(src.argtypes)
            fn.restype = ctypes.c_int
            _loaded[key] = lib
        out.append(_loaded[key])
    return out


def ptxas_report(src: KernelSource) -> list[str]:
    """ptxas's register, shared-memory and spill lines for a built source."""
    with open(os.path.join(BUILD_DIR, src.key, "ptxas.log")) as f:
        return [ln.split("ptxas info    :")[-1].strip() for ln in f
                if "Used" in ln or "spill" in ln]


def call(src: KernelSource, *args) -> None:
    """Build if needed, launch through the C entry point, and raise if the
    launch was refused."""
    lib = build_many([src])[0]
    rc = getattr(lib, src.entry)(*args)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {src.name} failed to launch: "
                           f"cudaError {rc}")
