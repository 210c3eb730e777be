"""What the benchmark may import: nothing under benchmark/ imports jax,
jaxlib, flax or the JAX package (top-level names compared whole: the
port's name begins with the JAX package's), nor the repository's
chip_smoke.py, bench.py or scripts/; the plain reference also imports
nothing of the port."""

from __future__ import annotations

import ast
import os
import subprocess
import sys
import types

import pytest

from benchmark import manifest
from benchmark.run import FORBIDDEN, forbidden_modules, run_cell
from benchmark.tests.tiny import tiny_bench

NEVER = FORBIDDEN | {"chip_smoke", "bench", "scripts"}
PORT = "mujoco_rl_ur5_tpu_torch"


def sources():
    for d, _, files in os.walk(manifest.HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def imported(path: str) -> set:
    """Top-level names of every module a file imports, anywhere in it."""
    with open(path) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(sources()),
                         ids=lambda p: os.path.relpath(p, manifest.HERE))
def test_no_forbidden_import(path):
    names = imported(path)
    assert not names & NEVER, (path, names & NEVER)
    if os.sep + "reference" + os.sep in path:
        assert PORT not in names, path


def test_names_compared_whole():
    assert "mujoco_rl_ur5_tpu" in FORBIDDEN and PORT not in FORBIDDEN
    assert imported(__file__) >= {"ast", "benchmark"}


def test_reference_loads_without_the_port_or_jax():
    code = ("import sys, benchmark.reference.mpc.ilqr, "
            "benchmark.reference.physics.dynamics, "
            "benchmark.reference.render.raycast, benchmark.kinds, "
            "benchmark.run as r; "
            "top = {m.split('.')[0] for m in sys.modules}; "
            f"print(sorted(top & set({sorted(NEVER | {PORT})!r})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=manifest.ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def test_forbidden_modules_reads_sys_modules(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in forbidden_modules()
    monkeypatch.delitem(sys.modules, "jax.numpy")
    monkeypatch.setitem(sys.modules, "mujoco_rl_ur5_tpu_torchx", sys)
    assert not forbidden_modules() & {"mujoco_rl_ur5_tpu"}


def test_no_result_when_the_check_loads_jax(tmp_path, monkeypatch):
    """A module loaded during the comparison after the window is caught
    too: the run ends with no result."""
    from benchmark import verdict
    orig = verdict.verdict

    def loading(*a, **kw):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return orig(*a, **kw)
    monkeypatch.setattr(verdict, "verdict", loading)
    bench = tiny_bench(tmp_path)
    with pytest.raises(SystemExit):
        run_cell("pile_observe_b4096", 3, 0.0, False, bench=bench,
                 device="cpu")
