"""Each cell's unit of work at a tiny size on the CPU, through the
program's plain path, with the whole run around it: set-up, window, the
end-to-end metrics and the check against the reference; and the seeded
generators."""

from __future__ import annotations

import os

import numpy as np
import pytest

from benchmark import generators, manifest
from benchmark.run import run_cell
from benchmark.tests.tiny import tiny_bench

CELLS = [w["name"] for w in manifest.load()["workloads"]]
SEED = 2 ** 31 + 12345


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_is_correct_on_the_cpu(tmp_path, cell):
    bench = tiny_bench(tmp_path)
    out = run_cell(cell, SEED, 0.0, False, bench=bench, device="cpu")
    e2e, _ = manifest.metrics_of(manifest.load(os.path.dirname(bench)),
                                 cell)
    assert out["correct"], out["compared"]
    assert out["failed"] == 0 and out["attempted"] >= 4
    assert set(out["metrics"]) == {m["name"] for m in e2e}
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert list(out)[-1] == "compared"


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 1, 2 ** 40, -3])
def test_generators_repeat_from_the_seed(seed):
    a = generators.reach_problem(16, generators.rng(seed, 1))
    b = generators.reach_problem(16, generators.rng(seed, 1))
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    c = generators.tracking_problem(8, 4, generators.rng(seed, 1))
    assert c[1].shape == (8, 5, 8) and np.allclose(c[1][:, 0], c[0][:, :8])
    other = generators.reach_problem(16, generators.rng(seed + 1, 1))
    assert not np.array_equal(a[0], other[0])


def test_scene_rest_matches_the_reference_compile():
    from benchmark.reference.scene.compile import compile_file
    from benchmark.reference.scene.mjcf import JNT_FREE
    path = os.path.join(manifest.HERE, "scenes", "ur5_2finger_objects.xml")
    q, free = generators.scene_rest(path)
    m = compile_file(path)
    t = m.topo
    assert free == [int(t.jnt_qposadr[j]) for j in
                    np.nonzero(np.asarray(t.jnt_type) == JNT_FREE)[0]]
    keep = np.ones(len(q), bool)
    for a in free:
        keep[a + 3: a + 7] = False
    np.testing.assert_allclose(q[keep], np.asarray(m.qpos0)[keep],
                               atol=1e-6)
    d = generators.drop_qpos(q, free, 3, generators.rng(1, 1))
    quats = np.stack([d[:, a + 3: a + 7] for a in free])
    np.testing.assert_allclose(np.linalg.norm(quats, axis=-1), 1, atol=1e-6)
