"""The needed-work counts against the numbers the repository's
chip_smoke.py printed for the same shapes at commit c4951de (its
``backward_flops`` and the bound column of PERF.md's kernel table: B=4096,
H=64, 8 substeps, 5 alphas, nx=16, nu=7; the ray cast's bytes bound at
B=256 and 4096 on the object pile's 200 x 200 top_down camera)."""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from benchmark import manifest
from benchmark.counts import chain, raycast
from benchmark.device import bound_s


def test_backward_flops():
    assert chain.backward_flops(16, 8) == 32684
    assert chain.backward_flops(16, 7) == 29671


@pytest.mark.parametrize("mode,part,ms", [
    ("reach", "rollout_open", 0.135), ("reach", "lin", 0.582),
    ("reach", "rollout_closed", 0.689), ("track", "rollout_closed", 0.683),
    ("reach", "backward", 0.343), ("reach", "quad", 0.090)])
def test_chain_bounds(mode, part, ms):
    parts = {p[0]: p for p in chain.solve_work(mode, 4096, 64, 8, 6, 5, 16,
                                               7)}
    _, _, ops, nbytes = parts[part]
    assert round(bound_s(ops, nbytes) * 1e3, 3) == ms


def test_track_has_no_quadratization_work():
    assert "quad" not in {p[0] for p in chain.solve_work(
        "track", 8, 4, 8, 2, 5, 16, 7)}


@pytest.mark.parametrize("frames,ms", [(256, 0.0615), (4096, 0.982)])
def test_raycast_bytes_bound(frames, ms):
    from benchmark.reference.physics.kinematics import fk
    from benchmark.reference.render import camera
    from benchmark.reference.render import raycast as rc
    from benchmark.reference.scene.compile import load_model
    m = load_model(os.path.join(manifest.HERE, "scenes",
                                "ur5_2finger_objects.xml"), device="cpu")
    cam = camera.make_camera(m, "top_down", 200, 200)
    q = torch.as_tensor(np.asarray(m.qpos0))[None].expand(2, -1)
    par, code, faces = rc.geom_table(m, fk(m, q), cam)
    ops, nbytes = raycast.cast_work(par, code, faces, cam.dirs,
                                    rc.render_tables(m, cam).cull, 200, 200,
                                    rc.TILE, frames)
    assert round(nbytes / 3.35e12 * 1e3, 4 if frames == 256 else 3) == ms
    # the culled operations are below the bytes: the cast is bound by them
    assert bound_s(ops, nbytes) == nbytes / 3.35e12
