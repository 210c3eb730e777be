"""The port's scene/mesh.py against the JAX package's, on the object pile's
finger pad (mujoco_rl_ur5_tpu_torch/assets/finger_pad.stl, ASCII, in mm)
and on a binary STL written here (the pad's triangles scaled and moved).

Both modules are numpy and scipy, so every result must be identical:
vertices and faces exactly, mass properties, hull, halfspaces and fitted
primitive to 1e-12 relative (float64, the same operations in the same
order). Also: the pad keeps all 24 vertices in its hull, has 34 hull
faces, and its exact and legacy volumes agree for the closed solid.
"""

import os
import struct

import numpy as np
import pytest

from mujoco_rl_ur5_tpu.scene import mesh as jmesh
from mujoco_rl_ur5_tpu_torch import OBJECTS
from mujoco_rl_ur5_tpu_torch.scene import mesh

PAD = os.path.join(os.path.dirname(OBJECTS), "finger_pad.stl")
RTOL = 1e-12


def _binary_stl(path, verts, faces):
    tris = verts[faces].astype(np.float32)
    with open(path, "wb") as f:
        f.write(b"binary pad".ljust(80, b"\0"))
        f.write(struct.pack("<I", len(tris)))
        for t in tris:
            n = np.cross(t[1] - t[0], t[2] - t[0])
            f.write(np.asarray(n, "<f4").tobytes() + t.astype("<f4").tobytes()
                    + b"\0\0")


@pytest.fixture(scope="module")
def stls(tmp_path_factory):
    v, f = mesh.load_stl(PAD)
    path = tmp_path_factory.mktemp("stl") / "pad_binary.stl"
    _binary_stl(path, v * np.array([0.5, 2.0, 1.5]) + [3.0, -1.0, 2.0], f)
    return {"ascii": PAD, "binary": os.fspath(path)}


def _same(a, b):
    np.testing.assert_allclose(np.asarray(a, float), np.asarray(b, float),
                               rtol=RTOL, atol=0)


@pytest.mark.parametrize("kind", ["ascii", "binary"])
def test_load_stl_matches_jax(stls, kind):
    v, f = mesh.load_stl(stls[kind])
    jv, jf = jmesh.load_stl(stls[kind])
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(f, jf)
    assert v.shape == (24, 3) and f.shape == (44, 3)


@pytest.mark.parametrize("kind", ["ascii", "binary"])
def test_mass_properties_match_jax(stls, kind):
    v, f = mesh.load_stl(stls[kind])
    for fn in ("mass_properties", "legacy_mass_properties"):
        for a, b in zip(getattr(mesh, fn)(v, f), getattr(jmesh, fn)(v, f)):
            _same(a, b)
    vol, com, inertia = mesh.mass_properties(v, f)
    lvol, lcom, linertia = mesh.legacy_mass_properties(v, f)
    assert vol > 0 and abs(lvol - vol) < 1e-9 * vol      # a closed solid
    np.testing.assert_allclose(lcom, com, atol=1e-9 * np.abs(v).max())
    d, q = mesh.principal_inertia(2.0, inertia)
    jd, jq = jmesh.principal_inertia(2.0, inertia)
    _same(d, jd)
    _same(q, jq)


@pytest.mark.parametrize("kind", ["ascii", "binary"])
def test_hull_matches_jax(stls, kind):
    v, _ = mesh.load_stl(stls[kind])
    hv, hf = mesh.hull_faces(v)
    jhv, jhf = jmesh.hull_faces(v)
    np.testing.assert_array_equal(hv, jhv)
    np.testing.assert_array_equal(hf, jhf)
    for cap in (24, 12):
        _same(mesh.convex_hull(v, cap), jmesh.convex_hull(v, cap))
    assert len(mesh.convex_hull(v, 24)) == 24
    n, d = mesh.hull_halfspaces(mesh.convex_hull(v, 24))
    jn, jd = jmesh.hull_halfspaces(jmesh.convex_hull(v, 24))
    _same(n, jn)
    _same(d, jd)
    assert len(n) == 34                       # two octagons, 32 triangles
    assert np.all(hv @ n.T <= d + 1e-9 * np.abs(d).max())
    kind, *fit = mesh.fit_primitive(hv)
    jkind, *jfit = jmesh.fit_primitive(hv)
    assert kind == jkind
    for a, b in zip(fit, jfit):
        _same(a, b)


def test_process_mesh_matches_jax():
    scale = np.full(3, 1e-3)
    m = mesh.process_mesh("pad", PAD, scale)
    j = jmesh.process_mesh("pad", PAD, scale)
    for field in ("verts", "faces", "volume", "com", "inertia_com",
                  "hull_verts", "hull_fnorm", "hull_fdist", "fit_size",
                  "fit_pos", "fit_quat"):
        _same(getattr(m, field), getattr(j, field))
    assert m.fit_kind == j.fit_kind
    assert m.hull_fnorm.shape == (34, 3) and m.hull_verts.shape == (24, 3)
