"""The port's scene compiler on scenes with meshes, cameras and colours,
against the JAX package's compiler, field by field.

Two scenes, each compiled by both packages from the same file:

* the object pile (mujoco_rl_ur5_tpu_torch/assets/ur5_2finger_objects.xml):
  the arm with mesh finger pads (finger_pad.stl, scaled from mm), the bin,
  10 spheres, 10 boxes, 10 cylinders and 10 capsules, a ``top_down``
  camera, ``visual/map``, a colour on every geom;
* a small scene written here: a free body whose inertia comes from a mesh
  (``inertiafromgeom``, the pad at another scale under a ``meshdir``), a
  texture and two materials (one with its own rgba, one taking the
  texture's colour), a geom group, and two cameras (euler orientation,
  fovy).

Field by field: integer tables, hull tables, colours, cameras, depth range
and extent exactly (both compilers lower the same float64 numbers to
float32); the qpos0 invweights, which both compute in float32 through
their own FK and CRBA, to 5e-4 relative.
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest

from mujoco_rl_ur5_tpu.scene.compile import compile_spec as jax_compile_spec
from mujoco_rl_ur5_tpu.scene.mjcf import parse_mjcf as jax_parse_mjcf
from mujoco_rl_ur5_tpu_torch import OBJECTS
from mujoco_rl_ur5_tpu_torch.scene.compile import compile_file
from mujoco_rl_ur5_tpu_torch.scene.mjcf import (
    GEOM_CAPSULE, GEOM_MESH, GEOM_SPHERE,
)
from mujoco_rl_ur5_tpu_torch.scene.model import ARRAY_FIELDS, Topology

SMALL = """<mujoco model="small_mesh_scene">
  <compiler angle="degree" meshdir="meshes"/>
  <visual><map znear="0.02" zfar="20"/></visual>
  <asset>
    <mesh name="pad" file="finger_pad.stl" scale="0.002 0.001 0.0015"/>
    <texture name="grain" type="2d" rgb1="0.3 0.6 0.2"/>
    <material name="painted" rgba="0.9 0.1 0.4 0.8"/>
    <material name="wood" texture="grain"/>
  </asset>
  <worldbody>
    <geom name="floor" type="plane" size="1 1 0.1" material="wood"/>
    <camera name="side" pos="0.8 -0.6 1.0" euler="60 0 90" fovy="58"/>
    <camera name="top" pos="0 0 1.5"/>
    <body name="block" pos="0 0 0.3" euler="10 20 30">
      <freejoint name="block_joint"/>
      <geom name="block_pad" type="mesh" mesh="pad" material="painted"
            group="2"/>
      <geom name="block_ball" type="sphere" size="0.02" pos="0.05 0 0"
            rgba="0.1 0.2 0.3 1"/>
    </body>
    <body name="ball" pos="0.3 0 0.2">
      <freejoint name="ball_joint"/>
      <geom name="ball_geom" type="sphere" size="0.03"/>
    </body>
  </worldbody>
</mujoco>
"""

INVWEIGHT_RTOL = 5e-4
SCENES = ["objects", "small"]


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    d = tmp_path_factory.mktemp("scene")
    (d / "meshes").mkdir()
    shutil.copy(os.path.join(os.path.dirname(OBJECTS), "finger_pad.stl"),
                d / "meshes")
    (d / "small.xml").write_text(SMALL)
    return {name: (compile_file(path), jax_compile_spec(jax_parse_mjcf(path)))
            for name, path in (("objects", OBJECTS),
                               ("small", os.fspath(d / "small.xml")))}


@pytest.mark.parametrize("scene", SCENES)
def test_topology_matches_jax(scenes, scene):
    port, ref = (m.topo for m in scenes[scene])
    for f in dataclasses.fields(Topology):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if f.name == "pair_groups":
            assert [(x, y) for x, y, _ in a] == [(x, y) for x, y, _ in b]
            for (_, _, i), (_, _, j) in zip(a, b):
                np.testing.assert_array_equal(i, j)
        elif f.name == "body_levels":
            assert len(a) == len(b)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        elif isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=f.name)
        elif isinstance(a, tuple):
            assert tuple(a) == tuple(b), f.name
        else:
            assert a == b, f.name


@pytest.mark.parametrize("scene", SCENES)
def test_model_arrays_match_jax(scenes, scene):
    """Hull tables (the pad's hull beside the cylinder prisms), colours,
    cameras, inertials (the small scene's block from its mesh): equal."""
    port, ref = scenes[scene]
    for name in ARRAY_FIELDS:
        if name in ("dof_invweight0", "geom_invweight0"):
            continue
        a, b = getattr(port, name), np.asarray(getattr(ref, name))
        assert a.shape == b.shape, name
        if b.dtype.kind == "f":
            assert a.dtype == b.dtype == np.float32, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("scene", SCENES)
def test_invweight0_matches_jax(scenes, scene):
    port, ref = scenes[scene]
    for name in ("dof_invweight0", "geom_invweight0"):
        np.testing.assert_allclose(getattr(port, name),
                                   np.asarray(getattr(ref, name)),
                                   rtol=INVWEIGHT_RTOL, atol=1e-12)


def test_object_pile_composition(scenes):
    """The reference pile's shape: nq 288, nv 248, 40 free objects of four
    families, mesh pads whose hull (24 vertices, 34 faces) widens the hull
    tables past the cylinder prism's 18 faces, one top_down camera at
    (0, -0.6, 2.0), and sphere-hull and capsule-hull pair groups."""
    m, _ = scenes["objects"]
    t = m.topo
    assert (t.nq, t.nv, t.ncam, t.cam_names) == (288, 248, 1, ("top_down",))
    np.testing.assert_allclose(m.cam_pos[0], [0.0, -0.6, 2.0])
    np.testing.assert_array_equal(m.cam_quat[0], [1.0, 0, 0, 0])
    assert (t.hull_maxv, t.hull_maxf) == (32, 34) and m.cam_fovy[0] == 45
    pad = t.geom_meshid[t.geom_id("left_finger")]
    assert pad == t.geom_meshid[t.geom_id("right_finger")]
    assert m.hull_vmask[pad].sum() == 24
    assert (m.hull_fdist[pad] < 1e9).sum() == 34
    kinds = [t.geom_type[t.geom_id(f"object_{i}_geom")] for i in range(40)]
    assert [kinds.count(k) for k in sorted(set(kinds))] == [10] * 4
    groups = {(a, b): len(i) for a, b, i in t.pair_groups}
    assert groups[(GEOM_SPHERE, GEOM_MESH)] > 0
    assert groups[(GEOM_CAPSULE, GEOM_MESH)] > 0
    assert len({tuple(c) for c in m.geom_rgba[[t.geom_id(f"object_{i}_geom")
                                               for i in range(0, 40, 10)]]}
               ) == 4
