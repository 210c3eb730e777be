"""The port's scene compiler for the contact step against the JAX package's.

Two scenes, each compiled by both packages from the same file:

* the pile fixture (mujoco_rl_ur5_tpu_torch/assets/ur5_2finger_pile.xml):
  the arm, a floor, a bin of five boxes and 40 free boxes and cylinders;
* a small scene written here: a limited hinge and a limited slide, a
  ``<contact><exclude>``, a non-colliding geom, geom default classes,
  spheres, capsules, a cylinder and an ellipsoid, and a static link whose
  box overlaps a hinged link's at qpos0, which the compiler prunes.

Field by field: integer tables exactly; float tables exactly (both
compilers lower the same float64 numbers to float32); the qpos0
invweights, which both compute in float32 through their own FK and CRBA,
to 5e-4 relative (each is within 2e-4 of a float64 evaluation: the arm's
mass matrix has a condition number near 1e7).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from mujoco_rl_ur5_tpu.scene.compile import compile_spec as jax_compile_spec
from mujoco_rl_ur5_tpu.scene.mjcf import parse_mjcf as jax_parse_mjcf
from mujoco_rl_ur5_tpu_torch import PILE
from mujoco_rl_ur5_tpu_torch.physics.constraints import n_candidates
from mujoco_rl_ur5_tpu_torch.scene.compile import compile_file, load_model
from mujoco_rl_ur5_tpu_torch.scene.model import (
    ARRAY_FIELDS, Topology, make_state,
)

SMALL = """<mujoco model="small_contact_scene">
  <compiler angle="degree"/>
  <option timestep="0.002" iterations="40" impratio="3"/>
  <default>
    <geom friction="0.8 0.01 0.001" margin="0.002"/>
    <default class="soft">
      <geom solref="0.03 0.8" solimp="0.8 0.9 0.002" condim="4"/>
    </default>
  </default>
  <worldbody>
    <geom name="floor" type="plane" size="1 1 0.1"/>
    <body name="base" pos="0 0 0.5">
      <geom name="base_box" type="box" size="0.1 0.1 0.1"/>
      <body name="link1" pos="0 0 0.12">
        <joint name="hinge" type="hinge" axis="0 1 0" limited="true"
               range="-30 45" damping="0.5"/>
        <geom name="link1_box" type="box" size="0.05 0.05 0.05"
              class="soft"/>
        <body name="link2" pos="0.2 0 0">
          <joint name="slide" type="slide" axis="1 0 0" limited="true"
                 range="-0.05 0.1"/>
          <geom name="link2_cap" type="capsule" size="0.03 0.06"
                euler="0 90 0"/>
          <geom name="ghost" type="sphere" size="0.02" contype="0"
                conaffinity="0"/>
        </body>
      </body>
    </body>
    <body name="ball" pos="0.5 0 0.3">
      <freejoint name="ball_joint"/>
      <geom name="ball_geom" type="sphere" size="0.04" density="500"/>
    </body>
    <body name="can" pos="-0.5 0 0.3" euler="20 0 10">
      <freejoint name="can_joint"/>
      <geom name="can_geom" type="cylinder" size="0.03 0.05" class="soft"/>
    </body>
    <body name="pill" pos="0 0.5 0.3">
      <freejoint name="pill_joint"/>
      <geom name="pill_geom" type="capsule" size="0.02 0.04"/>
      <geom name="pill_egg" type="ellipsoid" size="0.02 0.03 0.025"
            pos="0 0 0.06"/>
    </body>
  </worldbody>
  <contact>
    <exclude body1="link2" body2="base"/>
  </contact>
</mujoco>
"""

INVWEIGHT_RTOL = 5e-4


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    small = tmp_path_factory.mktemp("scene") / "small.xml"
    small.write_text(SMALL)
    out = {}
    for name, path in (("pile", PILE), ("small", os.fspath(small))):
        out[name] = (compile_file(path), jax_compile_spec(
            jax_parse_mjcf(path)))
    return out


SCENES = ["pile", "small"]


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
    """Geoms, collision proxies, hull tables, limits, mixed pair parameters
    and inertials (from the geoms for the free bodies): identical."""
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
                                   rtol=INVWEIGHT_RTOL, atol=1e-6,
                                   err_msg=name)


def test_pile_widths(scenes):
    """The state size and pair groups of the reference pile."""
    m = scenes["pile"][0]
    t = m.topo
    assert (t.nq, t.nv, t.ntree, t.mtdof, t.ngeom) == (288, 248, 41, 8, 48)
    assert (t.nmesh, t.hull_maxv, t.hull_maxf) == (20, 32, 18)
    groups = {(a, b): len(i) for a, b, i in t.pair_groups}
    # plane-box, plane-hull, box-box, box-hull, hull-hull
    assert groups == {(0, 6): 22, (0, 7): 20, (6, 6): 341, (6, 7): 540,
                      (7, 7): 190}
    assert n_candidates(m) == 1848
    assert t.neq == 1 and t.nlimit == 0
    assert np.all(m.dof_damping[8:] == np.float32(0.007))


def test_small_scene_limits_excludes_and_pruning(scenes):
    m = scenes["small"][0]
    t = m.topo
    assert t.nlimit == 2
    np.testing.assert_allclose(m.limit_range, [[-np.pi / 6, np.pi / 4],
                                               [-0.05, 0.1]], rtol=1e-6)
    pairs = {(t.geom_names[a], t.geom_names[b])
             for a, b in zip(t.pair_geom1, t.pair_geom2)}
    names = set(t.geom_names)
    assert "ghost" in names and not any("ghost" in p for p in pairs)
    # excluded, and pruned (static base against the hinged link, overlapping
    # at qpos0)
    assert ("base_box", "link2_cap") not in pairs
    assert ("link2_cap", "base_box") not in pairs
    assert ("link1_box", "base_box") not in pairs
    assert ("base_box", "link1_box") not in pairs
    assert ("floor", "ball_geom") in pairs and ("floor", "can_geom") in pairs


def test_load_model_and_state_on_the_card_by_default(monkeypatch):
    m = load_model(PILE, device="cpu")
    assert all(torch.is_tensor(getattr(m, f))
               and getattr(m, f).device == torch.device("cpu")
               for f in ARRAY_FIELDS)
    s = make_state(m, 3, device="cpu")
    assert s.qpos.shape == (3, 288) and s.qvel.shape == (3, 248)
    np.testing.assert_array_equal(s.qpos[1].numpy(), m.qpos0.numpy())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        load_model(PILE)
    with pytest.raises(RuntimeError, match="cuda"):
        make_state(m, 3)
