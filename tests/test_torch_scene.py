"""The port's MJCF parser, compiler, arm reduction and chain plan against the
JAX package's, on the port's hand-written arm scene
(mujoco_rl_ur5_tpu_torch/assets/ur5_2finger_arm.xml).

Both packages compile the scene's numbers to float32 arrays, so the
compiled models agree exactly. The chain plan derives the finger spring's
stiffness ``eq_kc`` from the rest-pose mass matrix; with 64-bit JAX (the
``x64`` fixture) both compute it in float64, and every plan field agrees:
integers exactly, floats to 1e-12 relative.
"""

import os

import numpy as np
import pytest
import torch

from mujoco_rl_ur5_tpu.mpc.grasp_mpc import GraspMPC as JaxGraspMPC
from mujoco_rl_ur5_tpu.physics.chain import make_chain_plan as jax_make_plan
from mujoco_rl_ur5_tpu.scene.compile import load_model as jax_load_model
from mujoco_rl_ur5_tpu.scene.mesh import (
    principal_inertia as jax_principal_inertia,
)
from mujoco_rl_ur5_tpu.scene.reduce import load_arm_model as jax_load_arm
from mujoco_rl_ur5_tpu_torch import ASSET
from mujoco_rl_ur5_tpu_torch.carry import PLAN_FIELDS
from mujoco_rl_ur5_tpu_torch.mpc.grasp_mpc import GraspMPC
from mujoco_rl_ur5_tpu_torch.physics.chain import make_chain_plan
from mujoco_rl_ur5_tpu_torch.scene.compile import (
    load_model, principal_inertia,
)
from mujoco_rl_ur5_tpu_torch.scene.mjcf import parse_mjcf
from mujoco_rl_ur5_tpu_torch.scene.reduce import (
    drop_free_bodies, load_arm_model,
)

MODEL_ARRAYS = ("qpos0", "body_pos", "body_quat", "body_mass",
                "body_inertia", "body_ipos", "body_iquat", "jnt_pos",
                "jnt_axis", "jnt_ref", "dof_damping", "dof_armature",
                "act_gear", "act_ctrlrange", "eq_poly", "eq_solref",
                "eq_solimp")
TOPO_ARRAYS = ("body_parent", "body_jntnum", "body_tree", "tree_rootbody",
               "jnt_type", "jnt_body", "jnt_qposadr", "jnt_dofadr",
               "act_dofadr", "act_jnt", "eq_j1_dof", "eq_j2_dof",
               "eq_j1_qadr", "eq_j2_qadr")


@pytest.fixture(scope="module")
def models():
    return {"full": (load_model(ASSET, device="cpu"),
                     jax_load_model(ASSET)),
            "arm": (load_arm_model(ASSET), jax_load_arm(ASSET))}


@pytest.fixture(scope="module")
def plans(x64, models):
    return (make_chain_plan(models["arm"][0]),
            jax_make_plan(models["arm"][1]))


def test_arm_widths(models):
    full, arm = models["full"][0].topo, models["arm"][0].topo
    assert (full.nq, full.nv, full.nu) == (15, 14, 7)   # + the free box
    assert (arm.nq, arm.nv, arm.nu, arm.neq) == (8, 8, 7, 1)
    assert make_chain_plan(models["arm"][0]).nmov == 9
    jarm = models["arm"][1].topo
    assert (jarm.nq, jarm.nu, jarm.neq) == (8, 7, 1)


@pytest.mark.parametrize("which", ["full", "arm"])
def test_compiled_model_matches_jax(models, which):
    port, ref = models[which]
    for name in ("nq", "nv", "nu", "nbody", "njnt", "neq", "ntree",
                 "timestep"):
        assert getattr(port.topo, name) == getattr(ref.topo, name), name
    np.testing.assert_array_equal(np.asarray(port.topo.gravity),
                                  np.asarray(ref.topo.gravity))
    assert port.topo.body_names == tuple(ref.topo.body_names)
    assert port.topo.joint_names == tuple(ref.topo.joint_names)
    for name in TOPO_ARRAYS:
        np.testing.assert_array_equal(
            np.asarray(getattr(port.topo, name)),
            np.asarray(getattr(ref.topo, name)), err_msg=name)
    for name in ("xpos0", "xquat0"):
        np.testing.assert_allclose(np.asarray(getattr(port.topo, name)),
                                   np.asarray(getattr(ref.topo, name)),
                                   rtol=1e-12, atol=1e-12, err_msg=name)
    for name in MODEL_ARRAYS:
        a, b = np.asarray(getattr(port, name)), np.asarray(getattr(ref, name))
        assert a.dtype == b.dtype == np.float32, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("field", PLAN_FIELDS)
def test_chain_plan_field_matches_jax(plans, field):
    a, b = getattr(plans[0], field), getattr(plans[1], field)
    if isinstance(a, (int, float)):
        assert a == b
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    if a.dtype.kind in "iub":
        np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)


def test_full_model_state_maps_match_jax(models):
    full, arm = models["full"][0], models["arm"][0]
    tm = GraspMPC(full, arm_model=arm, horizon=2, substeps=1,
                  device="cpu")
    jm = JaxGraspMPC(models["full"][1], arm_model=models["arm"][1],
                     horizon=2, substeps=1)
    np.testing.assert_array_equal(tm.full_qadr, jm.full_qadr)
    np.testing.assert_array_equal(tm.full_dofadr, jm.full_dofadr)
    rng = np.random.default_rng(0)
    qpos = rng.standard_normal((3, full.topo.nq)).astype(np.float32)
    qvel = rng.standard_normal((3, full.topo.nv)).astype(np.float32)
    x = tm.x_from_state(torch.from_numpy(qpos), torch.from_numpy(qvel))
    np.testing.assert_array_equal(
        x.numpy(), np.concatenate([qpos[:, jm.full_qadr],
                                   qvel[:, jm.full_dofadr]], -1))


def test_principal_inertia_matches_jax():
    rng = np.random.default_rng(1)
    for _ in range(5):
        W = rng.standard_normal((3, 3))
        inertia = W @ W.T + 0.1 * np.eye(3)
        d, q = principal_inertia(inertia)
        jd, jq = jax_principal_inertia(1.0, inertia)   # unit mass
        np.testing.assert_allclose(d, jd, rtol=1e-12)
        # the same rotation (a quaternion is defined up to sign)
        assert min(np.abs(q - jq).max(), np.abs(q + jq).max()) < 1e-9


def test_drop_free_bodies_keeps_the_arm():
    spec = parse_mjcf(ASSET)
    names = [b.name for b in spec.worldbody.bodies]
    kept = [b.name for b in drop_free_bodies(spec).worldbody.bodies]
    assert "box_1" in names and "box_1" not in kept
    assert kept == [n for n in names if n != "box_1"]
    assert [b.name for b in spec.worldbody.bodies] == names   # not mutated


def test_inertia_from_geoms_raises(tmp_path):
    """Inertia from a mesh geom needs scene/mesh.py, not ported yet (the
    primitive types' mass properties are: tests/test_torch_contact_scene)."""
    xml = tmp_path / "geom_inertia.xml"
    xml.write_text(
        '<mujoco><worldbody><body name="b"><joint name="j"/>'
        '<geom type="mesh" mesh="m"/></body></worldbody></mujoco>')
    with pytest.raises(ValueError, match="inertiafromgeom"):
        load_model(os.fspath(xml), device="cpu")


def _variant(tmp_path, kind):
    """The arm scene rewritten with ``<include>`` files or in degrees."""
    with open(ASSET) as f:
        text = f.read()
    if kind == "include":
        a, b = text.index("  <equality>"), text.index("</mujoco>")
        (tmp_path / "tail.xml").write_text(
            "<mujoco>\n" + text[a:b] + "</mujoco>\n")
        text = text[:a] + '  <include file="tail.xml"/>\n</mujoco>\n'
    else:
        text = (text.replace('angle="radian"', 'angle="degree"')
                .replace('euler="0 0 0.1"', f'euler="0 0 {float(np.degrees(0.1))!r}"')
                .replace('axisangle="1 0 0 3.14159265"',
                         f'axisangle="1 0 0 {float(np.degrees(3.14159265))!r}"'))
    path = tmp_path / f"arm_{kind}.xml"
    path.write_text(text)
    return os.fspath(path)


@pytest.mark.parametrize("kind", ["include", "degree"])
def test_scene_variants_compile_like_jax(tmp_path, models, kind):
    """<include> splicing and degree angles: the same model as the JAX
    package's parser gives, and as the radian scene without includes."""
    path = _variant(tmp_path, kind)
    port, ref = load_model(path, device="cpu"), jax_load_model(path)
    assert port.topo.joint_names == tuple(ref.topo.joint_names)
    assert (port.topo.nu, port.topo.neq) == (7, 1)
    for name in MODEL_ARRAYS:
        a = np.asarray(getattr(port, name))
        np.testing.assert_array_equal(a, np.asarray(getattr(ref, name)),
                                      err_msg=name)
        # the degree round trip moves a quaternion by an ulp of float32
        np.testing.assert_allclose(
            a, np.asarray(getattr(models["full"][0], name)), rtol=1e-6,
            atol=1e-6, err_msg=name)
