"""The port's renderer against the JAX package's, on the object pile.

* Camera: ``make_camera`` (intrinsics, the untransposed rotation, near and
  far from ``visual/map`` and the extent, the unit rays it keeps),
  ``camera_rays``,
  ``world_2_pixel``, ``pixel_2_world``, ``encode_depth`` and
  ``depth_2_meters`` against JAX's at 64 x 64, to 1e-6 relative (float32
  in another order).
* ``render_rgbd`` of the object fixture at 64 x 64 against JAX's
  ``render_rgbd(use_pallas=False)`` (the jnp path that tests/test_pallas.py
  holds equal to the TPU kernel), on two seeded dropped poses with the arm
  turned so that the finger pads hang over the bin, once with every geom
  and once with two objects hidden. The geom that wins each pixel (JAX's
  from its ``_cast_all`` and argmin, the port's from its plain cast) is the
  same on at least 99.9% of the pixels; where it is, the depth buffer
  agrees within 1e-6 and each rgb channel within 1 level (the shading
  rounds to uint8 after float32 arithmetic in another order). Every branch
  of the cast (plane, sphere, box, capsule, cylinder, hull) wins pixels;
  the hidden objects win none.
* ``render_tables`` makes the cast's code table, hull faces and
  background once per camera and hidden set (in any order) and hands the
  same tables back after; a listed geom's branch code is -1.
* On CPU tensors ``cuda_raycast.cast_rays`` is its plain version and
  launches nothing; on another device it raises. ``render_depth`` reads
  the floor, seen past the bin, at the camera's height of 2 m.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_rl_ur5_tpu.physics.kinematics import fk as jax_fk
from mujoco_rl_ur5_tpu.render import camera as jcamera
from mujoco_rl_ur5_tpu.render import raycast as jraycast
from mujoco_rl_ur5_tpu.scene.compile import compile_spec as jax_compile_spec
from mujoco_rl_ur5_tpu.scene.mjcf import parse_mjcf as jax_parse_mjcf
from mujoco_rl_ur5_tpu_torch import OBJECTS
from mujoco_rl_ur5_tpu_torch.physics.kinematics import fk
from mujoco_rl_ur5_tpu_torch.render import camera, cuda_raycast, raycast
from mujoco_rl_ur5_tpu_torch.scene.compile import load_model
from mujoco_rl_ur5_tpu_torch.scene.mjcf import JNT_FREE

B, W, H = 2, 64, 64
# the arm turned so that the finger pads hang level over the bin
PADS_OVER_BIN = [-1.42, -1.08, 0.348, -1.739, 3.142, 0.671]


@pytest.fixture(scope="module")
def scene():
    m = load_model(OBJECTS, device="cpu")
    jm = jax_compile_spec(jax_parse_mjcf(OBJECTS))
    t = m.topo
    rng = np.random.default_rng(3)
    q = np.tile(m.qpos0.numpy().astype(np.float64), (B, 1))
    q[:, :6] = PADS_OVER_BIN
    for j in np.nonzero(t.jnt_type == JNT_FREE)[0]:
        qa = t.jnt_qposadr[j]
        q[:, qa: qa + 2] += rng.uniform(-0.003, 0.003, (B, 2))
        quat = rng.normal(size=(B, 4))
        q[:, qa + 3: qa + 7] = quat / np.linalg.norm(quat, axis=1,
                                                     keepdims=True)
    q = q.astype(np.float32)
    return m, jm, q, camera.make_camera(m, "top_down", W, H), \
        jcamera.make_camera(jm, "top_down", W, H)


def test_camera_matches_jax(scene):
    m, jm, q, cam, jcam = scene
    for a, b in ((cam.pos, jcam.pos), (cam.rot, jcam.rot), (cam.K, jcam.K)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (cam.near, cam.far) == (jcam.near, jcam.far)
    np.testing.assert_allclose(camera.camera_rays(cam).numpy(),
                               np.asarray(jcamera.camera_rays(jcam)),
                               rtol=1e-6, atol=1e-7)
    jdirs = jcamera.camera_rays(jcam).reshape(-1, 3)
    np.testing.assert_allclose(
        cam.dirs.numpy(), np.asarray(jdirs / jnp.linalg.norm(
            jdirs, axis=-1, keepdims=True)), rtol=1e-6, atol=1e-7)
    for world in ([0.05, -0.62, 0.9], [-0.2, -0.4, 1.2]):
        got = camera.world_2_pixel(cam, torch.tensor(world))
        want = jcamera.world_2_pixel(jcam, jnp.asarray(world, jnp.float32))
        assert [int(x) for x in got] == [int(x) for x in want]
    for px, py, depth in ((10.0, 50.0, 1.1), (31.5, 2.0, 1.9)):
        got = camera.pixel_2_world(cam, px, py, torch.tensor(depth))
        want = jcamera.pixel_2_world(jcam, jnp.float32(px), jnp.float32(py),
                                     jnp.float32(depth))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    meters = torch.tensor([0.02, 0.5, 1.3, 2.0, 40.0])
    d = camera.encode_depth(cam, meters)
    np.testing.assert_allclose(
        d.numpy(), np.asarray(jcamera.encode_depth(jcam, jnp.asarray(
            meters.numpy()))), rtol=1e-6)
    # the round trip loses about (meters / near) float32 ulps
    np.testing.assert_allclose(camera.depth_2_meters(cam, d).numpy(),
                               meters.numpy(),
                               rtol=2 * 6e-8 * float(meters.max()) / cam.near)


def _jax_render(jm, jcam, qpos, hidden):
    """JAX's render_rgbd (the jnp path, op by op: jit would let XLA contract
    multiply-adds) and the geom that wins each pixel, picked as its
    render_rgbd picks it."""
    kin = jax_fk(jm, qpos)
    rgb, dbuf = jraycast.render_rgbd(jm, kin, jcam, hidden_geoms=hidden,
                                     use_pallas=False)
    dirs = jcamera.camera_rays(jcam).reshape(-1, 3)
    dn = dirs / jnp.linalg.norm(dirs, axis=-1, keepdims=True)
    s, _ = jraycast._cast_all(jm, kin, jcam.pos, dn)
    mask = np.asarray(jm.geom_rgba)[:, 3] > 0.01
    mask[list(hidden)] = False
    s = jnp.where(jnp.asarray(mask)[None, :], s, jraycast.BIG)
    return np.asarray(rgb), np.asarray(dbuf), np.asarray(jnp.argmin(s, 1))


@pytest.mark.parametrize("hidden", [(), ("object_7_geom", "object_36_geom")])
def test_render_rgbd_matches_jax(scene, hidden):
    m, jm, q, cam, jcam = scene
    t = m.topo
    hid = tuple(t.geom_id(n) for n in hidden)
    kin = fk(m, torch.from_numpy(q))
    before = cuda_raycast.cast_rays.launches
    rgb, dbuf = raycast.render_rgbd(m, kin, cam, hidden_geoms=hid)
    assert cuda_raycast.cast_rays.launches == before
    assert rgb.shape == (B, H, W, 3) and rgb.dtype == torch.uint8
    assert dbuf.shape == (B, H, W) and dbuf.dtype == torch.float32
    par, code, faces = raycast.geom_table(m, kin, cam, hid)
    s, gid, _ = raycast.cast_plain(par, code, faces, cam.dirs)
    wins = code[gid.long(), 0][s < raycast.BIG / 2]
    assert set(wins.tolist()) == set(range(6))          # every branch
    assert not np.isin(gid.numpy(), hid).any()
    for b in range(B):
        jrgb, jdbuf, jgid = _jax_render(jm, jcam, jnp.asarray(q[b]), hid)
        same = (gid[b].numpy() == jgid).reshape(H, W)[::-1, ::-1]
        assert same.mean() >= 0.999, same.mean()
        np.testing.assert_allclose(dbuf[b].numpy()[same],
                                   jdbuf[same], rtol=0, atol=1e-6)
        drgb = np.abs(rgb[b].numpy().astype(int) - jrgb)
        assert drgb[same].max() <= 1


def test_render_tables_are_made_once_per_hidden_set(scene):
    m = scene[0]
    t = m.topo
    cam = camera.make_camera(m, "top_down", W, H)
    a, b = (t.geom_id(f"object_{i}_geom") for i in (36, 7))
    assert cam.tables == {}
    tab = raycast.render_tables(m, cam)
    assert raycast.render_tables(m, cam, []) is tab
    hid = raycast.render_tables(m, cam, (a, b))
    assert raycast.render_tables(m, cam, [b, a, b]) is hid
    assert set(cam.tables) == {(), tuple(sorted((a, b)))}
    assert tab.code[a, 0] >= 0 and tab.code[b, 0] >= 0
    assert hid.code[a, 0] == -1 and hid.code[b, 0] == -1
    keep = [g for g in range(t.ngeom) if g not in (a, b)]
    assert torch.equal(hid.code[keep], tab.code[keep])
    np.testing.assert_array_equal(tab.background.numpy(),
                                  np.float32(raycast.BACKGROUND))
    assert torch.equal(tab.ray_fwd, cam.dirs @ -cam.rot[:, 2])
    kin = fk(m, torch.from_numpy(scene[2]))
    par, code, faces = raycast.geom_table(m, kin, cam, (a, b))
    assert code is hid.code and faces is hid.faces
    assert par.shape == (B, t.ngeom, 16)


def test_cast_routes_cpu_to_plain_and_depth_reads_meters(scene):
    m, _, q, cam, _ = scene
    kin = fk(m, torch.from_numpy(q))
    args = (*raycast.geom_table(m, kin, cam), cam.dirs)
    before = cuda_raycast.cast_rays.launches
    for a, b in zip(cuda_raycast.cast_rays(*args),
                    cuda_raycast.cast_rays.plain(*args)):
        assert torch.equal(a, b)
    assert cuda_raycast.cast_rays.launches == before
    with pytest.raises(RuntimeError, match="no kernel for device"):
        cuda_raycast.cast_rays(*(a.to("meta") for a in args))
    depth = raycast.render_depth(m, kin, cam)
    s, gid, _ = raycast.cast_plain(*args)
    floor = (gid == m.topo.geom_id("floor")).reshape(B, H, W).flip(1, 2)
    assert floor.sum() > 100
    np.testing.assert_allclose(depth[floor].numpy(), 2.0, rtol=1e-5)
