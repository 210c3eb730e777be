"""The ray cast's per-tile cull drops only geoms that no ray of the tile hits.

csrc/raycast.cu casts each 16 x 16 tile of pixels against the geoms that
survive the tile's cull (render/raycast.py: ``Cull``, ``tile_planes``,
``bounding_radius``, ``tile_survivors_plain``). The kernel's outputs equal
the unculled plain cast to the bit only if every dropped geom returns the
miss sentinel on every ray of its tile. Here, on frames of the object pile
(random object poses, the finger pads over the bin) from the top-down
camera and from a tilted one, at 40 x 40 pixels (ragged tiles of 16 x 8 and
8 x 8 at the edges): every (tile, geom) pair the plain cull drops has no
hit on any of the tile's rays (``geom_hits_plain``), the plane and the
geoms that hit survive, hidden geoms never do, and the cull drops most
pairs. Also: every tile's planes hold all of its rays on their inner side
within their slack, and each geom's radius bounds its surface.
"""

import math

import numpy as np
import pytest
import torch

from mujoco_rl_ur5_tpu_torch import OBJECTS
from mujoco_rl_ur5_tpu_torch.physics.kinematics import fk
from mujoco_rl_ur5_tpu_torch.render import camera, cuda_raycast, raycast
from mujoco_rl_ur5_tpu_torch.scene.compile import load_model
from mujoco_rl_ur5_tpu_torch.scene.mjcf import (
    GEOM_BOX, GEOM_CAPSULE, GEOM_CYLINDER, GEOM_MESH, GEOM_SPHERE, JNT_FREE,
)

W = H = 40
PADS_OVER_BIN = (-1.42, -1.08, 0.348, -1.739, 3.142, 0.671)


@pytest.fixture(scope="module")
def model():
    return load_model(OBJECTS, device="cpu")


def _tilted(m):
    """The top-down camera turned 30 degrees about x and moved so that it
    still looks at the bin."""
    cam = camera.make_camera(m, "top_down", W, H)
    a = math.radians(30.0)
    rot = torch.tensor([[1.0, 0.0, 0.0],
                        [0.0, math.cos(a), -math.sin(a)],
                        [0.0, math.sin(a), math.cos(a)]])
    target = torch.tensor([0.0, -0.6, 0.9])
    pos = target + 1.2 * rot[:, 2]
    cam = camera.Camera(pos=pos, rot=rot, K=cam.K, width=W, height=H,
                        near=cam.near, far=cam.far)
    cam.dirs = camera.unit_rays(cam)
    return cam


def _frames(m, B=3, seed=8):
    rng = np.random.default_rng(seed)
    t = m.topo
    q = np.tile(m.qpos0.numpy().astype(np.float64), (B, 1))
    q[:, :6] = PADS_OVER_BIN
    for j in np.nonzero(t.jnt_type == JNT_FREE)[0]:
        qa = t.jnt_qposadr[j]
        q[:, qa: qa + 2] += rng.uniform(-0.02, 0.02, (B, 2))
        quat = rng.normal(size=(B, 4))
        q[:, qa + 3: qa + 7] = quat / np.linalg.norm(quat, axis=1,
                                                     keepdims=True)
    return fk(m, torch.from_numpy(q.astype(np.float32)))


def _tile_of_pixel():
    ty, tx = np.divmod(np.arange(H * W), W)
    return torch.from_numpy((ty // raycast.TILE) * -(-W // raycast.TILE)
                            + tx // raycast.TILE)


@pytest.mark.parametrize("view", ["top_down", "tilted"])
def test_cull_drops_only_geoms_no_ray_of_the_tile_hits(model, view):
    cam = (camera.make_camera(model, "top_down", W, H) if view == "top_down"
           else _tilted(model))
    t = model.topo
    hidden = (t.geom_id("object_5_geom"),)
    par, code, faces = raycast.geom_table(model, _frames(model), cam, hidden)
    cull = raycast.render_tables(model, cam, hidden).cull
    keep = raycast.tile_survivors_plain(par, code, cull)      # (B, T, G)
    s_all = raycast.geom_hits_plain(par, code, faces, cam.dirs)[0]
    tile = _tile_of_pixel()
    T = keep.shape[1]
    # hits[b, t, g]: some ray of tile t hits geom g in frame b
    hit = (s_all < raycast.BIG).float()
    hits = torch.zeros(keep.shape).index_add_(1, tile, hit) > 0
    assert bool((hits <= keep).all())           # nothing hit is dropped
    floor = t.geom_id("floor")
    assert bool(keep[:, :, floor].all())
    assert not bool(keep[:, :, hidden[0]].any())
    visible = int((code[:, 0] >= 0).sum())
    assert T == 9 and float(keep.float().sum(-1).mean()) < 0.5 * visible
    # the CPU route of the kernel's wrapper gives the plain cull's lists
    count, ids = cuda_raycast.cast_rays(par, code, faces, cam.dirs, cull,
                                        survivors=True)[3:]
    assert torch.equal(count, keep.sum(-1, dtype=torch.int32))
    for b, k in ((0, 0), (2, T - 1)):
        want = torch.nonzero(keep[b, k])[:, 0].to(torch.int32)
        assert torch.equal(ids[b, k, :len(want)], want)
        assert bool((ids[b, k, len(want):] == -1).all())


@pytest.mark.parametrize("view", ["top_down", "tilted"])
def test_tile_planes_hold_their_tiles_rays(model, view):
    cam = (camera.make_camera(model, "top_down", W, H) if view == "top_down"
           else _tilted(model))
    planes = torch.from_numpy(raycast.tile_planes(cam.dirs, W, H))
    n, w = planes[..., :3].double(), planes[..., 3].double()
    assert torch.allclose(n.norm(dim=-1), torch.ones(9, 4, dtype=n.dtype))
    dots = torch.einsum("pc,pkc->pk", cam.dirs.double(),
                        n[_tile_of_pixel()])
    assert bool((dots >= -w[_tile_of_pixel()]).all())
    slack = float(np.float32(raycast.CULL_SLACK))   # stored in float32
    assert bool((w >= slack).all()) and bool((w < slack + 1e-6).all())


def test_bounding_radius_holds_each_geom(model):
    t = model.topo
    rad = raycast.bounding_radius(model)
    size = model.geom_size.double().numpy()
    signs = np.array([[i, j, k] for i in (-1, 1) for j in (-1, 1)
                      for k in (-1, 1)], float)
    seen = set()
    for g, ty in enumerate(t.geom_type):
        r, hl = size[g, 0], size[g, 1]
        if ty == GEOM_BOX:
            far = np.linalg.norm(signs * size[g], axis=-1).max()
        elif ty == GEOM_SPHERE:
            far = r
        elif ty == GEOM_CAPSULE:
            far = hl + r
        elif ty == GEOM_CYLINDER:
            far = np.hypot(r, hl)
        elif ty == GEOM_MESH:
            mid = int(t.geom_meshid[g])
            v = model.hull_verts[mid].double().numpy()
            v = v[model.hull_vmask[mid].numpy() > 0]
            # the hull's faces hold its vertices, in the same frame
            fn = model.hull_fnorm[mid].double().numpy()
            fd = model.hull_fdist[mid].double().numpy()
            live = fd < 1e9
            assert (v @ fn[live].T <= fd[live] + 1e-6).all()
            far = np.linalg.norm(v, axis=-1).max()
        else:
            continue
        seen.add(int(ty))
        np.testing.assert_allclose(rad[g], far, rtol=1e-12)
    assert seen == {GEOM_BOX, GEOM_SPHERE, GEOM_CAPSULE, GEOM_CYLINDER,
                    GEOM_MESH}
