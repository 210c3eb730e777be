"""Analytic ray casting of the scene's geoms -> RGB-D observations, batched
over scenarios: the port's counterpart of the JAX package's
render/raycast.py (and, through render/cuda_raycast.py, of
render/pallas_raycast.py).

Every pixel's ray is intersected with every visible geom; the nearest hit
wins the z-buffer (a strict minimum: of equal hits the geom listed first).
Each geom type has its analytic intersection (plane, sphere, box, capsule,
cylinder) and a mesh is cast against its convex hull, the shape it
collides as. The image is flat Lambertian shading under a camera headlight
and the planar eye depth in MuJoCo's depth-buffer encoding, both flipped
as the reference flips its images ([::-1, ::-1]).

The cast works on per-frame geom tables (``geom_table``): each geom's
rotation R (world from local), the camera in its frame R^T (cam - p), its
size, a branch code (-1 for a hidden geom) and its row in the hull face
table. ``cast_plain`` is the plain version: the per-type intersections of
the JAX package's raycast.py over (B, N, G) with the first-minimum argmin;
render/cuda_raycast.py holds the kernel that computes the same. Each
intersection is written out component by component in the order the
kernel rounds it (csrc/raycast.cu).

The kernel casts a tile of TILE x TILE pixels against the geoms that can
appear in it only. Its cull table (``Cull``, kept with the camera's tables)
holds each tile's four side planes and each geom's bounding radius;
``tile_survivors_plain`` is the plain version of the cull, rounded as the
kernel rounds it. A culled geom returns the miss sentinel on every ray of
its tile, so the cull changes no output: ``cast_plain`` stays the unculled
reference.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mujoco_rl_ur5_tpu_torch.ops.spatial import quat_to_mat
from mujoco_rl_ur5_tpu_torch.physics.kinematics import Kin, geom_poses
from mujoco_rl_ur5_tpu_torch.render.camera import (
    Camera, depth_2_meters, encode_depth,
)
from mujoco_rl_ur5_tpu_torch.scene.mjcf import (
    GEOM_BOX, GEOM_CAPSULE, GEOM_CYLINDER, GEOM_MESH, GEOM_PLANE, GEOM_SPHERE,
)
from mujoco_rl_ur5_tpu_torch.scene.model import Model
from mujoco_rl_ur5_tpu_torch.trace import spanned

BIG = 1e10
EPS = 1e-12
# geom type -> branch code of the cast (csrc/raycast.cu's switch)
BRANCH = {GEOM_PLANE: 0, GEOM_SPHERE: 1, GEOM_BOX: 2, GEOM_CAPSULE: 3,
          GEOM_CYLINDER: 4, GEOM_MESH: 5}
BACKGROUND = (0.12, 0.15, 0.2)
TILE = 16           # pixels per side of the kernel's tile (RAYCAST_TILE)
# the cull's margins: bounding radii widened by CULL_REL of themselves, and
# each tile plane's slack by CULL_SLACK (0.1 mm at 1 m): a ray that misses
# a geom by less still reaches its intersection, whose float32 roundoff
# is far smaller
CULL_REL, CULL_SLACK = 1e-3, 1e-4
# elements of one (B, N, G) intermediate of the plain cast (~134 MB)
PLAIN_CHUNK = 1 << 25


# -- per-type intersections, rays in the geom's frame -------------------------
# o = (ox, oy, oz), d = (dx, dy, dz) and size = (s0, s1, s2) broadcast to
# (..., Gt); each returns s (BIG on a miss) and the local normal.


def _sqrt(x):
    """The correctly rounded float32 square root, as the kernel's sqrtf
    (torch's vectorised CPU sqrt is off by an ulp in about 0.5% of cases;
    the float64 root rounded to float32 is exact)."""
    return torch.sqrt(x.double()).to(x.dtype)


def _unit(x, y, z):
    n = torch.clamp_min(_sqrt(x * x + y * y + z * z), EPS)
    return x / n, y / n, z / n


def _plane(o, d, size):
    ox, oy, oz = o
    dx, dy, dz = d
    s = torch.where(dz.abs() > EPS, -oz / dz, BIG)
    s = torch.where((s > 0) & (oz > 0), s, BIG)
    z = torch.zeros_like(s)
    return s, (z, z, z + 1.0)


def _sphere(o, d, size):
    ox, oy, oz = o
    dx, dy, dz = d
    r = size[0]
    a = dx * dx + dy * dy + dz * dz
    b = 2.0 * (ox * dx + oy * dy + oz * dz)
    c = (ox * ox + oy * oy + oz * oz) - r * r
    disc = b * b - 4.0 * a * c
    sq = _sqrt(torch.clamp_min(disc, 0.0))
    s = (-b - sq) / (2.0 * a)
    s = torch.where((disc > 0) & (s > 0), s, BIG)
    return s, _unit(ox + s * dx, oy + s * dy, oz + s * dz)


def _box(o, d, size):
    tmin, tmax = [], []
    for oa, da, h in zip(o, d, size):
        dinv = torch.where(da.abs() > EPS, 1.0 / da, BIG)
        t1, t2 = (-h - oa) * dinv, (h - oa) * dinv
        tmin.append(torch.minimum(t1, t2))
        tmax.append(torch.maximum(t1, t2))
    t_in = torch.maximum(torch.maximum(tmin[0], tmin[1]), tmin[2])
    t_out = torch.minimum(torch.minimum(tmax[0], tmax[1]), tmax[2])
    hit = (t_in <= t_out) & (t_out > 0) & (t_in > 0)
    s = torch.where(hit, t_in, BIG)
    # the entering slab's axis, the first of equals, against the ray
    is0 = (tmin[0] >= tmin[1]) & (tmin[0] >= tmin[2])
    is1 = ~is0 & (tmin[1] >= tmin[2])
    is2 = ~is0 & ~is1
    z = torch.zeros_like(s)
    return s, tuple(torch.where(k, -torch.sign(da), z)
                    for k, da in zip((is0, is1, is2), d))


def _cyl_side(o, d, r):
    ox, oy, _ = o
    dx, dy, _ = d
    a = dx * dx + dy * dy
    b = 2.0 * (ox * dx + oy * dy)
    c = (ox * ox + oy * oy) - r * r
    disc = b * b - 4.0 * a * c
    sq = _sqrt(torch.clamp_min(disc, 0.0))
    s = torch.where(a > EPS, (-b - sq) / (2.0 * torch.clamp_min(a, EPS)),
                    BIG)
    return torch.where((disc > 0) & (s > 0), s, BIG)


def _capsule(o, d, size):
    ox, oy, oz = o
    dx, dy, dz = d
    r, hl = size[0], size[1]
    s_side = _cyl_side(o, d, r)
    s_side = torch.where((oz + s_side * dz).abs() <= hl, s_side, BIG)

    def cap(cz):
        ocz = oz - cz
        b = 2.0 * (ox * dx + oy * dy + ocz * dz)
        c = (ox * ox + oy * oy + ocz * ocz) - r * r
        a = dx * dx + dy * dy + dz * dz
        disc = b * b - 4.0 * a * c
        sq = _sqrt(torch.clamp_min(disc, 0.0))
        s = (-b - sq) / (2.0 * a)
        ok = (disc > 0) & (s > 0) & ((ocz + s * dz) * torch.sign(cz) > 0)
        return torch.where(ok, s, BIG)

    s = torch.minimum(s_side, torch.minimum(cap(hl), cap(-hl)))
    pz = oz + s * dz
    return s, _unit(ox + s * dx, oy + s * dy,
                    pz - torch.clamp(pz, -hl, hl))


def _cylinder(o, d, size):
    ox, oy, oz = o
    dx, dy, dz = d
    r, hl = size[0], size[1]
    s_side = _cyl_side(o, d, r)
    s_side = torch.where((oz + s_side * dz).abs() <= hl, s_side, BIG)
    sgn = -torch.sign(dz)
    s_disc = torch.where(dz.abs() > EPS, (sgn * hl - oz) / dz, BIG)
    px, py = ox + s_disc * dx, oy + s_disc * dy
    s_disc = torch.where((s_disc > 0) & (px * px + py * py <= r * r), s_disc,
                         BIG)
    s = torch.minimum(s_side, s_disc)
    nx, ny, _ = _unit(ox + s * dx, oy + s * dy, torch.zeros_like(s))
    disc_wins = s_disc < s_side
    z = torch.zeros_like(s)
    return s, (torch.where(disc_wins, z, nx), torch.where(disc_wins, z, ny),
               torch.where(disc_wins, sgn, z))


def _hull(o, d, faces):
    """Convex polytope {n . x <= dist}: the last entering plane against the
    first exiting one; faces (..., F, 4) [normal, dist], padded faces at
    dist 1e10 impose nothing."""
    ox, oy, oz = o
    dx, dy, dz = d
    t_in = torch.full_like(dx, -BIG)
    t_out = torch.full_like(dx, BIG)
    outside = torch.zeros_like(dx, dtype=torch.bool)
    z = torch.zeros_like(dx)
    bn = [z, z, z]
    for f in range(faces.shape[-2]):
        fx, fy, fz, fd = faces[..., f, :].unbind(-1)
        nd = fx * dx + fy * dy + fz * dz
        no = fx * ox + fy * oy + fz * oz
        t = torch.where(nd.abs() > EPS, (fd - no) / nd, 0.0)
        t_ent = torch.where(nd < -EPS, t, -BIG)
        better = t_ent > t_in
        bn = [torch.where(better, a, b) for a, b in zip((fx, fy, fz), bn)]
        t_in = torch.maximum(t_in, t_ent)
        t_out = torch.minimum(t_out, torch.where(nd > EPS, t, BIG))
        outside = outside | ((nd.abs() <= EPS) & (no > fd))
    hit = (t_in <= t_out) & (t_in > 0) & ~outside
    return torch.where(hit, t_in, BIG), tuple(bn)


_CASTS = {0: _plane, 1: _sphere, 2: _box, 3: _capsule, 4: _cylinder}


# -- geom tables and the plain cast --------------------------------------------


class Cull(NamedTuple):
    """The kernel's cull table for one camera and model: a geom is dropped
    from a tile when its bounding sphere (centre c relative to the camera,
    radius r) lies wholly outside one of the tile's side planes,
    n . c + r + w |c| < 0."""

    planes: torch.Tensor      # (T, 4, 4) per tile: inward unit normal | w
    radius: torch.Tensor      # (G,) bounding radius about the geom's frame
    width: int                # the image's pixels, tiled TILE x TILE
    height: int
    nhull: int                # mesh geoms of the model (hull slots)


class Tables(NamedTuple):
    """What a cast needs beyond the poses: it depends on the model, the
    camera and the hidden set only."""

    code: torch.Tensor        # (G, 2) int32 [branch (-1 hidden), hull row]
    faces: torch.Tensor       # (M, F, 4) hull face table [normal | dist]
    fwd: torch.Tensor         # (3,) the camera's viewing direction
    ray_fwd: torch.Tensor     # (N,) each unit ray's cosine with fwd
    background: torch.Tensor  # (3,) the colour where nothing is hit
    cull: Cull                # the kernel's per-tile cull table


def bounding_radius(model: Model) -> np.ndarray:
    """Each geom's bounding-sphere radius about its own frame (the frame of
    ``geom_table``'s rows): sphere r, box |size|, capsule r + hl, cylinder
    sqrt(r^2 + hl^2), mesh the largest |vertex| of its hull; planes 0 (the
    cull never drops a plane)."""
    t = model.topo
    size = model.geom_size.detach().cpu().double().numpy()
    verts = model.hull_verts.detach().cpu().double().numpy()
    vmask = model.hull_vmask.detach().cpu().double().numpy()
    rad = np.zeros(t.ngeom)
    for g, ty in enumerate(t.geom_type):
        r, hl = size[g, 0], size[g, 1]
        if ty == GEOM_SPHERE:
            rad[g] = r
        elif ty == GEOM_BOX:
            rad[g] = np.linalg.norm(size[g])
        elif ty == GEOM_CAPSULE:
            rad[g] = r + hl
        elif ty == GEOM_CYLINDER:
            rad[g] = np.hypot(r, hl)
        elif ty == GEOM_MESH:
            mid = int(t.geom_meshid[g])
            rad[g] = (np.linalg.norm(verts[mid], axis=-1) * vmask[mid]).max()
    return rad


def tile_planes(dirs: torch.Tensor, width: int, height: int) -> np.ndarray:
    """(T, 4, 4) float32: for each TILE x TILE tile of the image (row-major
    over tiles, the ragged edge included), the planes through the camera
    and the tile's outermost columns and rows of rays, each as its inward
    unit normal n and slack w = max(0, -min n . d over the tile's rays) +
    CULL_SLACK; a degenerate plane (a one-pixel side) is n = 0, w = 1,
    which culls nothing."""
    d = dirs.detach().cpu().double().numpy().reshape(height, width, 3)
    ty_n, tx_n = -(-height // TILE), -(-width // TILE)
    ty, tx = np.divmod(np.arange(ty_n * tx_n), tx_n)
    y0, x0 = ty * TILE, tx * TILE
    y1 = np.minimum(y0 + TILE, height) - 1
    x1 = np.minimum(x0 + TILE, width) - 1
    # each tile's rays, the ragged edge padded with copies of its own
    # edge rays; their mean marks the inward side
    rays = np.pad(d, ((0, ty_n * TILE - height), (0, tx_n * TILE - width),
                      (0, 0)), mode="edge")
    rays = rays.reshape(ty_n, TILE, tx_n, TILE, 3).transpose(0, 2, 1, 3, 4)
    rays = rays.reshape(ty_n * tx_n, TILE * TILE, 3)
    sides = ((d[y0, x0], d[y1, x0]), (d[y0, x1], d[y1, x1]),
             (d[y0, x0], d[y0, x1]), (d[y1, x0], d[y1, x1]))
    n = np.stack([np.cross(a, b) for a, b in sides], 1)      # (T, 4, 3)
    ln = np.linalg.norm(n, axis=-1, keepdims=True)
    live = ln > 1e-12
    n = np.where(live, n / np.where(live, ln, 1.0), 0.0)
    n *= np.sign(n @ rays.mean(1)[..., None])
    n = n.astype(np.float32).astype(np.float64)
    low = (rays @ n.transpose(0, 2, 1)).min(1)
    w = np.maximum(0.0, -low) + CULL_SLACK
    out = np.concatenate([n, np.where(live, w[..., None], 1.0)], -1)
    return out.astype(np.float32)


def tile_survivors_plain(par, code, cull: Cull) -> torch.Tensor:
    """The kernel's cull in plain torch, rounded as csrc/raycast.cu rounds
    it: (B, T, G) bool, True where geom g may be hit by a ray of tile t of
    frame b (the plane always, a hidden geom never)."""
    R = [par[..., j] for j in range(9)]
    o = (par[..., 9], par[..., 10], par[..., 11])
    c = [-(R[3 * i] * o[0] + R[3 * i + 1] * o[1] + R[3 * i + 2] * o[2])
         for i in range(3)]
    ln = _sqrt(c[0] * c[0] + c[1] * c[1] + c[2] * c[2])[:, None]
    c = [x[:, None] for x in c]                           # (B, 1, G)
    pl = cull.planes.to(par.device)[None, :, :, :, None]  # (1, T, 4, 4, 1)
    keep = torch.ones(par.shape[0], pl.shape[1], par.shape[1],
                      dtype=torch.bool, device=par.device)
    for k in range(4):
        n0, n1, n2, w = (pl[:, :, k, j] for j in range(4))
        keep &= ~((n0 * c[0] + n1 * c[1] + n2 * c[2] + cull.radius) + w * ln
                  < 0)
    branch = code[:, 0].to(par.device)
    return (keep & (branch >= 0)) | (branch == 0)


def render_tables(model: Model, cam: Camera, hidden_geoms=()) -> Tables:
    """The camera's ``Tables`` for a hidden set, made on first use and kept
    in ``cam.tables``: a geom is hidden when its alpha is <= 0.01 or it is
    listed in ``hidden_geoms``. Making them reads the colours to the host
    once; later renders with the same set read nothing back."""
    key = tuple(sorted({int(g) for g in hidden_geoms}))
    if key in cam.tables:
        return cam.tables[key]
    t = model.topo
    branch = np.full(t.ngeom, -1, np.int32)
    visible = np.asarray(model.geom_rgba[:, 3].cpu()) > 0.01
    visible[np.asarray(key, np.int64)] = False
    for g, ty in enumerate(t.geom_type):
        if visible[g]:
            if int(ty) not in BRANCH:
                raise ValueError(f"geom {t.geom_names[g]!r}: the renderer "
                                 f"has no intersection for type {int(ty)}")
            branch[g] = BRANCH[int(ty)]
    dev = cam.dirs.device
    code = torch.from_numpy(np.stack(
        [branch, np.maximum(t.geom_meshid, 0).astype(np.int32)], -1)).to(dev)
    faces = torch.cat([model.hull_fnorm, model.hull_fdist[..., None]],
                      -1).contiguous()
    fwd = -cam.rot[:, 2]
    cull = Cull(torch.from_numpy(tile_planes(cam.dirs, cam.width,
                                             cam.height)).to(dev),
                torch.from_numpy((bounding_radius(model) * (1.0 + CULL_REL))
                                 .astype(np.float32)).to(dev),
                cam.width, cam.height, int((t.geom_type == GEOM_MESH).sum()))
    tab = cam.tables[key] = Tables(
        code, faces, fwd, cam.dirs @ fwd,
        torch.tensor(BACKGROUND, dtype=cam.dirs.dtype, device=dev), cull)
    return tab


def geom_table(model: Model, kin: Kin, cam: Camera, hidden_geoms=()):
    """Per-frame geom parameters of a cast: par (B, G, 16) float32 [R (9,
    row-major, world from local) | R^T (cam - p) | size | 0], and the
    hidden set's code (G, 2) int32 and hull face table (M, F, 4) of
    ``render_tables``."""
    gpos, gquat = geom_poses(model, kin)
    R = quat_to_mat(gquat)                               # (B, G, 3, 3)
    v = cam.pos - gpos
    o = torch.stack([R[..., 0, a] * v[..., 0] + R[..., 1, a] * v[..., 1]
                     + R[..., 2, a] * v[..., 2] for a in range(3)], -1)
    B, G = gpos.shape[:2]
    par = torch.cat([R.reshape(B, G, 9), o,
                     model.geom_size.expand(B, G, 3),
                     o.new_zeros(B, G, 1)], -1).contiguous()
    tab = render_tables(model, cam, hidden_geoms)
    return par, tab.code, tab.faces


def cast_plain(par, code, faces, dirs):
    """The z-buffer cast in plain torch: unit rays dirs (N, 3) from the
    camera against the tables of ``geom_table`` -> s* (B, N), geom id*
    (B, N) int32 (0 where nothing is hit) and the world normal* (B, N, 3)
    (0 where nothing is hit). Frames go in chunks that keep each (B, N, G)
    intermediate near PLAIN_CHUNK elements."""
    B, G = par.shape[:2]
    N = dirs.shape[0]
    step = max(1, PLAIN_CHUNK // max(N * G, 1))
    outs = [_cast_frames(par[i:i + step], code, faces, dirs)
            for i in range(0, B, step)]
    return tuple(torch.cat(x, 0) for x in zip(*outs))


def _cast_frames(par, code, faces, dirs):
    B, N = par.shape[0], dirs.shape[0]
    s_all, n_all = geom_hits_plain(par, code, faces, dirs)
    g = torch.argmin(s_all, -1, keepdim=True)
    s = torch.gather(s_all, -1, g)[..., 0]
    n = torch.gather(n_all, -2, g[..., None].expand(B, N, 1, 3))[..., 0, :]
    n = torch.where((s < BIG)[..., None], n, 0.0)
    return s, g[..., 0].to(torch.int32), n


def geom_hits_plain(par, code, faces, dirs):
    """Every ray against every geom: s (B, N, G), BIG where the ray misses
    or the geom is hidden, and the world normal at the hit (B, N, G, 3)."""
    B, G = par.shape[:2]
    N = dirs.shape[0]
    branch, row = (np.asarray(c) for c in code.cpu().numpy().T)
    s_all = par.new_full((B, N, G), BIG)
    n_all = par.new_zeros(B, N, G, 3)
    dx, dy, dz = (a[None, :, None] for a in dirs.unbind(-1))
    for br in sorted(set(branch.tolist()) - {-1}):
        ids = np.nonzero(branch == br)[0]
        p = par[:, ids][:, None]                          # (B, 1, Gt, 16)
        R = [[p[..., 3 * i + j] for j in range(3)] for i in range(3)]
        o = (p[..., 9], p[..., 10], p[..., 11])
        d = tuple(R[0][a] * dx + R[1][a] * dy + R[2][a] * dz
                  for a in range(3))
        if br == BRANCH[GEOM_MESH]:
            idx = torch.from_numpy(row[ids]).to(par.device)
            s, nl = _hull(o, d, faces[idx])
        else:
            s, nl = _CASTS[br](o, d, (p[..., 12], p[..., 13], p[..., 14]))
        nw = [R[i][0] * nl[0] + R[i][1] * nl[1] + R[i][2] * nl[2]
              for i in range(3)]
        idx = torch.from_numpy(ids).to(par.device)
        s_all[..., idx] = s
        n_all[..., idx, :] = torch.stack(nw, -1)
    return s_all, n_all


# -- images ----------------------------------------------------------------------


@spanned("render")
def render_rgbd(model: Model, kin: Kin, cam: Camera, hidden_geoms=()):
    """Render a batch of scenarios (``kin`` with leading dim B) -> rgb uint8
    (B, H, W, 3) and the depth buffer float32 (B, H, W), both flipped as
    the reference flips them. ``hidden_geoms``: geom ids that never win
    the z-buffer (as geoms of alpha <= 0.01). On CUDA tensors the cast is
    the kernel of render/cuda_raycast.py; shading, depth encoding and the
    flips are plain torch around it. Beyond the first render of a hidden
    set (``render_tables``) nothing is read back to the host."""
    from mujoco_rl_ur5_tpu_torch.render.cuda_raycast import cast_rays

    tab = render_tables(model, cam, hidden_geoms)
    par = geom_table(model, kin, cam, hidden_geoms)[0]
    s, gid, nrm = cast_rays(par, tab.code, tab.faces, cam.dirs, tab.cull)
    zdepth = torch.clamp(s * tab.ray_fwd, cam.near, cam.far)
    dbuf = encode_depth(cam, zdepth)
    lambert = (nrm @ tab.fwd).abs()
    base = model.geom_rgba[:, :3][gid.long()]
    shade = base * (0.35 + 0.65 * lambert[..., None])
    rgb = torch.where((s < BIG / 2)[..., None], shade, tab.background)
    rgb = torch.clamp(rgb * 255.0, 0, 255).to(torch.uint8)
    B, H, W = s.shape[0], cam.height, cam.width
    return (torch.flip(rgb.reshape(B, H, W, 3), (1, 2)),
            torch.flip(dbuf.reshape(B, H, W), (1, 2)))


def render_depth(model: Model, kin: Kin, cam: Camera, hidden_geoms=()):
    """Metric eye depth (B, H, W), flipped as ``render_rgbd``'s images."""
    return depth_2_meters(cam, render_rgbd(model, kin, cam, hidden_geoms)[1])
