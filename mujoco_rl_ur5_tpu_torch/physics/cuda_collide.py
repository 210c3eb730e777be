"""The contact step's narrowphase kernels, written by hand for Hopper: the
port's counterpart of the JAX package's physics/pallas_collide.py.

Six kernels carry the hull and box-box groups of the pile scenes (a
cylinder collides as a 16-gon prism hull, a mesh as its convex hull):

  ``box_box_batched``       csrc/collide_box_box.cu       (pallas_collide.py:675)
  ``hull_hull_batched``     csrc/collide_hull_hull.cu     (:689)
  ``box_hull_batched``      csrc/collide_box_hull.cu      (:703)
  ``plane_hull_batched``    csrc/collide_plane_hull.cu    (:715)
  ``sphere_hull_batched``   csrc/collide_sphere_hull.cu   (:727)
  ``capsule_hull_batched``  csrc/collide_capsule_hull.cu  (:739)

Each takes the scenario batch at once: per-geom collision poses pos
(B, G, 3) and quat (B, G, 4), the model's geom tables (sizes, and the hull
tables with each geom's row in them), and each pair's geom ids g1, g2
(B, n) as the broadphase selected them, all in one argument order
``(pos, quat, size, hulls, g1, g2)``; ``BATCHED`` maps each group's type
pair to its wrapper, and ``<wrapper>.plain`` is its plain version. The
kernels read the poses and the small hull tables by id, where the TPU
kernel was handed per-pair copies of every table (the JAX package gathers
(B, 64, 32, 3) vertex tables per capped group). Box-box gives each
(pair, scenario) a team of ``BOX_TEAM`` lanes (one corner each; the SAT
axes split between them); hull-hull, box-hull and plane-hull share one team
body (csrc/collide_hull_team.cuh; side 1 a box made from its size for
box-hull, a plane for plane-hull), and sphere-hull and capsule-hull take
its staging, team and joins with one probe loop for their one and five
probes: a team of ``HULL_TEAM`` lanes per (pair, scenario), the table
staged in shared memory, the loops over each row's real vertices and faces
(``Hulls.nvert``/``nface``). Each returns pos
(B, n, K, 3), normal (B, n, K, 3) and dist (B, n, K), K = 9 for box-box,
8 for hull-hull, box-hull and plane-hull, 1 for sphere-hull and 5 for
capsule-hull, with physics/collision.py's arithmetic, operation
for operation, and its tie rules (csrc/collide_common.cuh): built with
``-fmad=false``, a kernel and its plain version agree to the bit, so
candidates of equal depth (a resting box's four bottom corners, an upright
prism's rim) break their ties alike.

Routing: CPU tensors run the plain version beside each wrapper (the
collision.py function on per-pair gathers); CUDA tensors launch the kernel,
checked, and count it in ``<wrapper>.launches``; anything else raises.
The hull tables' widths V and F are the model's (hull_maxv, hull_maxf) and
reach the kernels at launch; no kernel holds a table in a fixed-size array.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import NamedTuple

import torch

from mujoco_rl_ur5_tpu_torch import _build
from mujoco_rl_ur5_tpu_torch.physics import collision
from mujoco_rl_ur5_tpu_torch.physics.cuda_chain import _route, _stream

_SMEM_BLOCK = 232448  # shared memory one block may use (H100, bytes)
KERNELS = ("box_box", "hull_hull", "box_hull", "plane_hull", "sphere_hull",
           "capsule_hull")


class Hulls(NamedTuple):
    """The model's hull tables and each geom's row in them. Each row keeps
    its real vertices and faces first (scene/compile.py lays the tables out
    so); ``nvert`` and ``nface`` are their counts (``hull_counts``), which
    the team hull kernels (``TEAM``) loop over and take as given."""

    meshid: torch.Tensor   # (G,) int, -1 for a geom that is no hull
    verts: torch.Tensor    # (M, V, 3)
    vmask: torch.Tensor    # (M, V)
    fnorm: torch.Tensor    # (M, F, 3)
    fdist: torch.Tensor    # (M, F)
    nvert: torch.Tensor = None   # (M,) int32
    nface: torch.Tensor = None   # (M,) int32


def hull_counts(vmask: torch.Tensor, fdist: torch.Tensor) -> tuple:
    """Each table row's real vertex and face counts (vmask > 0.5, fdist <
    1e9) as int32 tensors on the tables' device: two reductions there, no
    host sync."""
    return ((vmask > 0.5).sum(-1, dtype=torch.int32),
            (fdist < 1e9).sum(-1, dtype=torch.int32))


# -- plain versions ---------------------------------------------------------------


def _rows(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Per-scenario rows x (B, G, c) at ids g (B, n) -> (B, n, c)."""
    return torch.gather(x, 1, g[..., None].expand(g.shape + x.shape[-1:]))


def _hull_rows(h: Hulls, g: torch.Tensor):
    m = h.meshid[g]
    return h.verts[m], h.vmask[m], h.fnorm[m], h.fdist[m]


def box_box_plain(pos, quat, size, hulls, g1, g2):
    return collision.box_box(_rows(pos, g1), _rows(quat, g1), size[g1],
                             _rows(pos, g2), _rows(quat, g2), size[g2])


def hull_hull_plain(pos, quat, size, hulls, g1, g2):
    return collision.hull_hull(_rows(pos, g1), _rows(quat, g1),
                               *_hull_rows(hulls, g1), _rows(pos, g2),
                               _rows(quat, g2), *_hull_rows(hulls, g2))


def box_hull_plain(pos, quat, size, hulls, g1, g2):
    return collision.box_hull(_rows(pos, g1), _rows(quat, g1), size[g1],
                              _rows(pos, g2), _rows(quat, g2),
                              *_hull_rows(hulls, g2))


def plane_hull_plain(pos, quat, size, hulls, g1, g2):
    return collision.plane_hull(_rows(pos, g1), _rows(quat, g1), size[g1],
                                _rows(pos, g2), _rows(quat, g2),
                                *_hull_rows(hulls, g2))


def sphere_hull_plain(pos, quat, size, hulls, g1, g2):
    return collision.sphere_hull(_rows(pos, g1), _rows(quat, g1), size[g1],
                                 _rows(pos, g2), _rows(quat, g2),
                                 *_hull_rows(hulls, g2))


def capsule_hull_plain(pos, quat, size, hulls, g1, g2):
    return collision.capsule_hull(_rows(pos, g1), _rows(quat, g1), size[g1],
                                  _rows(pos, g2), _rows(quat, g2),
                                  *_hull_rows(hulls, g2))


# -- kernels --------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
# box-box's arguments: pos, quat, size, meshid, verts, fnorm, fdist, g1,
# g2, out_pos, out_nrm, out_dist, B, n, G, V, F, stream
_ARGS = (_P,) * 12 + (_I,) * 5 + (_P,)
# each team hull kernel's output slots, and whether it reads size; its
# arguments: pos, quat, [size], meshid, verts, fnorm, fdist, nvert, nface,
# g1, g2, out_pos, out_nrm, out_dist, B, n, G, M, V, F, stream
TEAM = {"hull_hull": (8, False), "box_hull": (8, True),
        "plane_hull": (8, False), "sphere_hull": (1, True),
        "capsule_hull": (5, True)}
BOX_TEAM = 8    # lanes per (pair, scenario) of csrc/collide_box_box.cu
HULL_TEAM = 4   # lanes per (pair, scenario) of csrc/collide_hull_team.cuh
_HEADERS = ("collide_common.cuh", "collide_hull_team.cuh")


@functools.lru_cache(maxsize=None)
def source(kernel: str) -> _build.KernelSource:
    """The build unit of one collide kernel (csrc/collide_<kernel>.cu with
    the shared headers), compiled without contracting multiply-adds so that
    it rounds as its plain version does."""
    headers = {}
    for name in _HEADERS:
        with open(os.path.join(_build.CSRC, name)) as f:
            headers[name] = f.read()
    return _build.KernelSource(
        f"collide_{kernel}", f"collide_{kernel}",
        (_P,) * (13 + TEAM[kernel][1]) + (_I,) * 6 + (_P,)
        if kernel in TEAM else _ARGS, headers, flags=("-fmad=false",))


def kernel_sources() -> list:
    return [source(k) for k in KERNELS]


def _poses(kernel: str, pos, quat):
    B, G = pos.shape[0], pos.shape[1]
    pos, quat = pos.contiguous(), quat.contiguous()
    if pos.shape != (B, G, 3) or quat.shape != (B, G, 4):
        raise ValueError(f"{kernel}: pos (B, G, 3) and quat (B, G, 4) "
                         f"expected, got {tuple(pos.shape)}, "
                         f"{tuple(quat.shape)}")
    return pos, quat


def _ids(g1, g2, B: int, n: int, dev):
    return [g.expand(B, n).to(device=dev, dtype=torch.int32).contiguous()
            for g in (g1, g2)]


def _outputs(B: int, n: int, K: int, dev):
    return (torch.empty(B, n, K, 3, device=dev),
            torch.empty(B, n, K, 3, device=dev), torch.empty(B, n, K,
                                                             device=dev))


def box_box_launch(pos, quat, size, g1, g2):
    """Check box-box's operands, lay them out as the kernel reads them and
    launch, counted in ``box_box_batched.launches``; returns (pos, normal,
    dist). The kernel reads the boxes' sizes and no hull table."""
    B, G = pos.shape[0], pos.shape[1]
    n = g1.shape[-1]
    dev = pos.device
    pos, quat = _poses("box_box", pos, quat)
    size = size.contiguous()
    if size.shape != (G, 3):
        raise ValueError("box_box: size (G, 3) expected, got "
                         f"{tuple(size.shape)}")
    ids = _ids(g1, g2, B, n, dev)
    z = torch.zeros(1, device=dev)
    tables = (torch.zeros(G, dtype=torch.int32, device=dev), z, z, z)
    out_pos, out_nrm, out_dist = _outputs(B, n, 9, dev)
    if B * n:
        _build.call(source("box_box"), pos.data_ptr(), quat.data_ptr(),
                    size.data_ptr(), *(t.data_ptr() for t in tables),
                    ids[0].data_ptr(), ids[1].data_ptr(), out_pos.data_ptr(),
                    out_nrm.data_ptr(), out_dist.data_ptr(), B, n, G, 0, 0,
                    _stream(pos))
        box_box_batched.launches += 1
    return out_pos, out_nrm, out_dist


def team_smem(kernel: str, M: int, V: int, F: int) -> int:
    """Shared memory (bytes) one block of a team hull kernel takes for
    tables of M rows of V vertices and F faces: its 128 / HULL_TEAM
    instances' world vertices in rows of 16 bytes (side 1's, side 2's V and
    1 more: hull-hull V + V + 1, box-hull 8 + V + 1; plane-hull and
    capsule-hull, with no vertices on side 1, V + 1; sphere-hull, which
    reads no vertices, none), then the staged table (each row's counts, the
    vertices except for sphere-hull and, except for plane-hull, which reads
    no faces, the face normals and offsets; csrc collide_hull_team.cuh
    smem_bytes and table_floats)."""
    faces = 0 if kernel == "plane_hull" else M * F * 4
    if kernel == "sphere_hull":
        return (faces + 2 * M) * 4
    rows = {"hull_hull": V, "box_hull": 8}.get(kernel, 0) + V + 1
    return (128 // HULL_TEAM * rows * 4 + M * V * 3 + faces + 2 * M) * 4


def team_launch(kernel: str, pos, quat, size, hulls: Hulls, g1, g2):
    """One launch of a team hull kernel (``TEAM``; ``size`` is read by
    box-hull, sphere-hull and capsule-hull), counted in its wrapper's
    ``launches``. The kernel loops over each row's real vertices and faces,
    ``hulls.nvert``/``hulls.nface`` (raises without them), and stages the
    table in one block's shared memory: raises where it does not fit."""
    B, G = pos.shape[0], pos.shape[1]
    n = g1.shape[-1]
    dev = pos.device
    pos, quat = _poses(kernel, pos, quat)
    _route(hulls.verts, hulls.vmask, hulls.fnorm, hulls.fdist)
    M, V, F = hulls.verts.shape[0], hulls.verts.shape[1], hulls.fnorm.shape[1]
    if V < 8 or hulls.meshid.shape != (G,):
        raise ValueError(f"{kernel}: hull tables need >= 8 vertices and a "
                         "mesh row per geom")
    if hulls.nvert is None or hulls.nface is None:
        raise ValueError(f"{kernel}: the kernel takes each row's real vertex "
                         "and face counts (Hulls.nvert, Hulls.nface)")
    need = team_smem(kernel, M, V, F)
    if need > _SMEM_BLOCK:
        raise ValueError(f"{kernel}: tables of {M} rows x {V} vertices x "
                         f"{F} faces need {need} bytes of shared memory, a "
                         f"block has {_SMEM_BLOCK}")
    K, sized = TEAM[kernel]
    sizes = ()
    if sized:
        size = size.contiguous()
        if size.shape != (G, 3):
            raise ValueError(f"{kernel}: size (G, 3) expected, got "
                             f"{tuple(size.shape)}")
        sizes = (size.data_ptr(),)
    meshid = hulls.meshid.to(device=dev, dtype=torch.int32).contiguous()
    verts, fnorm, fdist = (t.contiguous() for t in (hulls.verts, hulls.fnorm,
                                                    hulls.fdist))
    counts = [c.to(device=dev, dtype=torch.int32).contiguous()
              for c in (hulls.nvert, hulls.nface)]
    ids = _ids(g1, g2, B, n, dev)
    out_pos, out_nrm, out_dist = _outputs(B, n, K, dev)
    if B * n:
        _build.call(source(kernel), pos.data_ptr(), quat.data_ptr(), *sizes,
                    meshid.data_ptr(), verts.data_ptr(), fnorm.data_ptr(),
                    fdist.data_ptr(), counts[0].data_ptr(),
                    counts[1].data_ptr(), ids[0].data_ptr(),
                    ids[1].data_ptr(), out_pos.data_ptr(),
                    out_nrm.data_ptr(), out_dist.data_ptr(), B, n, G, M, V, F,
                    _stream(pos))
        _BY_KERNEL[kernel].launches += 1
    return out_pos, out_nrm, out_dist


def _wrapper(kernel: str, plain, doc: str):
    """``<kernel>_batched``: the plain version on CPU tensors; on CUDA
    tensors the kernel's launch, counted in ``.launches``."""

    def batched(pos, quat, size, hulls, g1, g2):
        if not _route(pos, quat, size):
            return plain(pos, quat, size, hulls, g1, g2)
        if kernel in TEAM:
            return team_launch(kernel, pos, quat, size, hulls, g1, g2)
        return box_box_launch(pos, quat, size, g1, g2)
    batched.__name__ = batched.__qualname__ = f"{kernel}_batched"
    batched.__doc__ = doc
    batched.launches, batched.plain = 0, plain
    return batched


box_box_batched = _wrapper(
    "box_box", box_box_plain, "Box-box corners both ways and the 15-axis "
    "edge SAT: 9 slots (the boxes come from their sizes).")
hull_hull_batched = _wrapper(
    "hull_hull", hull_hull_plain, "Least-overlap face over both hulls, "
    "8 deepest vertices: 8 slots.")
box_hull_batched = _wrapper(
    "box_hull", box_hull_plain, "A box as an 8-vertex / 6-face hull "
    "against a hull: 8 slots.")
plane_hull_batched = _wrapper(
    "plane_hull", plane_hull_plain, "The 8 deepest hull vertices under "
    "a plane: 8 slots.")
sphere_hull_batched = _wrapper(
    "sphere_hull", sphere_hull_plain, "A sphere's center against the "
    "hull's faces: 1 slot.")
capsule_hull_batched = _wrapper(
    "capsule_hull", capsule_hull_plain, "Five sphere probes along a "
    "capsule's axis against a hull: 5 slots.")

# the wrapper of each (type1, type2) pair group; the other primitive groups
# run collision.NARROWPHASE in plain torch, as in the JAX package
BATCHED = {
    (collision.GEOM_BOX, collision.GEOM_BOX): box_box_batched,
    (collision.GEOM_PLANE, collision.GEOM_MESH): plane_hull_batched,
    (collision.GEOM_SPHERE, collision.GEOM_MESH): sphere_hull_batched,
    (collision.GEOM_CAPSULE, collision.GEOM_MESH): capsule_hull_batched,
    (collision.GEOM_BOX, collision.GEOM_MESH): box_hull_batched,
    (collision.GEOM_MESH, collision.GEOM_MESH): hull_hull_batched,
}
_BY_KERNEL = {w.__name__[: -len("_batched")]: w for w in BATCHED.values()}
