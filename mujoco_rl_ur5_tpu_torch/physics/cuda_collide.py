"""The contact step's narrowphase kernels, written by hand for Hopper: the
port's counterpart of the JAX package's physics/pallas_collide.py.

Four kernels carry the groups of the pile scene (boxes and cylinders; a
cylinder collides as a 16-gon prism hull):

  ``box_box_batched``     csrc/collide_box_box.cu     (pallas_collide.py:675)
  ``hull_hull_batched``   csrc/collide_hull_hull.cu   (:689)
  ``box_hull_batched``    csrc/collide_box_hull.cu    (:703)
  ``plane_hull_batched``  csrc/collide_plane_hull.cu  (:715)

Each takes the scenario batch at once: per-geom collision poses pos
(B, G, 3) and quat (B, G, 4), the model's geom tables (sizes, and the hull
tables with each geom's row in them), and each pair's geom ids g1, g2
(B, n) as the broadphase selected them, all in one argument order
``(pos, quat, size, hulls, g1, g2)``; ``BATCHED`` maps each group's type
pair to its wrapper, and ``<wrapper>.plain`` is its plain version. One thread computes one (pair,
scenario) and reads the poses and the small hull tables by id, where the
TPU kernel was handed per-pair copies of every table (the JAX package
gathers (B, 64, 32, 3) vertex tables per capped group). Each returns pos
(B, n, K, 3), normal (B, n, K, 3) and dist (B, n, K), K = 9 for box-box and
8 for the hull groups, with physics/collision.py's arithmetic, operation
for operation, and its tie rules (csrc/collide_common.cuh): built with
``-fmad=false``, a kernel and its plain version agree to the bit, so
candidates of equal depth (a resting box's four bottom corners, an upright
prism's rim) break their ties alike.

Routing: CPU tensors run the plain version beside each wrapper (the
collision.py function on per-pair gathers); CUDA tensors launch the kernel,
checked, and count it in ``<wrapper>.launches``; anything else raises. The
sphere-hull and capsule-hull groups have no kernel yet (PERF.md rows 10-11,
ROADMAP.md Queue 2): on CUDA tensors they raise, on CPU tensors they run
their plain versions.
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

KERNELS = ("box_box", "hull_hull", "box_hull", "plane_hull")


class Hulls(NamedTuple):
    """The model's hull tables and each geom's row in them."""

    meshid: torch.Tensor   # (G,) int, -1 for a geom that is no hull
    verts: torch.Tensor    # (M, V, 3)
    vmask: torch.Tensor    # (M, V)
    fnorm: torch.Tensor    # (M, F, 3)
    fdist: torch.Tensor    # (M, F)


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


# -- kernels --------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
# pos, quat, size, meshid, verts, vmask, fnorm, fdist, g1, g2,
# out_pos, out_nrm, out_dist, B, n, G, V, F, stream
_ARGS = (_P,) * 13 + (_I,) * 5 + (_P,)


@functools.lru_cache(maxsize=None)
def source(kernel: str) -> _build.KernelSource:
    """The build unit of one collide kernel (csrc/collide_<kernel>.cu with
    the shared csrc/collide_common.cuh), compiled without contracting
    multiply-adds so that it rounds as its plain version does."""
    with open(os.path.join(_build.CSRC, "collide_common.cuh")) as f:
        common = f.read()
    return _build.KernelSource(f"collide_{kernel}", f"collide_{kernel}",
                               _ARGS, {"collide_common.cuh": common},
                               flags=("-fmad=false",))


def kernel_sources() -> list:
    return [source(k) for k in KERNELS]


def _launch(kernel: str, K: int, pos, quat, size, hulls, g1, g2):
    """Check the operands, lay them out as the kernel reads them and
    launch; returns (pos, normal, dist)."""
    B, G = pos.shape[0], pos.shape[1]
    n = g1.shape[-1]
    dev = pos.device
    pos, quat = pos.contiguous(), quat.contiguous()
    size = size.contiguous()
    if pos.shape != (B, G, 3) or quat.shape != (B, G, 4) \
            or size.shape != (G, 3):
        raise ValueError(f"{kernel}: pos (B, G, 3), quat (B, G, 4) and size "
                         f"(G, 3) expected, got {tuple(pos.shape)}, "
                         f"{tuple(quat.shape)}, {tuple(size.shape)}")
    ids = [g.expand(B, n).to(device=dev, dtype=torch.int32).contiguous()
           for g in (g1, g2)]
    if hulls is None:
        z = torch.zeros(1, device=dev)
        tables = (torch.zeros(G, dtype=torch.int32, device=dev), z, z, z, z)
        V = F = 0
    else:
        _route(hulls.verts, hulls.vmask, hulls.fnorm, hulls.fdist)
        V, F = hulls.verts.shape[1], hulls.fnorm.shape[1]
        if V < 8 or hulls.meshid.shape != (G,):
            raise ValueError(f"{kernel}: hull tables need >= 8 vertices and "
                             "a mesh row per geom")
        tables = (hulls.meshid.to(device=dev, dtype=torch.int32).contiguous(),
                  *(t.contiguous() for t in hulls[1:]))
    out_pos = torch.empty(B, n, K, 3, device=dev)
    out_nrm = torch.empty(B, n, K, 3, device=dev)
    out_dist = torch.empty(B, n, K, device=dev)
    if B * n:
        _build.call(source(kernel), pos.data_ptr(), quat.data_ptr(),
                    size.data_ptr(), *(t.data_ptr() for t in tables),
                    ids[0].data_ptr(), ids[1].data_ptr(), out_pos.data_ptr(),
                    out_nrm.data_ptr(), out_dist.data_ptr(), B, n, G, V, F,
                    _stream(pos))
    return out_pos, out_nrm, out_dist


def box_box_batched(pos, quat, size, hulls, g1, g2):
    """Box-box corners both ways and the 15-axis edge SAT: 9 slots (the
    boxes come from their sizes: ``hulls`` is not read)."""
    if not _route(pos, quat, size):
        return box_box_plain(pos, quat, size, hulls, g1, g2)
    out = _launch("box_box", 9, pos, quat, size, None, g1, g2)
    box_box_batched.launches += 1
    return out


def hull_hull_batched(pos, quat, size, hulls, g1, g2):
    """Least-overlap face over both hulls, 8 deepest vertices: 8 slots."""
    if not _route(pos, quat, size):
        return hull_hull_plain(pos, quat, size, hulls, g1, g2)
    out = _launch("hull_hull", 8, pos, quat, size, hulls, g1, g2)
    hull_hull_batched.launches += 1
    return out


def box_hull_batched(pos, quat, size, hulls, g1, g2):
    """A box as an 8-vertex / 6-face hull against a hull: 8 slots."""
    if not _route(pos, quat, size):
        return box_hull_plain(pos, quat, size, hulls, g1, g2)
    out = _launch("box_hull", 8, pos, quat, size, hulls, g1, g2)
    box_hull_batched.launches += 1
    return out


def plane_hull_batched(pos, quat, size, hulls, g1, g2):
    """The 8 deepest hull vertices under a plane: 8 slots."""
    if not _route(pos, quat, size):
        return plane_hull_plain(pos, quat, size, hulls, g1, g2)
    out = _launch("plane_hull", 8, pos, quat, size, hulls, g1, g2)
    plane_hull_batched.launches += 1
    return out


for _w, _p in ((box_box_batched, box_box_plain),
               (hull_hull_batched, hull_hull_plain),
               (box_hull_batched, box_hull_plain),
               (plane_hull_batched, plane_hull_plain)):
    _w.launches, _w.plain = 0, _p


ROWS = {"sphere_hull": 10, "capsule_hull": 11}   # PERF.md kernel table


def _no_kernel(name: str, fn):
    def plain(pos, quat, size, hulls, g1, g2):
        return fn(_rows(pos, g1), _rows(quat, g1), size[g1], _rows(pos, g2),
                  _rows(quat, g2), *_hull_rows(hulls, g2))

    def batched(pos, quat, size, hulls, g1, g2):
        if _route(pos, quat, size):
            raise NotImplementedError(
                f"{name}_batched has no CUDA kernel yet (PERF.md kernel "
                f"table row {ROWS[name]}, ROADMAP.md Queue 2); run the "
                "contact step on CPU tensors or take the pile without "
                "spheres and capsules")
        return plain(pos, quat, size, hulls, g1, g2)
    batched.__name__, batched.plain = f"{name}_batched", plain
    return batched


sphere_hull_batched = _no_kernel("sphere_hull", collision.sphere_hull)
capsule_hull_batched = _no_kernel("capsule_hull", collision.capsule_hull)

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
