# Frozen copy of the plain part of mujoco_rl_ur5_tpu_torch/physics/cuda_collide.py
# at commit c4951def7b192ba06c207f9c1c9298bddc6ddcb8: the hull tables and the plain narrowphase of
# each pair group that the program runs as a kernel; the benchmark's plain reference.
"""The plain narrowphase functions of the kernel pair groups, by (type1,
type2), with the hull tables they read."""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.physics import collision

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


BATCHED = {
    (collision.GEOM_BOX, collision.GEOM_BOX): box_box_plain,
    (collision.GEOM_PLANE, collision.GEOM_MESH): plane_hull_plain,
    (collision.GEOM_SPHERE, collision.GEOM_MESH): sphere_hull_plain,
    (collision.GEOM_CAPSULE, collision.GEOM_MESH): capsule_hull_plain,
    (collision.GEOM_BOX, collision.GEOM_MESH): box_hull_plain,
    (collision.GEOM_MESH, collision.GEOM_MESH): hull_hull_plain,
}
