"""The observation's ray-cast kernel, written by hand for Hopper: the port's
counterpart of the JAX package's render/pallas_raycast.py.

``cast_rays(par, code, faces, dirs, cull)`` takes render/raycast.py's
per-frame geom tables (``geom_table``), the camera's unit rays and its cull
table (``render_tables(...).cull``) and returns, per frame and pixel, the
nearest hit's distance s* (B, N), geom id (B, N) int32 and world normal
(B, N, 3) (csrc/raycast.cu, replacing pallas_raycast.py ``_kernel`` :50).
A block casts one 16 x 16 tile of one frame against the geoms that survive
the tile's cull, in ascending geom id; built with ``-fmad=false``, the
kernel gives its plain version ``raycast.cast_plain`` to the bit.

Routing: CPU tensors run the plain version; CUDA tensors launch the
kernel, checked, and count it in ``cast_rays.launches``; anything else
raises.
"""

from __future__ import annotations

import ctypes

import torch

from mujoco_rl_ur5_tpu_torch import _build
from mujoco_rl_ur5_tpu_torch.physics.cuda_chain import _route, _stream
from mujoco_rl_ur5_tpu_torch.render import raycast
from mujoco_rl_ur5_tpu_torch.trace import spanned

_P, _I = ctypes.c_void_p, ctypes.c_int
# par, code, faces, dirs, planes, radius, out_s, out_gid, out_n, tile_count,
# tile_list, B, W, Hi, G, F, nhull, stream
SOURCE = _build.KernelSource("raycast", "raycast", (_P,) * 11 + (_I,) * 6
                             + (_P,), flags=("-fmad=false",))


def kernel_sources() -> list:
    return [SOURCE]


def survivor_lists(keep: torch.Tensor):
    """(B, T, G) bool -> the kernel's lists: count (B, T) int32 and ids
    (B, T, G) int32, ascending, -1 past the count."""
    G = keep.shape[-1]
    idx = torch.arange(G, dtype=torch.int32, device=keep.device)
    ids = torch.where(keep, idx, G).sort(-1).values
    return keep.sum(-1, dtype=torch.int32), torch.where(ids < G, ids, -1)


@spanned("render.cast")
def cast_rays(par, code, faces, dirs, cull=None, survivors=False):
    """The z-buffer cast of every frame: see ``raycast.cast_plain``. The
    kernel needs ``cull``; ``survivors=True`` also returns each tile's
    survivor lists (``survivor_lists``'s layout: the kernel's own on CUDA,
    ``raycast.tile_survivors_plain``'s on the CPU)."""
    if not _route(par, faces, dirs):
        out = raycast.cast_plain(par, code, faces, dirs)
        if survivors:
            out += survivor_lists(raycast.tile_survivors_plain(par, code,
                                                               cull))
        return out
    B, G = par.shape[:2]
    N, F = dirs.shape[0], faces.shape[1]
    if cull is None:
        raise ValueError("cast_rays: the kernel needs the camera's cull "
                         "table (raycast.render_tables(...).cull)")
    W, Hi = cull.width, cull.height
    T = -(-W // raycast.TILE) * -(-Hi // raycast.TILE)
    if par.shape != (B, G, 16) or code.shape != (G, 2) \
            or dirs.shape != (W * Hi, 3) or faces.shape[2:] != (4,) \
            or cull.planes.shape != (T, 4, 4) or cull.radius.shape != (G,):
        raise ValueError(f"cast_rays: par (B, G, 16), code (G, 2), faces "
                         f"(M, F, 4), dirs ({W} * {Hi}, 3), planes ({T}, 4, "
                         f"4) and radius (G,) expected, got "
                         f"{tuple(par.shape)}, {tuple(code.shape)}, "
                         f"{tuple(faces.shape)}, {tuple(dirs.shape)}, "
                         f"{tuple(cull.planes.shape)}, "
                         f"{tuple(cull.radius.shape)}")
    dev = par.device
    par, faces, dirs, planes, radius = (
        t.to(device=dev, dtype=torch.float32).contiguous()
        for t in (par, faces, dirs, cull.planes, cull.radius))
    if par.data_ptr() % 16 or faces.data_ptr() % 16:
        raise ValueError("cast_rays: par and faces must be 16-byte aligned")
    code = code.to(device=dev, dtype=torch.int32).contiguous()
    s = torch.empty(B, N, device=dev)
    gid = torch.empty(B, N, dtype=torch.int32, device=dev)
    nrm = torch.empty(B, N, 3, device=dev)
    count = ids = None
    if survivors:
        count = torch.zeros(B, T, dtype=torch.int32, device=dev)
        ids = torch.full((B, T, G), -1, dtype=torch.int32, device=dev)
    if B * N:
        _build.call(SOURCE, par.data_ptr(), code.data_ptr(),
                    faces.data_ptr(), dirs.data_ptr(), planes.data_ptr(),
                    radius.data_ptr(), s.data_ptr(), gid.data_ptr(),
                    nrm.data_ptr(), 0 if count is None else count.data_ptr(),
                    0 if ids is None else ids.data_ptr(), B, W, Hi, G, F,
                    cull.nhull, _stream(par))
        cast_rays.launches += 1
    return (s, gid, nrm) + ((count, ids) if survivors else ())


cast_rays.launches, cast_rays.plain = 0, raycast.cast_plain
