"""The observation's ray-cast kernel, written by hand for Hopper: the port's
counterpart of the JAX package's render/pallas_raycast.py.

``cast_rays(par, code, faces, dirs)`` takes render/raycast.py's per-frame
geom tables (``geom_table``) and the camera's unit rays and returns, per
frame and pixel, the nearest hit's distance s* (B, N), geom id (B, N)
int32 and world normal (B, N, 3) (csrc/raycast.cu, replacing
pallas_raycast.py ``_kernel`` :50). One thread computes one (frame, pixel);
all threads of a block belong to one frame, so the per-geom switch on the
branch code is uniform. Built with ``-fmad=false``, the kernel rounds as
its plain version ``raycast.cast_plain`` does.

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

_P, _I = ctypes.c_void_p, ctypes.c_int
# par, code, faces, dirs, out_s, out_gid, out_n, B, N, G, F, stream
SOURCE = _build.KernelSource("raycast", "raycast", (_P,) * 7 + (_I,) * 4
                             + (_P,), flags=("-fmad=false",))


def kernel_sources() -> list:
    return [SOURCE]


def cast_rays(par, code, faces, dirs):
    """The z-buffer cast of every frame: see ``raycast.cast_plain``."""
    if not _route(par, faces, dirs):
        return raycast.cast_plain(par, code, faces, dirs)
    B, G = par.shape[:2]
    N, F = dirs.shape[0], faces.shape[1]
    if par.shape != (B, G, 16) or code.shape != (G, 2) \
            or dirs.shape != (N, 3) or faces.shape[2:] != (4,) \
            or B > 65535:
        raise ValueError(f"cast_rays: par (B, G, 16) with B <= 65535, code "
                         f"(G, 2), faces (M, F, 4) and dirs (N, 3) expected, "
                         f"got "
                         f"{tuple(par.shape)}, {tuple(code.shape)}, "
                         f"{tuple(faces.shape)}, {tuple(dirs.shape)}")
    dev = par.device
    par, faces, dirs = (t.contiguous() for t in (par, faces, dirs))
    code = code.to(device=dev, dtype=torch.int32).contiguous()
    s = torch.empty(B, N, device=dev)
    gid = torch.empty(B, N, dtype=torch.int32, device=dev)
    nrm = torch.empty(B, N, 3, device=dev)
    if B * N:
        _build.call(SOURCE, par.data_ptr(), code.data_ptr(),
                    faces.data_ptr(), dirs.data_ptr(), s.data_ptr(),
                    gid.data_ptr(), nrm.data_ptr(), B, N, G, F, _stream(par))
        cast_rays.launches += 1
    return s, gid, nrm


cast_rays.launches, cast_rays.plain = 0, raycast.cast_plain
