# Frozen copy of mujoco_rl_ur5_tpu_torch/render/camera.py at commit c4951def7b192ba06c207f9c1c9298bddc6ddcb8, imports
# rewritten to this package; the benchmark's plain reference. Dropped, as no
# check or count calls them: world_2_pixel, pixel_2_world.
"""Pinhole camera with the reference's conventions: the port's copy of the
JAX package's render/camera.py.

The reference rebuilds the intrinsics from the MJCF camera:

    f = 0.5 * height / tan(fovy * pi / 360)
    K = [[f, 0, W/2], [0, f, H/2], [0, 0, 1]]

and maps world to pixel as ``K @ rot @ (world - cam_pos)`` with ``rot`` the
camera's rotation matrix used untransposed, and back as
``inv(rot) @ (inv(K) @ pixel * -depth + cam_pos)``. Both quirks are kept as
they are (they are harmless for the ``top_down`` camera, whose orientation
is the identity), so that pixel coordinates decode alike.

Depth: the renderer computes the planar eye depth (along the camera's -z)
and stores it as MuJoCo's depth buffer does, d in [0, 1] with
``meters = near / (1 - d (1 - near / far))`` where near and far are
``visual/map`` znear and zfar times the model's extent (``encode_depth``
and its inverse ``depth_2_meters``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch

from benchmark.reference.scene.model import Model


@dataclass
class Camera:
    """A fixed camera of one model bound to an image size, its tensors on
    the model's device."""

    pos: torch.Tensor     # (3,) world position
    rot: torch.Tensor     # (3, 3) columns: the camera's axes in world
    K: torch.Tensor       # (3, 3) intrinsics
    width: int = 200
    height: int = 200
    near: float = 0.01
    far: float = 50.0
    dirs: torch.Tensor | None = None    # (H * W, 3) unit rays (unit_rays)
    # the renderer's tables of this camera and model, by hidden geom set
    # (render/raycast.py render_tables), made on first use
    tables: dict = field(default_factory=dict, compare=False, repr=False)


def _quat_mat(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)]),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)]),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)])])


def make_camera(model: Model, camera: str = "top_down", width: int = 200,
                height: int = 200) -> Camera:
    """The model's camera ``camera`` (a device model, ``Model.to``)."""
    t = model.topo
    cid = t.cam_id(camera)
    f = 0.5 * height / math.tan(float(model.cam_fovy[cid]) * math.pi / 360.0)
    K = torch.tensor([[f, 0.0, width / 2.0], [0.0, f, height / 2.0],
                      [0.0, 0.0, 1.0]], dtype=model.cam_pos.dtype,
                     device=model.cam_pos.device)
    cam = Camera(pos=model.cam_pos[cid], rot=_quat_mat(model.cam_quat[cid]),
                 K=K, width=width, height=height, near=t.znear * t.extent,
                 far=t.zfar * t.extent)
    cam.dirs = unit_rays(cam)
    return cam


def camera_rays(cam: Camera) -> torch.Tensor:
    """World ray directions (H, W, 3) for the pixel grid [py, px], scaled
    so that z_cam = -1: a hit at ray parameter s lies at planar eye depth
    s."""
    dt, dev = cam.K.dtype, cam.K.device
    PY, PX = torch.meshgrid(torch.arange(cam.height, dtype=dt, device=dev),
                            torch.arange(cam.width, dtype=dt, device=dev),
                            indexing="ij")
    pix = torch.stack([PX, PY, torch.ones_like(PX)], -1)
    dirs_cam = -(pix @ torch.linalg.inv(cam.K).T)
    return dirs_cam @ cam.rot.T


def unit_rays(cam: Camera) -> torch.Tensor:
    """The camera's unit ray directions (H * W, 3), row-major over [py, px]
    (``make_camera`` keeps them as ``Camera.dirs``)."""
    dirs = camera_rays(cam).reshape(-1, 3)
    return dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)


def encode_depth(cam: Camera, meters: torch.Tensor) -> torch.Tensor:
    """Metric eye depth -> depth-buffer value (inverse of
    ``depth_2_meters``)."""
    return (1.0 - cam.near / meters) / (1.0 - cam.near / cam.far)


def depth_2_meters(cam: Camera, d: torch.Tensor) -> torch.Tensor:
    """Depth-buffer value -> metric eye depth."""
    return cam.near / (1.0 - d * (1.0 - cam.near / cam.far))
