"""render/ of the PyTorch port: the camera, the batched ray-cast RGB-D
renderer and its ray-cast kernel."""

from mujoco_rl_ur5_tpu_torch.render.camera import (
    Camera, make_camera, pixel_2_world, world_2_pixel,
)
from mujoco_rl_ur5_tpu_torch.render.raycast import render_depth, render_rgbd

__all__ = [
    "Camera", "make_camera", "pixel_2_world", "world_2_pixel",
    "render_depth", "render_rgbd",
]
