"""Gymnasium wrapper: the reference's public single-env API over the port's
batched GraspEnv, the counterpart of the JAX package's env/gym_wrapper.py.

The reference's surface, as there:
  * a Gym id: ``gymnasium.make("mujoco_rl_ur5_tpu_torch/Grasper-v0")``
    (importing this module registers it; ``register_envs()`` does nothing
    the second time). The id differs from the JAX package's
    ("mujoco_rl_ur5_tpu/Grasper-v0"), so both register in one process;
  * the gymnasium 5-tuple from ``step(action, record_grasps=False)``;
    ``terminated`` is always False, as the reference's ``done``;
  * the constructor keywords file / image_width / image_height / show_obs
    / demo, ``action_space`` MultiDiscrete([H*W, 6]), dict observations
    {"rgb", "depth"}, ``print_info()`` and ``close()``;
  * ``record_grasps``: a side-camera image after a successful grasp, into
    ``self.grasp_captures`` (host arrays).

One wrapper owns one scenario (B=1) of the batched env. The default scene
is the port's object pile (assets/ur5_2finger_objects.xml), since the
reference scene is not in the repository. ``reset(seed=)`` seeds a
``torch.Generator`` on the env's device, so two resets with one seed give
equal states. The env runs on the card unless the caller passes
``device="cpu"``; the side capture is a ray cast on the card.
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional

import gymnasium
import numpy as np
import torch
from gymnasium import spaces

from mujoco_rl_ur5_tpu_torch import OBJECTS
from mujoco_rl_ur5_tpu_torch.env.grasp_env import GraspEnv as _BatchedGraspEnv
from mujoco_rl_ur5_tpu_torch.env.grasp_env import ROTATIONS, TABLE_HEIGHT
from mujoco_rl_ur5_tpu_torch.physics.kinematics import fk
from mujoco_rl_ur5_tpu_torch.render import make_camera, world_2_pixel
from mujoco_rl_ur5_tpu_torch.render.raycast import render_rgbd
from mujoco_rl_ur5_tpu_torch.scene.compile import load_model
from mujoco_rl_ur5_tpu_torch.scene.model import resolve_device

ENV_ID = "mujoco_rl_ur5_tpu_torch/Grasper-v0"
DEFAULT_SCENE = OBJECTS


class GrasperEnv(gymnasium.Env):
    """The single-env Gymnasium face of the batched grasping env."""

    metadata = {"render_modes": ["rgb_array"], "render_fps": 500}

    def __init__(self, file: str = DEFAULT_SCENE, image_width: int = 200,
                 image_height: int = 200, show_obs: bool = False,
                 demo: bool = False, render_mode: Optional[str] = None,
                 ncon: int = 128, iterations: Optional[int] = None,
                 budget_scale: float = 1.0, device="cuda"):
        self.device = resolve_device(device, "GrasperEnv")
        self.model = load_model(file, device=self.device)
        self.core = _BatchedGraspEnv(
            self.model, ncon=ncon, iterations=iterations,
            image_width=image_width, image_height=image_height, demo=demo,
            budget_scale=budget_scale, device=self.device)
        self.IMAGE_WIDTH, self.IMAGE_HEIGHT = image_width, image_height
        self.TABLE_HEIGHT = TABLE_HEIGHT
        self.show_obs = show_obs
        self.render_mode = render_mode
        self.action_space = spaces.MultiDiscrete(
            [image_width * image_height, len(ROTATIONS)])
        self.observation_space = spaces.Dict({
            "rgb": spaces.Box(0, 255, (image_height, image_width, 3),
                              np.uint8),
            "depth": spaces.Box(0.0, np.inf, (image_height, image_width),
                                np.float32),
        })
        self._es = None
        self.current_observation = None
        self.grasp_captures: list[np.ndarray] = []
        self._side_cam = None
        self._markers: list = []

    # -- gymnasium API ----------------------------------------------------------

    def reset(self, *, seed: Optional[int] = None, options=None):
        super().reset(seed=seed)
        s = int(self.np_random.integers(2**31 - 1)) if seed is None else seed
        gen = torch.Generator(device=self.device).manual_seed(int(s))
        self._es = self.core.reset(gen, 1)
        return self._obs(), {}

    def step(self, action, record_grasps: bool = False):
        """action = [pixel_idx, rotation]. Returns the gymnasium 5-tuple;
        ``terminated`` is always False."""
        if self._es is None:
            raise RuntimeError("GrasperEnv.step: call reset() first")
        a = torch.as_tensor(np.asarray(action), dtype=torch.int64,
                            device=self.device).reshape(1, 2)
        self._es, reward, _, info = self.core.step(self._es, a)
        info = {"grasped": bool(info["grasped"][0]),
                "phases": {k: bool(v[0]) for k, v in info["phases"].items()}}
        if record_grasps and info["grasped"]:
            self.grasp_captures.append(self.capture_side_camera())
        obs = self._obs()
        if self.show_obs:
            self._show(obs)
        return obs, float(reward[0]), False, False, info

    def render(self):
        if self.render_mode == "rgb_array":
            return self._es.rgb[0].cpu().numpy()
        return None

    def close(self):
        self._es = None

    # -- the reference's extras ------------------------------------------------

    def capture_side_camera(self, width: int = 1000,
                            height: int = 1000) -> np.ndarray:
        """The grasp capture: a width x height RGB render (uint8) of the
        current state from the scene's ``side`` camera."""
        if (self._side_cam is None or self._side_cam.width != width
                or self._side_cam.height != height):
            self._side_cam = make_camera(self.model, "side", width, height)
        qpos = self._es.sim.qpos
        rgb, _ = render_rgbd(self.model, fk(self.model, qpos),
                             self._side_cam)
        return rgb[0].cpu().numpy()

    def add_marker(self, position, label: str = "", size: float = 3,
                   color=(1.0, 0.0, 0.0)):
        """Mark a world position in later frames: a crosshair drawn into the
        RGB observation at the point's top_down projection (the reference
        drew viewer markers)."""
        self._markers.append((np.asarray(position, np.float64), label,
                              int(size), tuple(color)))

    def clear_markers(self):
        self._markers.clear()

    def marker_pixels(self) -> list:
        """Each marker's (x, y) in the observation image (flipped as the
        observation is)."""
        out = []
        for pos, _, _, _ in self._markers:
            px, py = world_2_pixel(self.core.cam, torch.as_tensor(
                pos, dtype=torch.float32, device=self.device))
            out.append((self.IMAGE_WIDTH - 1 - int(px),
                        self.IMAGE_HEIGHT - 1 - int(py)))
        return out

    def render_with_markers(self) -> np.ndarray:
        """The current RGB observation with every marker drawn."""
        rgb = self._es.rgb[0].cpu().numpy().copy()
        H, W = rgb.shape[:2]
        for (x, y), (_, _, size, color) in zip(self.marker_pixels(),
                                              self._markers):
            if 0 <= x < W and 0 <= y < H:
                c = (np.asarray(color) * 255).astype(np.uint8)
                rgb[max(0, y - size):y + size + 1, x] = c
                rgb[y, max(0, x - size):x + size + 1] = c
        return rgb

    def print_info(self):
        """The reference's model summary."""
        t = self.model.topo
        print("Model timestep:", t.timestep)
        print("Set number of frames skipped: ", 1)
        print("dt = timestep * frame_skip: ", t.timestep)
        print("Frames per second = 1/dt: ", 1.0 / t.timestep)
        print("Actionspace: ", self.action_space)
        print("Observation space:", self.observation_space)

    # -- helpers ----------------------------------------------------------------

    def _obs(self):
        obs = {"rgb": self._es.rgb[0].cpu().numpy(),
               "depth": self._es.depth[0].cpu().numpy().astype(np.float32)}
        self.current_observation = obs
        return obs

    def _show(self, obs):
        """Write the observation to grasper_obs.png in the temporary
        directory (headless; skipped without matplotlib)."""
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return
        fig, axes = plt.subplots(1, 2)
        axes[0].imshow(obs["rgb"])
        axes[1].imshow(obs["depth"])
        fig.savefig(os.path.join(tempfile.gettempdir(), "grasper_obs.png"))
        plt.close(fig)


def register_envs():
    """Register ENV_ID with gymnasium (once)."""
    if ENV_ID not in gymnasium.registry:
        gymnasium.register(
            id=ENV_ID,
            entry_point="mujoco_rl_ur5_tpu_torch.env.gym_wrapper:GrasperEnv")


register_envs()
