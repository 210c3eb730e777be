"""RGB-D observations: the FK of every scenario's bodies, then
``render_rgbd`` from the configuration's camera, one call per unit.

Traffic parameters: ``batch`` frames per call, a ``pool`` of seeded drop
poses that the calls take in turn; the configuration gives the camera and
the image size. The check renders a sample of the window's frames
(``check.rows`` of each call, ``check.calls`` calls) with the reference's
own scene, FK, ray cast and epilogue from the same poses, and holds the
program's images against them. The numbers, each the largest over the
sampled frames:

  rgb    the share of pixels whose colour differs in any channel by more
         than one level (a geom won or shaded otherwise);
  depth  the mean |difference| of the depth buffer over the pixels whose
         colour agrees (a surface moved; a pixel won otherwise is the rgb
         number's).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import pile
from benchmark.generators import rng
from benchmark.manifest import scene
from benchmark.reference import THREADS
from benchmark.reference.precision import tf32
from benchmark.verdict import sample, verdict


class Work:
    def __init__(self, cfg: dict, tr: dict, seed: int, device: str,
                 bench: str):
        from mujoco_rl_ur5_tpu_torch.render import camera, cuda_raycast
        self.cfg, self.tr, self.bench = cfg, tr, bench
        B = tr["batch"]
        self.drops_np = pile.drops(cfg, bench, tr, seed)
        self.rows_np = np.sort(rng(seed, 2).choice(
            B, tr["check"]["rows"], replace=False))
        self.model = pile.program(cfg, bench, device,
                                  cuda_raycast.kernel_sources())
        self.cam = camera.make_camera(self.model, cfg["camera"],
                                      cfg["width"], cfg["height"])
        self.drops = torch.from_numpy(self.drops_np).to(device)
        self.rows = torch.from_numpy(self.rows_np).to(device)
        self.kept = []
        self.call(0)                                       # warm-up

    def call(self, i: int) -> None:
        from mujoco_rl_ur5_tpu_torch.physics.kinematics import fk
        from mujoco_rl_ur5_tpu_torch.render.raycast import render_rgbd
        self.p = i % len(self.drops)
        self.out = render_rgbd(self.model, fk(self.model, self.drops[self.p]),
                               self.cam)

    def keep(self, i: int) -> None:
        self.kept.append((self.p, self.out[0][self.rows],
                          self.out[1][self.rows]))

    def free(self) -> None:
        self.kept = [(p, rgb.cpu(), d.cpu()) for p, rgb, d in self.kept]
        del self.model, self.cam, self.drops, self.out

    def check(self, gen: np.random.Generator, control: bool = False):
        return verdict(self.numbers(gen, control), self.tr["limits"])

    def numbers(self, gen: np.random.Generator, control: bool = False):
        """{name: the number of each sampled item}, of the program's
        answers or, with ``control``, of the control's."""
        from benchmark.reference.physics.kinematics import fk
        from benchmark.reference.render.camera import make_camera
        from benchmark.reference.render.raycast import render_rgbd
        from benchmark.reference.scene.compile import load_model
        torch.set_num_threads(THREADS)
        calls = sample(gen, [k[0] for k in self.kept],
                       self.tr["check"]["calls"])
        qpos = torch.cat([torch.from_numpy(
            self.drops_np[self.kept[c][0], self.rows_np]) for c in calls])
        rgb = torch.cat([self.kept[c][1] for c in calls])
        depth = torch.cat([self.kept[c][2] for c in calls])
        cfg = self.cfg

        def render(dtype):
            m = load_model(scene(cfg, self.bench),
                           dtype=np.float64 if dtype == torch.float64
                           else np.float32, device="cpu")
            cam = make_camera(m, cfg["camera"], cfg["width"], cfg["height"])
            return render_rgbd(m, fk(m, qpos.to(dtype)), cam)

        with torch.inference_mode():
            if control:
                with tf32():
                    rgb, depth = render(torch.float32)
            rgb_r, depth_r = render(torch.float64)
        same = (rgb.int() - rgb_r.int()).abs().amax(-1) <= 1
        gap = (depth.double() - depth_r.double()).abs() * same
        numbers = {
            "rgb": 1.0 - same.double().mean((-2, -1)).numpy(),
            "depth": (gap.sum((-2, -1)) / same.sum((-2, -1))).numpy(),
        }
        return numbers
