"""What the two object-pile kinds share: the program's compiled scene with
its kernels built, the seeded pool of drops, and the reference's own
compile of the same scene file (``reference/``, float64 on the CPU).

A drop is the pile at rest, every object shifted and turned and each
scenario's objects raised together (``generators.drop_qpos``), from the
rest pose that the benchmark reads from the scene file itself
(``generators.scene_rest``): both sides are handed the same drops.
"""

from __future__ import annotations

import numpy as np

from benchmark.generators import drop_qpos, rng, scene_rest
from benchmark.manifest import scene

def program(cfg: dict, bench: str, device: str, kernels) -> object:
    """The program's model of the configuration's scene, with the kernel
    sources ``kernels`` built (or taken from the build cache)."""
    from mujoco_rl_ur5_tpu_torch import _build
    from mujoco_rl_ur5_tpu_torch.scene.compile import load_model
    model = load_model(scene(cfg, bench), device=device)
    if device == "cuda":
        _build.build_many(kernels)
    return model


def drops(cfg: dict, bench: str, tr: dict, seed: int) -> np.ndarray:
    """(pool, batch, nq) float32 seeded drops of the configuration's scene,
    with the traffic's ``lift`` and ``lower`` (``generators.drop_qpos``)."""
    qpos0, qadr = scene_rest(scene(cfg, bench))
    gen = rng(seed, 1)
    return np.stack([drop_qpos(qpos0, qadr, tr["batch"], gen,
                               tr.get("lift", 0.1), tr.get("lower", 0.0))
                     for _ in range(tr["pool"])])


def reference_model(cfg: dict, bench: str):
    from benchmark.reference.scene.compile import load_model
    return load_model(scene(cfg, bench), dtype=np.float64, device="cpu")
