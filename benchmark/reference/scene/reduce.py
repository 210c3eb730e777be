# Frozen copy of mujoco_rl_ur5_tpu_torch/scene/reduce.py at commit c4951def7b192ba06c207f9c1c9298bddc6ddcb8, imports
# rewritten to this package; the benchmark's plain reference.
"""Model reduction: compile the arm-only submodel of a grasp scene.

The MPC plans over the arm and gripper alone, as the reference's planner
does: every top-level body that owns a free joint (the pile objects) is
dropped at the spec level, then the ordinary compiler runs, so every
derived table stays consistent by construction.
"""

from __future__ import annotations

import copy

import numpy as np

from benchmark.reference.scene.compile import compile_spec
from benchmark.reference.scene.mjcf import JNT_FREE, SceneSpec, parse_mjcf
from benchmark.reference.scene.model import Model


def drop_free_bodies(spec: SceneSpec) -> SceneSpec:
    """A copy of the spec without free-joint (pile object) bodies."""
    out = copy.copy(spec)
    wb = copy.copy(spec.worldbody)
    wb.bodies = [b for b in spec.worldbody.bodies
                 if not any(j.type == JNT_FREE for j in b.joints)]
    out.worldbody = wb
    return out


def load_arm_model(path: str, dtype=np.float32) -> Model:
    """Parse and compile the arm-only submodel of a scene MJCF."""
    return compile_spec(drop_free_bodies(parse_mjcf(path)), dtype=dtype)
