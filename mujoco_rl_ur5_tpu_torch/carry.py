"""Carry a chain plan across from the JAX package as plain arrays.

``plan_from_arrays`` builds the port's :class:`ChainPlan` from the JAX
plan's fields given as numpy arrays and numbers (``{name: value}`` for
every dataclass field), so that both packages compute on the identical
plan: integer arrays become int64, float arrays float64, exactly as the
JAX package's own plan holds them.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from mujoco_rl_ur5_tpu_torch.physics.chain import ChainPlan

PLAN_FIELDS = tuple(f.name for f in dataclasses.fields(ChainPlan))


def plan_from_arrays(d: dict) -> ChainPlan:
    missing = [n for n in PLAN_FIELDS if n not in d]
    if missing:
        raise KeyError(f"plan_from_arrays: missing fields {missing}")
    kw = {}
    for name in PLAN_FIELDS:
        v = d[name]
        if name in ("nv", "nu", "nmov"):
            kw[name] = int(v)
        elif name == "timestep":
            kw[name] = float(v)
        else:
            a = np.asarray(v)
            kw[name] = a.astype(np.int64 if a.dtype.kind in "iub"
                                else np.float64)
    return ChainPlan(**kw)
