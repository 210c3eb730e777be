"""Carry a chain plan, a compiled model or a warm start across from the
JAX package as plain arrays.

``plan_from_arrays`` builds the port's :class:`ChainPlan` from the JAX
plan's fields given as numpy arrays and numbers (``{name: value}`` for
every dataclass field), so that both packages compute on the identical
plan: integer arrays become int64, float arrays float64, exactly as the
JAX package's own plan holds them.

``model_from_arrays`` does the same for a compiled :class:`Model`: the
port's own topology with every numeric array taken from the JAX model's
leaves (``{name: array}``), so that both packages step on identical
``dof_invweight0``/``geom_invweight0`` and pair tables (the two compilers
compute the invweights in float32 with different sums). ``warm_from_arrays``
carries the contact solver's warm start, a pair of arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np

import torch

from mujoco_rl_ur5_tpu_torch.physics.chain import ChainPlan
from mujoco_rl_ur5_tpu_torch.scene.model import (
    ARRAY_FIELDS, Model, Topology,
)

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


def model_from_arrays(topo: Topology, d: dict, device="cpu") -> Model:
    """The port's Model on ``device`` with ``topo`` and every numeric array
    from ``d`` (floats keep their width, integers become int64)."""
    missing = [n for n in ARRAY_FIELDS if n not in d]
    if missing:
        raise KeyError(f"model_from_arrays: missing fields {missing}")
    return Model(topo=topo, **{n: np.asarray(d[n]) for n in ARRAY_FIELDS}
                 ).to(device)


def warm_from_arrays(warm, device="cpu"):
    """The contact solver's warm start (facet forces (B, ncand, 10),
    scalar-row forces (B, S)) as float32 tensors on ``device``."""
    return tuple(torch.as_tensor(np.array(a, np.float32), device=device)
                 for a in warm)
