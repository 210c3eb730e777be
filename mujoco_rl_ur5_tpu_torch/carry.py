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

``state_from_arrays``, ``pid_params_from_arrays``, ``pid_state_from_arrays``,
``ctrl_state_from_arrays``, ``env_state_from_arrays``,
``reacher_state_from_arrays`` and ``ilqr_from_arrays`` carry the JAX
package's State, PIDParams, PIDState, CtrlState, EnvState, ReacherState
and ILQRResult: each takes a dict of numpy arrays (nested dicts for the
nested fields) or any object with those attributes, and keeps each
array's dtype. The JAX EnvState's and ReacherState's PRNG keys have no
counterpart (the port draws from a ``torch.Generator``) and are not read.

``agent_from_arrays`` carries the grasp Q-network's Flax trees (``params``
and ``batch_stats`` as nested dicts of numpy arrays) to the port's
``state_dict``: the submodule names are Flax's, conv kernels (kh, kw, in,
out) become (out, in, kh, kw), BatchNorm ``scale``/``bias``/``mean``/``var``
become ``weight``/``bias``/``running_mean``/``running_var``.
``train_state_from_arrays`` carries a whole TrainState (the network, the
step, the rotation counters, and optax's Adam ``count``/``mu``/``nu`` into
AdamW's ``step``/``exp_avg``/``exp_avg_sq``), ``replay_from_arrays`` a
ReplayState.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np

import torch

from mujoco_rl_ur5_tpu_torch.control.controller import CtrlState
from mujoco_rl_ur5_tpu_torch.control.pid import PIDParams, PIDState
from mujoco_rl_ur5_tpu_torch.env.grasp_env import EnvState
from mujoco_rl_ur5_tpu_torch.env.reacher import ReacherState
from mujoco_rl_ur5_tpu_torch.learn.agent import COUNTERS, TrainState
from mujoco_rl_ur5_tpu_torch.learn.replay import ReplayState
from mujoco_rl_ur5_tpu_torch.mpc.ilqr import ILQRResult
from mujoco_rl_ur5_tpu_torch.mpc.lqr import Gains
from mujoco_rl_ur5_tpu_torch.physics.chain import ChainPlan
from mujoco_rl_ur5_tpu_torch.scene.model import (
    ARRAY_FIELDS, Model, State, Topology,
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


def _field(src, name):
    return src[name] if isinstance(src, dict) else getattr(src, name)


def _fields(src, names, device) -> dict:
    """{name: tensor on ``device``} with each array's dtype kept."""
    return {n: torch.as_tensor(np.array(_field(src, n)), device=device)
            for n in names}


def state_from_arrays(src, device="cpu") -> State:
    return State(**_fields(src, ("qpos", "qvel", "ctrl", "time"), device))


def pid_params_from_arrays(src, device="cpu") -> PIDParams:
    return PIDParams(**_fields(src, ("kp", "ki", "kd", "out_lo", "out_hi"),
                               device))


def pid_state_from_arrays(src, device="cpu") -> PIDState:
    return PIDState(**_fields(src, ("integral", "last_meas", "primed"),
                              device))


def ctrl_state_from_arrays(src, device="cpu") -> CtrlState:
    return CtrlState(
        pid=pid_state_from_arrays(_field(src, "pid"), device),
        setpoints=_fields(src, ("setpoints",), device)["setpoints"],
        params=pid_params_from_arrays(_field(src, "params"), device))


def env_state_from_arrays(src, device="cpu") -> EnvState:
    return EnvState(sim=state_from_arrays(_field(src, "sim"), device),
                    ctl=ctrl_state_from_arrays(_field(src, "ctl"), device),
                    **_fields(src, ("rgb", "depth"), device))


def reacher_state_from_arrays(src, device="cpu") -> ReacherState:
    return ReacherState(sim=state_from_arrays(_field(src, "sim"), device),
                        pid=pid_state_from_arrays(_field(src, "pid"), device),
                        **_fields(src, ("setpoints", "target"), device))


def ilqr_from_arrays(src, device="cpu") -> ILQRResult:
    return ILQRResult(gains=Gains(**_fields(_field(src, "gains"),
                                            ("K", "d", "S", "s"), device)),
                      **_fields(src, ("xs", "us", "cost"), device))


_RENAME = {"kernel": "weight", "scale": "weight", "bias": "bias",
           "mean": "running_mean", "var": "running_var"}


def _flat(tree, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def agent_from_arrays(params, batch_stats=None) -> dict:
    """The port's ``state_dict`` (CPU tensors, float32 or float64 as the
    arrays are) of a Flax grasp network's ``params`` and ``batch_stats``
    (either may be any tree of the same structure, such as Adam's
    moments)."""
    out = {}
    for tree in (params, batch_stats or {}):
        for path, a in _flat(tree).items():
            head, _, leaf = path.rpartition(".")
            if leaf == "kernel":
                a = a.transpose(3, 2, 0, 1)
            out[f"{head}.{_RENAME[leaf]}"] = torch.from_numpy(
                np.array(a, np.float64 if a.dtype == np.float64
                         else np.float32))
    return out


def _adam(opt_state):
    """optax's ScaleByAdamState inside an optimiser state (a chain)."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    for part in opt_state if isinstance(opt_state, (tuple, list)) else ():
        found = _adam(part)
        if found is not None:
            return found
    return None


def train_state_from_arrays(agent, src) -> TrainState:
    """The port's TrainState for ``agent`` (a GraspAgent, on its device)
    from the JAX package's TrainState as numpy arrays (a dict or an object
    with its fields): params, batch_stats, opt_state (optax's adamw
    chain), step and the three rotation counters. Float64 arrays give a
    float64 model."""
    sd = agent_from_arrays(_field(src, "params"), _field(src, "batch_stats"))
    model = agent.make_model().to(next(iter(sd.values())).dtype)
    model.load_state_dict(sd)
    ts = agent.state_for(model)
    adam = _adam(_field(src, "opt_state"))
    count = int(np.asarray(adam.count))
    if count:
        mu, nu = agent_from_arrays(adam.mu), agent_from_arrays(adam.nu)
        for name, p in model.named_parameters():
            ts.optimizer.state[p] = {
                "step": torch.tensor(float(count), dtype=torch.float32),
                "exp_avg": mu[name].to(p.device),
                "exp_avg_sq": nu[name].to(p.device)}
    return ts.replace(step=int(np.asarray(_field(src, "step"))), **{
        k: torch.as_tensor(np.array(_field(src, k)), dtype=torch.int32,
                           device=agent.device) for k in COUNTERS})


def replay_from_arrays(src, device="cpu") -> ReplayState:
    """The JAX package's ReplayState (states, actions, rewards, position,
    size) on ``device``."""
    return ReplayState(
        position=int(np.asarray(_field(src, "position"))),
        size=int(np.asarray(_field(src, "size"))),
        **_fields(src, ("states", "actions", "rewards"), device))
