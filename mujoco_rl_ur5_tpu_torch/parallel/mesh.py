"""Device meshes, batch sharding and the data- and tensor-parallel steps on
torch.distributed: the port's counterpart of the JAX package's
parallel/mesh.py.

The meaning kept from JAX's GSPMD layer: a data-parallel result equals the
single-process result on the whole batch. Where JAX annotates global
arrays and lets XLA insert the collectives, here every rank is a process
holding its contiguous share of the batch, and the collectives are
explicit:

  * "data": scenario and batch parallelism. ``shard_batch`` takes this
    rank's rows; ``dp_env_reset``/``dp_env_rollout`` run the batched env on
    them with no collective (the scenarios are independent);
    ``dp_train_step`` all-reduces the gradients to the global mean and the
    BatchNorm batch moments to the global batch's (torch's per-rank
    BatchNorm, or a plain DDP wrapper, would normalise each shard by its
    own moments);
  * "model": the tensor-parallel layout. ``tp_param_shardings`` /
    ``tp_place_train_state`` place every conv or linear weight with at
    least ``min_features`` output features as a DTensor sharded on its
    output-feature axis (dim 0: the port's weights are OIHW) over
    "model", everything else replicated. The placement shards storage
    only: a parametrization (torch.nn.utils.parametrize) gathers each
    placed tensor whole where its layer reads it, so every rank computes
    the whole layer.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with dims
("data", "model") over the ranks of the default process group
(``distributed.initialize_multihost``): NCCL on the card, gloo on the CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Sequence

import torch
import torch.distributed as dist

AXES = ("data", "model")


def tree_map(fn, tree):
    """``fn`` on every tensor of a tree of dataclasses, (named) tuples,
    lists and dicts; other leaves are kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return tree


def make_mesh(devices: Optional[Sequence[int]] = None, data: int = -1,
              model: int = 1):
    """A ("data", "model") mesh over ``devices`` (ranks of the default
    process group; all of them by default). ``data=-1`` absorbs the ranks
    ``model`` leaves. The device type follows the group's backend: "cuda"
    for NCCL, "cpu" otherwise."""
    from torch.distributed.device_mesh import DeviceMesh

    ranks = list(range(dist.get_world_size()) if devices is None
                 else devices)
    n = len(ranks)
    if data == -1:
        if n % model:
            raise ValueError(f"make_mesh: {n} ranks do not split into "
                             f"model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"make_mesh: {data} x {model} != {n} ranks")
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(kind, torch.tensor(ranks).reshape(data, model),
                      mesh_dim_names=AXES)


def _data(mesh) -> tuple:
    """(this rank's index on "data", the size of "data")."""
    return mesh.get_local_rank("data"), mesh.size(0)


def shard_batch(mesh, tree, axis: int = 0):
    """This rank's contiguous share of ``axis`` of every tensor in ``tree``
    over "data" (0-dim tensors are kept); the axis must divide evenly."""
    i, n = _data(mesh)

    def take(x):
        if x.dim() == 0:
            return x
        if x.shape[axis] % n:
            raise ValueError(f"shard_batch: {x.shape[axis]} rows do not "
                             f"split over {n} data ranks")
        k = x.shape[axis] // n
        return x.narrow(axis, i * k, k)
    return tree_map(take, tree)


def gather_batch(mesh, tree, axis: int = 0):
    """The inverse of ``shard_batch``: every rank's share concatenated on
    ``axis`` over "data", on every rank (an all-gather; none on one
    rank)."""
    _, n = _data(mesh)
    if n == 1:
        return tree
    group = mesh.get_group("data")

    def cat(x):
        if x.dim() == 0:
            return x
        y = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
        parts = [torch.empty_like(y) for _ in range(n)]
        dist.all_gather(parts, y, group=group)
        out = torch.cat(parts, axis)
        return out.to(torch.bool) if x.dtype == torch.bool else out
    return tree_map(cat, tree)


def replicate(mesh, tree):
    """Every tensor of ``tree`` as the mesh's first rank holds it, on every
    rank (a broadcast)."""
    src = int(mesh.mesh.flatten()[0])

    def bcast(x):
        y = x.detach().clone().contiguous()
        dist.broadcast(y, src=src)
        return y
    return tree_map(bcast, tree)


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group's ranks; the gradient is summed the same way (each
    rank's loss depends on every rank's share through the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


@contextlib.contextmanager
def _global_moments(model: torch.nn.Module, reduce):
    """Inside the block, every BatchNorm of ``model`` takes its training
    moments through ``reduce`` ((mean, mean of squares) of this rank's
    share -> those of the global batch)."""
    from mujoco_rl_ur5_tpu_torch.learn.networks import BatchNorm

    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.batch_moments = (lambda xf, m=m:
                           reduce(*BatchNorm.batch_moments(m, xf)))
    try:
        yield
    finally:
        for m in norms:
            del m.batch_moments


def dp_train_step(agent, mesh):
    """The data-parallel learner step: ``(ts, states, actions, rewards) ->
    (ts, loss)`` on this rank's shard of the batch, with the parameters
    replicated. It equals ``agent.train_step`` on the whole batch: the
    BatchNorm moments are those of the global batch (all-reduced inside
    the forward, differentiably), the loss is the global mean, and the
    gradients are all-reduced to it before the optimizer steps (with
    ``accum_steps``, once per step)."""
    group = mesh.get_group("data")

    def step(ts, states, actions, rewards):
        n = torch.tensor([float(states.shape[0])], dtype=torch.float64,
                         device=states.device)
        dist.all_reduce(n, group=group)
        share = states.shape[0] / float(n)

        def moments(mean, msq):
            return (_AllReduceSum.apply(mean * share, group),
                    _AllReduceSum.apply(msq * share, group))

        k = agent.cfg.accum_steps
        if ts.mini_step == 0:
            ts.optimizer.zero_grad(set_to_none=True)
        with _global_moments(ts.model, moments):
            loss, _ = agent.loss(ts, states, actions, rewards)
        part = loss * share
        (part / k if k > 1 else part).backward()
        total = part.detach().clone()
        dist.all_reduce(total, group=group)
        mini = ts.mini_step + 1
        if mini == k:
            for p in ts.model.parameters():
                if p.grad is not None:
                    dist.all_reduce(p.grad, group=group)
            ts.optimizer.step()
            mini = 0
        return ts.replace(mini_step=mini), total
    return step


def dp_env_reset(env, mesh):
    """Scenario-parallel reset: ``(generator, batch) ->`` this rank's share
    of ``env.reset(generator, batch)``. Every rank draws the whole batch
    from its generator (so the generators stay in step) and builds only
    its rows (``reset``'s ``rows``); no collective."""
    def reset(generator, batch):
        i, n = _data(mesh)
        if batch % n:
            raise ValueError(f"dp_env_reset: {batch} scenarios do not split "
                             f"over {n} data ranks")
        k = batch // n
        return env.reset(generator, batch, rows=slice(i * k, (i + 1) * k))
    return reset


def dp_env_rollout(env, mesh):
    """Scenario-parallel step: ``(es, actions) ->`` ``env.step`` on this
    rank's share ``es`` (from ``dp_env_reset``), with ``actions`` the whole
    batch's (this rank's rows are taken) or this rank's own; no
    collective."""
    def step(es, actions):
        if actions.shape[0] != es.sim.qpos.shape[0]:
            actions = shard_batch(mesh, actions)
        return env.step(es, actions)
    return step


# -- tensor parallelism --------------------------------------------------------


def _tp_placements(mesh, name: str, p: torch.Tensor, min_features: int):
    from torch.distributed.tensor import Replicate, Shard

    m = mesh.size(1)
    if (name.endswith("weight") and p.dim() >= 2
            and p.shape[0] >= min_features and p.shape[0] % m == 0):
        return (Replicate(), Shard(0))
    return (Replicate(), Replicate())


def tp_param_shardings(mesh, module: torch.nn.Module,
                       min_features: int = 128) -> dict:
    """The tensor-parallel layout of ``module``'s parameters: {name:
    placements over ("data", "model")}. A conv or linear weight with at
    least ``min_features`` output features (dim 0, dividing over "model")
    is ``Shard(0)`` over "model"; everything else is replicated."""
    return {name: _tp_placements(mesh, name, p, min_features)
            for name, p in module.named_parameters()}


class _Gathered(torch.nn.Module):
    """The parametrization of a placed tensor: the whole tensor, gathered
    (differentiably) where its layer reads it."""

    def forward(self, x):
        return x.full_tensor()


def tp_place_train_state(agent, mesh, ts, min_features: int = 128):
    """``ts`` with its parameters placed by ``tp_param_shardings`` (as
    DTensors, each read through ``_Gathered``) and the AdamW moments placed
    as their parameters; the BatchNorm statistics, the step and the
    counters stay replicated. The returned state feeds the ordinary
    ``agent.train_step``. A placed parameter ``name`` is held at
    ``<module>.parametrizations.<leaf>.original``; ``<module>.<leaf>``
    reads it whole."""
    from torch.distributed.tensor import distribute_tensor
    from torch.nn.utils import parametrize

    places = tp_param_shardings(mesh, ts.model, min_features)
    moved = {}
    for name, p in list(ts.model.named_parameters()):
        mod_name, _, leaf = name.rpartition(".")
        mod = ts.model.get_submodule(mod_name)
        setattr(mod, leaf, torch.nn.Parameter(
            distribute_tensor(p.detach(), mesh, places[name]),
            requires_grad=p.requires_grad))
        parametrize.register_parametrization(mod, leaf, _Gathered())
        moved[name] = (p, getattr(mod.parametrizations, leaf).original)
    placed = agent.state_for(ts.model)
    for name, (old, new) in moved.items():
        st = ts.optimizer.state.get(old)
        if st:
            placed.optimizer.state[new] = {
                k: (distribute_tensor(v, mesh, places[name])
                    if k != "step" else v.clone()) for k, v in st.items()}
    return placed.replace(step=ts.step, mini_step=ts.mini_step, **{
        k: getattr(ts, k) for k in ("greedy_rotations", "greedy_successes",
                                    "random_successes")})
