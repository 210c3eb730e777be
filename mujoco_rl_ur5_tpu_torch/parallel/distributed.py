"""Process-group start-up and fault-tolerant runs on torch.distributed: the
port's counterpart of the JAX package's parallel/distributed.py.

  * ``initialize_multihost``: ``init_process_group`` from torch's own
    variables (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK) or arguments;
    with none of them it returns False and touches no global state, so
    every entry point can call it. The backend follows the device the
    caller names: NCCL for "cuda", gloo for "cpu" (never probed);
  * ``global_mesh``: a ("data", "model") mesh over every rank;
  * ``sync_hosts``: a barrier (around checkpoint writes);
  * ``is_coordinator``: rank 0 (or no process group);
  * ``elastic_run``: restart a failing train function from the newest of
    the Trainer's checkpoints (``ep#####.pt``, ``final.pt``).
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

from mujoco_rl_ur5_tpu_torch.parallel.mesh import make_mesh


def initialize_multihost(coordinator: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         device="cuda") -> bool:
    """Start the default process group when running multi-process.

    ``coordinator`` is "host:port" (default MASTER_ADDR:MASTER_PORT),
    ``num_processes`` the world size (WORLD_SIZE), ``process_id`` this
    rank (RANK). Returns True when the group is up (also when it already
    was), False where no coordinator is given anywhere."""
    if dist.is_initialized():
        return True
    env = os.environ
    if coordinator is None and "MASTER_ADDR" in env:
        coordinator = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', 29500)}"
    if coordinator is None:
        return False
    world = num_processes if num_processes is not None \
        else int(env.get("WORLD_SIZE", 1))
    rank = process_id if process_id is not None else int(env.get("RANK", 0))
    kind = torch.device(device).type
    if kind == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group("nccl" if kind == "cuda" else "gloo",
                            init_method=f"tcp://{coordinator}",
                            world_size=world, rank=rank)
    return True


def global_mesh(model: int = 1):
    """A ("data", "model") mesh over every rank of every process."""
    return make_mesh(data=-1, model=model)


def sync_hosts(tag: str = "sync") -> None:
    """A barrier over every rank (nothing without a process group)."""
    if dist.is_initialized():
        dist.barrier()


def is_coordinator() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def elastic_run(train_fn: Callable[[Optional[str]], None],
                checkpoint_dir: str, max_restarts: int = 3,
                backoff_s: float = 5.0) -> None:
    """Run ``train_fn(resume_path)``; on an exception, find the newest
    checkpoint in ``checkpoint_dir`` and run it again from there, at most
    ``max_restarts`` times (then the exception propagates)."""
    attempt = 0
    while True:
        resume = _latest_checkpoint(checkpoint_dir)
        try:
            train_fn(resume)
            return
        except KeyboardInterrupt:
            raise
        except Exception as e:  # noqa: BLE001 -- restart on any failure
            attempt += 1
            if attempt > max_restarts:
                raise
            print(f"elastic_run: attempt {attempt} failed with "
                  f"{type(e).__name__}: {e}; restarting from "
                  f"{resume or 'scratch'} in {backoff_s}s")
            time.sleep(backoff_s)


def _latest_checkpoint(checkpoint_dir: str) -> Optional[str]:
    """The newest checkpoint in ``checkpoint_dir``: the last by name of its
    ``.pt`` files (the Trainer writes ep#####.pt, then final.pt) and
    directories, or None."""
    if not os.path.isdir(checkpoint_dir):
        return None
    entries = sorted(
        e for e in os.listdir(checkpoint_dir)
        if e.endswith(".pt")
        or os.path.isdir(os.path.join(checkpoint_dir, e)))
    return os.path.join(checkpoint_dir, entries[-1]) if entries else None
