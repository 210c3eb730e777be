"""Device-resident replay buffer, the port's counterpart of the JAX
package's learn/replay.py.

Capability parity with the reference's Modules.py:28-55 (``ReplayBuffer``):
fixed capacity, ring-buffer overwrite (``position = (position+1) %
capacity``, :41-44), and the deliberate sampling quirk: ``sample(B)``
returns B-1 uniformly random transitions PLUS the most recently pushed one
(:46-49), so the newest experience is always trained on. With gamma = 0 the
reference stores (state, action, reward) (Modules.py:13); so does this.

The ring is preallocated tensors on the buffer's device; ``position`` and
``size`` are host integers, so a push or a sample never waits for the
card. The B-1 random slots are drawn without replacement from the first
``size`` slots with ``torch.randperm`` on an explicit generator (the JAX
package takes the top B-1 of uniform scores: the same distribution).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import torch

from mujoco_rl_ur5_tpu_torch.scene.model import resolve_device


@dataclass(eq=False)
class ReplayState:
    """The buffer's contents (``push`` returns a new state; the tensors are
    written in place)."""

    states: torch.Tensor    # (cap, H, W, C)
    actions: torch.Tensor   # (cap,) int32 flat action index
    rewards: torch.Tensor   # (cap,) float32
    position: int           # next write slot
    size: int               # valid entries

    def replace(self, **kw) -> "ReplayState":
        return dataclasses.replace(self, **kw)


class ReplayBuffer:
    """Static configuration and the ops over a ReplayState, on ``device``:
    the card by default (raises without one), the CPU only when the caller
    asks for it."""

    def __init__(self, capacity: int, obs_shape: Tuple[int, ...],
                 obs_dtype=torch.float32, device="cuda"):
        self.capacity = capacity
        self.obs_shape = tuple(obs_shape)
        self.obs_dtype = obs_dtype
        self.device = resolve_device(device, "ReplayBuffer")

    def init(self) -> ReplayState:
        return ReplayState(
            states=torch.zeros((self.capacity,) + self.obs_shape,
                               dtype=self.obs_dtype, device=self.device),
            actions=torch.zeros(self.capacity, dtype=torch.int32,
                                device=self.device),
            rewards=torch.zeros(self.capacity, dtype=torch.float32,
                                device=self.device),
            position=0, size=0)

    def push(self, buf: ReplayState, state, action, reward) -> ReplayState:
        """Insert one transition at the ring position (Modules.py:38-44),
        or a batch of them along a leading axis: writes wrap modulo the
        capacity and, where a batch is longer than the ring, the newest
        write of each slot wins, as in the reference's ring."""
        dev = self.device
        state = torch.as_tensor(state, dtype=self.obs_dtype, device=dev)
        action = torch.as_tensor(action, dtype=torch.int32, device=dev)
        reward = torch.as_tensor(reward, dtype=torch.float32, device=dev)
        if state.dim() == len(self.obs_shape):          # one transition
            state, action, reward = state[None], action[None], reward[None]
        n = state.shape[0]
        keep = min(n, self.capacity)                    # the newest writes
        idx = (buf.position + torch.arange(n - keep, n, device=dev)) \
            % self.capacity
        buf.states[idx] = state[n - keep:]
        buf.actions[idx] = action.reshape(n)[n - keep:]
        buf.rewards[idx] = reward.reshape(n)[n - keep:]
        return buf.replace(position=(buf.position + n) % self.capacity,
                           size=min(buf.size + n, self.capacity))

    def sample(self, buf: ReplayState, generator: torch.Generator,
               batch_size: int):
        """(batch_size - 1) slots uniform WITHOUT replacement over the first
        ``size`` (the reference's random.sample, Modules.py:46-49) and the
        most recent transition last: (states, actions, rewards).
        ``generator`` lies on the buffer's device."""
        if buf.size < batch_size - 1 or buf.size == 0:
            raise ValueError(f"sample({batch_size}) from {buf.size} "
                             f"transitions")
        newest = (buf.position - 1) % self.capacity
        rand = torch.randperm(buf.size, generator=generator,
                              device=self.device)[:batch_size - 1]
        idx = torch.cat([rand, torch.tensor([newest], device=self.device)])
        return buf.states[idx], buf.actions[idx], buf.rewards[idx]

    def __len__(self):  # as the JAX package's: the size is the state's
        raise TypeError("use buf.size on the ReplayState")
