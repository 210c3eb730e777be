"""Offline RL pipeline: generate -> unite -> extract positives -> train; the
port's counterpart of the JAX package's learn/offline.py.

Capability parity with the reference's ``Offline RL/`` directory:
  * generate_data.py (:14-132): run the (optionally pretrained) agent and
    bank (state, action, reward) triples into fixed-size shard files
    (FILE_SIZE=12 -> ``grasping_data_{n}``);
  * unite_data.py (:9-28): concatenate shards into one dataset file;
  * extract_positives.py (:10-23): filter the reward == 1 subset;
  * grasping_dataset.py (:12-74): the dataset of network inputs;
  * train.py (:90-164): supervised BCE Q-fitting, 80/20 split, per-epoch
    eval with pos/neg ``binary_accuracy`` at thresholds 0.5 / 0.3
    (:198-224), BATCH 15, EPOCHS 20, lr 1e-3 (:19-26).

Shards are .npz of numpy arrays with the JAX package's keys (``states``
float32, ``actions`` int32, ``rewards`` float32) and names, so a shard
written by either package is read by the other. The dataset lives on the
device as tensors; an epoch is a loop of ``train_step`` calls over a
permutation drawn from a generator.
"""

from __future__ import annotations

import glob
import os
from typing import Iterator, Tuple

import numpy as np
import torch

from mujoco_rl_ur5_tpu_torch.scene.model import resolve_device

FILE_SIZE = 12       # transitions per shard, generate_data.py:20
BATCH = 15           # Offline RL/train.py:19
EPOCHS = 20          # :20
LR = 1e-3            # :21


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


# -- generate ----------------------------------------------------------------

class ShardWriter:
    """Banks transitions and flushes every ``file_size`` to
    ``dir/prefix_{n}.npz`` (generate_data.py:80-94)."""

    def __init__(self, out_dir: str, prefix: str = "grasping_data",
                 file_size: int = FILE_SIZE):
        os.makedirs(out_dir, exist_ok=True)
        self.out_dir, self.prefix, self.file_size = out_dir, prefix, file_size
        self.states, self.actions, self.rewards = [], [], []
        self.n_files = 0

    def push(self, state, action, reward):
        s = _np(state)
        if s.ndim == 3:                       # single transition
            s, action, reward = s[None], [action], [reward]
        self.states.extend(s)
        self.actions.extend(_np(action).reshape(-1))
        self.rewards.extend(_np(reward).reshape(-1))
        while len(self.states) >= self.file_size:
            self._flush()

    def _flush(self):
        k = self.file_size
        path = os.path.join(self.out_dir,
                            f"{self.prefix}_{self.n_files}.npz")
        np.savez_compressed(
            path,
            states=np.stack(self.states[:k]).astype(np.float32),
            actions=np.asarray(self.actions[:k], np.int32),
            rewards=np.asarray(self.rewards[:k], np.float32))
        del self.states[:k], self.actions[:k], self.rewards[:k]
        self.n_files += 1


# -- unite / extract -----------------------------------------------------------

def unite_data(shard_glob: str, out_path: str) -> int:
    """Concatenate shard files into one dataset (unite_data.py:9-28)."""
    files = sorted(glob.glob(shard_glob))
    parts = [np.load(f) for f in files]
    states = np.concatenate([p["states"] for p in parts])
    actions = np.concatenate([p["actions"] for p in parts])
    rewards = np.concatenate([p["rewards"] for p in parts])
    np.savez_compressed(out_path, states=states, actions=actions,
                        rewards=rewards)
    return len(rewards)


def extract_positives(dataset_path: str, out_path: str) -> int:
    """reward == 1 subset (extract_positives.py:10-23)."""
    d = np.load(dataset_path)
    m = d["rewards"] >= 0.5
    np.savez_compressed(out_path, states=d["states"][m],
                        actions=d["actions"][m], rewards=d["rewards"][m])
    return int(m.sum())


# -- dataset -------------------------------------------------------------------

class GraspingDataset:
    """Device-resident dataset (grasping_dataset.py:12-74). The stored
    states are already transformed (the generate step banks the network
    input); ``split`` reproduces train.py's 80/20 (:94-96)."""

    def __init__(self, path: str, device="cuda"):
        dev = resolve_device(device, "GraspingDataset")
        d = np.load(path)
        self.states = torch.as_tensor(d["states"], device=dev)
        self.actions = torch.as_tensor(d["actions"], dtype=torch.int32,
                                       device=dev)
        self.rewards = torch.as_tensor(d["rewards"], dtype=torch.float32,
                                       device=dev)

    def __len__(self):
        return self.rewards.shape[0]

    def split(self, frac: float = 0.8, seed: int = 0):
        """((states, actions, rewards) train, (...) test) by the same
        ``np.random.RandomState(seed)`` permutation as the JAX package."""
        n = len(self)
        perm = np.random.RandomState(seed).permutation(n)
        cut = int(frac * n)
        dev = self.rewards.device

        def pick(idx):
            idx = torch.as_tensor(idx, device=dev)
            return self.states[idx], self.actions[idx], self.rewards[idx]

        return pick(perm[:cut]), pick(perm[cut:])


def batches(data, batch: int, generator: torch.Generator) -> Iterator[Tuple]:
    """Full batches of ``data`` in an order drawn from ``generator`` (on
    the data's device); the ragged tail is dropped."""
    s, a, r = data
    n = s.shape[0]
    perm = torch.randperm(n, generator=generator, device=s.device)
    for i in range(0, n - batch + 1, batch):
        idx = perm[i:i + batch]
        yield s[idx], a[idx], r[idx]


# -- metrics -------------------------------------------------------------------

def binary_accuracy(q_sigmoid: torch.Tensor, rewards: torch.Tensor,
                    threshold_pos: float = 0.5, threshold_neg: float = 0.3):
    """Pos/neg accuracy at the reference's two thresholds (train.py:198-224):
    positives count as hits when sigmoid(Q) > 0.5, negatives when < 0.3."""
    pos = rewards >= 0.5
    hit_pos = (q_sigmoid > threshold_pos) & pos
    hit_neg = (q_sigmoid < threshold_neg) & ~pos
    acc_pos = hit_pos.sum() / pos.sum().clamp_min(1)
    acc_neg = hit_neg.sum() / (~pos).sum().clamp_min(1)
    return acc_pos, acc_neg


class AverageMeter:
    """Running average (train.py:227-252)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = self.sum = self.count = self.avg = 0.0

    def update(self, val, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


# -- supervised trainer ----------------------------------------------------------

def train_offline(agent, ts, dataset: GraspingDataset, epochs: int = EPOCHS,
                  batch: int = BATCH, seed: int = 0, log=print):
    """Supervised Q-fit (train.py:90-164). Returns the final TrainState and a
    per-epoch metrics list."""
    generator = torch.Generator(device=agent.device).manual_seed(seed)
    train_set, test_set = dataset.split(0.8, seed)
    history = []
    for epoch in range(epochs):
        tr_loss = AverageMeter()
        for s, a, r in batches(train_set, batch, generator):
            ts, loss = agent.train_step(ts, s, a, r)
            tr_loss.update(loss, s.shape[0])
        te_loss, pos_acc, neg_acc = AverageMeter(), AverageMeter(), AverageMeter()
        for s, a, r in batches(test_set, batch, generator):
            with torch.no_grad():
                loss, q = agent.loss(ts, s, a, r, train=False)
            ap, an = binary_accuracy(torch.sigmoid(q), r)
            te_loss.update(loss, s.shape[0])
            pos_acc.update(ap, s.shape[0])
            neg_acc.update(an, s.shape[0])
        row = dict(epoch=epoch, train_loss=tr_loss.avg, test_loss=te_loss.avg,
                   pos_acc=pos_acc.avg, neg_acc=neg_acc.avg)
        history.append(row)
        log(f"epoch {epoch}: train {tr_loss.avg:.4f} test {te_loss.avg:.4f} "
            f"acc+ {pos_acc.avg:.3f} acc- {neg_acc.avg:.3f}")
    return ts, history
