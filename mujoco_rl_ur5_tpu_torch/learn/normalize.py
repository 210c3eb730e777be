"""Observation normalization statistics, the port's counterpart of the JAX
package's learn/normalize.py.

Capability parity with the reference's normalize.py: sample N
domain-randomized env resets, compute the per-channel (R, G, B, D) mean and
std, persist them; the agent reloads them for "standardize" mode
(Grasping_Agent_multidiscrete.py:370-379). Reference stored values: means
~ [108.30, 120.33, 132.30, 1.532], stds ~ [67.87, 57.16, 48.94, 0.427].

The N resets are one batched ``env.reset``: every pile settles at once on
the env's device. Persisted as .npz with the JAX package's keys
(``means``, ``stds``), so either package reads the other's file.
"""

from __future__ import annotations

import numpy as np
import torch


def compute_mean_std(env, generator: torch.Generator, n_samples: int = 100):
    """(means (4,), stds (4,)) as numpy over ``n_samples`` randomized
    resets drawn from ``generator`` (population std, as jnp.std)."""
    es = env.reset(generator, n_samples)
    obs = torch.cat([es.rgb.float(), es.depth.float()[..., None]], -1)
    obs = obs.reshape(-1, 4)
    return (obs.mean(0).cpu().numpy(),
            obs.std(0, correction=0).cpu().numpy())


def save_mean_std(path: str, means, stds):
    np.savez(path, means=np.asarray(means), stds=np.asarray(stds))


def load_mean_std(path: str):
    d = np.load(path)
    return d["means"], d["stds"]
