"""A check's sample of the window's calls, and its verdict from per-item
numbers and their limits."""

from __future__ import annotations

import numpy as np


def verdict(numbers: dict, limits: dict) -> tuple:
    """({name: (largest value, limit)}, items over any limit) from
    {name: the number of each item}."""
    bad = np.zeros(len(next(iter(numbers.values()))), bool)
    out = {}
    for k, v in numbers.items():
        out[k] = (float(np.max(v)), limits[k])
        bad |= ~(v <= limits[k])
    return out, int(bad.sum())


def sample(gen: np.random.Generator, pools: list, n: int) -> list:
    """``n`` of the window's calls drawn from ``gen``, in order, taking
    calls of distinct pool entries first (``pools``: each call's entry):
    two calls of one entry repeat the same answers."""
    order = gen.permutation(len(pools))
    seen, first, rest = set(), [], []
    for c in order:
        (rest if pools[c] in seen else first).append(int(c))
        seen.add(pools[c])
    return sorted((first + rest)[:n])
