"""Model constants and index tables as device tensors, uploaded once.

Indexing a CUDA tensor with a numpy array copies the index to the card on
every call (a synchronous pageable copy). The port's batched physics reads
its static tables (tree layouts, pair lists, level schedules) through
``ix``, which converts and uploads each distinct table once per device and
keeps it; ``const`` does the same for float constants. Results are shared:
never write to them in place.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _uploaded(data: bytes, shape, dtype, device) -> torch.Tensor:
    a = np.frombuffer(data, np.float64).reshape(shape)
    return torch.as_tensor(a.copy(), dtype=dtype, device=device)


def const(a, like: torch.Tensor) -> torch.Tensor:
    """A model constant as a tensor of like's type on like's device."""
    a = np.asarray(a, np.float64)
    return _uploaded(a.tobytes(), a.shape, like.dtype, like.device)


@functools.lru_cache(maxsize=None)
def _indices(data: bytes, shape, is_bool: bool, device) -> torch.Tensor:
    t = torch.as_tensor(np.frombuffer(data, np.int64).reshape(shape).copy(),
                        device=device)
    return t > 0 if is_bool else t


def ix(a, device) -> torch.Tensor:
    """A static integer (or boolean) table as an int64 (bool) tensor on
    ``device``."""
    a = np.asarray(a)
    return _indices(a.astype(np.int64).tobytes(), a.shape, a.dtype == bool,
                    device)
