"""Profiling and debugging decorators, the port's counterpart of the JAX
package's utils/decorators.py (the reference's decorators.py: timer :7-19,
debug :22-52, typeassert :70-89, dict2list :91-116).

CUDA launches return before the card has finished, so a wall clock around
a call measures its enqueue unless it waits for the device first:

  * ``timer``       -- wall clock per call; synchronises the card when the
                       return value holds a CUDA tensor;
  * ``block_timer`` -- context manager variant for timing any region;
  * ``debug``       -- signature and return tracing with tensor and array
                       shapes and dtypes;
  * ``typeassert``  -- positional/keyword argument type gate;
  * ``dict2list``   -- dict of equal-length arrays -> one stacked array;
  * ``torch_trace`` -- a ``torch.profiler`` context that writes a Chrome
                       trace (the counterpart of the JAX package's
                       ``jax_trace`` around ``jax.profiler.trace``), with
                       the port's spans (``trace.py``) over their work.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from inspect import signature

import numpy as np
import torch


def _leaves(value):
    if isinstance(value, dict):
        for v in value.values():
            yield from _leaves(v)
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _leaves(v)
    else:
        yield value


def _block(value):
    """Wait for the card when ``value`` holds a CUDA tensor; return it."""
    if any(isinstance(v, torch.Tensor) and v.is_cuda for v in _leaves(value)):
        torch.cuda.synchronize()
    return value


def timer(func):
    """Prints the runtime of the decorated function (reference
    decorators.py:7-19), waiting for returned CUDA tensors first."""

    @functools.wraps(func)
    def wrapper_timer(*args, **kwargs):
        start = time.perf_counter()
        value = _block(func(*args, **kwargs))
        print(f"{func.__name__!r} took {time.perf_counter() - start:.4f} "
              f"secs to execute.")
        return value

    return wrapper_timer


@contextlib.contextmanager
def block_timer(label: str = "region", out: list | None = None):
    """``with block_timer("solve"):`` -- wall-clocks a region. Appends the
    elapsed seconds to ``out`` when given (for bench harnesses)."""
    start = time.perf_counter()
    try:
        yield
    finally:
        elapsed = time.perf_counter() - start
        if out is not None:
            out.append(elapsed)
        print(f"{label!r} took {elapsed:.4f} secs.")


def _describe(v) -> str:
    if hasattr(v, "shape") and hasattr(v, "dtype"):
        return f"{type(v).__name__}(shape={tuple(v.shape)}, dtype={v.dtype})"
    return repr(v) if np.isscalar(v) or v is None else type(v).__name__


def debug(func):
    """Prints the function signature and return value (reference
    decorators.py:22-52), with the shapes and dtypes of tensors and arrays."""

    @functools.wraps(func)
    def wrapper_debug(*args, **kwargs):
        args_repr = [_describe(a) for a in args]
        kwargs_repr = [f"{k}={_describe(v)}" for k, v in kwargs.items()]
        print(f"########## Debugging {func.__name__} ##########")
        print(f"Calling {func.__name__}({', '.join(args_repr + kwargs_repr)}).")
        value = func(*args, **kwargs)
        print(f"{func.__name__} return type: {type(value)!r}")
        if isinstance(value, dict):
            print("Returned dictionary contents:")
            for k, v in value.items():
                print(f"{k}: {_describe(v)}")
        elif isinstance(value, (tuple, list)):
            for i, v in enumerate(value):
                print(f"[{i}]: {_describe(v)}")
        else:
            print(f"{func.__name__} returned {_describe(value)}.")
        print("#################################")
        return value

    return wrapper_debug


def typeassert(*ty_args, **ty_kwargs):
    """Enforce argument types (reference decorators.py:70-89)."""

    def decorate(func):
        sig = signature(func)
        bound_types = sig.bind_partial(*ty_args, **ty_kwargs).arguments

        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            bound_values = sig.bind(*args, **kwargs)
            for name, value in bound_values.arguments.items():
                if name in bound_types and not isinstance(value,
                                                          bound_types[name]):
                    raise TypeError(
                        f"Argument {name} must be {bound_types[name]}")
            return func(*args, **kwargs)

        return wrapper

    return decorate


def dict2list(func):
    """Convert a returned dict of equal-length arrays or tensors into one
    stacked numpy array (reference decorators.py:91-116)."""

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        value = func(*args, **kwargs)
        if isinstance(value, dict):
            return np.stack([v.detach().cpu().numpy()
                             if isinstance(v, torch.Tensor) else np.asarray(v)
                             for v in value.values()])
        return value

    return wrapper


@contextlib.contextmanager
def torch_trace(logdir: str = "torch-trace"):
    """Profile the region with ``torch.profiler`` (the host, and the card
    where there is one) and write a Chrome trace to
    ``logdir/trace.json`` (chrome://tracing or Perfetto). The counterpart
    of the JAX package's ``jax_trace``; yields the profiler, whose
    ``key_averages()`` sums the time by operator and kernel. The port's
    spans are recorded over the region too (``trace.recording()``): each
    shows in the trace as a user annotation (``mpc.solve``,
    ``ilqr.expand``, ``step``, ``collide``, ``render``, ...) over the
    operators and kernels it launched."""
    from torch.profiler import ProfilerActivity, profile

    from mujoco_rl_ur5_tpu_torch import trace

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof, trace.recording():
        yield prof
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"torch profiler trace written to {path}")
