"""Spans and counters inside the port: where each layer spends the host's
time, the device time of the layers that ask for it, and counts of useful
work over attempts.

Recording is off unless a caller enters ``recording()``; off, a span is a
check of one module-level name that returns a shared no-op context, and a
count returns at once. Nothing else switches it: no environment variable,
no configuration field.

  * ``span(name, device=False)`` -- a context manager around one layer's
    work; ``spanned(name, device=False)`` the same around every call of a
    function. While recording it keeps the span's name, the index of the
    span it opened inside (its parent), a call id shared by every span of
    one root span, and its host start and end from ``time.time_ns()``,
    the clock torch.profiler stamps its events in. With ``device=True`` on
    a card it also records a pair of timing events on the current stream
    (none while the stream captures a CUDA graph). Where torch.profiler is
    also running, the span enters ``torch.profiler.record_function``
    under its name, so a profile shows the spans over the kernels they
    launched.
  * ``count(name, n)`` -- adds ``n`` to a counter while recording: an
    int, or a tensor summed on its own device with no read to the host.
  * ``recording()`` -- records until the outermost such block exits and
    yields its ``Recorder``, which stays readable after. Blocks nest:
    an inner one yields the same recorder.

Spans are recorded for one thread at a time: two threads recording at once
would nest each other's spans.
"""

from __future__ import annotations

import contextlib
import functools
import time

import torch

_REC = None                     # the Recorder while recording, else None
_OFF = contextlib.nullcontext()


class Span:
    """One recorded span: ``parent`` is the index of the enclosing span in
    ``Recorder.spans`` (-1 for a root), ``call`` the id of its root's call,
    ``start_ns``/``end_ns`` host times from ``time.time_ns()``, ``events``
    the (start, end) CUDA events of a device span, else None."""

    __slots__ = ("name", "parent", "call", "start_ns", "end_ns", "events")

    def __init__(self, name, parent, call, start_ns):
        self.name, self.parent, self.call = name, parent, call
        self.start_ns, self.end_ns, self.events = start_ns, None, None

    @property
    def host_ns(self) -> int:
        return self.end_ns - self.start_ns


class Recorder:
    """What one ``recording()`` block kept: its spans in the order they
    opened, and its counters."""

    def __init__(self):
        self.spans = []
        self._open = []          # indices of the open spans, innermost last
        self._calls = 0
        self._ints = {}          # counter -> int total
        self._tensors = {}       # counter -> device sums, read by counts()

    def _enter(self, name: str, device: bool) -> Span:
        if self._open:
            parent = self._open[-1]
            call = self.spans[parent].call
        else:
            parent, call = -1, self._calls
            self._calls += 1
        s = Span(name, parent, call, time.time_ns())
        if (device and torch.cuda.is_initialized()
                and not torch.cuda.is_current_stream_capturing()):
            s.events = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
            s.events[0].record()
        self._open.append(len(self.spans))
        self.spans.append(s)
        return s

    def _exit(self, s: Span) -> None:
        if s.events is not None:
            s.events[1].record()
        self._open.pop()
        s.end_ns = time.time_ns()

    def _closed(self, name: str):
        return [s for s in self.spans if s.name == name
                and s.end_ns is not None]

    def host_ns(self, name: str) -> int:
        """Host ns of every closed span called ``name``, summed."""
        return sum(s.host_ns for s in self._closed(name))

    def self_host_ns(self, name: str) -> int:
        """``host_ns(name)`` less the host time of those spans' children:
        the time the layer spent in its own code."""
        mine = {i for i, s in enumerate(self.spans)
                if s.name == name and s.end_ns is not None}
        inner = sum(s.host_ns for s in self.spans
                    if s.parent in mine and s.end_ns is not None)
        return self.host_ns(name) - inner

    def device_ms(self, name: str):
        """Device ms between the start and end events of every closed span
        called ``name`` recorded with them (one synchronise), or None where
        there is none."""
        ev = [s.events for s in self._closed(name) if s.events is not None]
        if not ev:
            return None
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in ev)

    def counts(self) -> dict:
        """{counter: its total}; device sums are read here, once."""
        out = dict(self._ints)
        for name, ts in self._tensors.items():
            out[name] = out.get(name, 0) + torch.stack(ts).sum().item()
        return out


class _Open:
    __slots__ = ("rec", "name", "device", "span", "rf")

    def __init__(self, rec: Recorder, name: str, device: bool):
        self.rec, self.name, self.device = rec, name, device

    def __enter__(self):
        self.span = self.rec._enter(self.name, self.device)
        self.rf = None
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        return self.span

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self.rec._exit(self.span)
        return False


def span(name: str, device: bool = False):
    """A context around one layer's work, recorded while recording."""
    rec = _REC
    if rec is None:
        return _OFF
    return _Open(rec, name, device)


def spanned(name: str, device: bool = False):
    """Decorator: every call of the function in ``span(name, device)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            rec = _REC
            if rec is None:
                return fn(*args, **kwargs)
            with _Open(rec, name, device):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name: str, n) -> None:
    """Add ``n`` (an int, or a tensor summed on its device) to a counter
    while recording."""
    rec = _REC
    if rec is None:
        return
    if isinstance(n, torch.Tensor):
        rec._tensors.setdefault(name, []).append(n.sum())
    else:
        rec._ints[name] = rec._ints.get(name, 0) + int(n)


@contextlib.contextmanager
def recording():
    """Record spans and counts until the outermost such block exits;
    yields the Recorder."""
    global _REC
    outer = _REC is None
    if outer:
        _REC = Recorder()
    rec = _REC
    try:
        yield rec
    finally:
        if outer:
            _REC = None
