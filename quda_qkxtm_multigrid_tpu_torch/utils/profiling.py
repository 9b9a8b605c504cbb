"""Timing profiles, the program's spans and counters, and the
analytic-flops ledger: the counterpart of the JAX package's
``utils/profiling.py`` (the reference's TimeProfile and the
per-operator analytic flop counts).

``TimeProfile`` sums host seconds, calls and flops per category; its
``__call__`` reads the host clock only, so a caller timing device work
synchronises the device inside the timed region.

Its ``span(name)`` and ``count(name, n)`` are the program's tracing.
They record while, and only while, a ``torch.profiler`` session is
recording (the profiler's own flag, ``torch._C._autograd.
_profiler_enabled``); otherwise a span reads that flag and returns,
building no ``record_function``, reading no clock and recording no
CUDA event.  While recording, a span

  - enters ``torch.profiler.record_function(name)``, so that it sits on
    the profiler's timeline with the device's kernels;
  - adds to its name's calls, roots (opened inside no other span of the
    program), host inclusive seconds and host self seconds (inclusive
    minus what its child spans cover);
  - where CUDA is initialised, records a timing event on the current
    stream at each end: the card's clock between the two, idle time
    included, and that minus its child spans' (device inclusive and
    self seconds), resolved only when the table is read.

A span opened while the current stream captures a CUDA graph records
nothing, nor does a count there; the replay of a captured graph is a
span of its own.  ``PROFILE`` is the process's recorder, which the
port's modules use through the functions below (``span``, ``spanned``,
``op_entry``, ``host_value``); ``table()`` reads it and ``reset()``
clears it.  One thread opens the spans.

The JAX package's ``enable_compile_cache`` (an XLA cache) has no
counterpart: PyTorch runs eagerly.
"""

from __future__ import annotations

import contextlib
import functools
import time
from collections import defaultdict

import torch
from torch.autograd import profiler as _autograd_profiler

_recording = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()


def _capturing() -> bool:
    """Whether the current CUDA stream is capturing a graph."""
    return (torch.cuda.is_initialized()
            and torch.cuda.is_current_stream_capturing())


class _Frame:
    """An open span: its name, host start, the host seconds and the
    device event pairs of its direct children, its own event pair."""

    __slots__ = ("name", "t0", "child_s", "child_events", "events", "rf")

    def __init__(self, name: str):
        self.name, self.child_s, self.child_events = name, 0.0, []
        self.events = None
        self.rf = _autograd_profiler.record_function(name)
        self.rf.__enter__()
        if torch.cuda.is_initialized():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.t0 = time.perf_counter()


class TimeProfile:
    """Accumulate wall time and optional flops per category; the spans
    and counters of the module docstring."""

    def __init__(self, name: str = ""):
        self.name = name
        self.seconds = defaultdict(float)
        self.calls = defaultdict(int)
        self.flops = defaultdict(float)
        self.roots = defaultdict(int)
        self.self_seconds = defaultdict(float)
        self.counts = defaultdict(int)
        self._device = {}       # name → [device s, device self s]
        self._pending = []      # (name, events, child event pairs)
        self._open = []         # the open spans, innermost last
        self._ops = 0           # open operator entries (``op_entry``)

    @contextlib.contextmanager
    def __call__(self, category: str, flops: float = 0.0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[category] += time.perf_counter() - t0
            self.calls[category] += 1
            self.flops[category] += flops

    def add_flops(self, category: str, n: float):
        self.flops[category] += n

    def span(self, name: str):
        """A context manager that records ``name`` while the profiler
        records (module docstring), and does nothing otherwise."""
        if not _recording() or _capturing():
            return _OFF
        return self._span(name)

    @contextlib.contextmanager
    def _span(self, name: str):
        frame = _Frame(name)
        self._open.append(frame)
        try:
            yield
        finally:
            self._close(frame)

    def _close(self, frame: _Frame):
        secs = time.perf_counter() - frame.t0
        if frame.events is not None:
            frame.events[1].record()
        frame.rf.__exit__(None, None, None)
        self._open.pop()
        name = frame.name
        self.seconds[name] += secs
        self.calls[name] += 1
        self.self_seconds[name] += secs - frame.child_s
        if self._open:
            parent = self._open[-1]
            parent.child_s += secs
            if frame.events is not None:
                parent.child_events.append(frame.events)
        else:
            self.roots[name] += 1
        if frame.events is not None:
            self._pending.append((name, frame.events, frame.child_events))

    def count(self, name: str, n: int = 1):
        """Add ``n`` to the counter ``name`` while the profiler records."""
        if _recording() and not _capturing():
            self.counts[name] += n

    def _resolve(self):
        """The device seconds of the spans closed since the last read."""
        if not self._pending:
            return
        torch.cuda.synchronize()
        for name, (e0, e1), children in self._pending:
            incl = e0.elapsed_time(e1) * 1e-3
            inner = sum(c0.elapsed_time(c1) for c0, c1 in children) * 1e-3
            acc = self._device.setdefault(name, [0.0, 0.0])
            acc[0] += incl
            acc[1] += incl - inner
        self._pending = []

    def table(self) -> dict:
        """``{"spans": {name: {calls, roots, host_s, host_self_s,
        device_s, device_self_s}}, "counters": {name: n}}``; the device
        seconds are None for a span that recorded no event (no CUDA)."""
        self._resolve()
        spans = {}
        for name in sorted(self.calls):
            dev = self._device.get(name, (None, None))
            spans[name] = {"calls": self.calls[name],
                           "roots": self.roots[name],
                           "host_s": self.seconds[name],
                           "host_self_s": self.self_seconds[name],
                           "device_s": dev[0], "device_self_s": dev[1]}
        return {"spans": spans, "counters": dict(self.counts)}

    def reset(self):
        """Forget every span, counter and category."""
        self.__init__(self.name)

    def summary(self) -> str:
        """One line for the total, then one a category, slowest first,
        with GFLOP/s where flops were counted."""
        total = sum(self.seconds.values())
        lines = [f"TimeProfile {self.name}: total {total:.3f} s"]
        for cat in sorted(self.seconds, key=self.seconds.get, reverse=True):
            s = self.seconds[cat]
            extra = ""
            if self.flops[cat]:
                extra = f"  {self.flops[cat] / max(s, 1e-12) / 1e9:.1f} GF/s"
            lines.append(f"  {cat:24s} {s:9.3f} s  x{self.calls[cat]:5d}"
                         f"{extra}")
        return "\n".join(lines)


PROFILE = TimeProfile("port")


def span(name: str):
    """``PROFILE.span(name)``."""
    return PROFILE.span(name)


def table() -> dict:
    """``PROFILE.table()``."""
    return PROFILE.table()


def reset():
    """``PROFILE.reset()``."""
    PROFILE.reset()


def spanned(name: str):
    """Decorator: each call of the function is the span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _recording() or _capturing():
                return fn(*args, **kwargs)
            with PROFILE._span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def op_entry(name: str, applies: int = 1):
    """Decorator of an operator's public entry (a method): each call is
    the span ``name`` and adds ``applies`` to the counter
    ``op.applies``.  An entry called inside another (``mdagm`` through
    ``m``, a subclass through ``super()``) records nothing of its own:
    the outer entry covers it."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(self, *args, **kwargs):
            if not _recording() or PROFILE._ops or _capturing():
                return fn(self, *args, **kwargs)
            PROFILE.counts["op.applies"] += applies
            PROFILE._ops += 1
            try:
                with PROFILE._span(name):
                    return fn(self, *args, **kwargs)
            finally:
                PROFILE._ops -= 1
        return inner
    return wrap


def host_value(t: torch.Tensor):
    """``t.item()``, a read of a device value on the host, counted as
    ``host_reads`` while the profiler records."""
    if _recording():
        PROFILE.counts["host_reads"] += 1
    return t.item()


# analytic per-site flop counts (the reference's flops ledgers)
FLOPS_PER_SITE = {
    "wilson_dslash": 1320,
    "clover_apply": 504,
    "twist_apply": 48,
    "staggered_dslash": 570,
}
