"""Step timing (port of ``StepTimer`` in ``lm2a_tpu/utils/profiling.py``), and
the port's spans and counters.

Spans mark the layer boundaries of the sampler, the compiled graphs, the
vocoder and the training step (``span(name)``, a context manager). A span
is off unless a ``torch.profiler`` session is active or a ``recording()``
block is open. Off, ``span`` returns one shared no-op object after one
check: no ``record_function``, no clock read, no allocation. On, a span
opens the ``record_function`` range ``lm2a/<name>``, so the profiler's
trace holds it on the device operations' clock, and appends a ``Record``
to a bounded in-memory record (the newest ``RECORD_MAX``): its host
interval in Unix ns (``time.time_ns``, the clock of the profiler's
``start_ns``), its id, its parent's, and its unit's, the id of the
top-level span it runs under (spans nest per thread).

A span given a CUDA ``device`` also records a timing event on that
device's current stream just before and just after its body (the marks);
``records()`` resolves them, after one synchronise, to the body's device
nanoseconds and the device nanoseconds since the previous marked record's
end mark.

``count(name, n)``, while spans are on, adds ``n`` to the current unit's
``Record.counts``; off, or outside any span, it does nothing.

The spans and counters (their readers: ``portbench/metrics/_program.py``):
``sample.request`` (a unit), ``sample.finish`` (``inference/sample.py``);
``graph.replay``, marked (``core/graphs.py``);
``vocode.request`` (a unit), ``vocode.readback`` (``vocoder/vocode.py``);
``train.call`` (a unit), ``train.stage`` (``training/train_step.py``); the
counter ``host.sync``: each call site that blocks the host on the card (a
readback, a pageable upload) in the sampler and the vocoder.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import Counter, deque
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Deque, Iterator, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler


class StepTimer:
    """Wall-clock step timing with exponential smoothing."""

    def __init__(self, report_every: int = 100, smoothing: float = 0.98):
        self.report_every = report_every
        self.smoothing = smoothing
        self._last: Optional[float] = None
        self._ema: Optional[float] = None
        self.steps = 0

    def tick(self) -> Optional[float]:
        """Call once per step; returns the EMA step time on report steps."""
        now = time.perf_counter()
        if self._last is not None:
            dt = now - self._last
            self._ema = dt if self._ema is None else (
                self.smoothing * self._ema + (1 - self.smoothing) * dt)
        self._last = now
        self.steps += 1
        if self.report_every and self.steps % self.report_every == 0:
            return self._ema
        return None

    @property
    def ema_seconds(self) -> Optional[float]:
        return self._ema


PREFIX = "lm2a/"
RECORD_MAX = 65536

_record: Deque["Record"] = deque(maxlen=RECORD_MAX)
_forced = 0  # open recording() blocks
_ids = itertools.count(1)
_local = threading.local()


@dataclass(eq=False)
class Record:
    """One finished span. Times are ns: host times on the Unix clock,
    device times from the marks (None where the span had none)."""

    name: str
    id: int
    parent: Optional[int]
    unit: int
    start_ns: int = 0
    end_ns: int = 0
    counts: Optional[Counter] = None  # a unit's counts (top-level spans only)
    marks: Optional[tuple] = None     # (start, end) CUDA events around the body
    device_ns: Optional[float] = None  # start mark to end mark
    gap_ns: Optional[float] = None     # the previous marked record's end mark to this start mark


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "device", "rec", "range", "stream")

    def __init__(self, name: str, device):
        self.name, self.device = name, device

    def __enter__(self):
        stack = _stack()
        sid = next(_ids)
        self.rec = rec = Record(self.name, sid, stack[-1].id if stack else None,
                                stack[0].id if stack else sid,
                                counts=None if stack else Counter())
        self.range = torch.profiler.record_function(PREFIX + self.name)
        self.range.__enter__()
        stack.append(rec)
        self.stream = None
        if self.device is not None and torch.device(self.device).type == "cuda":
            self.stream = torch.cuda.current_stream(self.device)
            start = torch.cuda.Event(enable_timing=True)
            start.record(self.stream)
            rec.marks = (start, None)
        rec.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        rec = self.rec
        rec.end_ns = time.time_ns()
        if self.stream is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(self.stream)
            rec.marks = (rec.marks[0], end)
        _stack().pop()
        _record.append(rec)
        self.range.__exit__(*exc)
        return False


def span(name: str, device=None):
    """A span named ``name`` around the ``with`` block (see the module
    docstring); ``device``: mark the body on that CUDA device's current
    stream."""
    if not (_forced or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return _Span(name, device)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the current unit's counter ``name`` (see the module
    docstring)."""
    if _forced or _autograd_profiler._is_profiler_enabled:
        stack = getattr(_local, "stack", None)
        if stack:
            stack[0].counts[name] += n


@contextmanager
def recording() -> Iterator[None]:
    """Spans on inside the block, with or without a profiler."""
    global _forced
    _forced += 1
    try:
        yield
    finally:
        _forced -= 1


def records() -> List[Record]:
    """The record, oldest first, every mark pair resolved (once)."""
    out = list(_record)
    if any(r.marks is not None and r.device_ns is None for r in out):
        torch.cuda.synchronize()
        prev = None
        for r in out:
            if r.marks is None:
                continue
            start, end = r.marks
            if r.device_ns is None:
                r.device_ns = start.elapsed_time(end) * 1e6
                if prev is not None:
                    r.gap_ns = prev.elapsed_time(start) * 1e6
            prev = end
    return out


def clear() -> None:
    _record.clear()
