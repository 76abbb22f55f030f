"""The traced part of a window: ``torch.profiler`` over the CPU and the card,
reduced to what the per-layer metrics read.

- busy: the union of the intervals in which any operation (kernel, copy,
  set) ran on the device, so overlapping kernels count once; idle is the
  rest of the traced window: the span ``portbench/traced_window`` that the
  harness opens around the traced units, widened to every operation.
- kernels: device seconds and launches of the operations whose names hold a
  kernel file's pattern (``kernels/<name>.py``).
- device_ops: device seconds by operation name; idle_gaps: the idle
  seconds summed by the benchmark span (``portbench/<name>``, the spans of
  one unit lie side by side) open on the host over each part of a gap.
"""

from __future__ import annotations

from collections import Counter, defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

WINDOW_SPAN = "portbench/traced_window"
SPAN_PREFIX = "portbench/"


@dataclass
class Trace:
    window_s: float
    busy_s: float
    device_s: Dict[str, float]                  # operation name -> device seconds
    kernel_s: Dict[str, float] = field(default_factory=dict)     # kernel file -> seconds
    kernel_n: Dict[str, int] = field(default_factory=dict)       # kernel file -> launches
    idle_by_span: Dict[str, float] = field(default_factory=dict)

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.device_s.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_by_span.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:160], s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps]}


def _start_end(e) -> Tuple[int, int]:
    if hasattr(e, "start_ns"):
        start = e.start_ns()
        return start, start + e.duration_ns()
    start = int(e.start_us() * 1000)  # older torch: microseconds
    return start, start + int(e.duration_us() * 1000)


def _device_events(events):
    from torch.autograd import DeviceType

    for e in events:
        if e.device_type() != DeviceType.CUDA:
            continue
        annotation = getattr(e, "is_user_annotation", None)
        if (annotation is not None and annotation()) or e.name().startswith(SPAN_PREFIX):
            continue  # the GPU mirror of a host span, not an operation
        yield e


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def reduce(prof, patterns: Dict[str, Tuple[str, ...]]) -> Trace:
    """The trace of ``prof`` (a finished ``torch.profiler.profile``);
    ``patterns`` maps each kernel file to the substrings of its names."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    spans = [(e.name(), *_start_end(e)) for e in events
             if e.device_type() == DeviceType.CPU and e.name().startswith(SPAN_PREFIX)]
    window = [(s, t) for n, s, t in spans if n == WINDOW_SPAN]
    if not window:
        raise RuntimeError("the trace holds no traced-window span")
    w0, w1 = window[0]
    device_s: Dict[str, float] = defaultdict(float)
    kernel_s: Dict[str, float] = defaultdict(float)
    kernel_n: Counter = Counter()
    intervals = []
    # every device operation of the profile is the traced units' (the card
    # was idle when it started); none is cut at the host span's ends, where
    # the card's clock, mapped onto the host's, can fall a little outside it
    for e in _device_events(events):
        s, t = _start_end(e)
        intervals.append((s, t))
        name = e.name()
        device_s[name] += (t - s) / 1e9
        for kernel, pats in patterns.items():
            if any(p in name for p in pats):
                kernel_s[kernel] += (t - s) / 1e9
                kernel_n[kernel] += 1
                break
    if intervals:
        w0, w1 = min(w0, min(s for s, _ in intervals)), max(w1, max(t for _, t in intervals))
    busy = _union(intervals)
    idle: Dict[str, float] = defaultdict(float)
    inner = [(a, b, n[len(SPAN_PREFIX):]) for n, a, b in spans if n != WINDOW_SPAN]
    prev = w0
    for s, t in busy + [(w1, w1)]:
        if s > prev:  # an idle gap [prev, s): each span takes the part it covers
            covered = 0
            for a, b, n in inner:
                part = min(b, s) - max(a, prev)
                if part > 0:
                    idle[n] += part / 1e9
                    covered += part
            if s - prev > covered:
                idle["outside any span"] += (s - prev - covered) / 1e9
        prev = max(prev, t)
    return Trace(window_s=(w1 - w0) / 1e9, busy_s=sum(t - s for s, t in busy) / 1e9,
                 device_s=dict(device_s), kernel_s=dict(kernel_s), kernel_n=dict(kernel_n),
                 idle_by_span=dict(idle))
