"""Readers of the program's own spans and counters
(``lm2a_tpu_torch.utils.profiling``), which the program records while the
profiler traces the cell's units. A unit is a top-level span of the
program (``sample.request``, ``train.call``); a reader reads the last
``trace_units`` of them, the traced units the harness kept, and every
record from the first one's start on. Each returns None where the program
recorded nothing for the cell, as a program without these spans."""

from __future__ import annotations


def _window(ctx, unit: str):
    """(units, records) of the traced units named ``unit``, or None."""
    try:
        from lm2a_tpu_torch.utils.profiling import records
    except ImportError:
        return None
    recs = records()
    units = [r for r in recs if r.name == unit and r.parent is None]
    units = units[-int(ctx.cell.traffic["trace_units"]):]
    if not units:
        return None
    return units, [r for r in recs if r.start_ns >= units[0].start_ns]


def _replays(recs, units):
    ids = {u.id for u in units}
    return [r for r in recs if r.name == "graph.replay" and r.unit in ids]


def _mean(values, scale: float):
    return sum(values) / len(values) * scale if values else None


def span_ms(unit: str, name: str):
    """The host milliseconds a unit in the spans ``name``, summed."""
    def read(ctx):
        w = _window(ctx, unit)
        if w is None:
            return None
        units, recs = w
        ns = [r.end_ns - r.start_ns for r in recs if r.name == name]
        return sum(ns) / len(units) / 1e6 if ns else None
    return read


def count_per_unit(unit: str, counter: str):
    """``counter`` a unit, over every top-level span of the window (a served
    request's sampler and vocoder)."""
    def read(ctx):
        w = _window(ctx, unit)
        if w is None:
            return None
        units, recs = w
        return sum(r.counts.get(counter, 0) for r in recs if r.counts is not None) / len(units)
    return read


def prepare_ms(unit: str):
    """The host milliseconds from a unit's start to its first graph replay's
    start, on average over the units that replayed: what the unit did on
    the host before its chain's first step."""
    def read(ctx):
        w = _window(ctx, unit)
        if w is None:
            return None
        first = {}
        for r in _replays(w[1], w[0]):
            first[r.unit] = min(first.get(r.unit, r.start_ns), r.start_ns)
        return _mean([first[u.id] - u.start_ns for u in w[0] if u.id in first], 1e-6)
    return read


def replay_gap_us(unit: str, across: bool = False):
    """The device microseconds from one replay's end to the next one's start,
    on average: within a unit (each unit's first replay left out), or, with
    ``across``, from a unit's last replay to the next unit's first."""
    def read(ctx):
        w = _window(ctx, unit)
        if w is None:
            return None
        reps = _replays(w[1], w[0])
        return _mean([r.gap_ns for p, r in zip(reps, reps[1:])
                      if (p.unit != r.unit) == across and r.gap_ns is not None], 1e-3)
    return read
