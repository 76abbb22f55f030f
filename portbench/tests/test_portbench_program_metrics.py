"""The readers of the program's spans and counters (``metrics/_program.py``):
each new metric on a made-up record, the record of a program without the
spans, the metrics' entries in ``BENCHMARK.json``, and, on the card, a
traced serve window with the spans and their device marks on. The card
test: ``python -m pytest --noconftest -p no:cacheprovider -m cuda
portbench/tests -q``."""

import json
import math
from collections import Counter
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from lm2a_tpu_torch.utils import profiling
from portbench import harness, spec
from portbench.spans import Spans
from portbench.weights import Seeds

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
PROGRAM = {  # metric -> (cells, end-to-end metric it moves)
    **{f"serve.{m}": (["ultimate-serve-ddim50"], "request_p95_ms")
       for m in ("prepare_ms", "finish_ms", "syncs", "replay_gap_us", "vocode_wait_ms")},
    **{f"gen.{m}": (["ultimate-gen-ddim50-b8"], "gen_mel_frames_per_s")
       for m in ("prepare_ms", "finish_ms", "syncs", "replay_gap_us")},
    **{f"train.{m}": (["ultimate-train-b16", "v1-train-b16"], "train_clips_per_s")
       for m in ("stage_ms", "call_gap_us")},
}


class _Recs:
    """A made-up record: ``add`` appends a finished span (times in us)."""

    def __init__(self):
        self.recs, self.ids = [], 0

    def add(self, name, start, end, parent=None, counts=None, gap=None):
        self.ids += 1
        unit = parent.unit if parent is not None else self.ids
        r = profiling.Record(name, self.ids, parent.id if parent is not None else None, unit,
                             start_ns=int(start * 1e3), end_ns=int(end * 1e3),
                             counts=Counter(counts or {}) if parent is None else None,
                             gap_ns=None if gap is None else gap * 1e3)
        self.recs.append(r)
        return r


def served(recs, t0, prepare_us, gaps, launch_us, finish_us, wait_us, syncs=(5, 2)):
    """One served request from ``t0``: the sampler's unit, then the
    vocoder's. Records are appended as the program appends them, the parent
    after its children; ids are handed out as spans open."""
    req = recs.add("sample.request", t0, t0 + 10_000, counts={"host.sync": syncs[0]})
    recs.recs.pop()
    t = t0 + prepare_us
    for gap in gaps:
        recs.add("graph.replay", t, t + launch_us, parent=req, gap=gap)
        t += launch_us
    recs.add("sample.finish", t0 + 9_000, t0 + 9_000 + finish_us, parent=req)
    recs.recs.append(req)
    voc = recs.add("vocode.request", t0 + 10_000, t0 + 12_000, counts={"host.sync": syncs[1]})
    recs.recs.pop()
    recs.add("vocode.readback", t0 + 11_000, t0 + 11_000 + wait_us, parent=voc)
    recs.recs.append(voc)


def ctx(trace_units):
    return SimpleNamespace(cell=SimpleNamespace(traffic={"trace_units": trace_units}))


def read(name, c):
    return harness.metric_reader(name)(c)


def test_serve_and_gen_readers_on_a_made_up_record(monkeypatch):
    recs = _Recs()
    # a first traced attempt, its trace retried: the readers take the last 2 units
    served(recs, 0, 9_000, [None, 900, 900], 900, 900, 900, syncs=(50, 50))
    served(recs, 100_000, 2_000, [12, 3, 5], 40, 300, 100)
    served(recs, 200_000, 4_000, [7, 9, 11], 60, 500, 300)
    monkeypatch.setattr(profiling, "records", lambda: recs.recs)
    c = ctx(2)
    for kind in ("serve", "gen"):
        assert read(f"{kind}.prepare_ms", c) == pytest.approx(3.0)
        assert read(f"{kind}.finish_ms", c) == pytest.approx(0.4)
        assert read(f"{kind}.syncs", c) == pytest.approx(7.0)
        # within a request only: 3, 5, 9, 11 (12 and 7 follow another request)
        assert read(f"{kind}.replay_gap_us", c) == pytest.approx(7.0)
    assert read("serve.vocode_wait_ms", c) == pytest.approx(0.2)
    assert read("train.stage_ms", c) is None  # no train.call unit in the record


def test_prepare_reads_none_where_no_unit_replayed(monkeypatch):
    """A chain run eagerly (the CPU, ``--debug``) has no replay to end the
    host's preparation."""
    recs = _Recs()
    served(recs, 0, 2_000, [], 40, 300, 100)
    monkeypatch.setattr(profiling, "records", lambda: recs.recs)
    assert read("serve.prepare_ms", ctx(1)) is None
    assert read("serve.finish_ms", ctx(1)) == pytest.approx(0.3)


def test_train_readers_on_a_made_up_record(monkeypatch):
    recs = _Recs()
    for i, (stage_us, gaps) in enumerate(((100, [None, 2]), (300, [1_500, 4]), (500, [6, 8]))):
        t0 = i * 100_000
        call = recs.add("train.call", t0, t0 + 1_000)
        recs.recs.pop()
        recs.add("train.stage", t0, t0 + stage_us, parent=call)
        for j, gap in enumerate(gaps):
            recs.add("graph.replay", t0 + stage_us + 200 * j, t0 + stage_us + 200 * j + 150,
                     parent=call, gap=gap)
        recs.recs.append(call)
    monkeypatch.setattr(profiling, "records", lambda: recs.recs)
    c = ctx(3)
    assert read("train.stage_ms", c) == pytest.approx(0.3)
    assert read("train.call_gap_us", c) == pytest.approx((1_500 + 6) / 2)
    assert read("serve.prepare_ms", c) is None  # no sample.request unit


def test_a_program_without_the_spans_reads_none(monkeypatch):
    monkeypatch.delattr(profiling, "records")
    for name in PROGRAM:
        assert read(name, ctx(4)) is None
    monkeypatch.setattr(profiling, "records", lambda: [], raising=False)
    for name in PROGRAM:
        assert read(name, ctx(4)) is None


@pytest.mark.parametrize("name", sorted(PROGRAM))
def test_each_program_metric_is_entered_and_read(name):
    """Each entry resolves to its reader and names cells that report the
    end-to-end metric it moves."""
    (entry,) = [m for m in BENCH["per_layer"] if m["name"] == name]
    cells, moves = PROGRAM[name]
    assert entry["workloads"] == cells and entry["moves"] == moves and entry["better"] == "lower"
    assert entry["source"] == ("device_trace" if name.endswith("gap_us") else
                               "program_counter" if name.endswith("syncs") else "program_span")
    assert harness.metric_reader(name).__name__ == "read"
    (e2e,) = [m for m in BENCH["end_to_end"] if m["name"] == moves]
    assert set(cells) <= set(e2e["workloads"]) <= {w["name"] for w in BENCH["workloads"]}
    for cell in cells:
        assert name in {m["name"] for m in spec.load_cell(cell).per_layer}


def test_no_span_name_holds_a_kernel_pattern():
    names = ("sample.request", "sample.finish", "graph.replay",
             "vocode.request", "vocode.readback", "train.call", "train.stage")
    for mod in harness.kernel_files().values():
        assert not [n for n in names for p in mod.PATTERNS if p in profiling.PREFIX + n]


@pytest.mark.cuda
def test_traced_serve_window_with_the_spans_on():
    """Two traced requests of the serve cell on the card: the launch check
    holds with the replays' marks on, no ``lm2a/`` range is taken for a
    device operation, and the program's metrics read."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cell = spec.load_cell("ultimate-serve-ddim50")
    cell.traffic["trace_units"] = 2
    dev = torch.device("cuda", 0)
    spans = Spans()
    driver = harness.driver_module(cell).Driver(cell, Seeds(2 ** 33 + 9), dev, spans)
    driver.setup()
    profiling.clear()
    tr, kernels, units = harness._traced(cell, driver, spans, 2, 0, harness.kernel_files())
    assert units >= 2 and kernels["conv3_fused"]["launches"] == 2 * 1500
    assert not [n for n in tr.device_s if profiling.PREFIX in n]
    c = harness.Context(cell, spans, tr, kernels, None)
    gap = read("serve.replay_gap_us", c)
    assert gap is not None and math.isfinite(gap) and gap >= 0
    assert read("serve.syncs", c) == 7.0
    assert read("serve.prepare_ms", c) > 0
    driver.release()
