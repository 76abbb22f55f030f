"""The port's spans and counters (``lm2a_tpu_torch/utils/profiling.py``) on
the CPU: off by default at the cost of one check, on under ``torch.profiler``
and inside ``recording()``, nested per thread into units, bounded, on the
profiler's clock; and the spans of the sampler, the vocoder and the
training step as tiny models record them."""

import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lm2a_tpu_torch.core.config import DiffusionConfig, LM2AConfig, ModelConfig, TrainConfig
from lm2a_tpu_torch.diffusion.schedule import make_schedule
from lm2a_tpu_torch.inference.sample import LoadedModels, generate_mel, generate_mel_batch
from lm2a_tpu_torch.models.factory import build_cond_projection, build_denoiser, random_init_
from lm2a_tpu_torch.training.train_step import (
    init_train_state, make_device_data_multistep, make_optimizer)
from lm2a_tpu_torch.utils import profiling
from lm2a_tpu_torch.vocoder.bigvgan import VocoderConfig
from lm2a_tpu_torch.vocoder.vocode import Vocoder

TINY = LM2AConfig(
    model=ModelConfig(base_dim=16, dim_mults=(1, 2), cond_dim=8, time_emb_dim=16,
                      num_res_blocks=1, mid_blocks=1, attn_heads=2),
    diffusion=DiffusionConfig(timesteps=8),
    train=TrainConfig(batch_size=2))
MEL_T = 16


@pytest.fixture(autouse=True)
def empty_record():
    profiling.clear()
    yield
    profiling.clear()


@pytest.fixture(scope="module")
def models():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    den = random_init_(build_denoiser(TINY.model), 3).eval().requires_grad_(False)
    proj = random_init_(build_cond_projection(TINY.model), 4).eval().requires_grad_(False)
    yield LoadedModels(cfg=TINY, denoiser=den.prepare(torch.float32), cond_proj=proj,
                       dataset_mean=-4.0, dataset_std=1.9, timesteps=8,
                       device=torch.device("cpu"))
    torch.set_num_threads(n)


def clip(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((12, 234), dtype=np.float32),
            rng.standard_normal((12, 768), dtype=np.float32))


def by_name(recs):
    out = {}
    for r in recs:
        out.setdefault(r.name, []).append(r)
    return out


def test_off_returns_the_shared_noop_and_records_nothing(monkeypatch):
    def refused(*a, **k):
        raise AssertionError("record_function entered while spans are off")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    s = profiling.span("a")
    assert s is profiling.span("b", device="cpu")
    with s, profiling.span("c"):
        profiling.count("test.off", 2)
    assert profiling.records() == []


def test_recording_nests_spans_into_units():
    with profiling.recording():
        with profiling.span("top"):
            with profiling.span("mid"):
                with profiling.span("leaf"):
                    pass
            with profiling.span("side"):
                pass
        with profiling.span("next"):
            pass
    with profiling.span("after"):  # the block closed: off again
        pass
    r = by_name(profiling.records())
    assert list(r) == ["leaf", "mid", "side", "top", "next"]  # in the order they ended
    top, mid, leaf, side, nxt = (r[n][0] for n in ("top", "mid", "leaf", "side", "next"))
    assert top.parent is None and top.unit == top.id
    assert mid.parent == top.id and leaf.parent == mid.id and side.parent == top.id
    assert {mid.unit, leaf.unit, side.unit} == {top.id}
    assert nxt.parent is None and nxt.unit == nxt.id != top.id
    assert top.start_ns <= mid.start_ns <= leaf.start_ns <= leaf.end_ns <= mid.end_ns
    assert mid.end_ns <= side.start_ns <= side.end_ns <= top.end_ns <= nxt.start_ns
    assert top.counts == {} and mid.counts is None


def test_count_goes_to_the_current_unit():
    with profiling.recording():
        profiling.count("test.unit")  # outside any span: counted nowhere
        with profiling.span("u1"):
            profiling.count("test.unit")
            with profiling.span("inner"):
                profiling.count("test.unit", 2)
        with profiling.span("u2"):
            profiling.count("test.other", 5)
    r = by_name(profiling.records())
    assert r["u1"][0].counts == {"test.unit": 3} and r["u2"][0].counts == {"test.other": 5}
    assert r["inner"][0].counts is None


def test_the_record_keeps_the_newest_entries():
    n = profiling.RECORD_MAX + 7
    with profiling.recording():
        for i in range(n):
            with profiling.span(f"s{i}"):
                pass
    recs = profiling.records()
    assert len(recs) == profiling.RECORD_MAX
    assert recs[0].name == "s7" and recs[-1].name == f"s{n - 1}"


def test_spans_under_the_profiler_share_its_clock():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("outer"):
            time.sleep(0.004)
            with profiling.span("inner"):
                time.sleep(0.002)
    with profiling.span("after"):
        pass
    recs = by_name(profiling.records())
    assert set(recs) == {"outer", "inner"}
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name().startswith(profiling.PREFIX)}
    assert set(events) == {"lm2a/outer", "lm2a/inner"}
    for name, (r,) in recs.items():
        e = events[profiling.PREFIX + name]
        assert abs(r.start_ns - e.start_ns()) < 1_000_000
        assert abs(r.end_ns - (e.start_ns() + e.duration_ns())) < 1_000_000
    assert recs["outer"][0].end_ns - recs["outer"][0].start_ns >= 6_000_000


class _Mark:
    """A stand-in CUDA event: ``elapsed_time`` in ms on a made-up clock."""

    def __init__(self, at_ms):
        self.at_ms = at_ms

    def elapsed_time(self, other):
        return other.at_ms - self.at_ms


def test_marks_resolve_to_device_times_and_gaps(monkeypatch):
    syncs = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: syncs.append(a))
    for i, (s, e) in enumerate(((1.0, 3.0), (3.5, 6.0), (6.0, 7.0))):
        profiling._record.append(profiling.Record("graph.replay", i + 1, None, i + 1,
                                                  marks=(_Mark(s), _Mark(e))))
        if i == 0:
            profiling._record.append(profiling.Record("unmarked", 9, None, 9))
    recs = [r for r in profiling.records() if r.marks is not None]
    assert len(syncs) == 1
    assert [r.device_ns for r in recs] == pytest.approx([2e6, 2.5e6, 1e6])
    assert recs[0].gap_ns is None and [r.gap_ns for r in recs[1:]] == pytest.approx([5e5, 0])
    profiling.records()  # resolved once: no second synchronise
    assert len(syncs) == 1


def test_spans_change_no_result(models):
    motion, lyrics = clip(1)
    kw = dict(steps=8, guidance_weight=2.0, method="ddim", ddim_steps=2, seed=11)
    plain = generate_mel(models, motion, lyrics, MEL_T, **kw)[0]
    with profiling.recording():
        traced = generate_mel(models, motion, lyrics, MEL_T, **kw)[0]
    np.testing.assert_array_equal(plain, traced)


def test_sampler_and_vocoder_spans_and_syncs(models):
    """A served request (``generate_mel``, then ``mel_to_wav``): 5 syncs in
    the sampler (two uploads, the mel's and two conditions' readbacks) and
    2 in the vocoder; a batched request (``generate_mel_batch``): 3."""
    vocoder = Vocoder(cfg=VocoderConfig(upsample_initial_channel=32, upsample_rates=(2, 2),
                                        upsample_kernel_sizes=(4, 4), resblock_kernel_sizes=(3,),
                                        resblock_dilation_sizes=((1, 3),)),
                      compute_dtype="float32", device="cpu")
    kw = dict(steps=8, guidance_weight=2.0, method="ddim", ddim_steps=2, seed=5)
    (m1, l1), (m2, l2) = clip(2), clip(3)
    with profiling.recording():
        mel = generate_mel(models, m1, l1, MEL_T, **kw)[0]
        vocoder.mel_to_wav(mel[0])
        generate_mel_batch(models, [m1, m2], [l1, l2], MEL_T, **kw)
    r = by_name(profiling.records())
    serve, batch = r["sample.request"]
    (voc,) = r["vocode.request"]
    assert serve.counts == {"host.sync": 5} and voc.counts == {"host.sync": 2}
    assert batch.counts == {"host.sync": 3}
    assert [f.unit for f in r["sample.finish"]] == [serve.id, serve.id, batch.id]
    assert all(f.parent == f.unit for f in r["sample.finish"])
    for req in (serve, batch):
        fin = [f for f in r["sample.finish"] if f.unit == req.id]
        assert req.start_ns <= fin[0].start_ns and fin[-1].end_ns <= req.end_ns
        assert all(a.end_ns <= b.start_ns for a, b in zip(fin, fin[1:]))
    (rb,) = r["vocode.readback"]
    assert rb.parent == voc.id and serve.end_ns <= voc.start_ns <= rb.start_ns
    assert "graph.replay" not in r  # the CPU runs each step's function: no replay


def test_step_runner_spans():
    cfg = TINY
    optimizer = make_optimizer(cfg)
    state = init_train_state(cfg, 7, "cpu", optimizer)
    multi = make_device_data_multistep(make_schedule(cfg.diffusion, device="cpu"), cfg,
                                       optimizer, -4.0, 1.9)
    gen = torch.Generator().manual_seed(0)
    pack = {k: torch.randn((4, MEL_T, w), generator=gen)
            for k, w in (("mel", 80), ("motion", 234), ("lyrics", 768))}
    rows = np.array([[0, 1], [2, 3]])
    with profiling.recording():
        for call in range(2):
            losses = multi(state, pack, rows, 7, [2 * call, 2 * call + 1])
    assert losses.shape == (2,) and torch.isfinite(losses).all()
    r = by_name(profiling.records())
    calls, stages = r["train.call"], r["train.stage"]
    assert len(calls) == len(stages) == 2
    for c, s in zip(calls, stages):
        assert c.parent is None and s.parent == c.id == s.unit
        assert c.start_ns <= s.start_ns <= s.end_ns <= c.end_ns
    assert calls[0].end_ns <= calls[1].start_ns and set(r) == {"train.call", "train.stage"}
