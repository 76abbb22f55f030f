"""The harness on the CPU: what it imports, ``BENCHMARK.json`` and the files
it names, the copied cost arithmetic against ``chip_smoke.py`` and the port,
the trace's reduction, and a whole run of each cell at tiny widths (the
harness's look for a card skipped)."""

import ast
import json
import math
import os
import re
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

import chip_smoke
from lm2a_tpu_torch.core.config import ModelConfig
from lm2a_tpu_torch.models.factory import build_cond_projection, build_denoiser
from lm2a_tpu_torch.ops import resblock_grad as rg
from lm2a_tpu_torch.vocoder.bigvgan import BIGVGAN_22KHZ_80BAND
from portbench import harness, spec, trace
from portbench.kernels import geometry as geo
from portbench.reference import unet as ref
from portbench.tests.tiny import tiny_cell

PB = Path(__file__).resolve().parents[1]
ROOT = PB.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def imports(path: Path):
    """(top-level name, level) of every import in a source file."""
    out = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out += [(a.name.split(".")[0], 0) for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            out.append(((node.module or "").split(".")[0], node.level))
    return out


@pytest.mark.parametrize("path", sorted(PB.rglob("*.py")), ids=lambda p: str(p.relative_to(PB)))
def test_no_jax_or_jax_package(path):
    bad = {n for n, level in imports(path) if level == 0 and n in harness.FORBIDDEN}
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", sorted((PB / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = {n for n, level in imports(path) if level == 0}
    assert not tops & {"lm2a_tpu_torch", "portbench", "chip_smoke"}, tops


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    fake = {"lm2a_tpu_torch": 1, "lm2a_tpu_torch.ops": 1, "jaxtyping": 1, "flaxen": 1}
    monkeypatch.setattr(sys, "modules", fake)
    assert harness.forbidden_modules() == []
    monkeypatch.setattr(sys, "modules", dict(fake, **{"lm2a_tpu.cli": 1, "jax": 1}))
    assert harness.forbidden_modules() == ["jax", "lm2a_tpu.cli"]


def test_benchmark_file_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and 1 <= BENCH["run_seconds"] <= 51
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("portbench/")
        names.add(c["name"])
    used = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and len(w["why"]) <= 200
        assert (PB / "traffic" / f"{w['traffic']}.json").is_file()
        used.add(w["config"])
    assert used == names
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in metrics:
        assert NAME.match(m["name"]) and re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m["workloads"]) <= set(WORKLOADS) if "workloads" in m else True
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and callable(harness.metric_reader(m["name"]))
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("workload", WORKLOADS)
def test_every_cell_loads_and_reports(workload):
    cell = spec.load_cell(workload)
    assert cell.limits and hasattr(harness.driver_module(cell), "Driver")
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer


def test_parameter_counts():
    for arch, count in (("ultimate", chip_smoke.FLAGSHIP_PARAMS), ("v1", chip_smoke.V1_PARAMS)):
        m = json.loads((PB / "configs" / f"lm2a-{arch}.json").read_text())["model"]
        assert sum(math.prod(s) for s, _ in ref.spec(m).values()) == count
        den = build_denoiser(ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                                            for k, v in m.items()}))
        assert set(den.state_dict()) == set(ref.spec(m))
        assert set(build_cond_projection(ModelConfig()).state_dict()) == set(ref.cond_spec(m))


def test_geometry_is_chip_smokes():
    mc = ModelConfig()
    m = json.loads((PB / "configs" / "lm2a-ultimate.json").read_text())["model"]
    v1 = json.loads((PB / "configs" / "lm2a-v1.json").read_text())["model"]
    for t in (516, 129, 12920):
        assert geo.resblock_geometries(m, t) == chip_smoke.resblock_geometries(mc, t)
        assert geo.v1_attention_sites(v1, t) == chip_smoke.v1_attention_sites(
            ModelConfig(arch="v1"), t)
    import dataclasses

    v = dataclasses.asdict(BIGVGAN_22KHZ_80BAND)
    assert geo.sandwich_geometries(v, 516) == chip_smoke.sandwich_geometries(
        BIGVGAN_22KHZ_80BAND, 516)
    for g in chip_smoke.resblock_geometries(mc, 516):
        _, t, cin, cout, skip, add_res = g
        assert geo.train_fits(t, cin, cout, skip) == rg.resblock_train_fits(t, cin, cout, skip)
        for rows in (2, 16):
            a = torch.empty((rows, t, cin), dtype=torch.bfloat16, device="meta")
            f = torch.empty((rows, t, cout), dtype=torch.float32, device="meta")
            assert geo.conv_cost(rows, t, cin, 2, cout, 0, 4, False, False) == \
                chip_smoke.conv_cost(a, cout, 0, torch.float32, False, False)
            assert geo.conv_cost(rows, t, cout, 4, cout, cin if skip else 0, 2,
                                 add_res and not skip, skip and not add_res) == \
                chip_smoke.conv_cost(f, cout, cin if skip else 0, torch.bfloat16,
                                     add_res and not skip, skip and not add_res)
            assert geo.bwd_costs(rows, t, cin, cout, skip) == \
                chip_smoke.bwd_costs(rows, t, cin, cout, skip)
    assert geo.PEAK_BF16 == chip_smoke.PEAK_BF16 and geo.PEAK_FP32 == chip_smoke.PEAK_FP32
    assert geo.PEAK_BYTES == chip_smoke.PEAK_BYTES


def test_launches_a_unit_are_the_ports_counts():
    """The cost models' launches against the counts the port's own notes
    give: a flagship train step 14 gn_stats, 14 conv3_fused, 16 conv3_dgrad,
    16 conv3_wgrad, 14 gn_bwd, 1 adan_ema; a v1 step 14 attention; a
    served forward 31 gn_stats and 30 conv3_fused; a vocode 109 sandwiches."""
    files = harness.kernel_files()

    def per_unit(workload):
        cell = spec.load_cell(workload)
        return {n: len(mod.launches(cell)) for n, mod in files.items() if mod.launches(cell)}

    assert per_unit("ultimate-train-b16") == {
        "gn_stats": 28, "conv3_fused": 28, "conv3_dgrad": 32, "conv3_wgrad": 32, "gn_bwd": 28,
        "adan_ema": 2}
    assert per_unit("v1-train-b16") == {"attention": 28, "adan_ema": 2}
    assert per_unit("ultimate-serve-ddim50") == {"gn_stats": 1550, "conv3_fused": 1500,
                                                 "snake_sandwich": 109}
    assert per_unit("ultimate-gen-ddim50-b8") == {"gn_stats": 1550, "conv3_fused": 1500}


def test_metric_readers_by_name():
    """A metric's reader comes from its file where it has one, else from its
    name's pattern; a name neither covers has no reader."""
    kernels = harness.kernel_files()
    assert harness.metric_reader("serve.sampler_ms").__name__ == "read"
    ctx = SimpleNamespace(kernels={"conv3_fused": {"least_s": 1.0, "device_s": 4.0}},
                          kernel=lambda n: (1.0, 4.0) if n == "conv3_fused" else None,
                          flops_rate=989e12 / 10, trace=SimpleNamespace(busy_s=3.0, window_s=4.0))
    assert harness.metric_reader("conv3_fused_roofline.any")(ctx) == 25.0
    assert harness.metric_reader("gn_stats_roofline.gen")(ctx) is None
    assert harness.metric_reader("kernel_roofline.x")(ctx) == 25.0
    assert harness.metric_reader("mfu.y")(ctx) == pytest.approx(10.0)
    assert harness.metric_reader("device_idle.z")(ctx) == 25.0
    assert set(kernels) >= {"conv3_fused", "gn_stats", "adan_ema"}
    for bad in ("nokernel_roofline.train", "latency_ms"):
        with pytest.raises(KeyError):
            harness.metric_reader(bad)


def test_launch_plan_mismatch_fails_the_run():
    """A cost model that gives another number of launches a unit than the
    counter saw fails the run, as a trace that missed launches does."""
    cell = spec.load_cell("ultimate-serve-ddim50")
    files = {"gn_stats": harness.kernel_files()["gn_stats"]}
    n = len(files["gn_stats"].launches(cell))
    good = SimpleNamespace(kernel_n={"gn_stats": 2 * n}, kernel_s={"gn_stats": 1.0})
    out = harness._kernels_traced(cell, good, {"gn_stats": 2 * n}, 2, files)
    assert out["gn_stats"]["launches"] == 2 * n
    for counted, traced in ((2 * n - 1, 2 * n - 1), (2 * n, 2 * n - 1)):
        tr = SimpleNamespace(kernel_n={"gn_stats": traced}, kernel_s={"gn_stats": 1.0})
        with pytest.raises(RuntimeError, match="gn_stats"):
            harness._kernels_traced(cell, tr, {"gn_stats": counted}, 2, files)


def test_a_trace_that_lost_launches_is_told_apart():
    """A trace that lost launches the counter saw raises the error that the
    traced part retries on; a cost model at odds with the counter does not."""
    cell = spec.load_cell("ultimate-serve-ddim50")
    files = {"gn_stats": harness.kernel_files()["gn_stats"]}
    n = len(files["gn_stats"].launches(cell))
    lost = SimpleNamespace(kernel_n={"gn_stats": 2 * n - 1}, kernel_s={"gn_stats": 1.0})
    with pytest.raises(harness.TraceMissedLaunches):
        harness._kernels_traced(cell, lost, {"gn_stats": 2 * n}, 2, files)
    off = SimpleNamespace(kernel_n={"gn_stats": 2 * n + 1}, kernel_s={"gn_stats": 1.0})
    with pytest.raises(RuntimeError) as e:
        harness._kernels_traced(cell, off, {"gn_stats": 2 * n + 1}, 2, files)
    assert not isinstance(e.value, harness.TraceMissedLaunches)


def test_sampler_and_counts_come_from_the_traffic_file():
    """The sampler's method and steps, the forwards a unit and the rows a
    forward are the traffic file's: a DDPM mix of 1000 steps needs no code."""
    cell = spec.load_cell("ultimate-serve-ddim50")
    files = harness.kernel_files()
    base = {n: len(m.launches(cell)) for n, m in files.items()}
    cell.traffic.update(method="ddpm", steps=1000)
    ddpm = {n: len(m.launches(cell)) for n, m in files.items()}
    assert ddpm["gn_stats"] == 31 * 1000 and ddpm["conv3_fused"] == 30 * 1000
    assert ddpm["snake_sandwich"] == base["snake_sandwich"] == 109
    cell.traffic.update(guidance=1.0)
    assert geo.forward_rows(cell) == 1


class _Event:
    def __init__(self, name, device, start, dur):
        self._n, self._d, self._s, self._t = name, device, start, dur

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._t

    def is_user_annotation(self):
        return self._n.startswith("portbench/") and self._d.name == "CUDA"


def test_trace_takes_the_union_and_names_idle_by_span():
    from torch.autograd import DeviceType

    cpu, gpu = DeviceType.CPU, DeviceType.CUDA
    events = [
        _Event("portbench/traced_window", cpu, 0, 1000),
        _Event("portbench/sampler", cpu, 0, 600),
        _Event("portbench/vocode", cpu, 600, 400),
        _Event("portbench/sampler", gpu, 0, 600),           # a span's GPU mirror
        _Event("void conv3_fused_kernel<1>", gpu, 100, 200),
        _Event("void conv3_fused_kernel<2>", gpu, 150, 100),  # overlaps: counted once
        _Event("gemm", gpu, 700, 100),
        _Event("void adan_ema_kernel<float>", gpu, 990, 20),  # past the host span's end
    ]
    prof = SimpleNamespace(profiler=SimpleNamespace(kineto_results=SimpleNamespace(
        events=lambda: events)))
    tr = trace.reduce(prof, {"conv3_fused": ("conv3_fused_kernel",),
                             "adan_ema": ("adan_ema_kernel",)})
    assert tr.window_s == pytest.approx(1.01e-6) and tr.busy_s == pytest.approx(3.2e-7)
    assert tr.kernel_n == {"conv3_fused": 2, "adan_ema": 1}
    assert tr.kernel_s["conv3_fused"] == pytest.approx(3e-7)
    # each part of a gap goes to the span open over it: 0-100 and 300-600 to
    # the sampler, 600-700 and 800-990 to the vocode
    assert tr.idle_by_span == pytest.approx({"sampler": 4e-7, "vocode": 2.9e-7})


def test_a_tiny_ddpm_run_is_correct():
    """The serve cell's driver with the traffic file's sampler switched to
    DDPM over a schedule of 4 timesteps: held step by step, every number
    within the cell's own limits."""
    cell = tiny_cell("ultimate-serve-ddim50", limits=spec.load_cell("ultimate-serve-ddim50").limits,
                     method="ddpm", steps=4)
    res = harness.run_cell(cell, 2 ** 31 + 23, 0.5, False, "cpu", time.perf_counter())
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_tiny_run_is_correct(workload):
    """A whole run of the cell's driver at tiny widths on the CPU: the
    window, the end-to-end metrics and the check, every number finite."""
    cell = tiny_cell(workload, limits={k: math.inf for k in spec.load_cell(workload).limits})
    res = harness.run_cell(cell, 2 ** 31 + 17, 1.0, False, "cpu", time.perf_counter())
    assert res["correct"] and res["attempted"] >= 1
    assert {m["name"] for m in cell.end_to_end} == set(res["metrics"])
    assert all(math.isfinite(c["value"]) for c in res["checks"].values())
