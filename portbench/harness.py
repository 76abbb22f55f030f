"""One run of one cell: set-up, a measured window, the check, one result line.

``python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>``

1. Set-up (``setup_s``, from the process's start): the program loads, the
   benchmark's weights and inputs are made on the card from the seed, and the
   cell's own shapes are warmed up (graphs captured, kernels built).
2. The window: units of the cell's traffic (``drivers/``) until ``--seconds``
   have passed, then the device drained; every unit started completes.
   With ``--trace 1`` the first ``trace_units`` units run under
   ``torch.profiler`` and the per-layer metrics are read from the trace, the
   spans and the counters (``metrics/``); the rest of the window runs
   untraced and gives the model-FLOP share. A trace that lost launches the
   counter saw is taken again over the next units (``TRACE_ATTEMPTS``).
3. The device's peak memory is read, the program's state freed, and the
   reference checks what the window produced (``check``). ``correct`` holds
   when every number compared is finite and within its limit
   (``limits/<workload>.json``).
4. No module of JAX or of the JAX package may be loaded by then.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from collections import Counter
from typing import Dict, Optional

from portbench import spec as spec_mod
from portbench.spans import Spans
from portbench.weights import Seeds

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "lm2a_tpu")
# The profiler keeps only the device operations that fall inside its own
# capture window, timed on the host; the card's clock, mapped onto the
# host's, can put the last operations after the profile's end. The profile
# therefore holds the traced units with the card idle this long on both
# sides, outside the traced-window span.
TRACE_PAD_S = 0.25
TRACE_ATTEMPTS = 3


class TraceMissedLaunches(RuntimeError):
    """The trace holds fewer (or more) launches of a kernel than the
    program's counter saw over the traced units."""


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({n for n in list(sys.modules) if n.split(".")[0] in FORBIDDEN})


def kernel_files():
    """Every kernel file of ``kernels/`` by name (the shared geometry aside)."""
    out = {}
    for f in sorted(os.listdir(os.path.join(HERE, "kernels"))):
        if f.endswith(".py") and not f.startswith("_") and f != "geometry.py":
            out[f[:-3]] = importlib.import_module(f"portbench.kernels.{f[:-3]}")
    return out


def driver_module(cell):
    """The module of ``drivers/`` that the cell's traffic file names."""
    return importlib.import_module(f"portbench.drivers.{cell.driver}")


def metric_reader(name: str):
    """The reader of per-layer metric ``name``: the file ``metrics/<name>.py``
    where there is one, else the reader its name's pattern gives
    (``metrics/_read.py``: ``<kernel>_roofline.*``, ``kernel_roofline.*``,
    ``mfu.*``, ``device_idle.*``)."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    if not os.path.exists(path):
        from portbench.metrics._read import by_pattern

        return by_pattern(name, kernel_files())
    s = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod.read


class Context:
    """What a per-layer metric's reader reads: the cell, the spans, the
    trace, the kernels' least and device times over the traced units, and
    the model's FLOPs a second over the untraced part of the window."""

    def __init__(self, cell, spans, trace, kernels, flops_rate):
        self.cell, self.spans, self.trace = cell, spans, trace
        self.kernels = kernels
        self.flops_rate = flops_rate  # None where no unit ran untraced

    def kernel(self, name: str):
        """(least seconds, device seconds) of kernel ``name`` over the traced
        units, or None where the cell's path does not run it or the counts
        do not describe what ran."""
        k = self.kernels.get(name)
        return None if k is None else (k["least_s"], k["device_s"])


def _kernels_traced(cell, trace, launches, units: int, files) -> Dict[str, dict]:
    """Per kernel file on the cell's path: the least seconds of the launches
    the cost model gives for the traced units, and their device seconds.
    The trace has to hold every launch the counter saw, and the cost model
    has to give as many launches as the counter saw: a change to the
    program's launch plan or routing has to come with its cost file."""
    from portbench.kernels.geometry import least_seconds

    out, problems, missed = {}, [], []
    for name, mod in files.items():
        per_unit = mod.launches(cell)
        counted = int(launches.get(mod.LAUNCH, 0))
        traced = int(trace.kernel_n.get(name, 0))
        if counted != traced:
            missed.append(f"{name}: the counter saw {counted} launches, the trace {traced}")
            continue
        if not per_unit and not counted:
            continue
        if len(per_unit) * units != counted:
            problems.append(f"{name}: the counter saw {counted} launches in {units} units, "
                            f"the cost model gives {len(per_unit)} a unit")
            continue
        least = units * sum(least_seconds(c, mod.PEAK) for c in per_unit)
        out[name] = {"least_s": least, "device_s": trace.kernel_s.get(name, 0.0),
                     "launches": counted}
    if problems:
        raise RuntimeError("the launches do not match: " + "; ".join(problems + missed))
    if missed:
        raise TraceMissedLaunches("the launches do not match: " + "; ".join(missed))
    return out


def _traced(cell, driver, spans, trace_units: int, units: int, files):
    """Runs ``trace_units`` units from unit ``units`` under the profiler and
    returns (trace, kernels, units run). Where the trace lost launches that
    the counter saw, the next units are traced afresh, up to
    ``TRACE_ATTEMPTS`` times; each loss is named on standard error."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from lm2a_tpu_torch.ops import _build
    from portbench import trace as trace_mod

    patterns = {n: tuple(m.PATTERNS) for n, m in files.items()}
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        before = Counter(_build.LAUNCHES)
        spans.tracing = True
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(TRACE_PAD_S)
            with record_function(trace_mod.WINDOW_SPAN):
                for _ in range(trace_units):
                    driver.unit(units)
                    units += 1
                driver.drain()
            time.sleep(TRACE_PAD_S)
        spans.tracing = False
        launches = Counter(_build.LAUNCHES)
        launches.subtract(before)
        tr = trace_mod.reduce(prof, patterns)
        del prof
        try:
            return tr, _kernels_traced(cell, tr, launches, trace_units, files), units
        except TraceMissedLaunches as e:
            print(f"[trace] attempt {attempt} of {TRACE_ATTEMPTS}: {e}", file=sys.stderr)
            if attempt == TRACE_ATTEMPTS:
                raise


def power_limit() -> Optional[str]:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 and r.stdout else None
    except (OSError, subprocess.SubprocessError):
        return None


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
             control=None) -> dict:
    """One run of ``cell`` on ``device``; returns the result (see the module
    docstring). ``control`` (a ``reference.precision.Precision``) puts the
    reference computed in it in the program's place in the check."""
    import torch

    spans = Spans()
    driver = driver_module(cell).Driver(cell, Seeds(seed), device, spans)
    driver.setup()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    spans.seconds.clear()

    trace_units = int(cell.traffic["trace_units"]) if trace else 0
    units = 0
    t0 = time.perf_counter()
    if trace_units:
        tr, kernels, units = _traced(cell, driver, spans, trace_units, units, kernel_files())
    traced_units = units
    t_untraced = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        driver.unit(units)
        units += 1
    driver.drain()
    t1 = time.perf_counter()
    window_s = t1 - t0
    untraced_units, untraced_s = units - traced_units, t1 - t_untraced

    e2e = driver.end_to_end(window_s, units)
    e2e["setup_s"] = setup_s
    peak = torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else 0
    driver.release()
    readings = driver.check(control)

    metrics: Dict[str, dict] = {}
    if trace:
        flops_unit = driver.flops_per_unit()
        flops_rate = flops_unit * untraced_units / untraced_s if untraced_units else None
        for name, k in kernels.items():
            print(f"[kernel] {name} launches {k['launches']} device_s {k['device_s']!r} "
                  f"least_s {k['least_s']!r}", file=sys.stderr)
        ctx = Context(cell, spans, tr, kernels, flops_rate)
        for m in cell.per_layer:
            v = metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            if m["name"] not in e2e:
                raise KeyError(f"{cell.name}: the {cell.driver} driver does not measure "
                               f"{m['name']!r} (it measures {sorted(e2e)})")
            metrics[m["name"]] = {"value": float(e2e[m["name"]]), "unit": m["unit"]}

    checks, notes = {}, []
    for k, v in readings.items():
        if k.startswith("_"):
            notes.append(v)
        elif k in cell.limits:
            checks[k] = {"value": v, "limit": cell.limits[k]}
        else:  # read and shown, not compared (PERF.md says why)
            notes.append(f"{k} {v!r} (not compared)")
    correct = bool(checks) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": correct, "attempted": units, "failed": 0, "metrics": metrics,
              "device": {"memory_peak_bytes": int(peak)}, "window_s": window_s}
    if trace:
        result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = tr.breakdown()
    result["_notes"] = notes
    result["checks"] = checks
    return result


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    cell = spec_mod.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("[portbench] no CUDA device: this benchmark measures the card and runs "
              "nowhere else", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"[portbench] {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace), dev, t_start)
    bad = forbidden_modules()
    if bad:
        print(f"[portbench] modules of JAX or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 4
    return emit(res, cell, torch)


def emit(res: dict, cell, torch) -> int:
    """Print the result line (stdout, last) and the numbers compared beside
    their limits (stderr, last)."""
    res["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                     "count": torch.cuda.device_count(), **res["device"],
                     "power": power_limit()}
    for note in res.pop("_notes"):
        print(f"[portbench] {note}", file=sys.stderr)
    checks = res.pop("checks")
    res["checks"] = checks  # the key of its own that comes last
    for k, c in checks.items():
        print(f"[check] {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0
