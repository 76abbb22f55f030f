"""The check catches what it is there to catch: a whole run of each cell at
tiny widths on the CPU (the harness's look for a card skipped) with the timed
path broken underneath, and with the control (the reference in fp8) in the
program's place. Each comes out not correct under the cell's own limits, and
the number that fails it reads at least three times the sound run's."""

import math
import time

import pytest

from portbench import harness, spec
from portbench.controls import plant
from portbench.reference.precision import FP8
from portbench.tests.tiny import tiny_cell

SEED = 2 ** 31 + 101
FAULTS = {
    "ultimate-train-b16": ("unchanged", "ema_unchanged", "halfbatch"),
    "v1-train-b16": ("unchanged", "ema_unchanged", "halfbatch"),
    "ultimate-serve-ddim50": ("unchanged", "altered"),
    "ultimate-gen-ddim50-b8": ("unchanged", "halfbatch", "altered"),
}
CASES = [(w, f) for w, fs in FAULTS.items() for f in fs + ("control",)]
_sound = {}


def run(workload, fault=None):
    cell = tiny_cell(workload, limits=spec.load_cell(workload).limits)
    if fault == "control":
        return harness.run_cell(cell, SEED, 0.5, False, "cpu", time.perf_counter(), control=FP8)
    if fault is None:
        return harness.run_cell(cell, SEED, 0.5, False, "cpu", time.perf_counter())
    with plant(fault, cell):
        return harness.run_cell(cell, SEED, 0.5, False, "cpu", time.perf_counter())


def sound(workload):
    if workload not in _sound:
        _sound[workload] = {k: c["value"] for k, c in run(workload)["checks"].items()}
    return _sound[workload]


@pytest.mark.parametrize("workload,fault", CASES)
def test_fault_comes_out_not_correct(workload, fault):
    res = run(workload, fault)
    assert not res["correct"]
    base = sound(workload)
    caught = [k for k, c in res["checks"].items()
              if not c["value"] <= c["limit"] and (not math.isfinite(c["value"])
                                                   or c["value"] >= 3 * base[k])]
    assert caught, (res["checks"], base)
