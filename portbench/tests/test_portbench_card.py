"""Every cell on the card, short: the command as the benchmark's driver runs
it, traced, from the repository's root; the result line is correct and
carries the cell's per-layer metrics and a breakdown. Needs the card:
``python -m pytest --noconftest -p no:cacheprovider -m cuda portbench/tests -q``."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
WORKLOADS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_runs_traced_and_correct(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark measures the card only")
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload", workload,
                        "--seed", str(2 ** 33 + 5), "--seconds", "3", "--trace", "1"],
                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["metrics"] and res["breakdown"]["device_ops"]
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
