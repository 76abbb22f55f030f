#!/usr/bin/env python3
"""Device time of the snake sandwich kernel under every launch plan.

    python3 scripts/torch_sandwich_plan_sweep.py [--out chiprun_out/sandwich_plan_sweep.json]

At the 7 sandwich geometries of a 516-frame BIGVGAN_22KHZ_80BAND vocode
(bf16, channels-first views, as the vocoder passes them) this times each
candidate of ``sandwich_candidates`` with ``torch.profiler`` (the kernel's
own device time, 10 launches, the L2 flushed before each) and prints it
beside the plan ``sandwich_plan`` picks. The plan's rule in
``lm2a_tpu_torch/vocoder/sandwich.py`` was chosen from this output. Needs
one NVIDIA GPU; it fails without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke  # noqa: E402
from lm2a_tpu_torch.vocoder import sandwich as sw  # noqa: E402
from lm2a_tpu_torch.vocoder.bigvgan import BIGVGAN_22KHZ_80BAND  # noqa: E402


def device_us(fn, flush, reps: int = 10):
    """Mean device time of the sandwich kernel over ``reps`` launches, each
    after an L2 flush; None when the profiler recorded none of them (it drops
    a window now and then), after three tries."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if "sandwich" in e.key)
        if total > 0:
            return total / reps
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "sandwich_plan_sweep.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sandwich plan sweep: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[sweep] {smi}", flush=True)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)
    gen = torch.Generator().manual_seed(0)
    real = sw.sandwich_plan
    report = dict(device=smi, geometries=[])
    try:
        for name, t, c, uses in chip_smoke.sandwich_geometries(BIGVGAN_22KHZ_80BAND,
                                                               chip_smoke.MEL_T):
            x = torch.randn((1, c, t), generator=gen).to(dev, torch.bfloat16).transpose(1, 2)
            la = (0.3 * torch.randn(c, generator=gen)).to(dev)
            lb = (0.3 * torch.randn(c, generator=gen)).to(dev)
            chosen = real(1, t, c, x.dtype, x.stride())
            rows = []
            for plan in sw.sandwich_candidates(1, t, c):
                sw.sandwich_plan = lambda *a, p=plan: p
                us = device_us(lambda: sw.snake_sandwich(x, la, lb, logscale=True), flush)
                rows.append(dict(plan=plan.__dict__, us=us))
            sw.sandwich_plan = real
            rows.sort(key=lambda r: float("inf") if r["us"] is None else r["us"])
            ours = next(r["us"] for r in rows if r["plan"] == chosen.__dict__)
            print(f"[sweep] {name} T={t} C={c} x{uses}: chosen {chosen} {ours} us; best "
                  + "; ".join(f"{r['plan']} {r['us']:.2f}" for r in rows[:6] if r["us"]),
                  flush=True)
            report["geometries"].append(dict(name=name, T=t, C=c, uses=uses,
                                             chosen=chosen.__dict__, chosen_us=ours, rows=rows))
    finally:
        sw.sandwich_plan = real
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
