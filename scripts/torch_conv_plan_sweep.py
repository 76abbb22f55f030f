#!/usr/bin/env python3
"""Device time of the port's Hopper conv kernels under every launch plan.

    python3 scripts/torch_conv_plan_sweep.py [--out chiprun_out/plan_sweep.json]

For flagship geometries of ``conv3_fused`` (2, 4 and 16 rows, and 2 rows
at T=12920) and of ``conv3_wgrad`` (B=16), this times each candidate of
``conv3_candidates`` / ``wgrad_candidates`` with ``torch.profiler`` (the
kernel's own device time, 10 launches; for the weight gradient with the
sum of its partials after the launch) and prints it beside the cost
model's estimate and the plan the model picks. The model's constants in
``lm2a_tpu_torch/ops/resblock.py`` (``BLOCK_US``, ``CHUNK_US``,
``WGRAD_CHUNK_US``, ``WAVE_BLOCKS``, ``SPLIT_MAX``; the partials' cost in
``ops/resblock_grad.py``) were fitted to this
output. Needs one NVIDIA GPU; it fails without one.
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
from lm2a_tpu_torch.ops import resblock as rb  # noqa: E402
from lm2a_tpu_torch.ops import resblock_grad as rg  # noqa: E402

# (rows, T, Cin, Cout, fp32 input): conv 1 (bf16 in) and conv 2 (fp32 in) shapes
FORWARD = [(2, 516, 256, 256, False), (2, 516, 256, 256, True), (4, 516, 256, 256, False),
           (2, 129, 1024, 1024, False), (4, 129, 1024, 1024, False), (2, 64, 1024, 1024, False),
           (4, 258, 512, 512, True), (16, 516, 256, 256, False), (2, 12920, 256, 256, False)]
# (B, T, Cin, Cout): the weight gradients of the 15 blocks' shapes at B=16
WGRAD = [(16, 516, 256, 256), (16, 258, 256, 512), (16, 258, 512, 512), (16, 516, 512, 256),
         (16, 129, 1024, 1024), (16, 64, 1024, 1024)]


def device_us(fn, key: str, reps: int = 10):
    """Mean device time of the kernels whose name holds ``key``; None when the profiler
    recorded none of its launches (it drops a window now and then), after
    three tries."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages() if key in e.key)
        if total > 0:
            return total / reps
    return None


def fmt(us) -> str:
    return "not measured" if us is None else f"{us:.1f}"


def forced(module, name: str, plan):
    """Context: ``module.name`` (a plan function) returns ``plan``."""
    class _Forced:
        def __enter__(self):
            self.orig = getattr(module, name)
            setattr(module, name, lambda *a, **k: plan)

        def __exit__(self, *exc):
            setattr(module, name, self.orig)
    return _Forced()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "plan_sweep.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("plan sweep: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    report = {"device": smi, "forward": [], "wgrad": []}
    for rows, t, cin, cout, f32 in FORWARD:
        w, x, film = chip_smoke.random_chain(gen, rows, t, cin, cout, False, dev)
        if f32:
            x = x.float()
        mean, rstd = rb.gn_stats(x, w.groups1)
        call = (x, mean, rstd, w.gn1_scale, w.gn1_bias, w.conv1_w, w.conv1_b)
        kw = dict(out_dtype=torch.bfloat16) if f32 else dict(film=film)
        nbytes = x.element_size()
        chosen = rb.conv3_plan(rows, t, cin, cout, 0, False, nbytes)
        rows_out = []
        for model_us, plan in rb.conv3_candidates(rows, t, cin, cout, 0, False, nbytes):
            with forced(rb, "conv3_plan", plan):
                us = device_us(lambda: rb.conv3_fused(*call, **kw), "conv3_fused")
            rows_out.append(dict(mw=plan.mw, bn=plan.bn, splits=plan.splits, blocks=plan.blocks,
                                 model_us=model_us, us=us, chosen=plan == chosen))
        rows_out.sort(key=lambda r: float("inf") if r["us"] is None else r["us"])
        report["forward"].append(dict(rows=rows, T=t, cin=cin, cout=cout, fp32_input=f32,
                                      candidates=rows_out))
        pick = next(r for r in rows_out if r["chosen"])
        print(f"[sweep] conv3_fused rows={rows} T={t} {cin}->{cout} {'fp32' if f32 else 'bf16'} "
              f"in: chosen mw{pick['mw']} bn{pick['bn']} S{pick['splits']} {fmt(pick['us'])} us "
              f"(model {pick['model_us']:.1f}); fastest "
              + "; ".join(f"mw{r['mw']} bn{r['bn']} S{r['splits']} ({r['blocks']}) {fmt(r['us'])} "
                          f"[model {r['model_us']:.1f}]" for r in rows_out[:6]), flush=True)
    for b, t, cin, cout in WGRAD:
        w, x, film = chip_smoke.random_chain(gen, b, t, cin, cout, False, dev)
        mean, rstd = rb.gn_stats(x, w.groups1)
        g = torch.randn((b, t, cout), generator=gen).to(dev, torch.bfloat16)
        kw = dict(taps=3, mean=mean, rstd=rstd, gamma=w.gn1_scale, beta=w.gn1_bias, bias=True)
        chosen = rg.wgrad_plan(b, t, cin, cout, 3)
        rows_out = []
        for model_us, plan in rg.wgrad_candidates(b, t, cin, cout, 3):
            with forced(rg, "wgrad_plan", plan):
                us = device_us(lambda: rg.conv3_wgrad(x, g, **kw), "")  # kernel + partials' sum
            rows_out.append(dict(mw=plan.mw, splits=plan.splits, parts=plan.parts,
                                 blocks=plan.blocks, model_us=model_us, us=us,
                                 chosen=plan == chosen))
        rows_out.sort(key=lambda r: float("inf") if r["us"] is None else r["us"])
        report["wgrad"].append(dict(B=b, T=t, cin=cin, cout=cout, candidates=rows_out))
        pick = next(r for r in rows_out if r["chosen"])
        print(f"[sweep] conv3_wgrad B={b} T={t} {cin}->{cout}: chosen mw{pick['mw']} "
              f"S{pick['splits']}x{pick['parts']} {fmt(pick['us'])} us (model "
              f"{pick['model_us']:.1f}); fastest "
              + "; ".join(f"mw{r['mw']} S{r['splits']}x{r['parts']} ({r['blocks']}) "
                          f"{fmt(r['us'])} [model {r['model_us']:.1f}]" for r in rows_out[:6]),
              flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
