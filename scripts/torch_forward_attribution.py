#!/usr/bin/env python3
"""Device time of one eager serving forward of the flagship denoiser, by module.

    python3 scripts/torch_forward_attribution.py [--tree DIR] [--rows 16,2] [--out FILE]

Builds ``UNet1DUltimate`` at ``ModelConfig()`` with seeded random weights in
its serving form (``prepare(torch.bfloat16)``) on the card and, for each row
count of ``--rows``, runs one forward of a guided step (half the rows
CFG-unconditional, T = S = 516) under ``torch.profiler`` after two warm-up
forwards. Every device operation goes to the innermost module open on the
host when it was launched (by an aten op or by a C entry of the port's
kernels): a cross-attention site (``CrossAttentionFusion``, the CFG
constant's calls included), a residual block outside its site, or the rest
of the forward. Prints, per row count, each group's device ms, the
operations of most device time inside the attention sites, and the
forward's wall ms on CUDA events (unprofiled, the median of 20; the eager
forward is host-paced, a graph replay is not). ``--tree DIR`` imports the
package from another checkout (an older commit unpacked with ``git
archive``), so two trees are attributed alike in one call.

Needs one NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEL_T = 516
PREFIX = "fwd/"


def attribute(prof) -> dict:
    """{group: {kernel name: device ms}}: each device operation goes to the
    innermost module range open on the host at its launch (the ``cuda*``
    or ``cu*`` API call of the same correlation id: cuBLAS launches
    through ``cuLaunchKernelEx``), whether an aten op or a ctypes C entry
    (the port's own kernels) made it."""
    from torch.autograd import DeviceType

    ranges, launched_at, ops = [], {}, []
    for e in prof.profiler.kineto_results.events():
        name, start = e.name(), e.start_ns()
        if e.device_type() == DeviceType.CPU:
            if name.startswith(PREFIX):
                ranges.append((start, start + e.duration_ns(), name))
            elif name.startswith("cu"):  # the CUDA API's launches, copies and sets
                launched_at[e.correlation_id()] = start
        elif e.device_type() == DeviceType.CUDA and not name.startswith(PREFIX):
            annotation = getattr(e, "is_user_annotation", None)
            if annotation is None or not annotation():
                ops.append((e.correlation_id(), name, e.duration_ns()))
    out = defaultdict(lambda: defaultdict(float))
    for corr, name, ns in ops:
        at = launched_at.get(corr)
        inside = [] if at is None else [(b - a, n) for a, b, n in ranges if a <= at <= b]
        group = min(inside)[1] if inside else PREFIX + ("other" if at is not None else "unlinked")
        out[group][name] += ns / 1e6
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--rows", default="16,2")
    ap.add_argument("--label", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from lm2a_tpu_torch.core.config import ModelConfig
    from lm2a_tpu_torch.models.attention import CrossAttentionFusion
    from lm2a_tpu_torch.models.factory import build_denoiser, random_init_
    from lm2a_tpu_torch.models.unet1d import ResBlockUltimate

    dev = torch.device("cuda")
    mc = ModelConfig()
    model = random_init_(build_denoiser(mc), 1234).to(dev).prepare(torch.bfloat16).eval()
    groups = {CrossAttentionFusion: "attention", ResBlockUltimate: "resblock"}
    for m in model.modules():
        name = groups.get(type(m))
        if name is None:
            continue
        ctx = {}

        def pre(mod, inp, name=name, ctx=ctx):
            ctx.setdefault("stack", []).append(record_function(PREFIX + name))
            ctx["stack"][-1].__enter__()

        def post(mod, inp, out, ctx=ctx):
            ctx["stack"].pop().__exit__(None, None, None)

        m.register_forward_pre_hook(pre)
        m.register_forward_hook(post)

    gen = torch.Generator(device=dev).manual_seed(7)
    report = {"tree": os.path.abspath(args.tree), "label": args.label,
              "device": torch.cuda.get_device_name(dev), "rows": {}}
    for rows in [int(r) for r in args.rows.split(",")]:
        x = torch.randn(rows, MEL_T, mc.in_dim, device=dev, generator=gen)
        t = torch.full((rows,), 500, device=dev, dtype=torch.long)
        mot = torch.randn(rows, MEL_T, mc.cond_dim, device=dev, generator=gen)
        txt = torch.randn(rows, MEL_T, mc.cond_dim, device=dev, generator=gen)
        uncond = rows // 2

        def fwd():
            with torch.no_grad():
                return model(x, t, mot, txt, uncond_rows=uncond)

        for _ in range(2):
            fwd()
        torch.cuda.synchronize()
        walls = []
        for _ in range(20):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fwd()
            b.record()
            b.synchronize()
            walls.append(a.elapsed_time(b))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fwd()
            torch.cuda.synchronize()
        by = attribute(prof)
        total = sum(sum(k.values()) for k in by.values())
        att = by.get(PREFIX + "attention", {})
        top = sorted(att.items(), key=lambda kv: -kv[1])[:10]
        res = {"wall_ms": statistics.median(walls), "device_ms": total,
               "groups": {g[len(PREFIX):]: sum(k.values()) for g, k in by.items()},
               "attention_kernels": [[n, ms] for n, ms in top]}
        report["rows"][rows] = res
        print(f"[attribution{(' ' + args.label) if args.label else ''}] rows={rows}: wall "
              f"{res['wall_ms']:.4f} ms, device {total:.4f} ms; "
              + ", ".join(f"{g} {ms:.4f}" for g, ms in sorted(res["groups"].items())))
        for n, ms in top:
            print(f"    {ms:8.4f} ms  {n[:150]}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
