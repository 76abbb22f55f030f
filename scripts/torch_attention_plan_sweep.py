#!/usr/bin/env python3
"""Device time of the port's Hopper attention kernel under every launch plan.

    python3 scripts/torch_attention_plan_sweep.py [--out chiprun_out/attention_plan_sweep.json]

For every geometry of the fused attention route (the 9 cross-attention
sites at 6 s with 2 and 16 conditioned rows, and the 150 s single pass),
this times each candidate of ``attention_candidates`` (key tile, ring
stages, split of the key tiles over a cluster) with ``torch.profiler`` (the
kernel's own device time, 10 launches) and prints it beside the cost
model's estimate, the plan the model picks and the time per key tile that
the measurement implies (a block's time less ``BLOCK_US`` and, when split,
the split's combine, over its key tiles). The model's constants in
``lm2a_tpu_torch/ops/attention.py`` (``BLOCK_US``, ``COMBINE_US``,
``COMBINE_US_PER_HD``, ``TILE_US``) were fitted to this output. Needs one
NVIDIA GPU; it fails without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from lm2a_tpu_torch.core.config import ModelConfig  # noqa: E402
from lm2a_tpu_torch.ops import attention as att  # noqa: E402
from torch_conv_plan_sweep import device_us, fmt, forced  # noqa: E402


def geometries():
    """(B, H, T, S, hd) of the fused route: 6 s at 2 and 16 rows, 150 s."""
    mc = ModelConfig()
    out = []
    for b, mel_t in ((chip_smoke.N_CLIPS, chip_smoke.MEL_T), (chip_smoke.WINDOW_ROWS, chip_smoke.MEL_T),
                     (1, chip_smoke.LONG_T)):
        for _, t, c in chip_smoke.attention_sites(mc, mel_t):
            g = (b, mc.attn_heads, t, mel_t, c // mc.attn_heads)
            if g not in out:
                out.append(g)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "attention_plan_sweep.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("attention plan sweep: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    report = {"device": smi, "attention": []}
    for b, h, t, s, hd in geometries():
        def make(n):  # heads split off channels-last projections, as the model does
            return (torch.randn((b, n, h * hd), generator=gen).to(dev, torch.bfloat16)
                    .view(b, n, h, hd).transpose(1, 2))

        q, k, v = make(t), make(s), make(s)
        chosen = att.attention_plan(b, h, t, s, hd)
        rows_out = []
        for model_us, plan in att.attention_candidates(b, h, t, s, hd):
            with forced(att, "attention_plan", plan):
                us = device_us(lambda: att.attention_core(q, k, v), "attention")
            waves = -(-plan.blocks(b, h) // att.WAVE_BLOCKS[plan.split])
            tile_us = None
            if us is not None:
                fixed = att.BLOCK_US[hd] + (att.COMBINE_US + att.COMBINE_US_PER_HD * hd
                                            if plan.split > 1 else 0.0)
                tile_us = (us / waves - fixed) / -(-plan.tiles // plan.split)
            rows_out.append(dict(bn=plan.bn, stages=plan.stages, split=plan.split,
                                 blocks=plan.blocks(b, h), waves=waves, model_us=model_us, us=us,
                                 tile_us=tile_us, chosen=plan == chosen))
        rows_out.sort(key=lambda r: float("inf") if r["us"] is None else r["us"])
        report["attention"].append(dict(B=b, H=h, T=t, S=s, hd=hd, candidates=rows_out))
        pick = next(r for r in rows_out if r["chosen"])
        print(f"[sweep] attention B={b} T={t} S={s} hd={hd}: chosen bn{pick['bn']} "
              f"st{pick['stages']} S{pick['split']} {fmt(pick['us'])} us (model "
              f"{pick['model_us']:.1f}); fastest "
              + "; ".join(f"bn{r['bn']} S{r['split']} ({r['blocks']}) {fmt(r['us'])} "
                          f"[model {r['model_us']:.1f}, tile {fmt(r['tile_us'])}]"
                          for r in rows_out[:6]), flush=True)
        del q, k, v
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
