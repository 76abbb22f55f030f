#!/usr/bin/env python3
"""How far the card's distill step is from the CPU's, by how far into a run.

    python3 scripts/torch_distill_route_steps.py [--warm 0,1,2,8,50] [--out chiprun_out/distill_route_steps.json]

At the small config of ``tests/test_torch_cuda.py``'s distill test (base
128, mults 1,2, bf16, ``--fused_resblock_grad``, x0_snr, teacher guidance
2.1) the student starts as ``cli distill`` starts it (``start_student``: the
teacher's EMA, step 0, Adan zeroed) and takes W steps on the card. From
that state one step with fixed injected draws runs on the card (the
kernels) and on the CPU (their plain versions). For each W it prints the
relative L2 of the two gradients and of the two parameter steps, the
steps' relative L2 again without the leaves whose CPU gradient is under
``chip_smoke.ROUTE_TOL``'s floor (the attention key biases, true gradient
zero), the share of elements whose step changes sign, and the card's
update against Adan's plain update of the same state with the card's own
gradient (max relative error). Needs one NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from lm2a_tpu_torch.diffusion.schedule import make_schedule  # noqa: E402
from lm2a_tpu_torch.ops import adan as adan_op  # noqa: E402
from lm2a_tpu_torch.training import distill  # noqa: E402
from lm2a_tpu_torch.training.adan import BETAS, EPS  # noqa: E402
from lm2a_tpu_torch.training.checkpoint import load_state_arrays, state_arrays  # noqa: E402
from lm2a_tpu_torch.training.loop import step_generator  # noqa: E402
from lm2a_tpu_torch.training.train_step import init_train_state, make_optimizer  # noqa: E402

CFG = dataclasses.replace(
    chip_smoke.LM2AConfig(), model=chip_smoke.ModelConfig(
        base_dim=128, dim_mults=(1, 2), cond_dim=16, time_emb_dim=32, num_res_blocks=1,
        mid_blocks=1, attn_heads=2, fused_resblock_grad=True),
    train=dataclasses.replace(chip_smoke.LM2AConfig().train, weight_decay=0.0,
                              opt_backend="pallas"))
B, T = 2, 64
KW = dict(dataset_mean=-4.6, dataset_std=1.9, guidance_weight=2.1, loss_space="x0_snr")


def student(device, teacher_ema):
    optimizer = make_optimizer(CFG)
    state = init_train_state(CFG, 0, device, optimizer)
    ema = {k: v.to(device) for k, v in teacher_ema.items()}
    distill.start_student(state, ema)
    step = distill.make_distill_step(make_schedule(CFG.diffusion, device=device), CFG,
                                     optimizer, 4, **KW)
    return state, distill.build_teacher(CFG, ema), step, optimizer


def one_step(device, teacher_ema, pre, batch, draws):
    state, teacher, step, _ = student(device, teacher_ema)
    load_state_arrays(state, pre)
    p0 = {k: p.detach().clone() for k, p in state.params().items()}
    step(state, teacher, {k: v.to(device) for k, v in batch.items()}, draws=draws)
    return state, {k: p.grad.detach().clone() for k, p in state.params().items()}, {
        k: (p.detach() - p0[k]).cpu() for k, p in state.params().items()}


def plain_update(device, teacher_ema, pre, grads):
    """Adan's plain update of ``pre`` with ``grads``, on ``device``."""
    ref, _, _, optimizer = student(device, teacher_ema)
    load_state_arrays(ref, pre)
    names = list(ref.params())
    scal = optimizer.scalars(ref.opt, [grads[n] for n in names])
    with torch.no_grad():
        for n in names:
            adan_op.adan_ema_plain((grads[n], ref.params()[n], ref.ema[n], ref.opt.m[n],
                                    ref.opt.v[n], ref.opt.n[n], ref.opt.prev_grad[n]), scal,
                                   betas=BETAS, eps=EPS, clip=optimizer.grad_clip)
    ref.step += 1
    ref.opt.step += 1
    return state_arrays(ref)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--warm", default="0,1,2,8,50")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "distill_route_steps.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(chip_smoke.nvidia_smi_line(), flush=True)
    gen = torch.Generator().manual_seed(11)
    batch = {"mel": -4.6 + 1.9 * torch.randn((B, T, 80), generator=gen),
             "motion": torch.randn((B, T, 234), generator=gen),
             "lyrics": torch.randn((B, T, 768), generator=gen)}
    draws = distill.DistillDraws(torch.tensor([0, 3]), torch.randn((B, T, 80), generator=gen))
    teacher_ema = init_train_state(CFG, 5, "cpu").ema
    floor = chip_smoke.ROUTE_TOL["leaf_floor"]
    rows = []
    for warm in (int(w) for w in args.warm.split(",")):
        state, teacher, step, _ = student(dev, teacher_ema)
        for i in range(warm):
            step(state, teacher, {k: v.to(dev) for k, v in batch.items()},
                 generator=step_generator(0, i, dev))
        pre = state_arrays(state)
        card, card_g, card_s = one_step(dev, teacher_ema, pre, batch, draws)
        _, cpu_g, cpu_s = one_step(torch.device("cpu"), teacher_ema, pre, batch, draws)
        gnorm = float(torch.sqrt(sum(g.square().sum() for g in cpu_g.values())))
        sums = dict(grad=[0.0, 0.0], step=[0.0, 0.0], step_kept=[0.0, 0.0])
        flips = total = 0
        for n, g in cpu_g.items():
            kept = float(g.norm()) >= floor * gnorm
            dg = float((card_g[n].cpu() - g).square().sum())
            ds = float((card_s[n] - cpu_s[n]).square().sum())
            sums["grad"][0] += dg
            sums["grad"][1] += float(g.square().sum())
            for key in ("step", "step_kept") if kept else ("step",):
                sums[key][0] += ds
                sums[key][1] += float(cpu_s[n].square().sum())
            flips += int((torch.sign(card_s[n]) * torch.sign(cpu_s[n]) < 0).sum())
            total += g.numel()
        want, got = plain_update(dev, teacher_ema, pre, card_g), state_arrays(card)
        update_err = max(float(abs(got[k].astype("float64") - w).max()
                               / max(abs(w).max(), 1e-30)) for k, w in want.items())
        row = dict(warm=warm, update_vs_plain_max_rel=update_err, sign_flip_share=flips / total,
                   **{f"{k}_rel_l2": (a / b) ** 0.5 if b > 0 else None
                      for k, (a, b) in sums.items()})
        rows.append(row)
        print(json.dumps(row), flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
