#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``lm2a_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--ddpm_steps 1000] [--out chiprun_out/chip_smoke]

Phases, in order; any failure exits non-zero and nothing is caught and
skipped:

1. device: the card's name and power limit (``nvidia-smi``), TF32 switches
   set off explicitly and printed;
2. build: every ``lm2a_tpu_torch/csrc/*.cu`` compiled with ``nvcc`` (one
   process per source, all at once), each kernel function's ``-Xptxas -v``
   registers, shared memory and spills logged;
3. kernels against their plain PyTorch versions on the card, at every
   geometry the flagship path gives them: the resblock chain kernels
   (``gn_stats``, ``conv3_fused``) at the 15 FiLM resblocks of the flagship
   UNet (bf16) at 4 rows (``cli sample`` of two clips under CFG) and at 2
   rows (the one-clip protocol chain), the snake sandwich at the 6 vocoder stages plus
   ``activation_post`` (bf16, log-scale parameters raw as the vocoder passes
   them); each with its time, its plain version's time,
   its bound and, where one PyTorch call computes the same function, that
   call's time; each ``conv3_fused``, ``gn_stats`` and sandwich launch run
   twice on the same inputs for the same bits (their K and T splits sum in a
   fixed rank order); the sums over the 30 ``gn_stats`` launches of a forward
   beside the device time of an empty kernel's launch, the floor of such
   small launches; the sandwich beside the MUFU floor of its sines, a device
   copy of its bytes and BigVGAN's own ``Activation1d`` form (several
   PyTorch calls, a yardstick and not a library time), then one vocode
   profiled (device time by group, busy share, launches);
   3b. the resblock kernels at the long-form row counts and lengths: 16
   rows at T=516 (8 windows of ``generate_long`` under CFG) and 2 rows at
   T=12920 (``generate_single_pass`` at 150 s), and at the 32 rows at T=516
   of ``cli distill``'s teacher (its guided forwards at B = 16);
   3c. the attention kernel at every geometry of the fused route: the 9
   cross-attention sites at 6 s (S=516) with 1, 2 and 16 conditioned rows,
   the CFG constant at T=S=1, and the 150 s single pass (S=T=12920); the
   sites of base widths 48 and 96 (head dims 6, 12, 24, 48) and the 7 of
   the v1 UNet at its defaults (head dims 32 to 192) at 2 (and v1 16)
   conditioned rows and the CFG constant, each
   launched twice on the same inputs for the same bits (the split-KV combine
   sums in rank order); timed against its plain version, its bound (with the
   MUFU's exp2 floor beside it) and ``F.scaled_dot_product_attention``;
   3d. the training kernels: the resblock backward (``conv3_dgrad``,
   ``conv3_wgrad``, ``gn_bwd``) at all 15 flagship block geometries at B=16
   (not only the 7 the training gate routes), every gradient against the
   plain versions, timed against them, their bounds and one cuDNN call each
   (``aten.convolution_backward``, ``aten.native_group_norm_backward``), and
   each block's whole backward against the autograd backward of the same
   chain built from ``F.group_norm``/``F.conv1d``, ``conv3_wgrad``,
   ``conv3_dgrad`` and ``gn_bwd`` run twice on the same inputs for the same
   bits, ``gn_bwd`` also beside a device copy of the bytes it moves;
   ``adan_ema`` over the full flagship parameter tree for 3 steps (the step-0
   freeze included),
   fp32 and bf16 state, against its plain version;
4. the slice: a flagship checkpoint (random weights from a seed, JAX layout)
   and two synthetic 6 s clips, then ``cli sample`` (DDIM-50, CFG 2.1, bf16)
   and ``cli towav`` (full BIGVGAN_22KHZ_80BAND width) with the launch
   counters reset just before and read just after; outputs checked for shape
   and finiteness, counts checked against the expected launches (every
   forward launches ``gn_stats`` twice a block and once for the UNet's last
   GroupNorm);
   4b. ``cli serve`` (DDIM-50, CFG 2.1, ``--warmup_t 516``) answering ping,
   one clip, a list of two, one clip with ``wav``, a request without
   ``npz`` and quit: replies in order, files, launch counts after warm-up;
   then a server without warm-up: the first request of a geometry captures
   its chain's CUDA graph, a second request and one at another CFG weight
   above 1 capture nothing (their seconds printed);
   4c. the 6 s fused route: ``cli sample`` of a checkpoint whose config sets
   ``fused_attention``, its attention launches counted, and its 4-row UNet
   forward on the card against the host;
   4d. ``cli pack`` of 64 synthetic 6 s clips, then ``cli train`` at flagship
   width (B=16, T=516, ``--fused_resblock_grad --opt_backend pallas``) for 6
   steps with a save every 4, then ``--resume`` for 2 more: checkpoint
   names, epochs and steps, finite losses, the launches of every kernel per
   step exactly; then ms per step, clips/s and peak memory of both routes
   and a profiled window of the kernel route;
   4e. the route comparison: from the resumed checkpoint, one step on the
   kernel route and one on the plain route (``--opt_backend xla``, no
   ``--fused_resblock_grad``) with the same batch and generator: loss,
   every gradient leaf, parameters and EMA;
   4g. compiled steps: one flagship train step from 4d's resumed state as a
   CUDA graph replay against the eager step (the same bits, or the first
   module where the replay departs printed and the two within
   ``ROUTE_TOL``); ms per step and clips/s at K = 1 and 2, streaming and
   device-resident, beside the eager step, and a profiled window of
   replays; ``cli train --steps_per_call 2 --device_data`` over 4d's pack
   (6 steps, a save every 4, then ``--resume`` for 2): checkpoints by the
   JAX fused rule, 4d's launches a step, the step-8 state the same bits as
   4d's K = 1 run's;
   4f. distillation: ``cli distill`` with 4d's last checkpoint as the
   teacher over 4d's pack (stages 100 -> 50, 4 steps each, K = 2 steps a
   call over the pack on the card, a save every 2 steps, cosine rate), the
   launches of every kernel per step exactly (the teacher's two serving
   forwards, the student's gated blocks forward and backward, the update),
   checkpoints, ``distill_progress`` and finite losses; then, the run cut
   after stage 1's mid-stage save, ``--resume``: the point it resumes at,
   the rows it draws, its launches; the student through ``cli sample`` with
   no flags (DDIM-50 at guidance 1.0, B-row forwards); one stage-0 step
   timed: wall ms, peak memory, busy share, device ms of the teacher's
   forwards, the student's forward and backward and the update; then a
   ``fused_attention`` copy of 4d's checkpoint as the teacher, one step a
   stage: every kernel's launches, the attention kernel's among them;
   4h. the width rule: every block of base widths 12, 16, 20, 32, 48 and
   96 and an odd-width block (Cin 21, Cout 42) through the forward and
   backward kernels and attention at head dims 2 and 4, each against its
   plain version; evaluation: ``cli val
   --max_samples 2`` over the two clips
   (DDPM-1000, guidance 2.1): 31 ``gn_stats`` and 30 ``conv3_fused``
   launches a forward for 1000 forwards a clip, the averages file, each
   clip's metrics equal to ``compute_metrics`` of the npz it wrote; ``cli
   train`` for 2 epochs over 4d's pack with a validation pack and
   ``--quality_every_epochs 1 --quality_clips 4 --quality_steps 50``: two
   finite quality rows, the second unlike the first, each monitor run's
   launches those of 50 forwards, its seconds; ``cli inspect_train_log`` on
   that run's log; ``cli train --fused_opt 0 --opt_backend xla
   --fused_resblock_grad`` for 2 steps (launches, the chained checkpoint
   layout), then 2 chained steps from 4d's resumed checkpoint on the card
   and on the host CPU within ``ROUTE_TOL``; ``cli towav`` of the clips'
   ground-truth and generated mels into ``sample_*/{gt,gen}.wav`` and ``cli
   evaluate --no-clap``, every key the JAX package writes; a base-32
   ``fused_attention`` checkpoint (head dims 4 to 16) through ``cli
   sample`` on the kernels and its forward against the host;
   4i. the data pipeline: a seeded raw tree (6 songs, 30 slices of 6 s)
   through ``cli preprocess --lyrics_backend hashed`` on the card and with
   ``--device cpu`` (the shards compared: every key but mel the same bits,
   mel within ``PREPROCESS_MEL_ATOL``; seconds a minute of audio), ``cli
   split``, ``cli inspect_npz``, ``cli pack`` of the train split, then 2
   flagship ``cli train`` steps on that pack on the native gatherer (its
   first batch the numpy gatherer's bits), 4d's launches a step;
   4j. the v1 UNet at its defaults (88,168,016 parameters) with
   ``fused_attention``: ``cli train --arch v1 --fused_attention`` (B=16,
   T=516, ``--opt_backend pallas``) for 4 steps and ``--resume`` for 2, 14
   attention launches and one ``adan_ema`` a step exactly; one replayed
   step timed (ms, clips/s, peak memory); ``cli sample`` (DDIM-10, CFG
   2.1) of the checkpoint, 280 attention launches, its 4-row forward
   against the host; one ``cli serve`` request;
5. one protocol chain (B=1, T=516, CFG 2.1, DDPM with ``--ddpm_steps``
   steps), DDIM-2 and DDIM-50, each run once to capture its cache entry and
   then timed as replays, and one vocode, timed; a DDIM-10 chain profiled
   as replays and with every step eager;
   5b. long form, timed: ``generate_single_pass`` at 150 s (12920 frames,
   the fused route taken by itself, DDIM-10) and ``generate_long`` at 60 s
   (12 windows of 516 frames, 8 per chain, DDIM-10);
   5c. cached chains (CUDA graph replays) against the same chains with every
   step eager, one seed: 6 s DDIM-50 at 4 rows, 20 DDPM steps at 2 rows,
   the 150 s single pass at DDIM-2 on the fused route: the same bits, or
   the first module where a replay departs printed and the two within
   ``UNET_REL_L2``; wall per step cached and eager, each entry's capture
   seconds and the device memory its capture reserved;
6. references: full-width UNet forwards on the card against the same
   checkpoint's forwards on the host CPU (plain versions, same bf16 weights)
   at 2, 4 and 32 CFG rows (the last the distill teacher's), and the full-width vocoder on a short mel, card against host CPU, fp32;
   6b. one full-width UNet forward at T=12920 on the fused route against the
   same forward through ``attention_core_plain`` on the card.

A ``[phase]`` line gives each phase's wall seconds. The line before the last
is a JSON object ``{"kernels": [...]}``; the last line is ``{"ok": true,
"device": {...}}``. Exits non-zero with no result when CUDA is not
available. Per-geometry numbers go to ``--out``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import re
import shutil
import subprocess
import sys
import time
import wave

import numpy as np
import torch
import torch.nn.functional as F

from lm2a_tpu_torch.checkpoint import save_checkpoint
from lm2a_tpu_torch.cli import __main__ as cli_main
from lm2a_tpu_torch.cli import sample as cli_sample
from lm2a_tpu_torch.cli import towav as cli_towav
from lm2a_tpu_torch.convert import UNET_CONV_TRANSPOSE, torch_params_to_jax
from lm2a_tpu_torch.core.config import LM2AConfig, ModelConfig
from lm2a_tpu_torch.data.schema import Sample, save_sample
from lm2a_tpu_torch.inference.longform import generate_long, generate_single_pass
from lm2a_tpu_torch.inference.sample import (
    FALLBACK_MEL_MEAN, FALLBACK_MEL_STD, generate_mel, load_models,
)
from lm2a_tpu_torch.models import attention as model_attention
from lm2a_tpu_torch.models.factory import (
    build_cond_projection, build_denoiser, param_count, random_init_,
)
from lm2a_tpu_torch.models.unet1d import default_num_groups
from lm2a_tpu_torch.ops import _build
from lm2a_tpu_torch.ops import adan as adan_op
from lm2a_tpu_torch.ops import attention as att
from lm2a_tpu_torch.ops import resblock as rb
from lm2a_tpu_torch.ops import resblock_grad as rg
from lm2a_tpu_torch.vocoder import sandwich as sw
from lm2a_tpu_torch.vocoder.bigvgan import BIGVGAN_22KHZ_80BAND
from lm2a_tpu_torch.vocoder.filters import kaiser_sinc_filter1d
from lm2a_tpu_torch.vocoder.vocode import Vocoder

ROOT = os.path.dirname(os.path.abspath(__file__))
# NVIDIA H100 SXM data sheet, dense: bf16 tensor cores, fp32 outside them, HBM3
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# sm_90's MUFU: 16 exp2 or sine a clock per SM (the attention softmax takes
# one exp2 per score, the sandwich two sines per output)
MUFU_PER_CLOCK = 16
MEL_T, MOTION_T = 516, 180
# the main path samples N_CLIPS clips in one batch; CFG doubles the rows of
# every forward. The protocol chain is one clip: 2 rows.
N_CLIPS = 2
MAIN_ROWS, PROTOCOL_ROWS = 2 * N_CLIPS, 2
# long form: windowed generation batches 8 windows of 516 frames per chain
# (16 rows under CFG); the single pass runs 150 s, 12920 frames, above the
# fused-route threshold (FUSED_ATTENTION_MIN_T = 12288)
WINDOW_ROWS = 16
LONG_T = 12920
LONG_SECONDS = LONG_T * 256 / 22050
FLAGSHIP_PARAMS = 134_292_816
V1_PARAMS = 88_168_016  # ModelConfig(arch="v1"), the JAX init's count
# kernel vs plain, same inputs on the card. bf16 outputs: 1-2 bf16 ulps
# (2^-8 relative each); the conv operands are the same bf16 values except
# where the kernel's SiLU (y / (1 + exp(-y))) and torch's (y * sigmoid(y))
# round to different bf16 neighbours. fp32 outputs: fp32 sums in another
# order plus those operand flips.
TOL = {
    "gn_stats": dict(atol=1e-4, rtol=1e-3),
    "conv3_fused": dict(atol=1e-2, rtol=1e-2),
    "chain": dict(atol=3e-2, rtol=3e-2),
    "snake_sandwich": dict(atol=1e-2, rtol=1e-2),
    # bf16 output: two ulps relative; absolute: p is rounded to bf16 against
    # the running max in the kernel and the global max in the plain version,
    # up to 2^-9 of each summand p*v
    "attention": dict(atol=2e-3, rtol=1e-2),
}
# the backward kernels against their plain versions on the same inputs, as
# relative L2 errors. conv3_dgrad: fp32 out of the same bf16 products summed
# in another order. conv3_wgrad: its prologue's SiLU (y / (1 + exp(-y))) and
# torch's (y * sigmoid(y)) round some bf16 operands to neighbouring values
# (2^-8 each). gn_bwd: a bf16 output whose fp32 value differs in the last
# bits (group sums in another order), so a few elements round the other way;
# its fp32 tile sums 1e-5. A whole block's gradients (each of the 11 or 13),
# kernels against plain versions: the flips above compounded through the
# chain. adan_ema: the same fp32 expressions, no FMA contraction: bit for bit
# up to one fp32 ulp.
TOL_REL_L2 = {
    "conv3_dgrad": 1e-5,
    "conv3_wgrad": 2e-3,
    "gn_bwd": 4e-3,
    "gn_bwd_partials": 1e-5,
    "resblock_bwd": 1e-2,
}
TOL["adan_ema"] = dict(atol=0.0, rtol=2e-7)
# end-to-end references, relative L2 error: the UNet in bf16 on both sides
# (15 blocks of bf16 roundings in another order), the vocoder in fp32 on both
UNET_REL_L2 = 2e-2
VOCODER_MAX_ABS = 1e-3

KERNELS = {
    "gn_stats": dict(route="cuda", source="lm2a_tpu_torch/csrc/resblock.cu",
                     replaces="lm2a_tpu/ops/pallas_resblock.py:155"),
    "conv3_fused": dict(route="cuda", source="lm2a_tpu_torch/csrc/resblock.cu",
                        replaces="lm2a_tpu/ops/pallas_resblock.py:155"),
    "snake_sandwich": dict(route="cuda", source="lm2a_tpu_torch/csrc/sandwich.cu",
                           replaces="lm2a_tpu/vocoder/pallas_sandwich.py:51"),
    "attention": dict(route="cuda", source="lm2a_tpu_torch/csrc/attention.cu",
                      replaces="lm2a_tpu/ops/pallas_attention.py:55 and :98"),
    "conv3_dgrad": dict(route="cuda", source="lm2a_tpu_torch/csrc/resblock_bwd.cu",
                        replaces="lm2a_tpu/ops/pallas_resblock.py:568"),
    "conv3_wgrad": dict(route="cuda", source="lm2a_tpu_torch/csrc/resblock_bwd.cu",
                        replaces="lm2a_tpu/ops/pallas_resblock.py:568"),
    "gn_bwd": dict(route="cuda", source="lm2a_tpu_torch/csrc/resblock_bwd.cu",
                   replaces="lm2a_tpu/ops/pallas_resblock.py:568"),
    "adan_ema": dict(route="cuda", source="lm2a_tpu_torch/csrc/adan.cu",
                     replaces="lm2a_tpu/ops/pallas_opt.py:103 (calls :173, :197)"),
}
TRAIN_B, TRAIN_CLIPS = 16, 64
# cli distill's teacher runs its guided forwards on 2B rows
DISTILL_ROWS = 2 * TRAIN_B
# 4e, kernel route against plain route on the card (bf16 compute on both; the
# routes round to bf16 at different places: GroupNorm and SiLU in fp32 inside
# the kernels, in bf16 between cuDNN ops on the plain route): the loss; each
# gradient leaf relative L2, with a floor of 1e-4 of the whole gradient's norm
# for leaves whose true gradient is zero (the attention key biases); the whole
# gradient; the whole model's step (new minus old parameters) and the EMA's
# change (new minus old EMA, so an EMA left behind reads 1), relative L2.
# One step from the resumed checkpoint per generator seed. The step read
# 2.6e-3 at seed 1234 (H100); the EMA's change is set by fp32 rounding of an
# EMA that moves by ~1e-3 of |p - ema| a step (5.6e-3 to 8.8e-3 at the tiny
# width on the CPU, tests/test_torch_train_cli.py).
ROUTE_TOL = dict(loss_rel=1e-2, leaf_rel_l2=5e-2, leaf_floor=1e-4, grad_rel_l2=2e-2,
                 step_rel_l2=1e-2, ema_change_rel_l2=3e-2)
ROUTE_SEEDS = (1234, 1235, 1236)


class SmokeFailure(RuntimeError):
    pass


def need(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------- geometry

def resblock_geometries(mc: ModelConfig, t: int):
    """(name, T, Cin, Cout, has_skip, add_residual) of every FiLM resblock of
    ``UNet1DUltimate`` at input length ``t``, in forward order."""
    dims = [mc.base_dim * m for m in mc.dim_mults]
    out, ts, prev = [], [], mc.base_dim
    for i, d in enumerate(dims):
        for b in range(mc.num_res_blocks):
            attn = b == mc.num_res_blocks - 1
            out.append((f"down_{i}_block_{b}", t, prev, d, prev != d, not attn))
            prev = d
        ts.append(t)
        t = (t + 2 - 4) // 2 + 1  # k4 s2 p(1,1)
    for b in range(mc.mid_blocks):
        out.append((f"mid_block_{b}", t, prev, prev, False, False))
    for i, d in enumerate(reversed(dims)):
        t = ts.pop()  # upsample 2x, then _fix_time_len to the skip's length
        for b in range(mc.num_res_blocks):
            cin = 2 * d if b == 0 else d
            out.append((f"up_{i}_block_{b}", t, cin, d, cin != d, b != 0))
        prev = d
    return out


def sandwich_geometries(vcfg, mel_t: int):
    """(name, T, C, uses per vocode) of every sandwich of the generator."""
    ch, t, out = vcfg.upsample_initial_channel, mel_t, []
    per_stage = sum(2 * len(d) for d in vcfg.resblock_dilation_sizes)
    for i, r in enumerate(vcfg.upsample_rates):
        ch, t = ch // 2, t * r
        out.append((f"stage_{i}", t, ch, per_stage))
    out.append(("activation_post", t, ch, 1))
    return out


# ---------------------------------------------------------------- timing

class Timer:
    """Per-launch CUDA-event timing with the L2 cache flushed before each
    launch, as the real caller finds it (a forward reads ~270 MB of weights,
    a vocode streams activations far larger than the 50 MB L2). After the
    flush the card spins for SPIN_CYCLES (~1 ms) while the host enqueues the
    start event and fn's launches, so the events time the device's work and
    not the host's launch latency (tens of microseconds a wrapper call, more
    than many of these kernels take)."""

    SPIN_CYCLES = 2_000_000

    def __init__(self, device, reps: int = 10):
        self.reps = reps
        self.flush = torch.empty(64 << 20, dtype=torch.int32, device=device)

    def ms(self, fn) -> float:
        fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(self.reps):
            self.flush.zero_()
            torch.cuda._sleep(self.SPIN_CYCLES)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            total += a.elapsed_time(b)
        return total / self.reps


def bound_ms(nbytes: float, ops: float, peak_ops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / peak_ops * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def max_abs(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def check_close(name: str, got, want, tol) -> float:
    err = max_abs(got, want)
    ok = torch.allclose(got.float(), want.float(), **tol)
    need(ok, f"{name}: kernel disagrees with its plain version "
             f"(max abs err {err:.3e}, tolerance {tol})")
    return err


def check_same_bits(name: str, fn, first) -> None:
    """A second launch on the same inputs gives the first one's bits: the
    K-split kernels sum in a fixed rank order, never with atomics."""
    again = fn()
    first = first if isinstance(first, tuple) else (first,)
    again = again if isinstance(again, tuple) else (again,)
    for a, b in zip(first, again):
        if a is not None:
            need(torch.equal(a, b), f"{name}: two launches on the same inputs differ")


# ---------------------------------------------------------------- phase 3

def random_chain(gen, b, t, cin, cout, has_skip, device):
    def n(*shape, scale=1.0):
        return torch.randn(shape, generator=gen) * scale

    w = rb.ResblockWeights.from_jax(
        1 + n(cin, scale=0.1), n(cin, scale=0.1),
        n(3, cin, cout, scale=(3 * cin) ** -0.5), n(cout, scale=0.1),
        1 + n(cout, scale=0.1), n(cout, scale=0.1),
        n(3, cout, cout, scale=(3 * cout) ** -0.5), n(cout, scale=0.1),
        n(cin, cout, scale=cin ** -0.5) if has_skip else None,
        n(cout, scale=0.1) if has_skip else None,
        groups1=default_num_groups(cin), groups2=default_num_groups(cout),
        dtype=torch.bfloat16, device=device)
    x = n(b, t, cin).to(device, torch.bfloat16)
    film = (n(b, cout, scale=0.2).to(device), n(b, cout, scale=0.2).to(device))
    return w, x, film


def conv_cost(a, cout, cin2, out_dtype, residual, split):
    b, t, cin = a.shape
    e = a.element_size()
    eo = 4 if out_dtype == torch.float32 else 2
    nbytes = (b * t * cin * e + cout * 3 * cin * 2 + 4 * (2 * cin + cout + 2 * b * cout)
              + b * t * cout * eo)
    if cin2:
        nbytes += b * t * cin2 * 2 + cout * cin2 * 2 + 4 * cout
        if split:
            nbytes += b * t * cout * 2
    if residual:
        nbytes += b * t * cout * 2
    return nbytes, 2.0 * b * t * cout * (3 * cin + cin2)


def gn_stats_library(x, groups: int):
    """One PyTorch reduction for the same statistics, plus the rsqrt on its
    (B, G) result."""
    b, t, c = x.shape
    var, mean = torch.var_mean(x.float().view(b, t, groups, c // groups), dim=(1, 3),
                               correction=0)
    return mean, torch.rsqrt(var + rb.GN_EPS)


def phase_resblock(timer, device, gen, rows: int, mel_t: int = MEL_T):
    mc = ModelConfig()
    per = {k: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, err=0.0,
                   ops=0.0, nbytes=0.0) for k in ("gn_stats", "conv3_fused")}
    # the device time of a launch that does nothing: the floor of each small launch
    floor_ms = timer.ms(lambda: rb.empty_kernel(device))
    rows_out = []
    for name, t, cin, cout, has_skip, add_res in resblock_geometries(mc, mel_t):
        w, x, (fs, fh) = random_chain(gen, rows, t, cin, cout, has_skip, device)
        got = rb.fused_resblock_chain(x, w, fs, fh, add_residual=add_res)
        want = rb.resblock_chain_plain(x, w, fs, fh, add_residual=add_res)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        chain_err = max(check_close(f"{name} chain", g, p, TOL["chain"])
                        for g, p in zip(got, want))

        # each launch on the same inputs as its plain version
        film = (fs, fh)
        m1, r1 = rb.gn_stats(x, w.groups1)
        pm1, pr1 = rb.gn_stats_plain(x, w.groups1)
        err_gn = max(check_close(f"{name} gn1 mean", m1, pm1, TOL["gn_stats"]),
                     check_close(f"{name} gn1 rstd", r1, pr1, TOL["gn_stats"]))
        check_same_bits(f"{name} gn1", lambda: rb.gn_stats(x, w.groups1), (m1, r1))
        c1 = dict(film=film, out_dtype=torch.float32)
        args1 = (x, m1, r1, w.gn1_scale, w.gn1_bias, w.conv1_w, w.conv1_b)
        f = rb.conv3_fused(*args1, **c1)
        err_conv = check_close(f"{name} conv1", f, rb.conv3_fused_plain(*args1, **c1),
                               TOL["conv3_fused"])
        check_same_bits(f"{name} conv1", lambda: rb.conv3_fused(*args1, **c1), f)
        m2, r2 = rb.gn_stats(f, w.groups2)
        pm2, pr2 = rb.gn_stats_plain(f, w.groups2)
        err_gn = max(err_gn, check_close(f"{name} gn2 mean", m2, pm2, TOL["gn_stats"]),
                     check_close(f"{name} gn2 rstd", r2, pr2, TOL["gn_stats"]))
        check_same_bits(f"{name} gn2", lambda: rb.gn_stats(f, w.groups2), (m2, r2))
        c2 = dict(out_dtype=torch.bfloat16)
        if has_skip:
            c2.update(skip=(x, w.skip_w, w.skip_b), split_skip=not add_res)
        elif add_res:
            c2.update(residual=x)
        args2 = (f, m2, r2, w.gn2_scale, w.gn2_bias, w.conv2_w, w.conv2_b)
        o2 = rb.conv3_fused(*args2, **c2)
        check_same_bits(f"{name} conv2", lambda: rb.conv3_fused(*args2, **c2), o2)
        p2 = rb.conv3_fused_plain(*args2, **c2)
        o2 = o2 if isinstance(o2, tuple) else (o2,)
        p2 = p2 if isinstance(p2, tuple) else (p2,)
        err_conv = max([err_conv] + [check_close(f"{name} conv2", g, p, TOL["conv3_fused"])
                                     for g, p in zip(o2, p2)])

        # times of the four launches, their plain versions, cuDNN's conv3
        xc = x.transpose(1, 2).contiguous()
        fc = f.to(torch.bfloat16).transpose(1, 2).contiguous()
        cw1 = w.conv1_w.view(cout, 3, cin).transpose(1, 2).contiguous()
        cw2 = w.conv2_w.view(cout, 3, cout).transpose(1, 2).contiguous()
        b1, b2 = w.conv1_b.to(torch.bfloat16), w.conv2_b.to(torch.bfloat16)
        g = {
            "gn1": timer.ms(lambda: rb.gn_stats(x, w.groups1)),
            "gn1_plain": timer.ms(lambda: rb.gn_stats_plain(x, w.groups1)),
            "gn1_library": timer.ms(lambda: gn_stats_library(x, w.groups1)),
            "gn2": timer.ms(lambda: rb.gn_stats(f, w.groups2)),
            "gn2_plain": timer.ms(lambda: rb.gn_stats_plain(f, w.groups2)),
            "gn2_library": timer.ms(lambda: gn_stats_library(f, w.groups2)),
            "conv1": timer.ms(lambda: rb.conv3_fused(*args1, **c1)),
            "conv1_plain": timer.ms(lambda: rb.conv3_fused_plain(*args1, **c1)),
            "conv1_library": timer.ms(lambda: F.conv1d(xc, cw1, b1, padding=1)),
            "conv2": timer.ms(lambda: rb.conv3_fused(*args2, **c2)),
            "conv2_plain": timer.ms(lambda: rb.conv3_fused_plain(*args2, **c2)),
            "conv2_library": timer.ms(lambda: F.conv1d(fc, cw2, b2, padding=1)),
        }
        gn_bytes = [x.numel() * 2 + 8 * rows * w.groups1, f.numel() * 4 + 8 * rows * w.groups2]
        gn_ops = [3.0 * x.numel(), 3.0 * f.numel()]
        cb1 = conv_cost(x, cout, 0, torch.float32, False, False)
        cb2 = conv_cost(f, cout, cin if has_skip else 0, torch.bfloat16,
                        add_res and not has_skip, has_skip and not add_res)
        g["gn1_bound"], g["gn2_bound"] = (bound_ms(nb, op, PEAK_FP32)[0]
                                          for nb, op in zip(gn_bytes, gn_ops))
        g["conv1_bound"], g["conv2_bound"] = (bound_ms(*cb, PEAK_BF16)[0] for cb in (cb1, cb2))
        g["gn_bound_ms"] = g["gn1_bound"] + g["gn2_bound"]
        g["conv_bound_ms"] = g["conv1_bound"] + g["conv2_bound"]
        g["conv_bound_by"] = [bound_ms(*cb1, PEAK_BF16)[1], bound_ms(*cb2, PEAK_BF16)[1]]
        k = per["gn_stats"]
        k["ms"] += g["gn1"] + g["gn2"]
        k["plain_ms"] += g["gn1_plain"] + g["gn2_plain"]
        k["library_ms"] += g["gn1_library"] + g["gn2_library"]
        k["bound_ms"] += g["gn_bound_ms"]
        k["err"] = max(k["err"], err_gn)
        k["ops"] += sum(gn_ops)
        k["nbytes"] += sum(gn_bytes)
        k = per["conv3_fused"]
        k["ms"] += g["conv1"] + g["conv2"]
        k["plain_ms"] += g["conv1_plain"] + g["conv2_plain"]
        k["library_ms"] += g["conv1_library"] + g["conv2_library"]
        k["bound_ms"] += g["conv_bound_ms"]
        k["err"] = max(k["err"], err_conv)
        k["ops"] += cb1[1] + cb2[1]
        k["nbytes"] += cb1[0] + cb2[0]
        g.update(name=name, T=t, cin=cin, cout=cout, skip=has_skip, add_residual=add_res,
                 chain_err=chain_err, gn_err=err_gn, conv_err=err_conv,
                 conv_tflops=(cb1[1] + cb2[1]) / (g["conv1"] + g["conv2"]) / 1e9)
        rows_out.append(g)
        log(f"[resblock] rows={rows} {name:14s} T={t:4d} {cin:4d}->{cout:4d} "
            f"skip={int(has_skip)} res={int(add_res)} | err chain {chain_err:.2e} gn "
            f"{err_gn:.2e} conv {err_conv:.2e} | ms gn {g['gn1'] + g['gn2']:.4f} (plain "
            f"{g['gn1_plain'] + g['gn2_plain']:.4f}, var_mean "
            f"{g['gn1_library'] + g['gn2_library']:.4f}, bound {g['gn_bound_ms']:.4f}, splits "
            f"{rb.gn_stats_plan(rows, t, cin, w.groups1, 2)}/"
            f"{rb.gn_stats_plan(rows, t, cout, w.groups2, 4)}) conv {g['conv1'] + g['conv2']:.4f} "
            f"(plain {g['conv1_plain'] + g['conv2_plain']:.4f}, F.conv1d "
            f"{g['conv1_library'] + g['conv2_library']:.4f}, bound "
            f"{g['conv_bound_ms']:.4f}) {g['conv_tflops']:.1f} TFLOP/s")
        if cin == 2 * cout == 2 * mc.base_dim * mc.dim_mults[-1]:
            # the geometry the TPU runs as the split pair _half1/_half2
            for half, (gn, cv) in (("half1", ("gn1", "conv1")), ("half2", ("gn2", "conv2"))):
                log(f"[resblock]   rows={rows} {name} as {half}: gn_stats {g[gn]:.4f} ms "
                    f"(plain {g[gn + '_plain']:.4f}, var_mean {g[gn + '_library']:.4f}, "
                    f"bound {g[gn + '_bound']:.4f}) + conv3_fused "
                    f"{g[cv]:.4f} ms (plain {g[cv + '_plain']:.4f}, F.conv1d "
                    f"{g[cv + '_library']:.4f}, bound {g[cv + '_bound']:.4f})")
    for k in ("gn_stats", "conv3_fused"):
        per[k]["bound_by"] = ("operations" if per[k]["ops"] / (PEAK_BF16 if k == "conv3_fused"
                              else PEAK_FP32) > per[k]["nbytes"] / PEAK_BYTES else "bytes")
    k = per["gn_stats"]
    n = 2 * len(rows_out)
    k["floor_ms"] = floor_ms
    log(f"[resblock] rows={rows} T={mel_t} sums over the {n} GroupNorms: gn_stats {k['ms']:.4f} ms "
        f"({k['ms'] / n * 1e3:.2f} us a launch; plain {k['plain_ms']:.4f}, var_mean "
        f"{k['library_ms']:.4f}, bound {k['bound_ms']:.4f}); an empty kernel "
        f"{floor_ms * 1e3:.2f} us a launch ({n} of them {n * floor_ms:.4f} ms)")
    k = per["conv3_fused"]
    log(f"[resblock] rows={rows} T={mel_t} sums over the 30 convs: conv3_fused {k['ms']:.4f} ms "
        f"({k['ops'] / k['ms'] / 1e9:.1f} TFLOP/s, {k['bound_ms'] / k['ms']:.1%} of its bound "
        f"{k['bound_ms']:.4f}), F.conv1d {k['library_ms']:.4f} ms, plain {k['plain_ms']:.4f} ms")
    return per, rows_out


def attention_sites(mc: ModelConfig, mel_t: int):
    """(name, T, C) of the cross-attention sites of ``UNet1DUltimate`` at
    mel length ``mel_t``; the keys are always the ``mel_t`` condition frames."""
    return [(name, t, cout) for name, t, _, cout, _, add_res in resblock_geometries(mc, mel_t)
            if not add_res]


def v1_attention_sites(mc: ModelConfig, mel_t: int):
    """(name, T, C) of the v1 UNet's 7 ``ResBlockV1`` s (every one attends) at
    mel length ``mel_t``: the down blocks at the stage's input width, the
    stride-2 downsample (k4, p1) halving T, the mid block, and the up
    blocks at the upsampled width plus the skip's, at the skip's length."""
    dims = [mc.base_dim * m for m in mc.dim_mults]
    prev, t, out, skips = mc.base_dim, mel_t, [], []
    for i, dim in enumerate(dims):
        out.append((f"down_{i}_res", t, prev))
        skips.append((t, prev))
        t, prev = (t + 2 - 4) // 2 + 1, dim
    out.append(("mid_res", t, prev))
    for i, dim in enumerate(reversed(dims)):
        t, skip_c = skips.pop()
        prev = dim + skip_c
        out.append((f"up_{i}_res", t, prev))
    return out


def sm_clock_hz() -> float:
    """The card's maximum SM clock (``nvidia-smi``), in Hz."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                       capture_output=True, text=True, timeout=60)
    need(r.returncode == 0, f"nvidia-smi failed: {r.stderr.strip()}")
    return float(r.stdout.strip().splitlines()[0]) * 1e6


def phase_attention(timer, device, gen):
    """The attention kernel against its plain version and SDPA at every
    geometry of the fused route, and two launches against each other for the
    same bits (the split-KV combine sums in rank order): the flagship's, base
    widths 48's and 96's (head dims 6 to 48: windows over rows whose heads
    are off the 16-byte unit, tiles padded past hd) and v1's at its defaults
    (head dims 32 to 192; 192 in two blocks a head). Returns per-forward
    sums keyed by route (``6s_b2``, two clips' conditioned rows, is the main
    path's 4-row forward) and per-geometry rows. Beside the bound (bytes or
    tensor operations, ``bound_ms``) each line prints the exponential floor:
    one exp2 per score on the MUFU at the card's maximum clock. An exp2 done
    as an FMA polynomial bypasses the MUFU, so that floor is not a hard one
    and ``bound_ms`` leaves it out."""
    mc = ModelConfig()
    heads = mc.attn_heads
    cache, rows_out = {}, []
    clock = sm_clock_hz()
    sms = torch.cuda.get_device_properties(device).multi_processor_count

    def one(b, t, s, c):
        key = (b, t, s, c)
        if key in cache:
            return cache[key]
        hd = c // heads

        def make(n):  # heads split off channels-last projections, as the model does
            return (torch.randn((b, n, c), generator=gen).to(device, torch.bfloat16)
                    .view(b, n, heads, hd).transpose(1, 2))

        q, k, v = make(t), make(s), make(s)
        name = f"attention B={b} T={t} S={s} hd={hd}"
        got = att.attention_core(q, k, v)
        err = check_close(name, got, att.attention_core_plain(q, k, v), TOL["attention"])
        check_same_bits(name, lambda: att.attention_core(q, k, v), got)
        plan = att.attention_plan(b, heads, t, s, hd)
        g = dict(B=b, T=t, S=s, hd=hd, err=err, bn=plan.bn, stages=plan.stages, split=plan.split,
                 replaces=("_attention_kernel" if s <= att.STREAMING_S_THRESHOLD
                           else "_flash_kernel"),
                 ms=timer.ms(lambda: att.attention_core(q, k, v)),
                 plain_ms=timer.ms(lambda: att.attention_core_plain(q, k, v)),
                 library_ms=timer.ms(lambda: F.scaled_dot_product_attention(q, k, v)))
        # q, k, v read once and the output written once, bf16
        g["nbytes"] = 2.0 * b * heads * hd * (2 * t + 2 * s)
        g["ops"] = 4.0 * b * heads * t * s * hd
        g["bound_ms"], g["bound_by"] = bound_ms(g["nbytes"], g["ops"], PEAK_BF16)
        g["exps"] = float(b * heads * t * s)
        g["exp_floor_ms"] = g["exps"] / (sms * MUFU_PER_CLOCK * clock) * 1e3
        g["tflops"] = g["ops"] / g["ms"] / 1e9
        log(f"[attention] B={b:2d} T={t:5d} S={s:5d} hd={hd:3d} ({g['replaces']}; bn "
            f"{plan.bn}, {plan.stages} stages, split {plan.split}) | err {err:.2e}, same bits "
            f"twice | ms {g['ms']:.4f} (plain {g['plain_ms']:.4f}, SDPA "
            f"{g['library_ms']:.4f}, bound {g['bound_ms']:.4f} {g['bound_by']}, exp2 floor "
            f"{g['exp_floor_ms']:.4f} at {clock / 1e6:.0f} MHz) {g['tflops']:.1f} TFLOP/s")
        rows_out.append(g)
        del q, k, v
        cache[key] = g
        return g

    # host time of one call (wrapper, plan lookup, three tensor-map encodes,
    # launch), the smallest geometry so the card never holds the host back
    q1 = torch.zeros((1, heads, 1, 32), device=device, dtype=torch.bfloat16)
    att.attention_core(q1, q1, q1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        att.attention_core(q1, q1, q1)
    host_us = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    log(f"[attention] host time per attention_core call (tensor maps encoded per call): "
        f"{host_us:.1f} us")
    rows_out.append(dict(host_us_per_call=host_us))
    sums = {}
    # route -> conditioned rows (the CFG doubles each), mel length, sites: the
    # flagship's; the head dims of base widths 48 and 96 (6, 12, 24, 48); v1
    # at its default widths (head dims 32 to 192)
    v1_sites = v1_attention_sites(ModelConfig(arch="v1"), MEL_T)
    routes = [("6s_b1", 1, MEL_T, attention_sites(mc, MEL_T)),
              ("6s_b2", N_CLIPS, MEL_T, attention_sites(mc, MEL_T)),
              ("6s_b16", WINDOW_ROWS, MEL_T, attention_sites(mc, MEL_T)),
              ("150s_b1", 1, LONG_T, attention_sites(mc, LONG_T)),
              ("base48_6s_b2", N_CLIPS, MEL_T, attention_sites(ModelConfig(base_dim=48), MEL_T)),
              ("base96_6s_b2", N_CLIPS, MEL_T, attention_sites(ModelConfig(base_dim=96), MEL_T)),
              ("v1_6s_b2", N_CLIPS, MEL_T, v1_sites), ("v1_6s_b16", WINDOW_ROWS, MEL_T, v1_sites)]
    for route, b, mel_t, sites in routes:
        k = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, ops=0.0, nbytes=0.0,
                 exp_floor_ms=0.0, err=0.0, launches=0)
        per_hd = {}
        # per site and branch: the conditioned rows, then the CFG constant at T=S=1
        for _, t, c in sites:
            for g in (one(b, t, mel_t, c), one(1, 1, 1, c)):
                h = per_hd.setdefault(g["hd"], dict.fromkeys(
                    ("ms", "library_ms", "bound_ms", "exp_floor_ms", "ops"), 0.0))
                for f in ("ms", "plain_ms", "bound_ms", "library_ms", "ops", "nbytes",
                          "exp_floor_ms"):
                    k[f] += 2 * g[f]
                    if f in h:
                        h[f] += 2 * g[f]
                k["err"] = max(k["err"], g["err"])
                k["launches"] += 2
        k["bound_by"] = ("operations" if k["ops"] / PEAK_BF16 > k["nbytes"] / PEAK_BYTES
                         else "bytes")
        k["per_hd"] = per_hd
        sums[route] = k
        log(f"[attention] one {route} forward ({k['launches']} launches): ms {k['ms']:.4f} "
            f"(plain {k['plain_ms']:.4f}, SDPA {k['library_ms']:.4f}, bound "
            f"{k['bound_ms']:.4f} {k['bound_by']}, exp2 floor {k['exp_floor_ms']:.4f}); by hd: "
            + "; ".join(f"hd {hd} {h['ms']:.4f} ms, {h['ops'] / h['ms'] / 1e9:.1f} TFLOP/s "
                        f"(SDPA {h['library_ms']:.4f}, bound {h['bound_ms']:.4f}, exp2 floor "
                        f"{h['exp_floor_ms']:.4f})" for hd, h in sorted(per_hd.items())))
    return sums, rows_out


def activation1d(x, alpha, beta):
    """BigVGAN's own PyTorch form of the anti-aliased SnakeBeta
    (``alias_free_torch`` ``Activation1d``: ``UpSample1d(2, 12)``, snake,
    ``DownSample1d(2, 12)``) on channels-first ``(B, C, T)``: replicate pad,
    a grouped ``conv_transpose1d``, the snake, replicate pad, a grouped
    ``conv1d`` — several PyTorch calls, so it is a yardstick of the sandwich
    and not its ``library_ms``. The port never calls it."""
    c, k = x.shape[1], sw.TAPS
    alpha, beta = alpha.to(x.dtype), beta.to(x.dtype)  # the module's dtype, as in BigVGAN
    f = torch.tensor(kaiser_sinc_filter1d(0.25, 0.3, k), device=x.device, dtype=x.dtype)
    f = f.view(1, 1, k).expand(c, 1, k)
    pad = k // 2 - 1  # UpSample1d: pad 5, crop 15 a side
    crop = pad * 2 + (k - 2) // 2
    y = 2 * F.conv_transpose1d(F.pad(x, (pad, pad), mode="replicate"), f, stride=2, groups=c)
    y = y[..., crop:-crop]
    y = y + (1.0 / (beta + 1e-9)).view(1, c, 1) * torch.sin(y * alpha.view(1, c, 1)) ** 2
    return F.conv1d(F.pad(y, (k // 2 - 1, k // 2), mode="replicate"), f, stride=2, groups=c)


def profile_vocode(voc, mel, label: str = ""):
    """One vocode under torch.profiler: device time by group (the sandwich
    kernel, ``aten::conv1d``, ``aten::conv_transpose1d``, and the rest:
    elementwise, copies and casts), the device's busy share of the wall
    time, the kernels launched and among them the elementwise ``exp``s."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    voc.mel_to_wav(mel)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        voc.mel_to_wav(mel)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    avg = prof.key_averages()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in avg
            if e.device_type == DeviceType.CUDA]
    busy = sum(r[1] for r in rows)
    op_ms = {e.key: e.device_time_total / 1e3 for e in avg if e.device_type == DeviceType.CPU}
    groups = {"sandwich": sum(ms for k, ms, _ in rows if "sandwich" in k),
              "conv": op_ms.get("aten::conv1d", 0.0),
              "transposed conv": op_ms.get("aten::conv_transpose1d", 0.0)}
    groups["elementwise and other"] = busy - sum(groups.values())
    launches = sum(n for *_, n in rows)
    exps = sum(n for k, _, n in rows if "exp" in k.lower() and "sandwich" not in k)
    log(f"[vocode] profiled vocode{label}: wall {wall_ms:.3f} ms, device kernels {busy:.4f} ms, "
        f"busy share {busy / wall_ms:.3f}, {launches} launches ({exps} elementwise exp); by "
        "group (ms): " + ", ".join(f"{k} {v:.4f}" for k, v in groups.items()))
    for name, ms, n in sorted(rows, key=lambda r: -r[1])[:8]:
        log(f"[vocode]   {ms:9.4f} ms {n:5d}x  {name[:90]}")
    return dict(wall_ms=wall_ms, busy_ms=busy, groups=groups, launches=launches, exps=exps,
                kernels=[dict(name=r[0], ms=r[1], count=r[2]) for r in rows])


def phase_sandwich(timer, device, gen):
    """The sandwich kernel at the 7 geometries of a 516-frame vocode (bf16,
    channels-first views as the vocoder passes them, log-scale parameters
    raw as ``SnakeAlias`` passes them): against its plain version under
    ``TOL``, the output's layout, two launches for the same bits; timed
    against the plain version, its byte bound, the MUFU floor (two sines an
    output at 16 a clock per SM at the card's maximum clock), a device copy
    of the same bytes and BigVGAN's own ``Activation1d`` form. Then one
    profiled vocode."""
    vcfg = BIGVGAN_22KHZ_80BAND
    k = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=None, err=0.0, ops=0.0,
             nbytes=0.0, mufu_floor_ms=0.0, copy_ms=0.0, activation1d_ms=0.0)
    clock = sm_clock_hz()
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    rows_out = []
    for name, t, c, uses in sandwich_geometries(vcfg, MEL_T):
        # channels-first activations viewed as (B, T, C), as the vocoder passes them
        x = torch.randn((1, c, t), generator=gen).to(device, torch.bfloat16).transpose(1, 2)
        la = (0.3 * torch.randn(c, generator=gen)).to(device)
        lb = (0.3 * torch.randn(c, generator=gen)).to(device)
        run = lambda: sw.snake_sandwich(x, la, lb, logscale=True)  # noqa: E731
        got = run()
        err = check_close(f"sandwich {name}", got,
                          sw.snake_sandwich_plain(x, la, lb, logscale=True), TOL["snake_sandwich"])
        need(got.stride() == x.stride(), f"sandwich {name}: output layout changed")
        check_same_bits(f"sandwich {name}", run, got)
        plan = sw.sandwich_plan(1, t, c, x.dtype, x.stride())
        ms = timer.ms(run)
        plain = timer.ms(lambda: sw.snake_sandwich_plain(x, la, lb, logscale=True))
        z = torch.empty_like(x)
        copy_ms = timer.ms(lambda: z.copy_(x))
        xb, a, b = x.transpose(1, 2), la.exp(), lb.exp()
        act_ms = timer.ms(lambda: activation1d(xb, a, b))
        # x read once, z written once (bf16); 58 fp32 operations per output:
        # 2x6 up taps x2 phases (24), snake on both phases (10), 12 down taps (24)
        nbytes, ops = 4.0 * t * c + 8 * c + 48, 58.0 * t * c
        bnd, by = bound_ms(nbytes, ops, PEAK_FP32)
        mufu_ms = 2.0 * t * c / (sms * MUFU_PER_CLOCK * clock) * 1e3
        for f, v in (("ms", ms), ("plain_ms", plain), ("bound_ms", bnd), ("ops", ops),
                     ("nbytes", nbytes), ("mufu_floor_ms", mufu_ms), ("copy_ms", copy_ms),
                     ("activation1d_ms", act_ms)):
            k[f] += uses * v
        k["err"] = max(k["err"], err)
        rows_out.append(dict(name=name, T=t, C=c, uses=uses, ms=ms, plain_ms=plain,
                             bound_ms=bnd, bound_by=by, mufu_floor_ms=mufu_ms, copy_ms=copy_ms,
                             activation1d_ms=act_ms, err=err, plan=dataclasses.asdict(plan),
                             gbps=nbytes / ms / 1e6))
        log(f"[sandwich] {name:15s} T={t:6d} C={c:4d} x{uses:2d} | err {err:.2e}, same bits "
            f"twice | ms {ms:.4f} (plain {plain:.4f}, bound {bnd:.4f} {by}, MUFU floor "
            f"{mufu_ms:.4f} at {clock / 1e6:.0f} MHz, copy of the bytes {copy_ms:.4f}, "
            f"Activation1d {act_ms:.4f}) {nbytes / ms / 1e6:.0f} GB/s | plan {plan.warps} warps "
            f"x {plan.blocks} blocks, {plan.tiles} tiles a warp")
        del x, z, got
    k["bound_by"] = ("operations" if k["ops"] / PEAK_FP32 > k["nbytes"] / PEAK_BYTES
                     else "bytes")
    log(f"[sandwich] one {MEL_T}-frame vocode (109 launches): ms {k['ms']:.4f} (bound "
        f"{k['bound_ms']:.4f} {k['bound_by']}, MUFU floor {k['mufu_floor_ms']:.4f}, copies of "
        f"the same bytes {k['copy_ms']:.4f}, Activation1d {k['activation1d_ms']:.4f}, plain "
        f"{k['plain_ms']:.4f})")
    mel = np.random.default_rng(6).standard_normal((1, 80, MEL_T)).astype(np.float32)
    voc = Vocoder(device=device, seed=0)
    k["profile"] = profile_vocode(voc, mel)
    del voc
    return k, rows_out


# ---------------------------------------------------------------- phase 3d

def rel_l2_dev(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    n = float(b.norm())
    return float((a - b).norm()) / n if n > 0 else float(a.norm())


def check_rel(name: str, got, want, tol: float) -> float:
    need(got.shape == want.shape and got.dtype == want.dtype,
         f"{name}: {got.shape} {got.dtype} against {want.shape} {want.dtype}")
    need(bool(torch.isfinite(got.float()).all()), f"{name}: not finite")
    err = rel_l2_dev(got, want)
    need(err <= tol, f"{name}: kernel disagrees with its plain version (relative L2 "
                     f"{err:.3e}, tolerance {tol})")
    return err


def bwd_costs(b, t, cin, cout, skip, f_bytes=4):
    """Bytes (each input read once, each output written once) and operations
    of each backward kernel of one block, per kernel name: lists of calls.

    The convs' operations are the GEMM's multiply-adds, at the bf16 tensor
    peak. Their fp32 GroupNorm + SiLU prologue or epilogue (about 16
    operations per activation element, once each) runs on other units and
    at the fp32 peak takes at most 16 * 989 / (67 * 6 * C) of the GEMM's time
    (15% at C = 256), so the bound is the GEMM's and it is left out."""
    nt = rg.n_tiles(t)
    bt = b * t
    dg = [  # conv 2 (pre f fp32), conv 1 (pre x bf16); the bucket sums in head and tail pieces
        (bt * cout * 2 + cout * 3 * cout * 2 + bt * cout * f_bytes + bt * cout * 4
         + 4 * b * nt * cout * 4, 2.0 * bt * cout * 3 * cout),
        (bt * cout * 2 + cout * 3 * cin * 2 + bt * cin * 2 + bt * cin * 4 + 4 * b * nt * cin * 4,
         2.0 * bt * cin * 3 * cout)]
    wg = [(bt * cout * f_bytes + bt * cout * 2 + 3 * cout * cout * 4 + cout * 4,
           2.0 * 3 * cout * cout * bt),
          (bt * cin * 2 + bt * cout * 2 + 3 * cin * cout * 4, 2.0 * 3 * cin * cout * bt)]
    gn = [(bt * cout * (4 + f_bytes + 2 + 4) + 7 * b * nt * cout * 4, 12.0 * bt * cout),
          (bt * cin * (4 + 2 + 2) + 4 * b * nt * cin * 4, 10.0 * bt * cin)]
    if skip:
        dg.append((bt * cout * 2 + cin * cout * 2 + bt * cin * 4, 2.0 * bt * cin * cout))
        wg.append((bt * cin * 2 + bt * cout * 2 + cin * cout * 4 + cout * 4,
                   2.0 * cin * cout * bt))
        gn[1] = (gn[1][0] + bt * cin * 4, gn[1][1] + bt * cin)
    return {"conv3_dgrad": dg, "conv3_wgrad": wg, "gn_bwd": gn}


def library_chain(x, w, fs, fh, has_skip):
    """The same block chain from F.group_norm / F.conv1d (cuDNN), channels
    first, bf16, under autograd: (outputs, inputs to differentiate)."""
    cout, cin = w.conv1_w.shape[0], x.shape[-1]
    xc = x.transpose(1, 2).contiguous().requires_grad_()
    w1 = w.conv1_w.view(cout, 3, cin).transpose(1, 2).contiguous().requires_grad_()
    w2 = w.conv2_w.view(cout, 3, cout).transpose(1, 2).contiguous().requires_grad_()
    vecs = [v.clone().requires_grad_() for v in (w.gn1_scale, w.gn1_bias, w.gn2_scale, w.gn2_bias)]
    b1, b2 = (v.to(torch.bfloat16).requires_grad_() for v in (w.conv1_b, w.conv2_b))
    h = F.silu(F.group_norm(xc, w.groups1, vecs[0].to(torch.bfloat16), vecs[1].to(torch.bfloat16)))
    h = F.conv1d(h, w1, b1, padding=1)
    h = h * (1 + fs.to(torch.bfloat16)[:, :, None]) + fh.to(torch.bfloat16)[:, :, None]
    h = F.silu(F.group_norm(h, w.groups2, vecs[2].to(torch.bfloat16), vecs[3].to(torch.bfloat16)))
    h = F.conv1d(h, w2, b2, padding=1)
    ins = [xc, w1, w2, b1, b2, *vecs]
    outs = [h]
    if has_skip:
        sw = w.skip_w[:, :, None].contiguous().requires_grad_()
        outs.append(F.conv1d(xc, sw, None))
        ins.append(sw)
    return outs, ins


def phase_backward(timer, device, gen, rows: int = TRAIN_B, mel_t: int = MEL_T):
    """3d: the resblock backward kernels against their plain versions at all
    15 flagship block geometries; sums for the kernels line over the blocks
    the training gate routes (one train step's backward)."""
    mc = ModelConfig()
    names = ("conv3_dgrad", "conv3_wgrad", "gn_bwd")
    per = {k: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, err=0.0, ops=0.0,
                   nbytes=0.0, copy_ms=0.0) for k in names}
    plain = rg.PLAIN
    rows_out = []
    for name, t, cin, cout, has_skip, _ in resblock_geometries(mc, mel_t):
        gated = rg.resblock_train_fits(t, cin, cout, has_skip, 2)
        w, x, (fs, fh) = random_chain(gen, rows, t, cin, cout, has_skip, device)
        fwd_args = (x, fs, fh, w.gn1_scale, w.gn1_bias, w.conv1_w, w.conv1_b, w.gn2_scale,
                    w.gn2_bias, w.conv2_w, w.conv2_b, w.skip_w, w.skip_b, w.groups1, w.groups2)
        h, xs, saved = rg.chain_forward(*fwd_args)
        hp, xsp, savedp = rg.chain_forward(*fwd_args, k=plain)
        _, f, z1, mean1, rstd1, mean2, rstd2, sc = saved
        # the training forward against its plain version: conv 1's f and z1
        # (before FiLM: the FiLM-scale gradient reads it) as conv3_fused's
        # outputs; the statistics and outputs downstream of f at the chain's
        fwd = [("mean1", mean1, savedp[3], TOL["gn_stats"]),
               ("rstd1", rstd1, savedp[4], TOL["gn_stats"]),
               ("f", f, savedp[1], TOL["conv3_fused"]), ("z1", z1, savedp[2], TOL["conv3_fused"]),
               ("mean2", mean2, savedp[5], TOL["chain"]), ("rstd2", rstd2, savedp[6], TOL["chain"]),
               ("h", h, hp, TOL["chain"])] + ([("xs", xs, xsp, TOL["chain"])] if has_skip else [])
        fwd_err = {lbl: check_close(f"{name} train forward {lbl}", a, b, tol)
                   for lbl, a, b, tol in fwd}
        del h, xs, hp, xsp, savedp
        gh = torch.randn((rows, t, cout), generator=gen).to(device, torch.bfloat16)
        gx = torch.randn((rows, t, cout), generator=gen).to(device, torch.bfloat16) if has_skip else None
        a1 = dict(mean=mean1, rstd=rstd1, gamma=w.gn1_scale, beta=w.gn1_bias)
        a2 = dict(mean=mean2, rstd=rstd2, gamma=w.gn2_scale, beta=w.gn2_bias)
        d_y2, p2 = rg.conv3_dgrad_plain(gh, w.conv2_w, taps=3, pre=f, **a2)
        d_z1, _ = rg.gn_bwd_plain(d_y2, f, mean2, rstd2, w.gn2_scale, p2, film_scale=sc, z1=z1,
                                  out_dtype=torch.bfloat16)
        d_y1, p1 = rg.conv3_dgrad_plain(d_z1, w.conv1_w, taps=3, pre=x, **a1)
        extra = rg.conv3_dgrad_plain(gx, w.skip_w, taps=1)[0] if has_skip else None
        calls = {  # kernel name -> [(label, fn(kernel ns) -> outputs, tolerance keys)]
            "conv3_dgrad": [
                ("conv2", lambda k: k.dgrad(gh, w.conv2_w, taps=3, pre=f, **a2)),
                ("conv1", lambda k: k.dgrad(d_z1, w.conv1_w, taps=3, pre=x, **a1))]
            + ([("skip", lambda k: k.dgrad(gx, w.skip_w, taps=1))] if has_skip else []),
            "conv3_wgrad": [
                ("conv2", lambda k: k.wgrad(f, gh, taps=3, bias=True, **a2)),
                ("conv1", lambda k: k.wgrad(x, d_z1, taps=3, **a1))]
            + ([("skip", lambda k: k.wgrad(x, gx, taps=1, bias=True))] if has_skip else []),
            "gn_bwd": [
                ("gn2", lambda k: k.gn_bwd(d_y2, f, mean2, rstd2, w.gn2_scale, p2, film_scale=sc,
                                           z1=z1, out_dtype=torch.bfloat16)),
                ("gn1", lambda k: k.gn_bwd(d_y1, x, mean1, rstd1, w.gn1_scale, p1, extra=extra,
                                           out_dtype=torch.bfloat16))],
        }
        # one cuDNN / ATen call for the same function, channels first
        cf = lambda v: v.transpose(1, 2).contiguous()  # noqa: E731
        w1c = w.conv1_w.view(cout, 3, cin).transpose(1, 2).contiguous()
        w2c = w.conv2_w.view(cout, 3, cout).transpose(1, 2).contiguous()
        s2c = F.silu(F.group_norm(cf(f), w.groups2, w.gn2_scale, w.gn2_bias)).to(torch.bfloat16)
        s1c = F.silu(F.group_norm(cf(x).float(), w.groups1, w.gn1_scale, w.gn1_bias)).to(
            torch.bfloat16)
        ghc, dz1c, xc, fc, dy1c, dy2c = cf(gh), cf(d_z1), cf(x), cf(f), cf(d_y1), cf(d_y2)
        xcf = xc.float()
        gxc = cf(gx) if has_skip else None
        swc = w.skip_w[:, :, None].contiguous() if has_skip else None
        conv_bwd = torch.ops.aten.convolution_backward

        def cb(go, inp, wt, pad, mask):
            return conv_bwd(go, inp, wt, [wt.shape[0]], [1], [pad], [1], False, [0], 1, mask)

        library = {
            "conv3_dgrad": [lambda: cb(ghc, s2c, w2c, 1, [True, False, False]),
                            lambda: cb(dz1c, s1c, w1c, 1, [True, False, False])]
            + ([lambda: cb(gxc, xc, swc, 0, [True, False, False])] if has_skip else []),
            "conv3_wgrad": [lambda: cb(ghc, s2c, w2c, 1, [False, True, True]),
                            lambda: cb(dz1c, s1c, w1c, 1, [False, True, True])]
            + ([lambda: cb(gxc, xc, swc, 0, [False, True, True])] if has_skip else []),
            "gn_bwd": [
                lambda: torch.ops.aten.native_group_norm_backward(
                    dy2c, fc, mean2, rstd2, w.gn2_scale, rows, cout, t, w.groups2,
                    [True, True, True]),
                lambda: torch.ops.aten.native_group_norm_backward(
                    dy1c, xcf, mean1, rstd1, w.gn1_scale, rows, cin, t, w.groups1,
                    [True, True, True])],
        }
        costs = bwd_costs(rows, t, cin, cout, has_skip)
        g = dict(name=name, T=t, cin=cin, cout=cout, skip=has_skip, gated=gated,
                 forward_err=fwd_err)
        for kname in names:
            err = rel = 0.0
            for label, call in calls[kname]:
                tol = TOL_REL_L2[kname]
                outs_k, outs_p = call(rg.KERNELS), call(plain)
                if kname in ("conv3_wgrad", "conv3_dgrad", "gn_bwd"):
                    check_same_bits(f"{name} {kname} {label}", lambda c=call: c(rg.KERNELS),
                                    outs_k)
                for i, (a, b) in enumerate(zip(outs_k, outs_p)):
                    if b is None:
                        continue
                    if kname == "conv3_dgrad" and i == 1:  # the pieces split by M tile
                        a, b = rg.bucket_sums(a), rg.bucket_sums(b)
                    part = kname == "gn_bwd" and i == 1
                    rel = max(rel, check_rel(f"{name} {kname} {label}[{i}]", a, b,
                                             TOL_REL_L2["gn_bwd_partials"] if part else tol))
                    err = max(err, max_abs(a, b))
            ms = sum(timer.ms(lambda c=c: c(rg.KERNELS)) for _, c in calls[kname])
            copy_ms = 0.0
            if kname == "gn_bwd":  # a device copy of the same bytes, half read, half written
                for nbytes, _ in costs[kname]:
                    src = torch.empty(int(nbytes) // 8, device=device)
                    dst = torch.empty_like(src)
                    copy_ms += timer.ms(lambda: dst.copy_(src))
                del src, dst
            plain_ms = sum(timer.ms(lambda c=c: c(plain)) for _, c in calls[kname])
            lib_ms = sum(timer.ms(fn) for fn in library[kname])
            nb = sum(c[0] for c in costs[kname])
            ops = sum(c[1] for c in costs[kname])
            bnd = bound_ms(nb, ops, PEAK_FP32 if kname == "gn_bwd" else PEAK_BF16)[0]
            g[kname] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bnd, err=err,
                            rel_l2=rel, nbytes=nb, ops=ops, launches=len(calls[kname]),
                            copy_ms=copy_ms)
            k = per[kname]
            k["err"] = max(k["err"], err)
            k["rel_l2"] = max(k.get("rel_l2", 0.0), rel)
            for fld, v in (("ms", ms), ("library_ms", lib_ms), ("bound_ms", bnd), ("ops", ops)):
                k[f"all_{fld}"] = k.get(f"all_{fld}", 0.0) + v
            if gated:
                for fld, v in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                               ("bound_ms", bnd), ("ops", ops), ("nbytes", nb),
                               ("copy_ms", copy_ms)):
                    k[fld] += v
        # the whole block backward: kernels against plain, and against cuDNN autograd
        args = (saved, w.gn1_scale, w.gn1_bias, w.conv1_w, w.gn2_scale, w.gn2_bias, w.conv2_w,
                w.skip_w, gh, gx)
        got, want = rg.chain_backward(*args), rg.chain_backward(*args, k=plain)
        g["chain_err"] = max(check_rel(f"{name} block backward {n}", got[n], want[n],
                                       TOL_REL_L2["resblock_bwd"]) for n in want)
        outs, ins = library_chain(x, w, fs, fh, has_skip)
        grads_out = [gh.transpose(1, 2)] + ([gx.transpose(1, 2)] if has_skip else [])
        g["chain_ms"] = timer.ms(lambda: rg.chain_backward(*args))
        g["chain_library_ms"] = timer.ms(lambda: torch.autograd.grad(
            outs, ins, grads_out, retain_graph=True))
        del outs, ins
        rows_out.append(g)
        log(f"[backward] B={rows} {name:14s} T={t:4d} {cin:4d}->{cout:4d} skip={int(has_skip)} "
            f"gated={int(gated)} | forward max abs f {fwd_err['f']:.2e} z1 {fwd_err['z1']:.2e} "
            f"h {fwd_err['h']:.2e} | rel L2 dgrad {g['conv3_dgrad']['rel_l2']:.2e} wgrad "
            f"{g['conv3_wgrad']['rel_l2']:.2e} gn_bwd {g['gn_bwd']['rel_l2']:.2e} block "
            f"{g['chain_err']:.2e} | ms dgrad "
            f"{g['conv3_dgrad']['ms']:.4f} (plain {g['conv3_dgrad']['plain_ms']:.4f}, cuDNN "
            f"{g['conv3_dgrad']['library_ms']:.4f}, bound {g['conv3_dgrad']['bound_ms']:.4f}) wgrad "
            f"{g['conv3_wgrad']['ms']:.4f} (plain {g['conv3_wgrad']['plain_ms']:.4f}, cuDNN "
            f"{g['conv3_wgrad']['library_ms']:.4f}, bound {g['conv3_wgrad']['bound_ms']:.4f}) gn_bwd "
            f"{g['gn_bwd']['ms']:.4f} (plain {g['gn_bwd']['plain_ms']:.4f}, ATen "
            f"{g['gn_bwd']['library_ms']:.4f}, bound {g['gn_bwd']['bound_ms']:.4f}, a copy of "
            f"its bytes {g['gn_bwd']['copy_ms']:.4f}) | block "
            f"{g['chain_ms']:.4f} against cuDNN autograd {g['chain_library_ms']:.4f}")
    for kname in names:
        k = per[kname]
        peak = PEAK_FP32 if kname == "gn_bwd" else PEAK_BF16
        k["bound_by"] = "operations" if k["ops"] / peak > k["nbytes"] / PEAK_BYTES else "bytes"
        copy = f", a copy of its bytes {k['copy_ms']:.4f}" if kname == "gn_bwd" else ""
        log(f"[backward] B={rows} {kname} sums: the gated blocks {k['ms']:.4f} ms "
            f"({k['ops'] / k['ms'] / 1e9:.1f} TFLOP/s, {k['bound_ms'] / k['ms']:.1%} of its bound "
            f"{k['bound_ms']:.4f}; library {k['library_ms']:.4f}{copy}), all 15 blocks "
            f"{k['all_ms']:.4f} ms ({k['all_ops'] / k['all_ms'] / 1e9:.1f} TFLOP/s, bound "
            f"{k['all_bound_ms']:.4f}; library {k['all_library_ms']:.4f})")
    return per, rows_out


def flagship_leaves(device, state_dtype, seed):
    """(g, p, ema, m, v, n, prev_grad) for every parameter of the flagship
    denoiser and condition projection, random from ``seed``."""
    cfg = LM2AConfig()
    with torch.device("meta"):
        shapes = [p.shape for m in (build_denoiser(cfg.model), build_cond_projection(cfg.model))
                  for p in m.parameters()]
    gen = torch.Generator(device=device).manual_seed(seed)

    def r(shape, scale, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)

    return [(r(s, 1e-3), r(s, 0.05), r(s, 0.05), r(s, 1e-4, state_dtype), r(s, 1e-5, state_dtype),
             r(s, 1e-4, state_dtype).abs() * 1e-3, r(s, 1e-3, state_dtype)) for s in shapes]


def phase_adan(timer, device):
    """3d: adan_ema over the full flagship tree, 3 steps from step 0, fp32
    and bf16 state, against its plain version; times at fp32 state (the
    main path's) and bf16."""
    out = {}
    hp = dict(betas=(0.02, 0.08, 0.01), eps=1e-8)
    for name, sdt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        got = flagship_leaves(device, sdt, seed=11)
        want = [tuple(t.clone() for t in leaf) for leaf in got]
        n = sum(leaf[1].numel() for leaf in got)
        launcher = adan_op.AdanEma(grad_clip=1.0)
        err = 0.0
        for step in range(3):
            gnorm = adan_op.global_norm([leaf[0] for leaf in got])
            scal = adan_op.step_scalars(step, gnorm, 2e-4, betas=hp["betas"], weight_decay=1e-4,
                                        ema_decay=0.999, device=device)
            launcher(got, scal)
            for leaf in want:
                adan_op.adan_ema_plain(leaf, scal, clip=1.0, **hp)
            for a, b in zip(got, want):
                for x, y in zip(a[1:], b[1:]):
                    ok = torch.allclose(x.float(), y.float(), **TOL["adan_ema"])
                    e = max_abs(x, y)
                    need(ok, f"adan_ema ({name} state, step {step}): kernel disagrees with its "
                             f"plain version (max abs err {e:.3e}, tolerance {TOL['adan_ema']})")
                    err = max(err, e)
        ms = timer.ms(lambda: launcher(got, scal))
        plain_ms = timer.ms(lambda: [adan_op.adan_ema_plain(leaf, scal, clip=1.0, **hp)
                                     for leaf in want])
        se = 4 if sdt == torch.float32 else 2
        nbytes = n * (4 + 2 * 4 * 2 + 4 * 2 * se)  # g read; p, ema, 4 states read + written
        ops = 30.0 * n
        bnd, by = bound_ms(nbytes, ops, PEAK_FP32)
        out[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bnd, bound_by=by, err=err,
                         library_ms=None, numel=n, leaves=len(got), nbytes=nbytes)
        log(f"[adan] {len(got)} leaves, {n} elements, {name} state, 3 steps from step 0 | err "
            f"{err:.2e} | ms {ms:.4f} (plain {plain_ms:.4f}, bound {bnd:.4f} {by}, "
            f"{nbytes / ms / 1e6:.0f} GB/s)")
        del got, want
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- phase 4

def write_checkpoint(ckpt_dir: str, cfg: LM2AConfig, seed: int) -> str:
    """Random weights from ``seed`` written in the JAX checkpoint layout."""
    unet = random_init_(build_denoiser(cfg.model), seed)
    proj = random_init_(build_cond_projection(cfg.model), seed + 1)
    return save_checkpoint(ckpt_dir, 0, torch_params_to_jax(unet.state_dict(),
                                                            UNET_CONV_TRANSPOSE),
                           torch_params_to_jax(proj.state_dict()), cfg,
                           dataset_mean=FALLBACK_MEL_MEAN, dataset_std=FALLBACK_MEL_STD)


def write_clips(clip_dir: str, n: int, seed: int, mel_t: int = MEL_T,
                motion_t: int = MOTION_T):
    """``n`` synthetic clips in the npz schema: mel (80, mel_t), motion
    (motion_t, 234), lyrics (motion_t, 768)."""
    os.makedirs(clip_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        p = os.path.join(clip_dir, f"clip_{i:02d}.npz")
        save_sample(p, Sample(
            mel=(FALLBACK_MEL_MEAN + FALLBACK_MEL_STD * rng.standard_normal((80, mel_t))
                 ).astype(np.float32),
            motion=rng.standard_normal((motion_t, 234)).astype(np.float32),
            lyrics=rng.standard_normal((motion_t, 768)).astype(np.float32)))
        paths.append(p)
    return paths


# the seeded raw tree of phase 4i and tests/test_torch_data_pipeline.py:
# (year, song, seconds of audio, first SMPL frame); slices every 6 s, the
# last of a song shorter than 6 s where the audio ends first
RAW_SONGS = (("2019", "song_a", 20.5, 0), ("2019", "song_b", 31.0, 10),
             ("2020", "song_c", 40.0, 0))
# phase 4i: 30 slices of 6 s, 5 a song, every one full (a pack takes one
# mel length)
RAW_SONGS_SMOKE = tuple((year, f"{song}_{i}", 30.5, f0) for i in range(2)
                        for year, song, f0 in (("2019", "song_a", 0), ("2019", "song_b", 10),
                                               ("2020", "song_c", 0)))


def write_raw_tree(root: str, seed: int, songs=RAW_SONGS, sr: int = 22050, fps: int = 30):
    """A raw dataset tree ``root/<year>/<song>/{audio.wav, sliced.json,
    smplfull.json}`` from ``seed``: seeded-noise audio (16-bit PCM), lyric
    keys "m:ss" every 6 s (and one key that is not a time), SMPL annotations
    at ``fps`` (72 poses, Th, Rh) from the song's first frame, with a gap of
    frames missing in each song (held from the last frame) and, where the
    first frame is above 0, none before it (zero filled)."""
    rng = np.random.default_rng(seed)
    for year, song, seconds, first in songs:
        d = os.path.join(root, year, song)
        os.makedirs(d, exist_ok=True)
        n = int(seconds * sr)
        pcm = np.clip(0.3 * rng.standard_normal(n) * 32767.0, -32768, 32767).astype("<i2")
        with wave.open(os.path.join(d, "audio.wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(sr)
            w.writeframes(pcm.tobytes())
        words = ("dance", "night", "light", "move", "heart", "sky", "run", "fire")
        sliced = {f"{t // 60}:{t % 60:02d}": " ".join(rng.choice(words, size=4))
                  for t in range(0, int(seconds), 6)}
        sliced["intro"] = "la la"
        frames = int(seconds * fps)
        gap = range(frames // 3, frames // 3 + 25)
        smpl = {}
        for f in range(first, frames):
            if f in gap:
                continue
            smpl[str(f).zfill(6)] = {"annots": [{
                "poses": [rng.standard_normal(72).round(4).tolist()],
                "Th": [rng.standard_normal(3).round(4).tolist()],
                "Rh": [rng.standard_normal(3).round(4).tolist()]}]}
        with open(os.path.join(d, "sliced.json"), "w") as f:
            json.dump(sliced, f)
        with open(os.path.join(d, "smplfull.json"), "w") as f:
            json.dump(smpl, f)
    return root


def run_slice(ckpt: str, clip_dir: str, out_dir: str, device: str, ddim_steps: int,
              preset: str, guidance: float = 2.1):
    """``cli sample --all`` then ``cli towav`` over its outputs, as a user
    runs them; returns (generated npz paths, wav paths, sample s, towav s)."""
    t0 = time.perf_counter()
    cli_sample.main(["--all", "--npz_dir", clip_dir, "--ckpt", ckpt, "--out_dir", out_dir,
                     "--method", "ddim", "--ddim_steps", str(ddim_steps),
                     "--guidance", str(guidance), "--seed", "0", "--device", device])
    t1 = time.perf_counter()
    cli_towav.main(["--npz_dir", out_dir, "--preset", preset, "--seed", "0",
                    "--device", device])
    if device != "cpu":
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    gens = sorted(os.path.join(out_dir, f) for f in os.listdir(out_dir)
                  if f.endswith("_gen.npz"))
    wavs = [os.path.splitext(p)[0] + ".wav" for p in gens]
    return gens, wavs, t1 - t0, t2 - t1


def check_outputs(gens, wavs, n_clips: int, mel_t: int, hop: int):
    need(len(gens) == n_clips, f"expected {n_clips} generated clips, got {len(gens)}")
    for g, w in zip(gens, wavs):
        mel = np.load(g)["mel"]
        need(mel.shape == (80, mel_t) and np.isfinite(mel).all(),
             f"{g}: mel {mel.shape} not finite (80, {mel_t})")
        with wave.open(w) as f:
            n = f.getnframes()
        need(n == hop * mel_t, f"{w}: wav of {n} samples, expected {hop * mel_t}")


def check_mels(paths, mel_t: int):
    for g in paths:
        mel = np.load(g)["mel"]
        need(mel.shape == (80, mel_t) and np.isfinite(mel).all(),
             f"{g}: mel {mel.shape} not finite (80, {mel_t})")


def run_serve(ckpt: str, clips, out_dir: str, device: str, ddim_steps: int,
              guidance: float = 2.1, warmup_t: int = MEL_T):
    """``python -m lm2a_tpu_torch.cli serve`` (the dispatcher, in this
    process) answering ping, one clip, a list of two, one clip with ``wav``,
    a request without ``npz`` and quit. The launch counters are reset when
    the server starts reading requests, after its warm-up chain. Returns the
    replies and the launches."""
    reqs = [{"cmd": "ping", "id": "ping"},
            {"npz": clips[0], "id": "one"},
            {"npz": list(clips[:2]), "id": "two"},
            {"npz": clips[1], "id": "wav", "wav": True},
            {"id": "bad"},
            {"cmd": "quit", "id": "quit"}]
    return serve_requests(["--ckpt", ckpt, "--method", "ddim", "--ddim_steps", str(ddim_steps),
                           "--guidance", str(guidance), "--warmup_t", str(warmup_t),
                           "--out_dir", out_dir, "--device", device], reqs)


def serve_requests(args, reqs):
    """``cli serve <args>`` (the dispatcher, in this process) reading
    ``reqs`` as JSON lines; the launch counters are reset when the server
    starts reading them. Returns the replies and the launches."""

    class Requests:
        def __iter__(self):
            _build.reset_launches()
            return iter([json.dumps(r) + "\n" for r in reqs])

    argv = ["lm2a_tpu_torch.cli", "serve", *args]
    out = io.StringIO()
    saved = sys.argv, sys.stdin
    sys.argv, sys.stdin = argv, Requests()
    try:
        with contextlib.redirect_stdout(out):
            cli_main.main()
    finally:
        sys.argv, sys.stdin = saved
    return [json.loads(line) for line in out.getvalue().splitlines()], dict(_build.LAUNCHES)


def check_serve(replies, mel_t: int, hop: int):
    need([r.get("id") for r in replies] == ["ping", "one", "two", "wav", "bad", "quit"],
         f"serve replies out of order: {replies}")
    need([r["ok"] for r in replies] == [True, True, True, True, False, True],
         f"serve ok flags: {replies}")
    one, two, wav = replies[1:4]
    need(isinstance(two["out"], list) and len(two["out"]) == 2, f"list reply {two}")
    check_mels([one["out"], *two["out"], wav["out"]], mel_t)
    with wave.open(wav["wav"]) as f:
        need(f.getnframes() == hop * mel_t, f"{wav['wav']}: {f.getnframes()} samples")


# ---------------------------------------------------------------- phase 4d, 4e

TRAIN_ARGS = ["--batch_size", str(TRAIN_B), "--fused_resblock_grad", "--opt_backend", "pallas",
              "--no_tensorboard", "--log_interval", "1", "--seed", "0"]


def run_cli(argv) -> None:
    """``python -m lm2a_tpu_torch.cli <argv>``, through the dispatcher, in this process."""
    saved = sys.argv
    sys.argv = ["lm2a_tpu_torch.cli", *argv]
    try:
        cli_main.main()
    finally:
        sys.argv = saved


def train_launches_per_step(mc: ModelConfig, mel_t: int = MEL_T):
    """Kernel launches of one ``cli train`` step on the kernel route: the
    blocks the training gate routes run 4 forward launches each and 6
    backward (8 with a 1x1 skip); one adan_ema launch updates every leaf."""
    gated = [skip for _, t, cin, cout, skip, _ in resblock_geometries(mc, mel_t)
             if rg.resblock_train_fits(t, cin, cout, skip, 2)]
    n, ns = len(gated), sum(gated)
    return {"gn_stats": 2 * n, "conv3_fused": 2 * n, "conv3_dgrad": 2 * n + ns,
            "conv3_wgrad": 2 * n + ns, "gn_bwd": 2 * n, "adan_ema": 1}, n


def distill_launches_per_step(mc: ModelConfig, mel_t: int = MEL_T):
    """Kernel launches of one ``cli distill`` step: the student's, a train
    step's on the kernel route without the condition drop and dropout (the
    same launches), and the teacher's two serving forwards (guided or not),
    each ``gn_stats`` twice a block and once for ``out_gn`` and
    ``conv3_fused`` twice a block. With ``fused_attention`` (teacher and
    student alike), every attention core of the teacher's two forwards
    (guided ones take the doubled batch whole: no CFG constant) and of the
    student's forward launches the attention kernel: both branches of every
    site, three forwards a step."""
    per, _ = train_launches_per_step(mc, mel_t)
    n_blocks = len(resblock_geometries(mc, mel_t))
    per["gn_stats"] += 2 * (2 * n_blocks + 1)
    per["conv3_fused"] += 2 * 2 * n_blocks
    if mc.fused_attention:
        per["attention"] = 3 * 2 * len(attention_sites(mc, mel_t))
    return per


def npz_steps(path: str):
    with np.load(os.path.join(path, "state.npz")) as z:
        return int(z[".step"]), int(z[".opt_state.step"])


def run_train(work: str, mc: ModelConfig):
    """4d: ``cli pack`` then ``cli train`` (6 steps, a save every 4) and
    ``--resume`` (2 more), launch counters reset just before each run."""
    from lm2a_tpu_torch.training.checkpoint import list_checkpoints, load_metadata

    clip_dir, pack, save = (os.path.join(work, d) for d in ("train_clips", "pack", "run"))
    t0 = time.perf_counter()
    write_clips(clip_dir, TRAIN_CLIPS, seed=7)
    run_cli(["pack", "--npz_dir", clip_dir, "--out_dir", pack])
    prep_s = time.perf_counter() - t0
    per_step, n_gated = train_launches_per_step(mc)
    out = dict(prep_s=prep_s, launches_per_step=per_step, gated_blocks=n_gated)
    for label, extra, steps, ckpts in (
            ("train", ["--max_steps", "6", "--save_interval", "4"], 6, [5, 6]),
            ("resume", ["--max_steps", "8", "--save_interval", "4", "--resume"], 2, [5, 6, 8])):
        _build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_cli(["train", "--npz_dir", pack, "--save_dir", save, *TRAIN_ARGS, *extra])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        expected = {k: v * steps for k, v in per_step.items()}
        found = list_checkpoints(save)
        log(f"[train] cli {label}: {steps} steps, B={TRAIN_B}, T={MEL_T}, flagship, bf16, "
            f"--fused_resblock_grad --opt_backend pallas: {secs:.2f} s with set-up and saves; "
            f"checkpoints {found}; launches {launches} expected {expected}")
        need(launches == expected, f"cli {label}: launches {launches} != expected {expected}")
        need(found == ckpts, f"cli {label}: checkpoints {found} != {ckpts}")
        for step in ckpts:
            path = os.path.join(save, f"ckpt_step_{step}")
            meta = load_metadata(path)
            need(meta["epoch"] == 1 and meta["step"] == step and npz_steps(path) == (step, step),
                 f"{path}: epoch {meta['epoch']}, steps {npz_steps(path)}")
        out[label] = dict(seconds=secs, launches=launches, checkpoints=found)
    with open(os.path.join(save, "train_log.csv")) as f:
        rows = [r.split(",") for r in f.read().splitlines()[1:]]
    losses = {int(r[1]): float(r[2]) for r in rows if r[4] == ""}
    need(sorted(losses) == list(range(8)) and all(np.isfinite(v) for v in losses.values()),
         f"train losses {losses}")
    log(f"[train] losses by step {losses}")
    out.update(losses=losses, pack=pack, ckpt=os.path.join(save, "ckpt_step_8"))
    return out


def route_states(ckpt: str, device):
    """Kernel-route and plain-route train states restored from ``ckpt``,
    their train steps, and the dataset statistics."""
    from lm2a_tpu_torch.core.config import config_from_dict
    from lm2a_tpu_torch.diffusion.schedule import make_schedule
    from lm2a_tpu_torch.training.checkpoint import load_metadata, restore_checkpoint
    from lm2a_tpu_torch.training.train_step import init_train_state, make_train_step

    meta = load_metadata(ckpt)
    kcfg = config_from_dict(meta["config"])
    need(kcfg.model.fused_resblock_grad and kcfg.train.opt_backend == "pallas",
         f"{ckpt}: not a kernel-route run")
    pcfg = dataclasses.replace(
        kcfg, model=dataclasses.replace(kcfg.model, fused_resblock_grad=False),
        train=dataclasses.replace(kcfg.train, opt_backend="xla"))
    out = {}
    for route, cfg in (("kernel", kcfg), ("plain", pcfg)):
        state = init_train_state(cfg, 0, device)
        restore_checkpoint(ckpt, state)
        step = make_train_step(make_schedule(cfg.diffusion, device=device), cfg,
                               dataset_mean=meta["dataset_mean"], dataset_std=meta["dataset_std"])
        out[route] = (state, step)
    return out


def train_batch(pack: str, device):
    from lm2a_tpu_torch.data.dataset import PackedDataset

    ds = PackedDataset(pack)
    return {k: torch.from_numpy(v).to(device) for k, v in ds.gather(np.arange(TRAIN_B)).items()}


def snapshot(state):
    """The train state's step counters and tensors, cloned on the device."""
    from lm2a_tpu_torch.training.adan import STATE_KEYS

    return dict(step=state.step, opt_step=state.opt.step,
                params={k: p.detach().clone() for k, p in state.params().items()},
                ema={k: e.clone() for k, e in state.ema.items()},
                opt={n: {k: v.clone() for k, v in getattr(state.opt, n).items()}
                     for n in STATE_KEYS})


@torch.no_grad()
def restore(state, snap) -> None:
    """Put ``snap`` back in place (the optimizer kernel keeps its pointers)."""
    state.step, state.opt.step = snap["step"], snap["opt_step"]
    for k, p in state.params().items():
        p.copy_(snap["params"][k])
    for k, e in state.ema.items():
        e.copy_(snap["ema"][k])
    for n, leaves in snap["opt"].items():
        for k, v in getattr(state.opt, n).items():
            v.copy_(leaves[k])


def route_comparison(routes, batch, device, seeds=ROUTE_SEEDS, tol=ROUTE_TOL):
    """4e: one step on each route from the same state, batch and generator,
    once per generator seed (each from the state the routes hold on entry)."""
    snaps = {route: snapshot(state) for route, (state, _) in routes.items()}
    out = []
    for seed in seeds:
        res = {}
        for route, (state, step) in routes.items():
            restore(state, snaps[route])
            loss = step(state, batch, generator=torch.Generator(device=device).manual_seed(seed))
            res[route] = dict(loss=float(loss),
                              grads={k: p.grad.detach().clone()
                                     for k, p in state.params().items()},
                              params={k: p.detach().clone() for k, p in state.params().items()},
                              ema={k: e.clone() for k, e in state.ema.items()})
        k, p = res["kernel"], res["plain"]
        before, ema_before = snaps["plain"]["params"], snaps["plain"]["ema"]
        loss_rel = abs(k["loss"] - p["loss"]) / abs(p["loss"])
        gsum = float(torch.sqrt(sum(g.float().square().sum() for g in p["grads"].values())))
        worst, num, den = (0.0, ""), 0.0, 0.0
        sums = dict(step=[0.0, 0.0], ema=[0.0, 0.0])  # |kernel - plain|^2, |plain|^2
        for name, gp in p["grads"].items():
            gk = k["grads"][name]
            d = float((gk.float() - gp.float()).norm())
            n = float(gp.float().norm())
            need(d <= tol["leaf_rel_l2"] * n + tol["leaf_floor"] * gsum,
                 f"route comparison, seed {seed}: gradient {name} relative L2 "
                 f"{d / max(n, 1e-30):.3e} (|diff| {d:.3e}, |grad| {n:.3e}, whole gradient "
                 f"{gsum:.3e})")
            worst = max(worst, (d / max(n, 1e-30) if n > tol["leaf_floor"] * gsum else 0.0,
                                name))
            num, den = num + d * d, den + n * n
            # the parameters' step and the EMA's change, new minus old
            for key, new, old in (("step", "params", before), ("ema", "ema", ema_before)):
                dk, dp = k[new][name] - old[name], p[new][name] - old[name]
                sums[key][0] += float((dk - dp).square().sum())
                sums[key][1] += float(dp.square().sum())
        grad_rel = (num / den) ** 0.5
        step_rel, ema_rel = ((a / b) ** 0.5 for a, b in (sums["step"], sums["ema"]))
        log(f"[route] seed {seed}: one step from the resumed checkpoint, kernel route against "
            f"plain route on the card: loss {k['loss']:.6f} against {p['loss']:.6f} (relative "
            f"{loss_rel:.2e}, tolerance {tol['loss_rel']}); gradient relative L2 "
            f"{grad_rel:.3e} (tolerance {tol['grad_rel_l2']}), worst leaf {worst[0]:.3e} "
            f"({worst[1]}; tolerance {tol['leaf_rel_l2']}); step relative L2 {step_rel:.3e} "
            f"(tolerance {tol['step_rel_l2']}); EMA change relative L2 {ema_rel:.3e} "
            f"(tolerance {tol['ema_change_rel_l2']})")
        need(loss_rel <= tol["loss_rel"] and grad_rel <= tol["grad_rel_l2"]
             and step_rel <= tol["step_rel_l2"] and ema_rel <= tol["ema_change_rel_l2"],
             f"the kernel route and the plain route disagree (seed {seed})")
        out.append(dict(seed=seed, loss=(k["loss"], p["loss"]), loss_rel=loss_rel,
                        grad_rel_l2=grad_rel, worst_leaf=worst, step_rel_l2=step_rel,
                        ema_change_rel_l2=ema_rel))
        del res, k, p
    return out


def time_routes(routes, batch, device, steps: int = 3, rounds: int = 2):
    """ms per step of each route, in turns (kernel, plain, kernel, plain),
    after a warm-up step each; peak memory per route."""
    times = {r: [] for r in routes}
    peak = {}
    n = 0
    for r, (state, step) in routes.items():
        torch.cuda.reset_peak_memory_stats()
        step(state, batch, generator=torch.Generator(device=device).manual_seed(n))
        torch.cuda.synchronize()
        peak[r] = torch.cuda.max_memory_allocated()
        n += 1
    for _ in range(rounds):
        for r, (state, step) in routes.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                step(state, batch, generator=torch.Generator(device=device).manual_seed(n))
                n += 1
            torch.cuda.synchronize()
            times[r].append((time.perf_counter() - t0) / steps * 1e3)
    out = {}
    for r in routes:
        ms = float(np.mean(times[r]))
        out[r] = dict(ms_per_step=ms, rounds=times[r], clips_per_s=TRAIN_B / ms * 1e3,
                      peak_gib=peak[r] / 2 ** 30)
        log(f"[train] {r} route: {ms:.2f} ms per step (rounds {[round(v, 2) for v in times[r]]}), "
            f"{TRAIN_B / ms * 1e3:.1f} clips/s, peak memory {peak[r] / 2 ** 30:.2f} GiB "
            f"(B={TRAIN_B}, T={MEL_T}, flagship, bf16 compute, fp32 master weights)")
    return out


KERNEL_GROUPS = ("conv3_fused", "gn_stats", "conv3_dgrad", "conv3_wgrad", "gn_bwd", "adan_ema")


def profile_device(fn, steps: int):
    """``fn(i)`` for i < ``steps`` under torch.profiler: the wall ms, the device
    kernels by name (ms over all steps, count), their sum and their sums by
    group (the port's kernels, cuBLAS/cuDNN, the rest)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            fn(i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                  key=lambda r: -r[1])
    groups = dict.fromkeys(KERNEL_GROUPS + ("gemm/conv (cuBLAS, cuDNN)", "other"), 0.0)
    for name, ms, _ in rows:
        key = next((g for g in KERNEL_GROUPS if g in name), None)
        if key is None:
            low = name.lower()
            key = ("gemm/conv (cuBLAS, cuDNN)" if any(w in low for w in (
                "gemm", "cutlass", "conv", "wgrad", "dgrad", "xmma", "sm90", "cudnn"))
                else "other")
        groups[key] += ms
    return wall_ms, rows, sum(r[1] for r in rows), groups


def profile_train(state, step, batch, device, steps: int = 2):
    """Device kernel time by name over ``steps`` kernel-route train steps
    under torch.profiler, grouped, and the device's busy share."""
    step(state, batch, generator=torch.Generator(device=device).manual_seed(99))
    torch.cuda.synchronize()
    wall_ms, rows, busy, groups = profile_device(
        lambda i: step(state, batch, generator=torch.Generator(device=device).manual_seed(100 + i)),
        steps)
    log(f"[profile] {steps} train steps, kernel route, B={TRAIN_B}: wall {wall_ms:.2f} ms "
        f"({wall_ms / steps:.2f} ms/step), device kernels {busy:.2f} ms, busy share "
        f"{busy / wall_ms:.3f}; by group (ms per step): "
        + ", ".join(f"{k} {v / steps:.2f}" for k, v in groups.items()))
    for name, ms, n in rows[:12]:
        log(f"[profile]   {ms / steps:9.3f} ms/step {n // steps:6d}x  {name[:90]}")
    return dict(steps=steps, wall_ms=wall_ms, busy_ms=busy, groups=groups,
                kernels=[dict(name=r[0], ms=r[1], count=r[2]) for r in rows[:40]])


# ---------------------------------------------------------------- phase 4f

# two stages (the stage-1 teacher is the stage-0 student at guidance 1.0), K =
# 2 steps a call over the pack on the card, a save every 2 steps
DISTILL_STAGES = [100, 50]
DISTILL_ARGS = ["--start_steps", "100", "--student_steps", "50", "--steps_per_stage", "4",
                "--steps_per_call", "2", "--save_interval", "2", "--lr_decay", "cosine",
                "--batch_size", str(TRAIN_B), "--seed", "0"]
# (stage, steps done in it, global step) of each checkpoint of the run
DISTILL_CKPTS = {2: (0, 2, 2), 4: (0, 4, 4), 6: (1, 2, 6), 8: (1, 4, 8)}
DISTILL_LOSS_RE = re.compile(r"\[(\d+)\] step (\d+)/\d+ loss (\S+)")


class Tee(io.TextIOBase):
    """Writes to ``out`` and keeps a copy."""

    def __init__(self, out):
        self.out, self.kept = out, io.StringIO()

    def write(self, text):
        self.kept.write(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


@contextlib.contextmanager
def distill_calls(calls: list):
    """Record the rows and global steps of each K-step call ``cli distill``
    makes; the calls run as they would."""
    from lm2a_tpu_torch.training import distill

    real = distill.make_device_data_multistep_distill

    def make(*a, **kw):
        fn = real(*a, **kw)

        def multi(state, teacher, data, idx, seed, offsets):
            calls.append((idx.cpu().tolist(), list(offsets)))
            return fn(state, teacher, data, idx, seed, offsets)

        return multi

    distill.make_device_data_multistep_distill = make
    try:
        yield calls
    finally:
        distill.make_device_data_multistep_distill = real


def run_distill_cli(work: str, teacher: str, pack: str, mc: ModelConfig):
    """4f: ``cli distill`` (8 steps), then, with the run cut after stage 1's
    mid-stage save, ``--resume`` (2 steps); launch counters reset just
    before each run. Returns the per-run readings and the student's path."""
    from lm2a_tpu_torch.training import distill
    from lm2a_tpu_torch.training.checkpoint import list_checkpoints, load_metadata

    save = os.path.join(work, "run")
    per_step = distill_launches_per_step(mc)
    argv = ["distill", "--teacher", teacher, "--npz_dir", pack, "--save_dir", save,
            *DISTILL_ARGS]
    runs = dict(launches_per_step=per_step)
    for label, extra, steps in (("distill", [], 8), ("resume", ["--resume"], 2)):
        if label == "resume":  # the run as if cut after stage 1's mid-stage save
            shutil.rmtree(os.path.join(save, "ckpt_step_8"))
            os.remove(os.path.join(save, "ckpt_step_8.meta.json"))
        calls, tee = [], Tee(sys.stdout)
        _build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with distill_calls(calls), contextlib.redirect_stdout(tee):
            run_cli(argv + extra)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        expected = {k: v * steps for k, v in per_step.items()}
        text = tee.kept.getvalue()
        losses = [(int(a), int(b), float(c)) for a, b, c in DISTILL_LOSS_RE.findall(text)]
        found = list_checkpoints(save)
        log(f"[distill] cli {label}: {steps} steps, B={TRAIN_B}, T={MEL_T}, flagship, bf16, "
            f"stages {DISTILL_STAGES}, K=2 a call: {secs:.2f} s with set-up and saves; "
            f"checkpoints {found}; launches {launches} expected {expected}; losses "
            f"(stage steps, done, loss) {losses}")
        need(launches == expected, f"cli distill {label}: launches {launches} != {expected}")
        need(found == sorted(DISTILL_CKPTS), f"cli distill {label}: checkpoints {found}")
        need(len(losses) == steps // 2 and all(np.isfinite(v) for *_, v in losses),
             f"cli distill {label}: losses {losses}")
        runs[label] = dict(seconds=secs, launches=launches, losses=losses, calls=calls)
        if label == "distill":
            need(all(f"stage: student_steps={n}, 4 steps, teacher guidance {w}" in text
                     for n, w in zip(DISTILL_STAGES, (2.1, 1.0))), "cli distill: stage lines")
        else:
            point = f"resumed {os.path.join(save, 'ckpt_step_6')}: stage 1 step 2/4 (gstep 6)"
            need(point in text, f"cli distill --resume did not report {point!r}")
    first, resumed = runs["distill"]["calls"], runs["resume"]["calls"]
    stream = [idx.tolist() for idx in distill.index_stream(
        TRAIN_CLIPS, TRAIN_B, 0 + DISTILL_STAGES[1], 4, 2, done=2)]
    need(resumed == first[3:] and [c[0] for c in resumed] == stream and resumed[0][1] == [6, 7],
         f"cli distill --resume drew {resumed}, the cut run {first[3:]}")
    for step, (stage, done, gstep) in DISTILL_CKPTS.items():
        path = os.path.join(save, f"ckpt_step_{step}")
        meta = load_metadata(path)
        want = dict(stage_idx=stage, done_in_stage=done, gstep=gstep, stages=DISTILL_STAGES)
        need(meta["distill_progress"] == want and meta["step"] == step
             and npz_steps(path) == (step, step)
             and meta["distilled_steps"] == DISTILL_STAGES[stage]
             and meta["folded_guidance"] == 2.1 and meta["teacher"] == teacher,
             f"{path}: metadata {meta.get('distill_progress')}, step {meta['step']}")
    log(f"[distill] resume: stage 1, step 2/4, gstep 6 from ckpt_step_6; its call drew rows "
        f"{resumed[0][0]} at global steps {resumed[0][1]}, the cut run's last call; "
        f"checkpoints {sorted(DISTILL_CKPTS)} with distill_progress as expected")
    return runs, os.path.join(save, "ckpt_step_8")


def sample_student(ckpt: str, clip_dir: str, out_dir: str, n_blocks: int):
    """``cli sample --all`` of the student with no method, step or guidance
    flag: DDIM-50 at guidance 1.0, B-row forwards. A forward pre-hook on the
    denoiser counts the rows of each forward Python runs: the chain's first
    step (the capture's warm-up) and its capture; the other 48 steps replay
    the capture, which the launches count."""
    from lm2a_tpu_torch.core import graphs
    from lm2a_tpu_torch.models.unet1d import UNet1DUltimate

    rows = []

    def hook(module, args):
        if isinstance(module, UNet1DUltimate):
            rows.append(int(args[0].shape[0]))

    handle = torch.nn.modules.module.register_module_forward_pre_hook(hook)
    _build.reset_launches()
    captures = graphs.captures
    t0 = time.perf_counter()
    try:
        cli_sample.main(["--all", "--npz_dir", clip_dir, "--ckpt", ckpt, "--out_dir", out_dir,
                         "--seed", "0", "--device", "cuda"])
    finally:
        handle.remove()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    gens = sorted(os.path.join(out_dir, f) for f in os.listdir(out_dir) if f.endswith("_gen.npz"))
    need(len(gens) == N_CLIPS, f"student sample wrote {gens}")
    check_mels(gens, MEL_T)
    expected = {"gn_stats": (2 * n_blocks + 1) * 50, "conv3_fused": 2 * n_blocks * 50}
    captures = graphs.captures - captures
    log(f"[distill] cli sample of the student, no flags, {N_CLIPS} clips: {secs:.2f} s; "
        f"{len(rows)} forwards of {sorted(set(rows))} rows run by Python and {captures} CUDA "
        f"graph capture (DDIM-50 at guidance 1.0: the first step and the capture of 50 "
        f"forwards of {N_CLIPS} rows, the rest replays); launches {launches} expected {expected}")
    need(rows == [N_CLIPS] * 2 and captures == 1,
         f"student sample: forwards of {rows} rows, {captures} captures")
    need(launches == expected, f"student sample: launches {launches} != {expected}")
    return dict(seconds=secs, forwards=len(rows), rows=N_CLIPS, launches=launches)


def time_distill(ckpt: str, pack: str, device, smi: str, steps: int = 3):
    """One distill step of stage 0 (guidance 2.1: 2B-row teacher forwards),
    the student and the teacher copies of ``ckpt``'s EMA: wall ms a step and
    peak memory, then torch.profiler windows of two steps, of the teacher's
    two forwards alone and of one update alone; the student's forward and
    backward are the step's device time less those two."""
    from lm2a_tpu_torch.core.config import config_from_dict
    from lm2a_tpu_torch.diffusion.gaussian import guided_eps
    from lm2a_tpu_torch.diffusion.schedule import make_schedule
    from lm2a_tpu_torch.training import distill
    from lm2a_tpu_torch.training.checkpoint import load_ema, load_metadata
    from lm2a_tpu_torch.training.train_step import (
        init_train_state, make_optimizer, step_generator,
    )

    meta = load_metadata(ckpt)
    tcfg = config_from_dict(meta["config"])  # the optimizer of cli distill
    cfg = dataclasses.replace(tcfg, train=dataclasses.replace(tcfg.train, weight_decay=0.0,
                                                              opt_backend="pallas"))
    optimizer = make_optimizer(cfg)
    state = init_train_state(cfg, 0, device, optimizer)
    ema = load_ema(ckpt, state)
    distill.start_student(state, ema)
    teacher = distill.build_teacher(cfg, ema)
    del ema
    step = distill.make_distill_step(
        make_schedule(cfg.diffusion, device=device), cfg, optimizer, DISTILL_STAGES[0],
        dataset_mean=meta["dataset_mean"], dataset_std=meta["dataset_std"],
        guidance_weight=2.1, loss_space="eps")
    batch = train_batch(pack, device)

    def one(i):
        return step(state, teacher, batch, generator=step_generator(0, 100 + i, device))

    torch.cuda.reset_peak_memory_stats()
    one(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        one(1 + i)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / steps * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    gen = torch.Generator(device=device).manual_seed(7)
    x = torch.randn((TRAIN_B, MEL_T, cfg.model.in_dim), generator=gen, device=device)
    t = torch.randint(0, cfg.diffusion.timesteps, (TRAIN_B,), generator=gen, device=device)
    with torch.no_grad():
        cond = teacher.cond_proj(batch["motion"], batch["lyrics"])

    @torch.no_grad()
    def teacher_forwards(i):
        for _ in range(2):
            guided_eps(teacher.unet, x, t, *cond, 2.1)

    def update(i):
        params = state.params()
        optimizer.update(params, {k: p.grad for k, p in params.items()}, state.ema, state.opt)

    windows = {}
    for name, fn in (("step", one), ("teacher", teacher_forwards), ("update", update)):
        fn(0)
        torch.cuda.synchronize()
        windows[name] = profile_device(fn, 2)
    s_wall, rows, busy, groups = windows["step"]
    teacher_ms, update_ms = windows["teacher"][2] / 2, windows["update"][2] / 2
    split = dict(teacher_forwards=teacher_ms, update=update_ms,
                 student_forward_backward=busy / 2 - teacher_ms - update_ms)
    log(f"[distill] {smi}: one distill step, stage 0 (teacher guidance 2.1, {2 * TRAIN_B}-row "
        f"teacher forwards, B={TRAIN_B}, T={MEL_T}, flagship, bf16): {wall:.2f} ms a step "
        f"(mean of {steps} after one warm-up), peak memory {peak:.2f} GiB; profiled two "
        f"steps: wall {s_wall / 2:.2f} ms a step, device kernels {busy / 2:.2f} ms, busy share "
        f"{busy / s_wall:.3f}; device ms a step: teacher's two forwards {teacher_ms:.2f} "
        f"(profiled alone), update {update_ms:.2f} (alone), student forward and backward "
        f"{split['student_forward_backward']:.2f} (the rest); by group: "
        + ", ".join(f"{k} {v / 2:.2f}" for k, v in groups.items()))
    for name, ms, n in rows[:12]:
        log(f"[distill]   {ms / 2:9.3f} ms/step {n // 2:6d}x  {name[:90]}")
    return dict(ms_per_step=wall, peak_gib=peak, profiled_wall_ms=s_wall / 2,
                busy_ms=busy / 2, busy_share=busy / s_wall, split_ms=split,
                groups={k: v / 2 for k, v in groups.items()},
                kernels=[dict(name=r[0], ms=r[1] / 2, count=r[2] // 2) for r in rows[:40]])


def fused_copy(ckpt: str, dst: str) -> str:
    """A copy of checkpoint ``ckpt`` whose config sets ``fused_attention``."""
    shutil.copytree(ckpt, dst)
    with open(ckpt + ".meta.json") as f:
        meta = json.load(f)
    meta["config"]["model"]["fused_attention"] = True
    with open(dst + ".meta.json", "w") as f:
        json.dump(meta, f)
    return dst


def run_fused_teacher_distill(work: str, teacher: str, pack: str, mc: ModelConfig):
    """4f: ``cli distill`` from 4d's checkpoint with ``fused_attention`` set
    in its config (teacher and student on the attention kernel), one step a
    stage (100 -> 50) at K = 1: the launches of every kernel per step
    exactly, finite losses."""
    fused = fused_copy(teacher, os.path.join(work, "fused_teacher", "ckpt_step_8"))
    fmc = dataclasses.replace(mc, fused_attention=True)
    per_step = distill_launches_per_step(fmc)
    tee = Tee(sys.stdout)
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        run_cli(["distill", "--teacher", fused, "--npz_dir", pack, "--save_dir",
                 os.path.join(work, "fused_run"), "--start_steps", "100", "--student_steps", "50",
                 "--steps_per_stage", "1", "--steps_per_call", "1", "--save_interval", "1000",
                 "--batch_size", str(TRAIN_B), "--seed", "0"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    expected = {k: 2 * v for k, v in per_step.items()}
    losses = [float(c) for *_, c in DISTILL_LOSS_RE.findall(tee.kept.getvalue())]
    log(f"[distill] fused_attention teacher: cli distill, one step a stage (100 -> 50, K=1, "
        f"B={TRAIN_B}, flagship, bf16) {secs:.2f} s with set-up; launches {launches} expected "
        f"{expected}; losses {losses}")
    need(launches == expected, f"fused-teacher distill: launches {launches} != {expected}")
    need(len(losses) == 2 and all(np.isfinite(v) for v in losses),
         f"fused-teacher distill losses {losses}")
    return dict(seconds=secs, launches=launches, losses=losses)


def run_distill(work: str, teacher: str, pack: str, mc: ModelConfig, clip_dir: str,
                n_blocks: int, smi: str, device):
    """4f: the distill run and its resume, the student sampled, a step timed,
    and two steps from a ``fused_attention`` teacher."""
    t0 = time.perf_counter()
    runs, student = run_distill_cli(work, teacher, pack, mc)
    runs["fused_teacher"] = run_fused_teacher_distill(work, teacher, pack, mc)
    runs["sample"] = sample_student(student, clip_dir, os.path.join(work, "out"), n_blocks)
    runs["timing"] = time_distill(student, pack, device, smi)
    runs["seconds"] = time.perf_counter() - t0
    log(f"[distill] phase 4f: {runs['seconds']:.1f} s in all (cli distill "
        f"{runs['distill']['seconds']:.2f} s, --resume {runs['resume']['seconds']:.2f} s)")
    return runs


# ---------------------------------------------------------------- compiled steps

# ---------------------------------------------------------------- phase 4h

VAL_STEPS = 1000  # cli val's default: the reference's DDPM-1000 protocol
QUALITY_CLIPS, QUALITY_STEPS, QUALITY_EPOCHS = 4, 50, 2
BASE32_DDIM = 10


def _launch_delta(before: dict) -> dict:
    now = dict(_build.LAUNCHES)
    return {k: v - before.get(k, 0) for k, v in now.items() if v - before.get(k, 0)}


def _read_metrics_txt(path: str) -> dict:
    """``k: v`` lines of an assessment's txt after its header, as floats."""
    out = {}
    with open(path) as f:
        for line in f.read().splitlines():
            k, sep, v = line.partition(": ")
            if sep and k not in ("sample", "samples", "random", "seed"):
                try:
                    out[k] = float(v)
                except ValueError:
                    pass
    return out


def run_val(ckpt: str, clip_dir: str, out_dir: str, n_blocks: int):
    """4h: ``cli val --max_samples 2`` (DDPM-1000, guidance 2.1 resolved for
    an undistilled checkpoint) over the smoke's clips: every forward on the
    kernels (31 ``gn_stats``, 30 ``conv3_fused``), the averages file, and
    each clip's metrics file equal to ``compute_metrics`` of the npz it
    wrote against its clip."""
    from lm2a_tpu_torch.data.schema import load_sample, normalize_mel_layout
    from lm2a_tpu_torch.eval.mel_metrics import compute_metrics

    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_cli(["val", "--ckpt", ckpt, "--npz_dir", clip_dir, "--out_dir", out_dir,
             "--max_samples", "2", "--device", "cuda"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    clips = sorted(f for f in os.listdir(clip_dir) if f.endswith(".npz"))
    expected = {"gn_stats": (2 * n_blocks + 1) * VAL_STEPS * len(clips),
                "conv3_fused": 2 * n_blocks * VAL_STEPS * len(clips)}
    need(launches == expected, f"cli val: launches {launches} != expected {expected}")
    avg_txt = open(os.path.join(out_dir, "average_metrics.txt")).read()
    need(f"samples: {len(clips)}" in avg_txt and "seed: 100" in avg_txt,
         f"cli val: averages file {avg_txt!r}")
    avg = _read_metrics_txt(os.path.join(out_dir, "average_metrics.txt"))
    per = {}
    for name in clips:
        base = os.path.splitext(name)[0]
        real = normalize_mel_layout(load_sample(os.path.join(clip_dir, name)).mel)
        gen = normalize_mel_layout(np.load(os.path.join(out_dir, f"{base}_gen_mel.npz"))["mel"])
        need(gen.shape == real.shape and np.isfinite(gen).all(), f"cli val: {base} mel")
        want = compute_metrics(real, gen)
        got = _read_metrics_txt(os.path.join(out_dir, f"{base}_metrics.txt"))
        need(got == want, f"cli val: {base} metrics {got} != compute_metrics {want}")
        per[base] = got
    need(set(avg) == set(next(iter(per.values()))) and all(np.isfinite(list(avg.values()))),
         f"cli val: averages {avg}")
    log(f"[eval] cli val --max_samples {len(clips)} (DDPM-{VAL_STEPS}, CFG 2.1, B=1, "
        f"T={MEL_T}, flagship, bf16): {secs:.2f} s, {secs / len(clips):.2f} s per clip with "
        f"load and metrics; launches {launches} expected {expected}; per-sample metrics equal "
        f"compute_metrics of the written npz; averages {avg}")
    return dict(seconds=secs, per_clip_s=secs / len(clips), launches=launches, averages=avg,
                per_sample=per)


def run_quality(work: str, pack: str, n_blocks: int):
    """4h: ``cli train`` for 2 epochs over 4d's pack with a validation pack,
    ``--quality_every_epochs 1 --quality_clips 4 --quality_steps 50``: two
    quality rows, finite, the second unlike the first (the EMA moved), each
    monitor run's launches those of 50 forwards."""
    import csv

    from lm2a_tpu_torch.training import quality

    val_clips, val_pack, save = (os.path.join(work, d) for d in ("val_clips", "val_pack", "run"))
    write_clips(val_clips, TRAIN_B, seed=11)
    run_cli(["pack", "--npz_dir", val_clips, "--out_dir", val_pack])
    runs = []
    real_run = quality.QualityMonitor.run

    def counted(self, x_init=None):
        before = dict(_build.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_run(self, x_init)
        torch.cuda.synchronize()
        runs.append(dict(seconds=time.perf_counter() - t0, launches=_launch_delta(before)))
        return out

    quality.QualityMonitor.run = counted
    try:
        t0 = time.perf_counter()
        run_cli(["train", "--npz_dir", pack, "--val_npz_dir", val_pack, "--save_dir", save,
                 *TRAIN_ARGS, "--epochs", str(QUALITY_EPOCHS), "--quality_every_epochs", "1",
                 "--quality_clips", str(QUALITY_CLIPS), "--quality_steps", str(QUALITY_STEPS)])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        quality.QualityMonitor.run = real_run
    with open(os.path.join(save, "quality_log.csv")) as f:
        rows = list(csv.reader(f))
    need(rows[0] == ["epoch", "step", "mse", "ssim", "avg_cos_sim", "mean_error", "std_error",
                     "snr"], f"quality_log.csv header {rows[0]}")
    need(len(rows) == 1 + QUALITY_EPOCHS, f"quality_log.csv rows {rows}")
    vals = [[float(v) for v in r[2:]] for r in rows[1:]]
    need(all(np.isfinite(v).all() for v in vals), f"quality rows not finite: {rows}")
    need(vals[0] != vals[1], f"the second epoch's quality row equals the first's: {rows}")
    per_run = {"gn_stats": (2 * n_blocks + 1) * QUALITY_STEPS,
               "conv3_fused": 2 * n_blocks * QUALITY_STEPS}
    for r in runs:
        need(r["launches"] == per_run, f"quality monitor launches {r['launches']} != {per_run}")
    need(len(runs) == QUALITY_EPOCHS, f"quality monitor ran {len(runs)} times")
    log(f"[eval] cli train {QUALITY_EPOCHS} epochs (B={TRAIN_B}, flagship, "
        f"--fused_resblock_grad --opt_backend pallas) with --quality_every_epochs 1 "
        f"(DDIM-{QUALITY_STEPS}, CFG 2.1 uncond_fast, {QUALITY_CLIPS} val clips, "
        f"{2 * QUALITY_CLIPS}-row forwards): {secs:.2f} s in all; monitor seconds per epoch "
        + ", ".join(f"{r['seconds']:.3f}" for r in runs)
        + f" (the first with its capture); launches per run {runs[0]['launches']} expected "
        f"{per_run}; quality rows {rows[1:]}")
    return dict(seconds=secs, runs=runs, rows=rows, train_log=os.path.join(save, "train_log.csv"))


def card_vs_host_steps(sides, batch, cfg, steps: int, tol, what: str, tag: str, desc: str,
                       gate_update: bool = True, seed: int = 77):
    """``steps`` train steps of ``sides`` ({"card": (state, step), "host":
    (state, step)}, the same state on both) on ``batch`` with the same
    injected draws: each step's loss, every gradient leaf and the whole
    gradient within ``tol`` (``ROUTE_TOL``), and with ``gate_update`` the
    parameters' step and the EMA's change too (else printed only)."""
    from lm2a_tpu_torch.training.train_step import Draws

    rows = batch["mel"].shape[0]
    gen = torch.Generator().manual_seed(seed)
    out = []
    for i in range(steps):
        draws = Draws(torch.randint(0, cfg.diffusion.timesteps, (rows,), generator=gen),
                      torch.randn(batch["mel"].shape, generator=gen), torch.ones((rows, 1, 1)))
        res = {}
        for label, (state, step) in sides.items():
            d = next(state.unet.parameters()).device
            # copies: on the host .float().cpu() of an fp32 tensor is the tensor itself
            before = {k: p.detach().to("cpu", torch.float32, copy=True)
                      for k, p in state.params().items()}
            ema_before = {k: e.to("cpu", torch.float32, copy=True) for k, e in state.ema.items()}
            t0 = time.perf_counter()
            loss = float(step(state, {k: v.to(d) for k, v in batch.items()}, draws=draws))
            res[label] = dict(
                loss=loss, seconds=time.perf_counter() - t0,
                grads={k: p.grad.detach().to("cpu", torch.float32, copy=True)
                       for k, p in state.params().items()},
                step={k: p.detach().to("cpu", torch.float32) - before[k]
                      for k, p in state.params().items()},
                ema={k: e.to("cpu", torch.float32) - ema_before[k] for k, e in state.ema.items()})
        c, h = res["card"], res["host"]
        loss_rel = abs(c["loss"] - h["loss"]) / abs(h["loss"])
        gsum = float(torch.sqrt(sum(g.square().sum() for g in h["grads"].values())))
        num = den = 0.0
        for name, gh in h["grads"].items():
            dd = float((c["grads"][name] - gh).norm())
            n = float(gh.norm())
            need(dd <= tol["leaf_rel_l2"] * n + tol["leaf_floor"] * gsum,
                 f"{what}, step {i}: gradient {name} card vs host {dd:.3e} of {n:.3e}")
            num, den = num + dd * dd, den + n * n
        grad_rel = (num / den) ** 0.5
        step_rel, ema_rel = (
            float(torch.sqrt(sum((c[key][k] - h[key][k]).square().sum() for k in h[key])
                             / sum(v.square().sum() for v in h[key].values())))
            for key in ("step", "ema"))
        log(f"{tag} step {i}: {desc}: loss {c['loss']:.6f} vs {h['loss']:.6f} (relative "
            f"{loss_rel:.2e}, tolerance {tol['loss_rel']}); gradient rel L2 {grad_rel:.3e} "
            f"({tol['grad_rel_l2']}); step rel L2 {step_rel:.3e} "
            + (f"({tol['step_rel_l2']})" if gate_update else "(not held)")
            + f"; EMA change rel L2 {ema_rel:.3e} "
            + (f"({tol['ema_change_rel_l2']})" if gate_update else "(not held)")
            + f"; host step {h['seconds']:.1f} s")
        need(loss_rel <= tol["loss_rel"] and grad_rel <= tol["grad_rel_l2"]
             and (not gate_update or (step_rel <= tol["step_rel_l2"]
                                      and ema_rel <= tol["ema_change_rel_l2"])),
             f"{what}: the card's step {i} disagrees with the host's")
        out.append(dict(loss=(c["loss"], h["loss"]), loss_rel=loss_rel, grad_rel_l2=grad_rel,
                        step_rel_l2=step_rel, ema_change_rel_l2=ema_rel))
        del res, c, h
    return out


def fused_opt0_steps(work: str, pack: str, ckpt: str, mc: ModelConfig, device,
                     rows: int = 4, steps: int = 2, tol=ROUTE_TOL):
    """4h: ``cli train --fused_opt 0 --opt_backend xla --fused_resblock_grad``
    for 2 steps (the gated blocks' kernels, no ``adan_ema``; the chained
    checkpoint layout), then 2 steps from 4d's resumed checkpoint in the
    chained form on the card (kernel blocks) and on the host CPU (plain
    versions), the same injected draws on ``rows`` rows: loss, gradient,
    step and EMA change within ``ROUTE_TOL`` at each step."""
    from lm2a_tpu_torch.core.config import config_from_dict
    from lm2a_tpu_torch.diffusion.schedule import make_schedule
    from lm2a_tpu_torch.training.checkpoint import load_metadata, load_state_arrays
    from lm2a_tpu_torch.training.train_step import init_train_state, make_train_step

    save = os.path.join(work, "fused_opt0")
    args = list(TRAIN_ARGS)
    args[args.index("--opt_backend") + 1] = "xla"
    per_step, _ = train_launches_per_step(mc)
    expected = {k: steps * v for k, v in per_step.items() if k != "adan_ema"}
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_cli(["train", "--npz_dir", pack, "--save_dir", save, *args, "--fused_opt", "0",
             "--max_steps", str(steps)])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    need(launches == expected, f"cli train --fused_opt 0: launches {launches} != {expected}")
    with np.load(os.path.join(save, f"ckpt_step_{steps}", "state.npz")) as z:
        need(int(z[".opt_state[1].step"]) == steps and ".opt_state.step" not in z.files,
             "cli train --fused_opt 0: not the chained checkpoint layout")

    meta = load_metadata(ckpt)
    base = config_from_dict(meta["config"])
    cfg = dataclasses.replace(base, train=dataclasses.replace(base.train, fused_opt=False,
                                                              opt_backend="xla"))
    host = torch.device("cpu")
    batch = {k: v[:rows] for k, v in train_batch(pack, host).items()}
    with np.load(os.path.join(ckpt, "state.npz")) as z:  # 4d's fused layout, chained here
        chained = {k.replace(".opt_state", ".opt_state[1]", 1): z[k] for k in z.files}
    sides = {}
    for label, d in (("card", device), ("host", host)):
        state = init_train_state(cfg, 0, d)
        load_state_arrays(state, chained)
        need(state.opt.chained, "the chained form's state")
        step = make_train_step(make_schedule(cfg.diffusion, device=d), cfg,
                               dataset_mean=meta["dataset_mean"], dataset_std=meta["dataset_std"])
        sides[label] = (state, step)
    out = card_vs_host_steps(
        sides, batch, cfg, steps, tol, "fused_opt 0", "[eval] fused_opt 0",
        f"card (kernel blocks, chained clip + Adan) vs host CPU (plain), {rows} rows, from "
        "4d's resumed checkpoint")
    log(f"[eval] cli train --fused_opt 0 --opt_backend xla --fused_resblock_grad, {steps} "
        f"steps: {cli_s:.2f} s with set-up; launches {launches} expected {expected}; "
        "checkpoint in the chained layout (.opt_state[1])")
    del sides
    return dict(cli_s=cli_s, launches=launches, steps=out)


def run_evaluate(work: str, clip_dir: str, val_out: str):
    """4h: ``cli towav`` of each clip's ground-truth and generated mel into
    ``sample_*/{gt,gen}.wav``, then ``cli evaluate --no-clap``: the JSON's
    keys those the JAX package's ``evaluate_all`` writes (NDB's where
    scikit-learn imports, its error otherwise, as there)."""
    import importlib.util

    src, root, results = (os.path.join(work, d) for d in ("eval_src", "evaluation", "results"))
    os.makedirs(src, exist_ok=True)
    clips = sorted(f for f in os.listdir(clip_dir) if f.endswith(".npz"))
    for i, name in enumerate(clips):
        base = os.path.splitext(name)[0]
        shutil.copy(os.path.join(clip_dir, name), os.path.join(src, f"s{i}_gt.npz"))
        shutil.copy(os.path.join(val_out, f"{base}_gen_mel.npz"), os.path.join(src, f"s{i}_gen.npz"))
    t0 = time.perf_counter()
    run_cli(["towav", "--npz_dir", src, "--device", "cuda"])
    towav_s = time.perf_counter() - t0
    for i in range(len(clips)):
        d = os.path.join(root, f"sample_{i:03d}")
        os.makedirs(d)
        for kind in ("gt", "gen"):
            shutil.move(os.path.join(src, f"s{i}_{kind}.wav"), os.path.join(d, f"{kind}.wav"))
    t0 = time.perf_counter()
    run_cli(["evaluate", "--eval-dir", root, "--output-dir", results, "--no-clap"])
    eval_s = time.perf_counter() - t0
    with open(os.path.join(results, "evaluation_results.json")) as f:
        res = json.load(f)
    sklearn = importlib.util.find_spec("sklearn") is not None
    md_keys = {"total_samples", "eval_dir", "acoustic_similarity_mean", "beat_precision_mean",
               "beat_recall_mean", "beat_error_mean", "fad_overall", "js_kl_overall", "beat_F1"}
    batch_keys = {"fad_overall", "ndb_overall", "js_kl_overall"}
    if sklearn:
        md_keys |= {"ndb_overall", "ndb_K"}
        batch_keys |= {"ndb_K"}
    else:
        batch_keys |= {"ndb_overall_error"}
    sample_keys = {"gt", "gen", "fad", "js_mean", "kl_mean", "ndb", "batch_only_note",
                   "acoustic_similarity", "cosine_similarity", "clap_note", "beat_f1",
                   "beat_precision", "beat_recall", "beat_error", "va_distance", "va_cosine",
                   "va_status"}
    need(set(res) == {"metadata", "batch_metrics", "per_sample_metrics"}
         and set(res["metadata"]) == md_keys and set(res["batch_metrics"]) == batch_keys
         and len(res["per_sample_metrics"]) == len(clips)
         and all(set(r) == sample_keys for r in res["per_sample_metrics"].values()),
         f"evaluation_results.json keys: {sorted(res['metadata'])} "
         f"{sorted(res['batch_metrics'])}")
    need(res["metadata"]["total_samples"] == len(clips)
         and np.isfinite(res["metadata"]["acoustic_similarity_mean"]),
         f"evaluation metadata {res['metadata']}")
    log(f"[eval] cli towav of {len(clips)} gt + {len(clips)} generated mels "
        f"(BIGVGAN_22KHZ_80BAND, seeded) {towav_s:.2f} s; cli evaluate --no-clap "
        f"{eval_s:.2f} s over {len(clips)} sample_*/{{gt,gen}}.wav pairs (host numpy/scipy; "
        f"scikit-learn {'present' if sklearn else 'absent: NDB records its error, as in the JAX package'}); "
        f"metadata {res['metadata']}")
    return dict(towav_s=towav_s, evaluate_s=eval_s, metadata=res["metadata"],
                batch_metrics=res["batch_metrics"], sklearn=sklearn)


def run_inspect(train_log: str):
    """4h: ``cli inspect_train_log`` on the quality run's log (no plot: the
    card's machine has no matplotlib)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run_cli(["inspect_train_log", train_log, "--head", "2"])
    text = buf.getvalue()
    need(re.search(r"^\d+ rows$", text, re.M) and "train loss: first=" in text,
         f"cli inspect_train_log: {text!r}")
    log("[eval] cli inspect_train_log: " + " | ".join(
        line for line in text.splitlines() if "rows" in line or "loss:" in line))
    return text


def sample_base32(work: str, clip_dir: str, device, rng):
    """4h: a base-32 ``fused_attention`` checkpoint (C/G 4 and 8, head dims
    4, 8 and 16) through ``cli sample`` with every block on ``gn_stats`` and
    ``conv3_fused`` and every attention core on the kernel, then one 4-row
    forward on the card against the host's plain versions."""
    cfg = LM2AConfig(model=ModelConfig(base_dim=32, fused_attention=True))
    ckpt = write_checkpoint(os.path.join(work, "ckpt_base32"), cfg, seed=2)
    n_blocks = len(resblock_geometries(cfg.model, MEL_T))
    n_sites = len(attention_sites(cfg.model, MEL_T))
    out = os.path.join(work, "out_base32")
    _build.reset_launches()
    t0 = time.perf_counter()
    cli_sample.main(["--all", "--npz_dir", clip_dir, "--ckpt", ckpt, "--out_dir", out,
                     "--method", "ddim", "--ddim_steps", str(BASE32_DDIM), "--guidance", "2.1",
                     "--seed", "0", "--device", "cuda"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    expected = {"gn_stats": (2 * n_blocks + 1) * BASE32_DDIM,
                "conv3_fused": 2 * n_blocks * BASE32_DDIM,
                "attention": 4 * n_sites * BASE32_DDIM}
    check_mels([os.path.join(out, f) for f in sorted(os.listdir(out)) if f.endswith("_gen.npz")],
               MEL_T)
    need(launches == expected, f"base 32: launches {launches} != expected {expected}")
    log(f"[eval] base-32 fused_attention checkpoint through cli sample (DDIM-{BASE32_DDIM}, "
        f"CFG 2.1, {MAIN_ROWS}-row forwards) {secs:.2f} s; launches {launches} expected "
        f"{expected}")
    err = unet_card_vs_host(load_models(ckpt, device=device), load_models(ckpt, device="cpu"),
                            rng, MAIN_ROWS, " at base width 32 (fused route)")
    return dict(seconds=secs, launches=launches, unet_rel_l2=err)


NARROW_BASES = (12, 16, 20, 32, 48, 96)
# a block at an odd width (Cin 21 -> Cout 42 with its skip; C/G 21): rows of
# 42 and 84 bytes, the masked forms' 2- and 4-byte accesses
ODD_BLOCKS = ((21, 42, True, False),)


def narrow_widths(device, gen, rows: int = MAIN_ROWS, t: int = MEL_T):
    """4h: the width rule on the card. Every distinct block of base widths
    12, 16, 20, 32, 48 and 96 (C/G 2 to 12; K chunks and N tiles narrower
    than 64; at 12 and 20 widths off the 8-channel unit: all through the
    kernels' masked forms) and an odd-width block (``ODD_BLOCKS``) through ``gn_stats`` +
    ``conv3_fused`` against the plain chain (max abs error,
    ``TOL["chain"]``) and through the backward kernels against their plain
    versions (relative L2, ``TOL_REL_L2["resblock_bwd"]``), and the
    attention kernel at head dims 2 and 4 (8 heads, the 6 s sites' shape)
    against its plain version (max abs, ``TOL["attention"]``)."""
    out = {}
    for base in NARROW_BASES + ("odd",):
        blocks = (list(ODD_BLOCKS) if base == "odd" else
                  sorted({g[2:] for g in resblock_geometries(ModelConfig(base_dim=base), t)}))
        fwd_err, bwd_rel = 0.0, 0.0
        for cin, cout, skip, add_res in blocks:
            w, x, (fs, fh) = random_chain(gen, rows, t, cin, cout, skip, device)
            got = rb.fused_resblock_chain(x, w, fs, fh, add_residual=add_res)
            want = rb.resblock_chain_plain(x, w, fs, fh, add_residual=add_res)
            for g, p in zip(got if isinstance(got, tuple) else (got,),
                            want if isinstance(want, tuple) else (want,)):
                fwd_err = max(fwd_err, check_close(f"narrow base {base} chain {cin}->{cout}",
                                                   g, p, TOL["chain"]))
            h, xs, saved = rg.chain_forward(x, fs, fh, w.gn1_scale, w.gn1_bias, w.conv1_w,
                                            w.conv1_b, w.gn2_scale, w.gn2_bias, w.conv2_w,
                                            w.conv2_b, w.skip_w, w.skip_b, w.groups1, w.groups2)
            gh = torch.randn(h.shape, generator=gen).to(device, torch.bfloat16)
            gx = torch.randn(h.shape, generator=gen).to(device, torch.bfloat16) if skip else None
            args = (saved, w.gn1_scale, w.gn1_bias, w.conv1_w, w.gn2_scale, w.gn2_bias,
                    w.conv2_w, w.skip_w, gh, gx)
            kern, plain = rg.chain_backward(*args), rg.chain_backward(*args, k=rg.PLAIN)
            for name, p in plain.items():
                r = rel_l2_dev(kern[name], p)
                need(bool(torch.isfinite(kern[name]).all()) and r <= TOL_REL_L2["resblock_bwd"],
                     f"narrow base {base} {cin}->{cout}: backward {name} rel L2 {r:.3e}")
                bwd_rel = max(bwd_rel, r)
        out[base] = dict(blocks=len(blocks), chain_max_abs=fwd_err, backward_rel_l2=bwd_rel)
        log(f"[narrow] base {base}: {len(blocks)} distinct blocks at {rows} rows, T={t}, bf16: "
            f"gn_stats + conv3_fused chain vs plain max abs {fwd_err:.3e} (tolerance "
            f"{TOL['chain']}); backward kernels vs plain, worst rel L2 {bwd_rel:.3e} "
            f"(tolerance {TOL_REL_L2['resblock_bwd']})")
    for hd in (2, 4):
        h = 8
        q, k, v = ((torch.randn((rows, n, h * hd), generator=gen).to(device, torch.bfloat16)
                    .view(rows, n, h, hd).transpose(1, 2)) for n in (t, t, t))
        err = check_close(f"attention hd {hd}", att.attention_core(q, k, v),
                          att.attention_core_plain(q, k, v), TOL["attention"])
        out[f"attention_hd{hd}"] = err
        log(f"[narrow] attention hd {hd}, {rows} rows x 8 heads, T=S={t}, bf16: kernel vs plain "
            f"max abs {err:.3e} (tolerance {TOL['attention']})")
    return out


def run_evaluation(work: str, ckpt: str, clip_dir: str, train: dict, mc: ModelConfig,
                   n_blocks: int, device, smi: str, rng):
    """4h: evaluation on the card (see the module docstring)."""
    t0 = time.perf_counter()
    out = dict(narrow=narrow_widths(device, torch.Generator().manual_seed(10)))
    out["val"] = run_val(ckpt, clip_dir, os.path.join(work, "val"), n_blocks)
    out["quality"] = run_quality(os.path.join(work, "quality"), train["pack"], n_blocks)
    out["inspect"] = run_inspect(out["quality"].pop("train_log"))
    torch.cuda.empty_cache()
    out["fused_opt0"] = fused_opt0_steps(work, train["pack"], train["ckpt"], mc, device)
    torch.cuda.empty_cache()
    out["evaluate"] = run_evaluate(work, clip_dir, os.path.join(work, "val"))
    out["base32"] = sample_base32(work, clip_dir, device, rng)
    out["seconds"] = time.perf_counter() - t0
    log(f"[eval] phase 4h: {out['seconds']:.1f} s in all | {smi}")
    return out


# ---------------------------------------------------------------- phase 4i

# the preprocessed log-mel on the card against the host's (cuFFT against the
# CPU's FFT, fp32, seeded-noise audio): the rule the CPU tests hold the
# port's mel to against the JAX package's
PREPROCESS_MEL_ATOL = 1e-4


def capture_cli(argv) -> str:
    """``run_cli(argv)`` with its standard output kept (and shown)."""
    tee = Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        run_cli(argv)
    return tee.kept.getvalue()


def compare_shards(a_dir: str, b_dir: str) -> float:
    """Two ``cli preprocess`` outputs: the same files, every shard key but
    ``mel`` the same bits, ``motion_stats.npz`` and ``sample_info_list.json``
    equal; returns the largest ``mel`` difference."""
    names = sorted(os.listdir(a_dir))
    need(names == sorted(os.listdir(b_dir)), f"preprocess outputs differ: {names}")
    worst = 0.0
    for name in names:
        a, b = os.path.join(a_dir, name), os.path.join(b_dir, name)
        if name.endswith(".json"):
            with open(a) as fa, open(b) as fb:
                need(json.load(fa) == json.load(fb), f"{name} differs")
            continue
        za, zb = np.load(a, allow_pickle=True), np.load(b, allow_pickle=True)
        need(za.files == zb.files, f"{name}: keys {za.files} != {zb.files}")
        for k in za.files:
            need(za[k].shape == zb[k].shape and za[k].dtype == zb[k].dtype, f"{name} {k}")
            if k == "mel":
                worst = max(worst, float(np.abs(za[k] - zb[k]).max()))
            else:
                need(np.array_equal(za[k], zb[k]), f"{name} {k}: not the same bits")
    return worst


def run_data_pipeline(work: str, mc: ModelConfig, smi: str):
    """4i: a seeded raw tree (``RAW_SONGS_SMOKE``, 30 slices of 6 s) through
    ``cli preprocess --lyrics_backend hashed`` on the card and with
    ``--device cpu`` (the shards compared), ``cli split``, ``cli
    inspect_npz``, ``cli pack`` of the train split, then 2 steps of flagship
    ``cli train --fused_resblock_grad --opt_backend pallas`` on that pack on
    the native gatherer (its first batch the numpy gatherer's bits), the
    launches per step exactly 4d's."""
    from lm2a_tpu_torch.data.dataset import BatchIterator, PackedDataset

    t_all = time.perf_counter()
    raw = write_raw_tree(os.path.join(work, "raw"), seed=11, songs=RAW_SONGS_SMOKE)
    minutes = sum(secs for _, _, secs, _ in RAW_SONGS_SMOKE) / 60
    secs, npz = {}, {}
    for dev in ("cuda", "cpu"):
        npz[dev] = os.path.join(work, f"npz_{dev}")
        t0 = time.perf_counter()
        text = capture_cli(["preprocess", "--root", raw, "--out", npz[dev], "--lyrics_backend",
                            "hashed", "--device", dev])
        torch.cuda.synchronize()
        secs[dev] = time.perf_counter() - t0
        need(f"wrote samples: {5 * len(RAW_SONGS_SMOKE)}" in text, f"cli preprocess: {text!r}")
    mel_err = compare_shards(npz["cuda"], npz["cpu"])
    log(f"[data] cli preprocess of {len(RAW_SONGS_SMOKE)} songs ({minutes:.2f} min of audio, "
        f"{5 * len(RAW_SONGS_SMOKE)} slices of 6 s, hashed lyrics): card {secs['cuda']:.2f} s "
        f"({secs['cuda'] / minutes:.2f} s a minute of audio), host CPU {secs['cpu']:.2f} s "
        f"({secs['cpu'] / minutes:.2f} s a minute); shards card vs host: every key but mel the "
        f"same bits, mel max abs {mel_err:.3e} (tolerance {PREPROCESS_MEL_ATOL}) | {smi}")
    need(mel_err <= PREPROCESS_MEL_ATOL, f"preprocess mel card vs host {mel_err:.3e}")
    split = os.path.join(work, "split")
    text = capture_cli(["split", "--npz_dir", npz["cuda"], "--out_dir", split])
    n_train = len([f for f in os.listdir(os.path.join(split, "train")) if f.endswith(".npz")])
    need(f"Train set: {n_train}" in text and n_train >= TRAIN_B, f"cli split: {text!r}")
    shard = os.path.join(split, "train", sorted(os.listdir(os.path.join(split, "train")))[0])
    text = capture_cli(["inspect_npz", shard])
    need(f"mel: shape=(80, {MEL_T})" in text and "motion: shape=(180, 234)" in text,
         f"cli inspect_npz: {text!r}")
    pack = os.path.join(work, "pack")
    run_cli(["pack", "--npz_dir", os.path.join(split, "train"), "--out_dir", pack])
    native, plain = PackedDataset(pack), PackedDataset(pack, use_native=False)
    need(native.gatherer == "native", f"the pack's gatherer is {native.gatherer}")
    first = [next(iter(BatchIterator(d, TRAIN_B, seed=0))) for d in (native, plain)]
    need(all(np.array_equal(first[0][k], first[1][k]) for k in first[1]),
         "the native gatherer's first batch is not the numpy gatherer's")
    del native, plain
    per_step, _ = train_launches_per_step(mc)
    _build.reset_launches()
    t0 = time.perf_counter()
    text = capture_cli(["train", "--npz_dir", pack, "--save_dir", os.path.join(work, "run"),
                        *TRAIN_ARGS, "--max_steps", "2", "--save_interval", "1000"])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    expected = {k: 2 * v for k, v in per_step.items()}
    log(f"[data] cli split {n_train} train shards, cli inspect_npz, cli pack; cli train 2 steps "
        f"(B={TRAIN_B}, flagship, --fused_resblock_grad --opt_backend pallas) on the pack "
        f"{train_s:.2f} s; gatherer: native (first batch the numpy gatherer's bits); launches "
        f"{launches} expected {expected}")
    need("batch gatherer: native" in text, "cli train did not gather with the native gatherer")
    need(launches == expected, f"pipeline train launches {launches} != {expected}")
    out = dict(minutes=minutes, preprocess_s=secs, mel_max_abs=mel_err, train_shards=n_train,
               train_s=train_s, launches=launches, seconds=time.perf_counter() - t_all)
    log(f"[data] phase 4i: {out['seconds']:.1f} s in all")
    return out


# ---------------------------------------------------------------- phase 4j

V1_ARGS = ["--arch", "v1", "--fused_attention"]


def v1_launches_per_step(mc: ModelConfig, mel_t: int = MEL_T):
    """Kernel launches of one ``cli train --arch v1 --fused_attention`` step:
    both branches of every block's attention core in the forward (the
    backward recomputes through the plain core), one ``adan_ema``; v1's
    convolutions and GroupNorms are plain PyTorch."""
    return {"attention": 2 * len(v1_attention_sites(mc, mel_t)), "adan_ema": 1}


def serve_one(ckpt: str, clip: str, out_dir: str, ddim_steps: int):
    """``cli serve`` (no warm-up) answering one request and quit; returns the
    request's reply and the launches."""
    replies, launches = serve_requests(
        ["--ckpt", ckpt, "--method", "ddim", "--ddim_steps", str(ddim_steps), "--guidance",
         "2.1", "--out_dir", out_dir, "--device", "cuda"],
        [{"npz": clip, "id": "one"}, {"cmd": "quit", "id": "quit"}])
    need([r.get("id") for r in replies] == ["one", "quit"] and replies[0]["ok"],
         f"v1 serve replies {replies}")
    check_mels([replies[0]["out"]], MEL_T)
    return replies[0], launches


def time_v1_step(ckpt: str, pack: str, device, calls: int = 4, windows: int = 5):
    """One v1 train step (B=16) as ``cli train`` runs it, a CUDA graph replay:
    ms per step (median of ``windows`` windows of ``calls``), clips/s, peak
    memory, and one replay's launches."""
    from lm2a_tpu_torch.core.config import config_from_dict
    from lm2a_tpu_torch.data.dataset import PackedDataset, upload_dataset
    from lm2a_tpu_torch.diffusion.schedule import make_schedule
    from lm2a_tpu_torch.training.checkpoint import load_metadata, restore_checkpoint
    from lm2a_tpu_torch.training.train_step import StepRunner, init_train_state, make_train_step

    meta = load_metadata(ckpt)
    cfg = config_from_dict(meta["config"])
    state = init_train_state(cfg, 0, device)
    restore_checkpoint(ckpt, state)
    step = make_train_step(make_schedule(cfg.diffusion, device=device), cfg,
                           dataset_mean=meta["dataset_mean"], dataset_std=meta["dataset_std"])
    data = upload_dataset(PackedDataset(pack, use_native=False), device)
    n = data["mel"].shape[0]
    runner = StepRunner(step, state, None, TRAIN_B, 1)
    batches = [{k: v[np.arange(c * TRAIN_B, (c + 1) * TRAIN_B) % n].view((1, TRAIN_B) + v.shape[1:])
                for k, v in data.items()} for c in range(calls + 1)]

    def call(c):
        return runner.run(runner.load(batches[c]), 0, [900 + c])

    torch.cuda.reset_peak_memory_stats()
    call(0)  # the capture
    _build.reset_launches()
    call(1)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    wins = []
    for _ in range(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for c in range(1, calls + 1):
            losses = call(c)
        torch.cuda.synchronize()
        wins.append((time.perf_counter() - t0) / calls * 1e3)
    need(bool(torch.isfinite(losses).all()), "v1 train step: losses not finite")
    ms = float(np.median(wins))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del runner, data, state
    torch.cuda.empty_cache()
    return dict(ms_per_step=ms, windows_ms=wins, clips_per_s=TRAIN_B / ms * 1e3, peak_gib=peak,
                launches=launches)


def run_v1(work: str, pack: str, clip_dir: str, smi: str, device, rng):
    """4j: v1 at its default widths with ``fused_attention`` (88,168,016
    parameters): ``cli train --arch v1 --fused_attention`` (B=16, T=516,
    ``--opt_backend pallas``) for 4 steps with saves every 2, ``--resume``
    for 2 more, the launches per step exactly; one replayed step timed; ``cli
    sample`` of the checkpoint (DDIM-10, CFG 2.1, bf16, both clips), its
    attention launches, the 4-row forward on the card against the host CPU;
    one ``cli serve`` request."""
    from lm2a_tpu_torch.training.checkpoint import latest_checkpoint, list_checkpoints

    t_all = time.perf_counter()
    mc = ModelConfig(arch="v1", fused_attention=True)
    with torch.device("meta"):
        n_params = param_count(build_denoiser(mc))
    need(n_params == V1_PARAMS, f"v1 denoiser has {n_params} params")
    per_step = v1_launches_per_step(mc)
    n_sites = len(v1_attention_sites(mc, MEL_T))
    save = os.path.join(work, "run")
    out = dict(params=n_params, launches_per_step=per_step)
    for label, extra, steps, last in (
            ("train", ["--max_steps", "4", "--save_interval", "2"], 4, 4),
            ("resume", ["--max_steps", "6", "--save_interval", "2", "--resume"], 2, 6)):
        _build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_cli(["train", "--npz_dir", pack, "--save_dir", save, *TRAIN_ARGS, *V1_ARGS, *extra])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        expected = {k: v * steps for k, v in per_step.items()}
        found = list_checkpoints(save)
        log(f"[v1] cli {label} --arch v1 --fused_attention: {steps} steps, B={TRAIN_B}, "
            f"T={MEL_T}, defaults ({n_params} params), bf16, --opt_backend pallas: {secs:.2f} s "
            f"with set-up and saves; checkpoints {found}; launches {launches} expected {expected}")
        need(launches == expected, f"v1 cli {label}: launches {launches} != {expected}")
        need(found and found[-1] == last and len(found) >= 2,
             f"v1 cli {label}: checkpoints {found}")
        out[label] = dict(seconds=secs, launches=launches, checkpoints=found)
    with open(os.path.join(save, "train_log.csv")) as f:
        rows = [r.split(",") for r in f.read().splitlines()[1:]]
    losses = {int(r[1]): float(r[2]) for r in rows if r[4] == ""}
    need(sorted(losses) == list(range(6)) and all(np.isfinite(v) for v in losses.values()),
         f"v1 train losses {losses}")
    ckpt = latest_checkpoint(save)
    t = out["timing"] = time_v1_step(ckpt, pack, device)
    log(f"[v1] train step replayed (CUDA graph), B={TRAIN_B}, T={MEL_T}: {t['ms_per_step']:.3f} "
        f"ms (median of 5 windows of 4; spread {min(t['windows_ms']):.3f}-"
        f"{max(t['windows_ms']):.3f}), {t['clips_per_s']:.1f} clips/s, peak memory "
        f"{t['peak_gib']:.2f} GiB; one replay's launches {t['launches']} | {smi}")
    need(t["launches"] == per_step, f"v1 replay launches {t['launches']} != {per_step}")
    gen_dir = os.path.join(work, "gen")
    _build.reset_launches()
    t0 = time.perf_counter()
    cli_sample.main(["--all", "--npz_dir", clip_dir, "--ckpt", ckpt, "--out_dir", gen_dir,
                     "--method", "ddim", "--ddim_steps", "10", "--guidance", "2.1", "--seed", "0",
                     "--device", "cuda"])
    torch.cuda.synchronize()
    sample_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    expected = {"attention": 4 * n_sites * 10}
    check_mels([os.path.join(gen_dir, f) for f in sorted(os.listdir(gen_dir))
                if f.endswith("_gen.npz")], MEL_T)
    log(f"[v1] cli sample (DDIM-10, CFG 2.1, {N_CLIPS} clips, bf16) {sample_s:.2f} s; launches "
        f"{launches} expected {expected}")
    need(launches == expected, f"v1 sample launches {launches} != {expected}")
    out["sample"] = dict(seconds=sample_s, launches=launches)
    out["unet_rel_l2"] = unet_card_vs_host(load_models(ckpt, device=device),
                                           load_models(ckpt, device="cpu"), rng, MAIN_ROWS,
                                           " v1 at its defaults, fused_attention")
    t0 = time.perf_counter()
    reply, launches = serve_one(ckpt, os.path.join(clip_dir, sorted(os.listdir(clip_dir))[0]),
                                os.path.join(work, "serve"), 10)
    serve_s = time.perf_counter() - t0
    expected = {"attention": 4 * n_sites * 10}
    log(f"[v1] cli serve, one request (DDIM-10, CFG 2.1): {serve_s:.2f} s with load and capture, "
        f"{reply.get('seconds')} s for the request; launches {launches} expected {expected}")
    need(launches == expected, f"v1 serve launches {launches} != {expected}")
    out["serve"] = dict(seconds=serve_s, reply=reply, launches=launches)
    out.update(v1_more_paths(work, pack, clip_dir, ckpt, mc, device))
    out["seconds"] = time.perf_counter() - t_all
    log(f"[v1] phase 4j: {out['seconds']:.1f} s in all | {smi}")
    return out


V1_QUALITY_STEPS, V1_VAL_STEPS, V1_ROUTE_ROWS, V1_ROUTE_STEPS = 10, 4, 2, 2


def v1_more_paths(work: str, pack: str, clip_dir: str, ckpt: str, mc: ModelConfig, device):
    """4j, the rest of v1's paths on the card:

    - ``cli train --arch v1 --fused_attention --steps_per_call 2
      --device_data`` for one epoch of 4d's pack with a validation pack and
      ``--quality_every_epochs 1`` (DDIM-``V1_QUALITY_STEPS``): the train
      steps, the validation batch's forward and the monitor's forwards,
      each one's attention launches exactly, finite losses;
    - ``cli val --max_samples 1 --steps V1_VAL_STEPS`` of 4j's checkpoint;
    - ``cli distill`` with that checkpoint as the teacher, one step a stage
      (4 -> 2, K=1): 3 forwards a step on the kernel, one ``adan_ema``;
    - ``V1_ROUTE_STEPS`` train steps from the checkpoint on the card and on
      the host CPU, the same injected draws on ``V1_ROUTE_ROWS`` rows: the
      loss and the gradient within ``ROUTE_TOL`` (the parameters' step and
      the EMA's change printed: the checkpoint is 6 steps in, where Adan's
      first updates do not scale with the gradient, as
      ``tests/test_torch_cuda.py``'s distill step notes)."""
    import csv

    from lm2a_tpu_torch.core.config import config_from_dict
    from lm2a_tpu_torch.data.dataset import PackedDataset
    from lm2a_tpu_torch.diffusion.schedule import make_schedule
    from lm2a_tpu_torch.training import quality
    from lm2a_tpu_torch.training.checkpoint import (latest_checkpoint, load_metadata,
                                                    restore_checkpoint)
    from lm2a_tpu_torch.training.train_step import init_train_state, make_train_step

    n_sites = len(v1_attention_sites(mc, MEL_T))
    per_step = v1_launches_per_step(mc)
    out = {}

    # K = 2 device-data steps, validation and the quality monitor
    val_clips, val_pack, save = (os.path.join(work, d) for d in ("val_clips", "val_pack",
                                                                  "run_k2"))
    write_clips(val_clips, TRAIN_B, seed=11)
    run_cli(["pack", "--npz_dir", val_clips, "--out_dir", val_pack])
    n_steps = len(PackedDataset(pack, use_native=False)) // TRAIN_B
    n_val = len(PackedDataset(val_pack, use_native=False)) // TRAIN_B
    runs = []
    real_run = quality.QualityMonitor.run

    def counted(self, x_init=None):
        before = dict(_build.LAUNCHES)
        r = real_run(self, x_init)
        runs.append(_launch_delta(before))
        return r

    quality.QualityMonitor.run = counted
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        run_cli(["train", "--npz_dir", pack, "--val_npz_dir", val_pack, "--save_dir", save,
                 *TRAIN_ARGS, *V1_ARGS, "--epochs", "1", "--steps_per_call", "2",
                 "--device_data", "--quality_every_epochs", "1", "--quality_clips",
                 str(QUALITY_CLIPS), "--quality_steps", str(V1_QUALITY_STEPS)])
        torch.cuda.synchronize()
    finally:
        quality.QualityMonitor.run = real_run
    secs = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    q_run = {"attention": 4 * n_sites * V1_QUALITY_STEPS}
    expected = {"attention": 2 * n_sites * (n_steps + n_val) + q_run["attention"],
                "adan_ema": n_steps}
    with open(os.path.join(save, "quality_log.csv")) as f:
        q_rows = list(csv.reader(f))[1:]
    with open(os.path.join(save, "train_log.csv")) as f:
        log_rows = list(csv.reader(f))[1:]
    losses = [float(r[2]) for r in log_rows if r[2]]
    val_losses = [float(r[3]) for r in log_rows if r[3]]
    log(f"[v1] cli train --arch v1 --fused_attention --steps_per_call 2 --device_data, one "
        f"epoch ({n_steps} steps, B={TRAIN_B}) with {n_val} validation batch and "
        f"--quality_every_epochs 1 (DDIM-{V1_QUALITY_STEPS}, {QUALITY_CLIPS} clips): {secs:.2f} "
        f"s with set-up; launches {launches} expected {expected}; the monitor's {runs} expected "
        f"[{q_run}]; losses {losses}; val losses {val_losses}; quality rows {q_rows}")
    need(runs == [q_run], f"v1 quality monitor launches {runs} != [{q_run}]")
    need(launches == expected, f"v1 K=2 device-data run: launches {launches} != {expected}")
    need(len(q_rows) == 1 and all(np.isfinite(float(v)) for v in q_rows[0][2:]),
         f"v1 quality rows {q_rows}")
    # a row for each call of K = 2 steps (and one for a single tail step), then the epoch's
    need(len(losses) == -(-n_steps // 2) + 1 and val_losses
         and all(np.isfinite(losses + val_losses)),
         f"v1 K=2 losses {losses}, val losses {val_losses}")
    out["k2_device_data"] = dict(seconds=secs, launches=launches, monitor=runs, losses=losses,
                                 quality=q_rows)

    # cli val
    _build.reset_launches()
    t0 = time.perf_counter()
    run_cli(["val", "--ckpt", ckpt, "--npz_dir", clip_dir, "--out_dir",
             os.path.join(work, "val"), "--max_samples", "1", "--steps", str(V1_VAL_STEPS),
             "--device", "cuda"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    expected = {"attention": 4 * n_sites * V1_VAL_STEPS}
    avg = _read_metrics_txt(os.path.join(work, "val", "average_metrics.txt"))
    log(f"[v1] cli val --max_samples 1 (DDPM-{V1_VAL_STEPS}, CFG 2.1): {secs:.2f} s; launches "
        f"{launches} expected {expected}; averages {avg}")
    need(launches == expected, f"v1 cli val: launches {launches} != {expected}")
    need(avg and all(np.isfinite(list(avg.values()))), f"v1 cli val: averages {avg}")
    out["val"] = dict(seconds=secs, launches=launches, averages=avg)

    # cli distill with a v1 teacher and student
    tee = Tee(sys.stdout)
    _build.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        run_cli(["distill", "--teacher", ckpt, "--npz_dir", pack, "--save_dir",
                 os.path.join(work, "student"), "--start_steps", "4", "--student_steps", "2",
                 "--steps_per_stage", "1", "--steps_per_call", "1", "--save_interval", "1000",
                 "--batch_size", str(TRAIN_B), "--seed", "0", "--device", "cuda"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    expected = {"attention": 2 * 3 * 2 * n_sites, "adan_ema": 2}
    losses = [float(c) for *_, c in DISTILL_LOSS_RE.findall(tee.kept.getvalue())]
    student = latest_checkpoint(os.path.join(work, "student"))
    log(f"[v1] cli distill, v1 teacher and student, one step a stage (4 -> 2, K=1, "
        f"B={TRAIN_B}): {secs:.2f} s with set-up; launches {launches} expected {expected}; "
        f"losses {losses}; student {student}")
    need(launches == expected, f"v1 cli distill: launches {launches} != {expected}")
    need(len(losses) == 2 and all(np.isfinite(losses)), f"v1 distill losses {losses}")
    need(student is not None, "v1 cli distill wrote no checkpoint")
    out["distill"] = dict(seconds=secs, launches=launches, losses=losses)

    # train steps on the card against the host CPU
    meta = load_metadata(ckpt)
    cfg = config_from_dict(meta["config"])
    host = torch.device("cpu")
    batch = {k: v[:V1_ROUTE_ROWS] for k, v in train_batch(pack, host).items()}
    sides = {}
    for label, d in (("card", device), ("host", host)):
        state = init_train_state(cfg, 0, d)
        restore_checkpoint(ckpt, state)
        sides[label] = (state, make_train_step(make_schedule(cfg.diffusion, device=d), cfg,
                                               dataset_mean=meta["dataset_mean"],
                                               dataset_std=meta["dataset_std"]))
    _build.reset_launches()
    out["route"] = card_vs_host_steps(
        sides, batch, cfg, V1_ROUTE_STEPS, ROUTE_TOL, "v1 train step", "[v1] train",
        f"card (attention kernel, adan_ema) vs host CPU (plain), {V1_ROUTE_ROWS} rows, from "
        "4j's checkpoint", gate_update=False)
    launches = dict(_build.LAUNCHES)
    expected = {k: v * V1_ROUTE_STEPS for k, v in per_step.items()}
    need(launches == expected, f"v1 route steps: launches {launches} != {expected}")
    del sides
    return out


def first_divergence(root: torch.nn.Module, run) -> str:
    """Where a CUDA graph replay of ``run()`` first departs from an eager
    run: every submodule's tensor outputs recorded (forward hooks, clones
    captured into the graph), compared in call order; the first module whose
    output is not the same bits, with its max abs difference."""
    records = {"eager": [], "graph": []}
    side = {"list": None}

    def hook(name):
        def fn(m, a, out):
            for o in out if isinstance(out, tuple) else (out,):
                if isinstance(o, torch.Tensor):
                    side["list"].append((name, o.detach().clone()))
        return fn

    handles = [m.register_forward_hook(hook(n)) for n, m in root.named_modules() if n]
    try:
        with torch.no_grad():
            side["list"] = records["eager"]
            run()
            side["list"] = []
            s = torch.cuda.Stream()
            s.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(s):
                run()
            torch.cuda.current_stream().wait_stream(s)
            graph = torch.cuda.CUDAGraph()
            side["list"] = records["graph"]
            with torch.cuda.graph(graph):
                run()
            graph.replay()
            torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    for (name, a), (_, b) in zip(records["eager"], records["graph"]):
        if not torch.equal(a, b):
            return f"{name} (max abs {max_abs(a, b):.3e})"
    return "none of the modules' outputs (the difference is outside them)"


def graph_vs_eager_chains(models, clips, rng):
    """5c: chains through the cache (CUDA graph replays) against the same
    chains with every step eager, one seed: a 6 s DDIM-50 at CFG 2.1 over the
    two clips (4 rows), 20 DDPM steps at 2 rows, the 150 s single pass at
    DDIM-2 on the fused route. The same bits, or the first module where a
    replay departs printed and the two within ``UNET_REL_L2``. Also the wall
    per step of the cached chain against the eager one (DDIM-50) and each
    entry's capture seconds and device memory."""
    from lm2a_tpu_torch.core.graphs import eager_on_card
    from lm2a_tpu_torch.inference.longform import with_streaming_attention
    from lm2a_tpu_torch.inference.sample import generate_mel_batch

    samples = [np.load(c) for c in clips]
    motions, lyrics = [s["motion"] for s in samples], [s["lyrics"] for s in samples]
    long_m = rng.standard_normal((int(LONG_SECONDS * 30) + 1, 234)).astype(np.float32)
    long_l = rng.standard_normal((long_m.shape[0], 768)).astype(np.float32)
    long_models = with_streaming_attention(models, LONG_T)
    cases = {
        "ddim50_4rows": (models, lambda m: generate_mel_batch(
            m, motions, lyrics, MEL_T, guidance_weight=2.1, method="ddim", ddim_steps=50,
            seed=3)[0], 50, MAIN_ROWS, MEL_T),
        "ddpm20_2rows": (models, lambda m: generate_mel(
            m, motions[0], lyrics[0], MEL_T, steps=20, guidance_weight=2.1, method="ddpm",
            seed=3)[0], 20, PROTOCOL_ROWS, MEL_T),
        "single_pass_ddim2": (long_models, lambda m: generate_mel(
            m, long_m, long_l, LONG_T, guidance_weight=2.1, method="ddim", ddim_steps=2,
            seed=3)[0], 2, PROTOCOL_ROWS, LONG_T),
    }
    out = {}
    for label, (m, fn, n_steps, rows, mel_t) in cases.items():
        walls = {}
        res = {}
        for run in ("first", "cached", "eager"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with eager_on_card() if run == "eager" else contextlib.nullcontext():
                res[run] = fn(m)
            torch.cuda.synchronize()
            walls[run] = time.perf_counter() - t0
        need(all(np.isfinite(r).all() for r in res.values()), f"{label}: not finite")
        same = np.array_equal(res["cached"], res["eager"]) and np.array_equal(
            res["first"], res["eager"])
        err = rel_l2(torch.from_numpy(res["cached"]), torch.from_numpy(res["eager"]))
        cause = ""
        if not same:
            inputs = unet_inputs(rng, rows, mel_t, models.cfg.model.cond_dim)
            x, t, conds, n = inputs
            x, t = x.to(models.device), t.to(models.device)
            mf, tf = (c.to(models.device, torch.bfloat16) for c in conds)
            cause = first_divergence(m.denoiser, lambda: m.denoiser(x, t, mf, tf, uncond_rows=n))
        ddpm = label.startswith("ddpm")
        entry = next(c for k, c in m._samplers.items() if k[0] == mel_t and k[4] == rows // 2
                     and (k[1] if ddpm else k[5]) == n_steps and k[3] == ("ddpm" if ddpm else
                                                                       "ddim"))
        step, = entry.steps.values()
        log(f"[graphs] {label}: CFG 2.1, {rows} rows, T={mel_t}: cached chain against the "
            f"eager chain, same seed: {'the same bits' if same else 'NOT the same bits'} "
            f"(rel L2 {err:.3e}, tolerance {UNET_REL_L2}"
            + (f"; first module departing under the graph: {cause}" if cause else "")
            + f"); wall: first call (with its capture) {walls['first']:.4f} s, cached "
            f"{walls['cached']:.4f} s ({walls['cached'] / n_steps * 1e3:.3f} ms/step), eager "
            f"{walls['eager']:.4f} s ({walls['eager'] / n_steps * 1e3:.3f} ms/step); capture "
            f"{step.capture_seconds:.3f} s, {step.capture_bytes / 2 ** 20:.1f} MiB reserved by "
            f"the capture")
        need(same or err <= UNET_REL_L2, f"{label}: the replayed chain departs from the eager one")
        out[label] = dict(same_bits=same, rel_l2=err, cause=cause, walls=walls,
                          capture_s=step.capture_seconds, capture_bytes=step.capture_bytes,
                          steps=n_steps, rows=rows, mel_t=mel_t)
    del long_models
    torch.cuda.empty_cache()
    return out


def sampler_cache_memory(models, label: str):
    """Each cached chain's capture seconds and the device memory its capture
    reserved (the entries share one pool, so a later entry reserves only
    what the pool lacked)."""
    rows = []
    for key, chain in models._samplers.items():
        for step in chain.steps.values():
            if step.graph is not None:
                rows.append(dict(key=list(key), capture_s=step.capture_seconds,
                                 capture_mib=step.capture_bytes / 2 ** 20))
    log(f"[graphs] sampler cache {label}: {len(rows)} captured chains; "
        + "; ".join(f"(mel_t, steps, guided, method, batch, ddim) {r['key']}: capture "
                    f"{r['capture_s']:.3f} s, {r['capture_mib']:.1f} MiB" for r in rows)
        + f"; device memory reserved {torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB")
    return rows


def run_serve_cache(ckpt: str, clip: str, out_dir: str, ddim_steps: int):
    """4b: ``cli serve`` without a warm-up, three requests of one geometry
    (DDIM-50, B=1): the first captures its chain, a second with another
    seed and a third at another CFG weight above 1 capture nothing. Returns
    the replies and the captures during each request."""
    from lm2a_tpu_torch.core import graphs

    reqs = [{"npz": clip, "id": "first", "seed": 1},
            {"npz": clip, "id": "second", "seed": 2},
            {"npz": clip, "id": "weight3", "seed": 1, "guidance": 3.0},
            {"cmd": "quit", "id": "quit"}]
    for r in reqs[:3]:
        r["out_dir"] = os.path.join(out_dir, r["id"])
    marks = []

    class Requests:
        def __iter__(self):
            for r in reqs:
                marks.append(graphs.captures)
                yield json.dumps(r) + "\n"

    argv = ["lm2a_tpu_torch.cli", "serve", "--ckpt", ckpt, "--method", "ddim",
            "--ddim_steps", str(ddim_steps), "--guidance", "2.1", "--out_dir", out_dir,
            "--device", "cuda"]
    out = io.StringIO()
    saved = sys.argv, sys.stdin
    sys.argv, sys.stdin = argv, Requests()
    try:
        with contextlib.redirect_stdout(out):
            cli_main.main()
    finally:
        sys.argv, sys.stdin = saved
    replies = [json.loads(line) for line in out.getvalue().splitlines()]
    captures = [b - a for a, b in zip(marks, marks[1:])]
    log(f"[serve] cli serve, no warm-up, DDIM-{ddim_steps}, B=1: seconds per request "
        + ", ".join(f"{r['id']} {r['seconds']}" for r in replies if "seconds" in r)
        + f"; CUDA graph captures during each request {captures} (expected [1, 0, 0]: one "
        "entry for the geometry and for every weight above 1)")
    need([r["ok"] for r in replies] == [True] * 4 and captures == [1, 0, 0],
         f"serve cache: replies {replies}, captures {captures}")
    check_mels([r["out"] for r in replies[:3]], MEL_T)
    return dict(replies=replies, captures=captures)


def run_train_k2(work: str, mc: ModelConfig, pack: str, k1_ckpt: str):
    """4g: ``cli train --steps_per_call 2 --device_data`` over 4d's pack
    (6 steps, a save every 4), then ``--resume`` for 2: checkpoints where the
    JAX fused rule puts them (``step % 4 < 2``), 4d's launches a step, and
    the step-8 checkpoint the same bits as 4d's K = 1 run's (parameters,
    EMA, Adan state: the same rows and generators each step)."""
    from lm2a_tpu_torch.training.checkpoint import list_checkpoints, load_metadata

    save = os.path.join(work, "run_k2")
    per_step, _ = train_launches_per_step(mc)
    out = {}
    for label, extra, steps, ckpts in (
            ("train", ["--max_steps", "6", "--save_interval", "4"], 6, [4, 6]),
            ("resume", ["--max_steps", "8", "--save_interval", "4", "--resume"], 2, [4, 6, 8])):
        _build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_cli(["train", "--npz_dir", pack, "--save_dir", save, *TRAIN_ARGS,
                 "--steps_per_call", "2", "--device_data", *extra])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        expected = {k: v * steps for k, v in per_step.items()}
        found = list_checkpoints(save)
        log(f"[train] cli {label} --steps_per_call 2 --device_data: {steps} steps, B={TRAIN_B}, "
            f"flagship: {secs:.2f} s with set-up and saves; checkpoints {found}; launches "
            f"{launches} expected {expected}")
        need(launches == expected, f"K=2 {label}: launches {launches} != expected {expected}")
        need(found == ckpts, f"K=2 {label}: checkpoints {found} != {ckpts}")
        out[label] = dict(seconds=secs, launches=launches, checkpoints=found)
    for step, epoch in ((4, 0), (6, 1), (8, 1)):
        path = os.path.join(save, f"ckpt_step_{step}")
        meta = load_metadata(path)
        need(meta["epoch"] == epoch and meta["step"] == step and npz_steps(path) == (step, step),
             f"{path}: epoch {meta['epoch']}, steps {npz_steps(path)}")
    differ = []
    with np.load(os.path.join(save, "ckpt_step_8", "state.npz")) as a, \
            np.load(os.path.join(k1_ckpt, "state.npz")) as b:
        need(sorted(a.files) == sorted(b.files), "K=2 and K=1 checkpoints hold other leaves")
        for key in a.files:
            if not np.array_equal(a[key], b[key]):
                differ.append(key)
        n = len(a.files)
    log(f"[train] step-8 checkpoint, K=2 --device_data against 4d's K=1 run: {n - len(differ)} "
        f"of {n} arrays (parameters, EMA, Adan state, steps) the same bits"
        + (f"; differ: {differ[:8]}" if differ else ""))
    need(not differ, "the K=2 device-data run's step-8 state is not the K=1 run's")
    out["same_bits"] = n
    return out


def graph_step_vs_eager(routes, batch, device):
    """4g: one flagship train step from one state (4d's resumed checkpoint)
    as a CUDA graph replay and as the eager step, the same generator: loss,
    every gradient leaf, the parameters and the EMA, the same bits, or the
    first module where a replay departs printed and the two within
    ``ROUTE_TOL``."""
    from lm2a_tpu_torch.core.graphs import eager_on_card
    from lm2a_tpu_torch.training.train_step import StepRunner

    state, step = routes["kernel"]
    snap = snapshot(state)
    runner = StepRunner(step, state, None, TRAIN_B, 1)
    rows = runner.load(batch)
    runner.run(rows, 0, [600])  # the capture's warm-up: an eager step
    res = {}
    for label in ("replay", "eager"):
        restore(state, snap)
        with eager_on_card() if label == "eager" else contextlib.nullcontext():
            loss = float(runner.run(rows, 0, [601])[0])
        torch.cuda.synchronize()
        res[label] = dict(loss=loss, grads={k: p.grad.detach().clone()
                                            for k, p in state.params().items()},
                          params={k: p.detach().clone() for k, p in state.params().items()},
                          ema={k: e.clone() for k, e in state.ema.items()})
    restore(state, snap)
    r, e = res["replay"], res["eager"]
    differ = [f"{kind}:{k}" for kind in ("grads", "params", "ema")
              for k in e[kind] if not torch.equal(r[kind][k], e[kind][k])]
    same = not differ and r["loss"] == e["loss"]
    cause, grad_rel = "", 0.0
    if not same:
        gsum = float(torch.sqrt(sum(g.float().square().sum() for g in e["grads"].values())))
        num = sum(float((r["grads"][k] - g).float().norm()) ** 2 for k, g in e["grads"].items())
        grad_rel = num ** 0.5 / gsum
        t = torch.arange(TRAIN_B, device=device) * 60
        with torch.no_grad():
            m, l = state.cond_proj.forward_train(batch["motion"], batch["lyrics"], torch.bfloat16)
        cause = first_divergence(state.unet, lambda: state.unet.forward_train(
            batch["mel"], t, m, l, dtype=torch.bfloat16))
    log(f"[train] one flagship step from 4d's resumed state, B={TRAIN_B}: CUDA graph replay "
        f"against the eager step, same generator: loss {r['loss']:.6f} / {e['loss']:.6f}; "
        + ("the same bits in every gradient leaf, parameter and EMA" if same else
           f"NOT the same bits ({len(differ)} arrays differ, e.g. {differ[:4]}; gradient "
           f"relative L2 {grad_rel:.3e}, tolerance {ROUTE_TOL['grad_rel_l2']}; first module "
           f"departing under the graph: {cause})"))
    need(same or (grad_rel <= ROUTE_TOL["grad_rel_l2"]
                  and abs(r["loss"] - e["loss"]) <= ROUTE_TOL["loss_rel"] * abs(e["loss"])),
         "the replayed train step departs from the eager one")
    del runner, res
    return dict(same_bits=same, differ=differ[:20], cause=cause, grad_rel_l2=grad_rel)


def time_compiled_steps(routes, pack: str, device, calls: int = 4, windows: int = 5):
    """ms per train step and clips/s of the compiled steps (CUDA graph
    replays) at K = 1 and K = 2, streaming (each call's batches copied into
    the runner's buffer, as ``cli train`` does after its prefetch) and
    device-resident (``--device_data``: only row indices staged), beside the
    eager K = 1 step; each after one warm-up call, from 4d's resumed state
    (restored after), as the median of ``windows`` timed windows of
    ``calls`` calls, with their spread (least and most). A profiled window
    of device-resident K = 1 replays gives the busy share."""
    from lm2a_tpu_torch.core.graphs import eager_on_card
    from lm2a_tpu_torch.data.dataset import PackedDataset, upload_dataset
    from lm2a_tpu_torch.training.train_step import StepRunner

    state, step = routes["kernel"]
    snap = snapshot(state)
    data = upload_dataset(PackedDataset(pack), device)
    n = data["mel"].shape[0]
    out = {}
    for label, k, resident, eager in (("K=1 eager", 1, False, True), ("K=1", 1, False, False),
                                      ("K=1 device_data", 1, True, False),
                                      ("K=2", 2, False, False), ("K=2 device_data", 2, True, False)):
        runner = StepRunner(step, state, data if resident else None, TRAIN_B, k)
        order = [np.arange(c * k * TRAIN_B, (c + 1) * k * TRAIN_B) % n for c in range(calls + 1)]
        batches = [{key: v[o].view((k, TRAIN_B) + v.shape[1:]) for key, v in data.items()}
                   for o in order]

        def call(c, runner=runner, k=k, resident=resident):
            idx = order[c].reshape(k, TRAIN_B) if resident else runner.load(batches[c])
            return runner.run(idx, 0, list(range(700 + c * k, 700 + (c + 1) * k)))

        wins = []
        with eager_on_card() if eager else contextlib.nullcontext():
            call(0)
            for _ in range(windows):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for c in range(1, calls + 1):
                    losses = call(c)
                torch.cuda.synchronize()
                wins.append((time.perf_counter() - t0) / (calls * k) * 1e3)
        ms = float(np.median(wins))
        need(bool(torch.isfinite(losses).all()), f"{label}: losses not finite")
        out[label] = dict(ms_per_step=ms, windows_ms=wins, clips_per_s=TRAIN_B / ms * 1e3, k=k,
                          resident=resident)
        log(f"[train] compiled steps, {label}{' (every step eager)' if eager else ' (CUDA graph replays)'}: "
            f"{ms:.3f} ms per step (median of {windows} windows of {calls * k} steps; spread "
            f"{min(wins):.3f}-{max(wins):.3f}), {TRAIN_B / ms * 1e3:.1f} clips/s (B={TRAIN_B}, "
            f"T={MEL_T}, flagship, kernel route)")
        if label == "K=1 device_data":
            wall_ms, rows, busy, groups = profile_device(lambda i: call(1 + i % calls), 3)
            out["profile"] = dict(wall_ms=wall_ms, busy_ms=busy, kernels=len(rows),
                                  launches=sum(r[2] for r in rows), groups=groups)
            log(f"[profile] 3 device-resident K=1 train steps as CUDA graph replays: wall "
                f"{wall_ms:.2f} ms, device kernels {busy:.2f} ms (busy share "
                f"{busy / wall_ms:.3f}), {sum(r[2] for r in rows)} kernel executions seen by "
                "torch.profiler inside the replays; by group (ms per step): "
                + ", ".join(f"{g} {v / 3:.2f}" for g, v in groups.items()))
        del runner
    restore(state, snap)
    del data
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- references

def unet_inputs(rng, rows: int, mel_t: int, cond_dim: int):
    """CFG rows: the first half unconditional (zero conditions), the same t
    for each pair."""
    n = rows // 2
    x = torch.as_tensor(rng.standard_normal((rows, mel_t, 80)).astype(np.float32))
    t = torch.as_tensor(np.tile(rng.integers(0, 1000, n), 2))
    conds = [torch.as_tensor(rng.standard_normal((n, mel_t, cond_dim)), dtype=torch.float32)
             for _ in range(2)]
    return x, t, [torch.cat([torch.zeros_like(c), c]) for c in conds], n


@torch.no_grad()
def unet_forward(denoiser, inputs, device) -> torch.Tensor:
    x, t, conds, n = inputs
    mf, tf = (c.to(device, torch.bfloat16) for c in conds)
    return denoiser(x.to(device), t.to(device), mf, tf, uncond_rows=n).float().cpu()


def unet_card_vs_host(models, cpu_models, rng, rows: int, label: str) -> float:
    inputs = unet_inputs(rng, rows, MEL_T, models.cfg.model.cond_dim)
    card = unet_forward(models.denoiser, inputs, models.device)
    t0 = time.perf_counter()
    host = unet_forward(cpu_models.denoiser, inputs, torch.device("cpu"))
    host_s = time.perf_counter() - t0
    err = rel_l2(card, host)
    log(f"[reference] UNet forward{label}, {rows} CFG rows (uncond_rows={rows // 2}), "
        f"T={MEL_T}, bf16: card kernels vs host plain: rel L2 {err:.3e} (tolerance "
        f"{UNET_REL_L2}), max abs {max_abs(card, host):.3e}; host forward {host_s:.1f} s")
    need(bool(torch.isfinite(card).all()) and err <= UNET_REL_L2,
         f"UNet forward{label} at {rows} rows disagrees with the host reference")
    return err


def unet_kernel_vs_plain_core(models, rng, mel_t: int) -> float:
    """One 2-row forward on the fused route, through the attention kernel and
    then through ``attention_core_plain``, both on the card."""
    fused = models.denoiser.with_fused_attention()
    inputs = unet_inputs(rng, 2, mel_t, models.cfg.model.cond_dim)
    kernel = unet_forward(fused, inputs, models.device)
    model_attention.attention_core = att.attention_core_plain
    try:
        plain = unet_forward(fused, inputs, models.device)
    finally:
        model_attention.attention_core = att.attention_core
    err = rel_l2(kernel, plain)
    log(f"[reference] UNet forward, fused route, 2 CFG rows, T={mel_t}, bf16: attention "
        f"kernel vs attention_core_plain, both on the card: rel L2 {err:.3e} (tolerance "
        f"{UNET_REL_L2}), max abs {max_abs(kernel, plain):.3e}")
    need(bool(torch.isfinite(kernel).all()) and err <= UNET_REL_L2,
         f"UNet forward at T={mel_t}: the attention kernel disagrees with the plain core")
    return err


# ---------------------------------------------------------------- phase 5b

def run_long_form(models, rng, ddim_steps: int, n_blocks: int):
    """``generate_single_pass`` at 150 s and ``generate_long`` at 60 s (CFG
    2.1, DDIM), each after an untimed call of the same chains: the windowed
    chains then replay from the cache; the single pass's model copy starts
    a fresh cache each call, so its timed call includes its capture. The
    launches of the timed calls are checked."""
    kw = dict(guidance_weight=2.1, method="ddim", seed=0)
    long_motion = rng.standard_normal((int(LONG_SECONDS * 30) + 1, 234)).astype(np.float32)
    long_lyrics = rng.standard_normal((long_motion.shape[0], 768)).astype(np.float32)
    win_motion = rng.standard_normal((60 * 30, 234)).astype(np.float32)
    win_lyrics = [rng.standard_normal(768).astype(np.float32) for _ in range(12)]
    runs = {
        "single_pass_150s": (lambda n: generate_single_pass(
            models, long_motion, long_lyrics, LONG_SECONDS, ddim_steps=n, **kw), LONG_T,
            # per step: 9 sites x 2 branches x (conditioned row + CFG constant)
            {"attention": 36 * ddim_steps, "gn_stats": (2 * n_blocks + 1) * ddim_steps,
             "conv3_fused": 2 * n_blocks * ddim_steps}),
        "windowed_60s": (lambda n: generate_long(
            models, win_motion, win_lyrics, 60.0, batch_size=8, ddim_steps=n, **kw), 5168,
            # two chains: 8 windows, then 4
            {"gn_stats": 2 * (2 * n_blocks + 1) * ddim_steps,
             "conv3_fused": 4 * n_blocks * ddim_steps}),
    }
    out = {}
    for label, (fn, mel_t, expected) in runs.items():
        fn(ddim_steps)
        _build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mel = fn(ddim_steps)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        need(mel.shape == (80, mel_t) and np.isfinite(mel).all(),
             f"{label}: mel {mel.shape} not finite (80, {mel_t})")
        log(f"[longform] {label}: DDIM-{ddim_steps}, CFG 2.1, bf16, (80, {mel_t}) mel in "
            f"{secs:.4f} s = {mel_t / secs:.1f} mel frames/s; launches {launches}")
        need(launches == expected, f"{label}: launches {launches} != expected {expected}")
        out[label] = dict(seconds=secs, mel_t=mel_t, frames_per_s=mel_t / secs,
                          launches=launches)
    return out


@torch.no_grad()
def route_break_even(models, rng, lengths=(516, 2048, 4096, 8192, LONG_T), reps: int = 3):
    """One 2-row UNet forward (CFG, ``uncond_rows=1``) on the default route
    (folded, plain attention core) and on the fused route at each length,
    CUDA events, mean of ``reps`` after one warm-up each."""
    fused = models.denoiser.with_fused_attention()
    out = []
    for t in lengths:
        inputs = unet_inputs(rng, 2, t, models.cfg.model.cond_dim)
        x, tt, conds, n = inputs
        x, tt = x.to(models.device), tt.to(models.device)
        mf, tf = (c.to(models.device, torch.bfloat16) for c in conds)
        row = dict(T=t)
        for name, den in (("default_ms", models.denoiser), ("fused_ms", fused)):
            den(x, tt, mf, tf, uncond_rows=n)
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(reps):
                den(x, tt, mf, tf, uncond_rows=n)
            b.record()
            b.synchronize()
            row[name] = a.elapsed_time(b) / reps
        log(f"[route] 2-row UNet forward, T={t:5d}: default route {row['default_ms']:.3f} ms, "
            f"fused route {row['fused_ms']:.3f} ms ({row['default_ms'] / row['fused_ms']:.2f}x)")
        out.append(row)
        del x, tt, mf, tf
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- where the time goes

def profile_chain(models, motion, lyrics, steps: int):
    """A ``steps``-step DDIM chain (B=1, CFG 2.1) under torch.profiler, twice:
    cached (CUDA graph replays; the busy share of the window, and how many
    kernel executions the profiler sees inside the replays) and with every
    step eager (device kernel time by name)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from lm2a_tpu_torch.core.graphs import eager_on_card

    run = lambda: generate_mel(models, motion, lyrics, MEL_T, method="ddim",  # noqa: E731
                               ddim_steps=steps, guidance_weight=2.1, seed=4)
    run()
    torch.cuda.synchronize()
    out = {}
    for label in ("cached", "eager"):
        with eager_on_card() if label == "eager" else contextlib.nullcontext():
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
        rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                       for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                      key=lambda r: -r[1])
        busy_ms = sum(r[1] for r in rows)
        log(f"[profile] DDIM-{steps} chain, B=1 CFG 2.1, {label}"
            f"{' (CUDA graph replays)' if label == 'cached' else ' (every step eager)'}: wall "
            f"{wall_ms:.2f} ms ({wall_ms / steps:.2f} ms/step), device kernels {busy_ms:.2f} ms, "
            f"busy share {busy_ms / wall_ms:.3f}, {sum(r[2] for r in rows)} kernel executions "
            "seen")
        for name, ms, n in rows[:12 if label == "eager" else 4]:
            log(f"[profile]   {ms:9.3f} ms {n:6d}x  {name[:90]}")
        out[label] = dict(steps=steps, wall_ms=wall_ms, busy_ms=busy_ms,
                          kernels=[dict(name=r[0], ms=r[1], count=r[2]) for r in rows])
    return out


# ---------------------------------------------------------------- main

def nvidia_smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True, text=True,
                       timeout=60)
    need(r.returncode == 0, f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def ptxas_summary(log: str):
    """(kernel function, its ``-Xptxas -v`` registers / shared memory line,
    its spill line) for each entry function in an nvcc log, names demangled
    where ``c++filt`` exists."""
    out, name, spill = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name, spill = line.split("'")[1], ""
        elif "spill stores" in line:
            spill = line.strip()
        elif name and "Used" in line:
            out.append([name, line.split("Used", 1)[1].strip(), spill])
            name = None
    if out and shutil.which("c++filt"):
        r = subprocess.run(["c++filt"], input="\n".join(o[0] for o in out),
                           capture_output=True, text=True, timeout=60)
        if r.returncode == 0:
            for o, d in zip(out, r.stdout.splitlines()):
                o[0] = d.replace("(anonymous namespace)::", "").split("(")[0]
    return out


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float().cpu(), b.float().cpu()
    return float((a - b).norm() / b.norm())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ddpm_steps", type=int, default=1000,
                    help="steps of the protocol DDPM chain (the schedule has 1000)")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "chip_smoke"))
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script measures the port "
              "on an NVIDIA GPU only", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    os.makedirs(args.out, exist_ok=True)
    report = {}
    phase_s, last = {}, [t_start]

    def mark(phase: str) -> None:  # the wall seconds since the previous mark
        now = time.perf_counter()
        phase_s[phase] = now - last[0]
        last[0] = now
        log(f"[phase] {phase}: {phase_s[phase]:.1f} s")

    # 1. device
    smi = nvidia_smi_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {smi} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    # 2. build
    build_s = _build.build_all()
    with open(os.path.join(args.out, "build.log"), "w") as f:
        for name, text in _build.build_log.items():
            f.write(f"--- {name}.cu ---\n{text}\n")
    log(f"[build] {len(_build.build_log)} sources built in {build_s:.1f} s "
        f"(nvcc {' '.join(_build.NVCC_FLAGS)})")
    mark("1-2 device and build")
    for src, text in _build.build_log.items():
        for fn, used, spill in ptxas_summary(text):
            log(f"[build] ptxas {src}.cu {fn}: Used {used} | {spill}")
        serialized = [line for line in text.splitlines() if "wgmma.mma_async instructions are serialized" in line]
        if serialized:  # ptxas's C75xx notes: every wgmma of the function waits for the last
            log(f"[build] ptxas {src}.cu: {len(serialized)} functions with serialized wgmma ("
                + ", ".join(sorted({line.split("(C")[1][:4] for line in serialized})) + ")")

    # 3. kernels against their plain versions
    gen = torch.Generator().manual_seed(0)
    timer = Timer(dev)
    # the kernels line times the main path's rows; errors count every row count
    per, report["resblock"] = phase_resblock(timer, dev, gen, rows=MAIN_ROWS)
    for label, rows, mel_t in (("protocol", PROTOCOL_ROWS, MEL_T),
                               ("windowed", WINDOW_ROWS, MEL_T),  # 3b
                               ("single_pass", PROTOCOL_ROWS, LONG_T),
                               ("distill", DISTILL_ROWS, MEL_T)):
        other, report[f"resblock_{label}"] = phase_resblock(timer, dev, gen, rows, mel_t)
        for k in other:
            per[k]["err"] = max(per[k]["err"], other[k]["err"])
        report[f"resblock_{label}_sums"] = other
    per["snake_sandwich"], report["sandwich"] = phase_sandwich(timer, dev, gen)
    report["vocode_profile"] = per["snake_sandwich"].pop("profile")
    # 3c
    attn_sums, report["attention"] = phase_attention(timer, dev, gen)
    report["attention_sums"] = attn_sums
    per["attention"] = dict(attn_sums["6s_b2"],
                            err=max(k["err"] for k in attn_sums.values()))
    mark("3-3c")
    # 3d: the training kernels
    per_bwd, report["backward"] = phase_backward(timer, dev, gen)
    mark("3d backward")
    per.update(per_bwd)
    per["conv3_fused"]["err"] = max([per["conv3_fused"]["err"]] + [
        r["forward_err"][k] for r in report["backward"] for k in ("f", "z1")])
    report["adan"] = phase_adan(timer, dev)
    per["adan_ema"] = dict(report["adan"]["fp32"],
                           err=max(v["err"] for v in report["adan"].values()))
    del timer
    mark("3d adan")

    # 4. the slice through the CLIs
    work = os.path.join(ROOT, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    cfg = LM2AConfig()
    t0 = time.perf_counter()
    ckpt = write_checkpoint(os.path.join(work, "ckpt"), cfg, seed=0)
    with torch.device("meta"):
        n_params = param_count(build_denoiser(cfg.model))
    need(n_params == FLAGSHIP_PARAMS, f"denoiser has {n_params} params")
    clips = write_clips(os.path.join(work, "clips"), N_CLIPS, seed=1)
    log(f"[slice] flagship checkpoint ({n_params} denoiser params, seeded) and "
        f"{len(clips)} clips written in {time.perf_counter() - t0:.1f} s")
    n_blocks = len(resblock_geometries(cfg.model, MEL_T))
    n_sites = len(attention_sites(cfg.model, MEL_T))
    n_sandwich = sum(u for *_, u in sandwich_geometries(BIGVGAN_22KHZ_80BAND, MEL_T))
    ddim_steps = 50
    _build.reset_launches()
    gens, wavs, sample_s, towav_s = run_slice(
        ckpt, os.path.dirname(clips[0]), os.path.join(work, "out"), "cuda", ddim_steps,
        "bigvgan_22khz_80band")
    launches = dict(_build.LAUNCHES)
    check_outputs(gens, wavs, len(clips), MEL_T, BIGVGAN_22KHZ_80BAND.hop)
    # per forward: GN1 and GN2 of every block, and the UNet's last GroupNorm (out_gn)
    n_gn = 2 * n_blocks + 1
    expected = {"gn_stats": n_gn * ddim_steps,
                "conv3_fused": 2 * n_blocks * ddim_steps,
                "snake_sandwich": n_sandwich * len(clips)}
    log(f"[slice] cli sample (DDIM-{ddim_steps}, CFG 2.1, {len(clips)} clips, bf16) "
        f"{sample_s:.2f} s; cli towav ({len(clips)} clips, BIGVGAN_22KHZ_80BAND) "
        f"{towav_s:.2f} s; launches {launches} expected {expected}")
    need(launches == expected, f"launch counts {launches} != expected {expected}")

    # 4b. cli serve: three sampled chains (one clip, a list of two, one with wav)
    t0 = time.perf_counter()
    replies, serve_launches = run_serve(ckpt, clips, os.path.join(work, "serve"), "cuda",
                                        ddim_steps)
    serve_s = time.perf_counter() - t0
    check_serve(replies, MEL_T, BIGVGAN_22KHZ_80BAND.hop)
    serve_expected = {"gn_stats": 3 * n_gn * ddim_steps,
                      "conv3_fused": 3 * 2 * n_blocks * ddim_steps,
                      "snake_sandwich": n_sandwich}
    log(f"[serve] cli serve (DDIM-{ddim_steps}, CFG 2.1, warm-up T={MEL_T}) {serve_s:.2f} s "
        "in all; seconds per request: " + ", ".join(
            f"{r['id']} {r['seconds']}" for r in replies if "seconds" in r)
        + f"; replies in order, ok {[r['ok'] for r in replies]}; launches after the "
        f"warm-up {serve_launches} expected {serve_expected}")
    need(serve_launches == serve_expected,
         f"serve launch counts {serve_launches} != expected {serve_expected}")
    report["serve_cache"] = run_serve_cache(ckpt, clips[0], os.path.join(work, "serve_cache"),
                                            ddim_steps)

    # 4c. the 6 s fused route: a checkpoint whose config sets fused_attention
    fused_cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                                   fused_attention=True))
    fused_ckpt = write_checkpoint(os.path.join(work, "ckpt_fused"), fused_cfg, seed=0)
    fused_out = os.path.join(work, "out_fused")
    _build.reset_launches()
    t0 = time.perf_counter()
    cli_sample.main(["--all", "--npz_dir", os.path.dirname(clips[0]), "--ckpt", fused_ckpt,
                     "--out_dir", fused_out, "--method", "ddim", "--ddim_steps",
                     str(ddim_steps), "--guidance", "2.1", "--seed", "0", "--device", "cuda"])
    torch.cuda.synchronize()
    fused_s = time.perf_counter() - t0
    fused_launches = dict(_build.LAUNCHES)
    check_mels([os.path.join(fused_out, f) for f in sorted(os.listdir(fused_out))
                if f.endswith("_gen.npz")], MEL_T)
    # per step: every site, both branches, the conditioned rows and the CFG constant
    fused_expected = {"gn_stats": n_gn * ddim_steps,
                      "conv3_fused": 2 * n_blocks * ddim_steps,
                      "attention": 4 * n_sites * ddim_steps}
    log(f"[fused] cli sample, fused_attention checkpoint (DDIM-{ddim_steps}, CFG 2.1, "
        f"{len(clips)} clips) {fused_s:.2f} s; launches {fused_launches} expected "
        f"{fused_expected}")
    need(fused_launches == fused_expected,
         f"fused-route launch counts {fused_launches} != expected {fused_expected}")
    launches["attention"] = fused_launches["attention"]
    rng = np.random.default_rng(5)
    fused_models = load_models(fused_ckpt, device=dev)
    unet_err = {"fused_4": unet_card_vs_host(fused_models, load_models(fused_ckpt, device="cpu"),
                                             rng, MAIN_ROWS, " on the fused route")}
    del fused_models

    mark("4-4c")
    # 4d. cli pack + cli train (6 steps, a save every 4) + --resume (2 steps)
    train = run_train(os.path.join(work, "train"), cfg.model)
    for k in ("conv3_dgrad", "conv3_wgrad", "gn_bwd", "adan_ema"):
        launches[k] = train["train"]["launches"][k]
    routes = route_states(train["ckpt"], dev)
    batch = train_batch(train["pack"], dev)
    report["route_comparison"] = route_comparison(routes, batch, dev)  # 4e
    report["graph_step"] = graph_step_vs_eager(routes, batch, dev)  # 4g
    report["compiled_steps"] = time_compiled_steps(routes, train["pack"], dev)
    report["train_timing"] = time_routes(routes, batch, dev)
    report["train_profile"] = profile_train(*routes["kernel"], batch, dev)
    report["train"] = {k: v for k, v in train.items() if k not in ("pack", "ckpt")}
    del routes, batch
    torch.cuda.empty_cache()
    # 4g. cli train --steps_per_call 2 --device_data over 4d's pack, resumed
    report["train_k2"] = run_train_k2(os.path.join(work, "train"), cfg.model, train["pack"],
                                      train["ckpt"])
    torch.cuda.empty_cache()
    mark("4d-4g")
    # 4f. cli distill from 4d's checkpoint over 4d's pack, resumed, the student sampled
    report["distill"] = run_distill(os.path.join(work, "distill"), train["ckpt"], train["pack"],
                                    cfg.model, os.path.dirname(clips[0]), n_blocks, smi, dev)
    torch.cuda.empty_cache()
    shutil.rmtree(os.path.join(work, "distill"), ignore_errors=True)
    mark("4f")
    # 4h. evaluation: cli val, the quality monitor, fused_opt 0, cli evaluate, base 32
    report["evaluation"] = run_evaluation(os.path.join(work, "eval"), ckpt,
                                          os.path.dirname(clips[0]), train, cfg.model, n_blocks,
                                          dev, smi, np.random.default_rng(9))
    torch.cuda.empty_cache()
    shutil.rmtree(os.path.join(work, "eval"), ignore_errors=True)
    mark("4h")
    # 4i. the data pipeline: a raw tree through preprocess, split, pack, train
    report["data_pipeline"] = run_data_pipeline(os.path.join(work, "data"), cfg.model, smi)
    shutil.rmtree(os.path.join(work, "data"), ignore_errors=True)
    torch.cuda.empty_cache()
    mark("4i")
    # 4j. v1 at its default widths on the fused attention route, over 4d's pack
    report["v1"] = run_v1(os.path.join(work, "v1"), train["pack"], os.path.dirname(clips[0]),
                          smi, dev, np.random.default_rng(13))
    shutil.rmtree(os.path.join(work, "v1"), ignore_errors=True)
    shutil.rmtree(os.path.join(work, "train"), ignore_errors=True)
    torch.cuda.empty_cache()
    mark("4j")

    # 5. protocol chain and one vocode, timed
    models = load_models(ckpt, device=dev)
    s = np.load(clips[0])
    motion, lyrics = s["motion"], s["lyrics"]
    times = {}
    # each chain twice: the first call captures its cache entry's CUDA graph
    # (its first step the capture's warm-up), the second is timed and only
    # replays. DDIM-2 is timed too: a chain's seconds less DDIM-2's, over its
    # steps less 2, is the marginal time of a step without the per-call set-up
    for label, kw in (("ddim2", dict(method="ddim", ddim_steps=2)),
                      ("ddim50", dict(method="ddim", ddim_steps=50)),
                      (f"ddpm{args.ddpm_steps}", dict(method="ddpm",
                                                      steps=args.ddpm_steps))):
        n_fwd = kw.get("ddim_steps") or kw["steps"]
        for key in (f"{label}_first", label):
            _build.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mel = generate_mel(models, motion, lyrics, MEL_T, guidance_weight=2.1, seed=3,
                               **kw)[0]
            torch.cuda.synchronize()
            times[key] = time.perf_counter() - t0
            need(mel.shape == (1, 80, MEL_T) and np.isfinite(mel).all(), f"{label}: bad mel")
            need(_build.LAUNCHES["conv3_fused"] == 2 * n_blocks * n_fwd,
                 f"{label}: {dict(_build.LAUNCHES)}")
        marginal = ("" if label == "ddim2" else
                    f", marginal {(times[label] - times['ddim2']) / (n_fwd - 2) * 1e3:.2f} "
                    "ms per step")
        log(f"[chain] {label}: B=1 T={MEL_T} CFG 2.1 bf16, cached (CUDA graph replays): "
            f"{times[label]:.4f} s, {MEL_T / times[label]:.1f} mel frames/s, "
            f"{times[label] / n_fwd * 1e3:.2f} ms per step (2-row forward){marginal}; the "
            f"first call with its capture {times[label + '_first']:.4f} s")
    voc = Vocoder(device=dev, seed=0)
    voc.mel_to_wav(mel[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wav = voc.mel_to_wav(mel[0])
    torch.cuda.synchronize()
    times["vocode"] = time.perf_counter() - t0
    need(wav.shape == (1, 256 * MEL_T) and np.isfinite(wav).all(), "vocode: bad wav")
    log(f"[vocode] {MEL_T} frames -> {wav.shape[1]} samples, BIGVGAN_22KHZ_80BAND bf16: "
        f"{times['vocode']:.3f} s")
    del voc

    report["profile"] = profile_chain(models, motion, lyrics, steps=10)
    mark("5")

    # 5b. long form, timed, and the length where the fused route starts to win
    report["longform"] = run_long_form(models, rng, ddim_steps=10, n_blocks=n_blocks)
    report["route_break_even"] = route_break_even(models, rng)
    # 5c. cached chains against eager chains, the cache's captures and memory
    report["graphs"] = graph_vs_eager_chains(models, clips, rng)
    report["sampler_cache"] = sampler_cache_memory(models, "after phases 5-5c")
    mark("5b-5c")

    # 6. references on the host CPU
    cpu_models = load_models(ckpt, device="cpu")
    for rows in (PROTOCOL_ROWS, MAIN_ROWS, DISTILL_ROWS):
        unet_err[rows] = unet_card_vs_host(models, cpu_models, rng, rows, "")
    del cpu_models
    mel32 = rng.standard_normal((1, 80, 32)).astype(np.float32) + FALLBACK_MEL_MEAN
    wv = [Vocoder(device=d, seed=0, compute_dtype="float32").mel_to_wav(mel32)
          for d in (dev, "cpu")]
    voc_err = float(np.abs(wv[0] - wv[1]).max())
    log(f"[reference] vocoder, 32 frames, full width, fp32: card vs host max abs "
        f"{voc_err:.3e} (tolerance {VOCODER_MAX_ABS})")
    need(voc_err <= VOCODER_MAX_ABS, "vocoder disagrees with the host reference")
    # 6b. the long-form forward, attention kernel against the plain core
    unet_err["fused_long"] = unet_kernel_vs_plain_core(models, rng, LONG_T)
    mark("6")

    shutil.rmtree(work, ignore_errors=True)
    kernels = []
    for name, meta in KERNELS.items():
        k = per[name]
        kernels.append({
            "name": name, "route": meta["route"], "source": meta["source"],
            "replaces": meta["replaces"], "launches": launches[name],
            "max_abs_err": k["err"], "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k["library_ms"],
        })
    log(f"[kernels] ms, plain_ms, bound_ms, library_ms: sums over one {MAIN_ROWS}-row "
        "flagship UNet forward as cli sample runs it (gn_stats, library = torch.var_mean "
        "+ rsqrt; conv3_fused, library = F.conv1d of the same conv3; attention on the "
        "fused route, library = F.scaled_dot_product_attention), over one "
        f"{MEL_T}-frame vocode (snake_sandwich), over one B={TRAIN_B} train step's backward "
        "of the blocks the training gate routes (conv3_dgrad and conv3_wgrad, library = "
        "aten.convolution_backward; gn_bwd, library = aten.native_group_norm_backward) and "
        "over one update of the full flagship tree at fp32 state (adan_ema); launches from "
        "cli sample and towav (attention: cli sample of the fused_attention checkpoint; the "
        "training kernels: cli train's 6 steps); max_abs_err over every geometry checked "
        "(the backward kernels' relative L2 errors are in the [backward] lines)")
    report.update(device=smi, build_s=build_s, launches=launches, expected=expected,
                  serve=dict(replies=replies, launches=serve_launches, seconds=serve_s),
                  fused=dict(launches=fused_launches, seconds=fused_s),
                  sample_s=sample_s, towav_s=towav_s, times=times, unet_rel_l2=unet_err,
                  vocoder_max_abs=voc_err, kernels=kernels, tolerances=TOL,
                  phase_s=phase_s, total_s=time.perf_counter() - t_start)
    with open(os.path.join(args.out, "report.json"), "w") as f:
        json.dump(report, f, indent=1)
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
