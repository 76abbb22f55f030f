#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``lm2a_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--ddpm_steps 1000] [--out chiprun_out/chip_smoke]

Phases, in order; any failure exits non-zero and nothing is caught and
skipped:

1. device: the card's name and power limit (``nvidia-smi``), TF32 switches
   set off explicitly and printed;
2. build: every ``lm2a_tpu_torch/csrc/*.cu`` compiled with ``nvcc`` (one
   process per source, all at once);
3. kernels against their plain PyTorch versions on the card, at every
   geometry the flagship path gives them: the resblock chain kernels
   (``gn_stats``, ``conv3_fused``) at the 15 FiLM resblocks of the flagship
   UNet (bf16) at 4 rows (``cli sample`` of two clips under CFG) and at 2
   rows (the one-clip protocol chain), the snake sandwich at the 6 vocoder stages plus
   ``activation_post`` (bf16); each with its time, its plain version's time,
   its bound and, where one PyTorch call computes the same function, that
   call's time;
4. the slice: a flagship checkpoint (random weights from a seed, JAX layout)
   and two synthetic 6 s clips, then ``cli sample`` (DDIM-50, CFG 2.1, bf16)
   and ``cli towav`` (full BIGVGAN_22KHZ_80BAND width) with the launch
   counters reset just before and read just after; outputs checked for shape
   and finiteness, counts checked against the expected launches;
5. one protocol chain (B=1, T=516, CFG 2.1, DDPM with ``--ddpm_steps``
   steps) and one vocode, timed;
6. references: full-width UNet forwards on the card against the same
   checkpoint's forwards on the host CPU (plain versions, same bf16 weights)
   at 2 and 4 CFG rows, and the full-width vocoder on a short mel, card against host CPU, fp32.

The line before the last is a JSON object ``{"kernels": [...]}``; the last
line is ``{"ok": true, "device": {...}}``. Exits non-zero with no result
when CUDA is not available. Per-geometry numbers go to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
import wave

import numpy as np
import torch
import torch.nn.functional as F

from lm2a_tpu_torch.checkpoint import save_checkpoint
from lm2a_tpu_torch.cli import sample as cli_sample
from lm2a_tpu_torch.cli import towav as cli_towav
from lm2a_tpu_torch.convert import torch_params_to_jax
from lm2a_tpu_torch.core.config import LM2AConfig, ModelConfig
from lm2a_tpu_torch.data.schema import Sample, save_sample
from lm2a_tpu_torch.inference.sample import (
    FALLBACK_MEL_MEAN, FALLBACK_MEL_STD, generate_mel, load_models,
)
from lm2a_tpu_torch.models.factory import (
    build_cond_projection, build_denoiser, param_count, random_init_,
)
from lm2a_tpu_torch.models.unet1d import default_num_groups
from lm2a_tpu_torch.ops import _build
from lm2a_tpu_torch.ops import resblock as rb
from lm2a_tpu_torch.vocoder import sandwich as sw
from lm2a_tpu_torch.vocoder.bigvgan import BIGVGAN_22KHZ_80BAND
from lm2a_tpu_torch.vocoder.vocode import Vocoder

ROOT = os.path.dirname(os.path.abspath(__file__))
# NVIDIA H100 SXM data sheet, dense: bf16 tensor cores, fp32 outside them, HBM3
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
MEL_T, MOTION_T = 516, 180
# the main path samples N_CLIPS clips in one batch; CFG doubles the rows of
# every forward. The protocol chain is one clip: 2 rows.
N_CLIPS = 2
MAIN_ROWS, PROTOCOL_ROWS = 2 * N_CLIPS, 2
FLAGSHIP_PARAMS = 134_292_816
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
}
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
}


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
    a vocode streams activations far larger than the 50 MB L2)."""

    def __init__(self, device, reps: int = 10):
        self.reps = reps
        self.flush = torch.empty(64 << 20, dtype=torch.int32, device=device)

    def ms(self, fn) -> float:
        fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(self.reps):
            self.flush.zero_()
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


def phase_resblock(timer, device, gen, rows: int):
    mc = ModelConfig()
    per = {k: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, err=0.0,
                   ops=0.0, nbytes=0.0) for k in ("gn_stats", "conv3_fused")}
    rows_out = []
    for name, t, cin, cout, has_skip, add_res in resblock_geometries(mc, MEL_T):
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
        c1 = dict(film=film, out_dtype=torch.float32)
        args1 = (x, m1, r1, w.gn1_scale, w.gn1_bias, w.conv1_w, w.conv1_b)
        f = rb.conv3_fused(*args1, **c1)
        err_conv = check_close(f"{name} conv1", f, rb.conv3_fused_plain(*args1, **c1),
                               TOL["conv3_fused"])
        m2, r2 = rb.gn_stats(f, w.groups2)
        pm2, pr2 = rb.gn_stats_plain(f, w.groups2)
        err_gn = max(err_gn, check_close(f"{name} gn2 mean", m2, pm2, TOL["gn_stats"]),
                     check_close(f"{name} gn2 rstd", r2, pr2, TOL["gn_stats"]))
        c2 = dict(out_dtype=torch.bfloat16)
        if has_skip:
            c2.update(skip=(x, w.skip_w, w.skip_b), split_skip=not add_res)
        elif add_res:
            c2.update(residual=x)
        args2 = (f, m2, r2, w.gn2_scale, w.gn2_bias, w.conv2_w, w.conv2_b)
        o2 = rb.conv3_fused(*args2, **c2)
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
            f"{g['gn1_library'] + g['gn2_library']:.4f}) conv {g['conv1'] + g['conv2']:.4f} "
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
    return per, rows_out


def phase_sandwich(timer, device, gen):
    vcfg = BIGVGAN_22KHZ_80BAND
    k = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=None, err=0.0,
             ops=0.0, nbytes=0.0)
    rows_out = []
    for name, t, c, uses in sandwich_geometries(vcfg, MEL_T):
        # channels-first activations viewed as (B, T, C), as the vocoder passes them
        x = torch.randn((1, c, t), generator=gen).to(device, torch.bfloat16).transpose(1, 2)
        alpha = torch.exp(0.3 * torch.randn(c, generator=gen)).to(device)
        beta = torch.exp(0.3 * torch.randn(c, generator=gen)).to(device)
        got = sw.snake_sandwich(x, alpha, beta)
        err = check_close(f"sandwich {name}", got, sw.snake_sandwich_plain(x, alpha, beta),
                          TOL["snake_sandwich"])
        need(got.stride() == x.stride(), f"sandwich {name}: output layout changed")
        ms = timer.ms(lambda: sw.snake_sandwich(x, alpha, beta))
        plain = timer.ms(lambda: sw.snake_sandwich_plain(x, alpha, beta))
        # x read once, z written once (bf16); 58 fp32 operations per output:
        # 2x6 up taps x2 phases (24), snake on both phases (10), 12 down taps (24)
        nbytes, ops = 4.0 * t * c + 8 * c + 48, 58.0 * t * c
        bnd, by = bound_ms(nbytes, ops, PEAK_FP32)
        k["ms"] += uses * ms
        k["plain_ms"] += uses * plain
        k["bound_ms"] += uses * bnd
        k["ops"] += uses * ops
        k["nbytes"] += uses * nbytes
        k["err"] = max(k["err"], err)
        rows_out.append(dict(name=name, T=t, C=c, uses=uses, ms=ms, plain_ms=plain,
                             bound_ms=bnd, bound_by=by, err=err,
                             gbps=nbytes / ms / 1e6))
        log(f"[sandwich] {name:15s} T={t:6d} C={c:4d} x{uses:2d} | err {err:.2e} | "
            f"ms {ms:.4f} (plain {plain:.4f}, bound {bnd:.4f} {by}) "
            f"{nbytes / ms / 1e6:.0f} GB/s")
    k["bound_by"] = ("operations" if k["ops"] / PEAK_FP32 > k["nbytes"] / PEAK_BYTES
                     else "bytes")
    return k, rows_out


# ---------------------------------------------------------------- phase 4

def write_checkpoint(ckpt_dir: str, cfg: LM2AConfig, seed: int) -> str:
    """Random weights from ``seed`` written in the JAX checkpoint layout."""
    unet = random_init_(build_denoiser(cfg.model), seed)
    proj = random_init_(build_cond_projection(cfg.model), seed + 1)
    return save_checkpoint(ckpt_dir, 0, torch_params_to_jax(unet.state_dict()),
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


# ---------------------------------------------------------------- where the time goes

def profile_chain(models, motion, lyrics, steps: int):
    """Device kernel time by name over a ``steps``-step DDIM chain (B=1, CFG
    2.1) under torch.profiler, and the device's busy share of the window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run = lambda: generate_mel(models, motion, lyrics, MEL_T, method="ddim",  # noqa: E731
                               ddim_steps=steps, guidance_weight=2.1, seed=4)
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                  key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    log(f"[profile] DDIM-{steps} chain, B=1 CFG 2.1: wall {wall_ms:.2f} ms "
        f"({wall_ms / steps:.2f} ms/step), device kernels {busy_ms:.2f} ms, busy share "
        f"{busy_ms / wall_ms:.3f}, {sum(r[2] for r in rows)} kernels")
    for name, ms, n in rows[:12]:
        log(f"[profile]   {ms:9.3f} ms {n:6d}x  {name[:90]}")
    return dict(steps=steps, wall_ms=wall_ms, busy_ms=busy_ms,
                kernels=[dict(name=r[0], ms=r[1], count=r[2]) for r in rows])


# ---------------------------------------------------------------- main

def nvidia_smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True, text=True,
                       timeout=60)
    need(r.returncode == 0, f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


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

    # 3. kernels against their plain versions
    gen = torch.Generator().manual_seed(0)
    timer = Timer(dev)
    # the kernels line times the main path's rows; errors count both row counts
    per, report["resblock"] = phase_resblock(timer, dev, gen, rows=MAIN_ROWS)
    per_protocol, report["resblock_protocol"] = phase_resblock(timer, dev, gen,
                                                               rows=PROTOCOL_ROWS)
    for k in per_protocol:
        per[k]["err"] = max(per[k]["err"], per_protocol[k]["err"])
    report["resblock_protocol_sums"] = per_protocol
    per["snake_sandwich"], report["sandwich"] = phase_sandwich(timer, dev, gen)
    del timer

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
    n_sandwich = sum(u for *_, u in sandwich_geometries(BIGVGAN_22KHZ_80BAND, MEL_T))
    ddim_steps = 50
    _build.reset_launches()
    gens, wavs, sample_s, towav_s = run_slice(
        ckpt, os.path.dirname(clips[0]), os.path.join(work, "out"), "cuda", ddim_steps,
        "bigvgan_22khz_80band")
    launches = dict(_build.LAUNCHES)
    check_outputs(gens, wavs, len(clips), MEL_T, BIGVGAN_22KHZ_80BAND.hop)
    expected = {"gn_stats": 2 * n_blocks * ddim_steps,
                "conv3_fused": 2 * n_blocks * ddim_steps,
                "snake_sandwich": n_sandwich * len(clips)}
    log(f"[slice] cli sample (DDIM-{ddim_steps}, CFG 2.1, {len(clips)} clips, bf16) "
        f"{sample_s:.2f} s; cli towav ({len(clips)} clips, BIGVGAN_22KHZ_80BAND) "
        f"{towav_s:.2f} s; launches {launches} expected {expected}")
    need(launches == expected, f"launch counts {launches} != expected {expected}")

    # 5. protocol chain and one vocode, timed
    models = load_models(ckpt, device=dev)
    s = np.load(clips[0])
    motion, lyrics = s["motion"], s["lyrics"]
    times = {}
    # warm-up at the timed shapes: cuBLAS/cuDNN pick their kernels on first use
    generate_mel(models, motion, lyrics, MEL_T, guidance_weight=2.1, method="ddim", ddim_steps=2)
    # DDIM-2 is timed too: a chain's seconds less DDIM-2's, over its steps less
    # 2, is the marginal time of a step without the per-call set-up
    for label, kw in (("ddim2", dict(method="ddim", ddim_steps=2)),
                      ("ddim50", dict(method="ddim", ddim_steps=50)),
                      (f"ddpm{args.ddpm_steps}", dict(method="ddpm",
                                                      steps=args.ddpm_steps))):
        _build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mel = generate_mel(models, motion, lyrics, MEL_T, guidance_weight=2.1, seed=3, **kw)[0]
        torch.cuda.synchronize()
        times[label] = time.perf_counter() - t0
        need(mel.shape == (1, 80, MEL_T) and np.isfinite(mel).all(), f"{label}: bad mel")
        n_fwd = kw.get("ddim_steps") or kw["steps"]
        need(_build.LAUNCHES["conv3_fused"] == 2 * n_blocks * n_fwd,
             f"{label}: {dict(_build.LAUNCHES)}")
        marginal = ("" if label == "ddim2" else
                    f", marginal {(times[label] - times['ddim2']) / (n_fwd - 2) * 1e3:.2f} "
                    "ms per step")
        log(f"[chain] {label}: B=1 T={MEL_T} CFG 2.1 bf16: {times[label]:.4f} s, "
            f"{MEL_T / times[label]:.1f} mel frames/s, "
            f"{times[label] / n_fwd * 1e3:.2f} ms per step (2-row forward){marginal}")
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

    report["profile"] = profile_chain(models, motion, lyrics, steps=10)

    # 6. references on the host CPU
    rng = np.random.default_rng(5)
    cpu_models = load_models(ckpt, device="cpu")
    unet_err = {}
    for rows in (PROTOCOL_ROWS, MAIN_ROWS):
        n = rows // 2  # clips; the first n rows are their unconditional halves
        x = torch.as_tensor(rng.standard_normal((rows, MEL_T, 80)).astype(np.float32))
        t = torch.as_tensor(np.tile(rng.integers(0, 1000, n), 2))  # same t per CFG pair
        conds = [torch.as_tensor(rng.standard_normal((n, MEL_T, cfg.model.cond_dim)),
                                 dtype=torch.float32) for _ in range(2)]
        conds = [torch.cat([torch.zeros_like(c), c]) for c in conds]
        outs = []
        for m, d in ((models, dev), (cpu_models, torch.device("cpu"))):
            mf, tf = (c.to(d, torch.bfloat16) for c in conds)
            with torch.no_grad():
                outs.append(m.denoiser(x.to(d), t.to(d), mf, tf, uncond_rows=n)
                            .float().cpu())
        err = unet_err[rows] = rel_l2(outs[0], outs[1])
        log(f"[reference] UNet forward, {rows} CFG rows (uncond_rows={n}), T={MEL_T}, "
            f"bf16: card kernels vs host plain: rel L2 {err:.3e} (tolerance "
            f"{UNET_REL_L2}), max abs {max_abs(outs[0], outs[1]):.3e}")
        need(bool(torch.isfinite(outs[0]).all()) and err <= UNET_REL_L2,
             f"UNet forward at {rows} rows disagrees with the host reference")
    del cpu_models
    mel32 = rng.standard_normal((1, 80, 32)).astype(np.float32) + FALLBACK_MEL_MEAN
    wv = [Vocoder(device=d, seed=0, compute_dtype="float32").mel_to_wav(mel32)
          for d in (dev, "cpu")]
    voc_err = float(np.abs(wv[0] - wv[1]).max())
    log(f"[reference] vocoder, 32 frames, full width, fp32: card vs host max abs "
        f"{voc_err:.3e} (tolerance {VOCODER_MAX_ABS})")
    need(voc_err <= VOCODER_MAX_ABS, "vocoder disagrees with the host reference")

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
        "+ rsqrt; conv3_fused, library = F.conv1d of the same conv3) and over one "
        f"{MEL_T}-frame vocode (snake_sandwich); launches from the main path; max_abs_err "
        f"over {MAIN_ROWS} and {PROTOCOL_ROWS} rows")
    report.update(device=smi, build_s=build_s, launches=launches, expected=expected,
                  sample_s=sample_s, towav_s=towav_s, times=times, unet_rel_l2=unet_err,
                  vocoder_max_abs=voc_err, kernels=kernels, tolerances=TOL,
                  total_s=time.perf_counter() - t_start)
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
