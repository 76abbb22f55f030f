#!/usr/bin/env python3
"""Device times of the resblock, attention, resblock backward and sandwich
kernels of a tree of this repository under this tree's timer, and host times
of an attention call.

    python3 scripts/torch_kernel_times.py [--tree DIR] [--label NAME] [--out FILE]
                                          [--only resblock,attention,backward,sandwich,narrow]

Runs phases 3 and 3b (the resblock forward kernels, ``gn_stats`` and
``conv3_fused``, at the 15 flagship blocks at 4 rows, 16 rows and 2 rows of
T=516 and 2 rows of T=12920), 3c (the attention kernel at every 6 s and 150 s
geometry) and 3d (the resblock backward kernels, ``gn_bwd`` among them, at
the 15 flagship blocks, B=16) and the sandwich phase (the snake sandwich at
the 7 geometries of a 516-frame vocode, one row a geometry, and the sum a
vocode) of ``DIR/chip_smoke.py`` (default: this tree) on the kernels of
``DIR/lm2a_tpu_torch``, with ``Timer`` taken from this tree's
``chip_smoke.py``: it spins the card after each L2 flush, so the CUDA events
time the device's work and not the host's launch latency. The sandwich phase
also profiles one vocode of ``DIR``'s vocoder with this tree's
``profile_vocode`` (device time by group, busy share, launches). An older commit
unpacked with ``git archive`` into an ignored directory is so timed as this
tree times itself; run the two in one call (older, newer, newer, older) to
compare them. ``--only`` names the phases to run (all but ``narrow`` by
default). ``narrow`` times the resblock kernels at the blocks of the narrow
base widths 12, 20, 32 and 48 (``NARROW_BASES``), each block at its own T,
all of them in the kernels' masked forms: one 4-row forward's ``gn_stats``
+ ``conv3_fused`` chains, and one B=16 step's block backwards
(``conv3_dgrad``, ``conv3_wgrad``, ``gn_bwd`` and the glue between them),
summed over the blocks. With the attention phase it also prints

- the host time of one ``attention_core`` call at each 6 s site (two clips'
  conditioned rows, the main path's call): 200 calls enqueued back to back,
  which the device's work (shorter, and queued) does not hold up;
- the host time of one ``cuTensorMapEncodeTiled`` of a 6 s query view (the
  attention wrapper encodes three a call), through ctypes, and ctypes' own
  cost of a call with the same twelve arguments (to libc's
  ``getpagesize``, which ignores them); the encode is the difference.

Needs one NVIDIA GPU; it fails without one.
"""

from __future__ import annotations

import argparse
import ast
import ctypes
import importlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_tree(tree: str):
    """``DIR/chip_smoke.py`` with its package, its ``Timer`` and
    ``profile_vocode`` replaced by this tree's."""
    sys.path.insert(0, tree)
    cs = importlib.import_module("chip_smoke")
    if os.path.dirname(os.path.abspath(cs.__file__)) != tree:
        raise SystemExit(f"chip_smoke came from {cs.__file__}, not {tree}")
    src = open(os.path.join(ROOT, "chip_smoke.py")).read()
    for node in ast.parse(src).body:
        if getattr(node, "name", None) in ("Timer", "profile_vocode"):
            exec(ast.get_source_segment(src, node), cs.__dict__)
    return cs


NARROW_BASES = (12, 20, 32, 48)


def narrow_times(cs, timer, dev, gen, bases=NARROW_BASES):
    """{base: (blocks, forward ms, backward ms)}: the device ms of every block
    of ``ModelConfig(base_dim=base)`` at its own T through the forward chain
    (``cs.MAIN_ROWS`` rows) and the block backward (``cs.TRAIN_B`` rows), on
    the kernels of the loaded tree."""
    import torch

    rb = importlib.import_module("lm2a_tpu_torch.ops.resblock")
    rg = importlib.import_module("lm2a_tpu_torch.ops.resblock_grad")
    out = {}
    for base in bases:
        blocks = cs.resblock_geometries(cs.ModelConfig(base_dim=base), cs.MEL_T)
        fwd = bwd = 0.0
        for _, t, cin, cout, skip, add_res in blocks:
            w, x, (fs, fh) = cs.random_chain(gen, cs.MAIN_ROWS, t, cin, cout, skip, dev)
            fwd += timer.ms(lambda: rb.fused_resblock_chain(x, w, fs, fh, add_residual=add_res))
            w, x, (fs, fh) = cs.random_chain(gen, cs.TRAIN_B, t, cin, cout, skip, dev)
            h, _, saved = rg.chain_forward(x, fs, fh, w.gn1_scale, w.gn1_bias, w.conv1_w,
                                           w.conv1_b, w.gn2_scale, w.gn2_bias, w.conv2_w,
                                           w.conv2_b, w.skip_w, w.skip_b, w.groups1, w.groups2)
            gh = torch.randn(h.shape, generator=gen).to(dev, torch.bfloat16)
            gx = torch.randn(h.shape, generator=gen).to(dev, torch.bfloat16) if skip else None
            args = (saved, w.gn1_scale, w.gn1_bias, w.conv1_w, w.gn2_scale, w.gn2_bias,
                    w.conv2_w, w.skip_w, gh, gx)
            bwd += timer.ms(lambda: rg.chain_backward(*args))
        out[base] = dict(blocks=len(blocks), forward_ms=fwd, backward_ms=bwd)
    return out


def attention_host_us(cs, att, dev, gen, reps: int = 200):
    """(site, host microseconds a call) at the 6 s sites, two clips."""
    import torch

    mc = cs.ModelConfig()
    b, h, s = cs.N_CLIPS, mc.attn_heads, cs.MEL_T
    out = []
    for name, t, c in cs.attention_sites(mc, cs.MEL_T):
        hd = c // h

        def make(n):  # heads split off channels-last projections, as the model does
            return (torch.randn((b, n, h * hd), generator=gen).to(dev, torch.bfloat16)
                    .view(b, n, h, hd).transpose(1, 2))

        q, k, v = make(t), make(s), make(s)
        att.attention_core(q, k, v)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            att.attention_core(q, k, v)
        us = (time.perf_counter() - t0) / reps * 1e6
        torch.cuda.synchronize()
        out.append((name, us))
    return out


def encode_us(dev, reps: int = 20000, rounds: int = 5):
    """Host microseconds of one cuTensorMapEncodeTiled of a 6 s query view
    ((B, T, H, hd) = (2, 516, 8, 32) bf16, a 128-row box, 64-byte swizzle,
    as the attention kernel's wrapper encodes it) through ctypes, and of
    ctypes' marshalling of the same arguments alone: (encode less
    marshalling, encode, marshalling), or Nones where the driver refuses
    the map. A call refused for a null map is no baseline: the driver's
    error path takes longer than an encode."""
    import torch

    fn = ctypes.CDLL("libcuda.so.1").cuTensorMapEncodeTiled
    u32, u64 = ctypes.c_uint32, ctypes.c_uint64
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, u32, ctypes.c_void_p, ctypes.POINTER(u64),
                   ctypes.POINTER(u64), ctypes.POINTER(u32), ctypes.POINTER(u32),
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    # the same marshalling into a C function that ignores its arguments
    # (extra arguments are the caller's to clean up in the C calling convention)
    base = ctypes.CDLL(None).getpagesize
    base.restype, base.argtypes = ctypes.c_int, fn.argtypes
    buf = ctypes.create_string_buffer(128 + 64)  # a CUtensorMap, 64-byte aligned
    dst = (ctypes.addressof(buf) + 63) // 64 * 64
    x = torch.empty((2, 516, 8, 32), dtype=torch.bfloat16, device=dev)
    # hd innermost, then (h, t, b) by increasing stride, as the kernel orders them
    dims = (u64 * 4)(32, 8, 516, 2)
    strides = (u64 * 3)(64, 512, 516 * 512)
    box, elem = (u32 * 4)(32, 1, 128, 1), (u32 * 4)(1, 1, 1, 1)
    # bf16 = 9, no interleave, 64-byte swizzle = 2, L2 promotion 256 B = 3, no OOB NaN fill
    args = (dst, 9, 4, x.data_ptr(), dims, strides, box, elem, 0, 2, 3, 0)
    if fn(*args) != 0:
        return None, None, None
    best_enc = best_base = float("inf")
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(*args)
        t1 = time.perf_counter()
        for _ in range(reps):
            base(*args)
        t2 = time.perf_counter()
        best_enc, best_base = min(best_enc, t1 - t0), min(best_base, t2 - t1)
    enc, mar = best_enc / reps * 1e6, best_base / reps * 1e6
    return enc - mar, enc, mar


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=ROOT, help="root of the tree whose kernels are timed")
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "kernel_times.json"))
    ap.add_argument("--only", default="resblock,attention,backward,sandwich",
                    help="comma-separated phases: resblock (3, 3b), attention (3c), backward "
                         "(3d), sandwich (3's sandwich and a profiled vocode), narrow (the "
                         "resblock kernels at the narrow bases' blocks)")
    args = ap.parse_args(argv)
    phases = set(args.only.split(","))
    if not phases <= {"resblock", "attention", "backward", "sandwich", "narrow"}:
        raise SystemExit(f"unknown phases in --only {args.only}")
    tree = os.path.abspath(args.tree)
    cs = load_tree(tree)
    import torch

    if not torch.cuda.is_available():
        print("kernel times: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[times] {args.label}: {tree}; {smi}", flush=True)
    build_s = cs._build.build_all()
    print(f"[times] {args.label}: built in {build_s:.1f} s", flush=True)
    att = importlib.import_module("lm2a_tpu_torch.ops.attention")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    timer = cs.Timer(dev)
    report = dict(label=args.label, tree=tree, device=smi)
    keep = ("ms", "plain_ms", "library_ms", "bound_ms")

    def show(what, k):
        print(f"[times] {args.label}: {what} "
              + " ".join(f"{n} {k[n]:.4f}" for n in keep if k.get(n) is not None), flush=True)

    if "resblock" in phases:
        rb = importlib.import_module("lm2a_tpu_torch.ops.resblock")
        if hasattr(rb, "empty_kernel"):
            report["empty_kernel_ms"] = timer.ms(lambda: rb.empty_kernel(dev))
            print(f"[times] {args.label}: an empty kernel "
                  f"{report['empty_kernel_ms'] * 1e3:.2f} us a launch", flush=True)
        for rows, mel_t in ((cs.MAIN_ROWS, cs.MEL_T), (cs.WINDOW_ROWS, cs.MEL_T),
                            (cs.PROTOCOL_ROWS, cs.MEL_T), (cs.PROTOCOL_ROWS, cs.LONG_T)):
            per, _ = cs.phase_resblock(timer, dev, gen, rows, mel_t)
            report[f"resblock_{rows}x{mel_t}"] = per
            for name, k in per.items():
                show(f"{name} per {rows}-row forward at T={mel_t} (30 launches)", k)
    if "attention" in phases:
        attn, _ = cs.phase_attention(timer, dev, gen)
        report["attention"] = attn
        for route, k in attn.items():
            show(f"attention {route}", k)
    if "backward" in phases:
        bwd, _ = cs.phase_backward(timer, dev, gen)
        report["backward"] = bwd
        for name, k in bwd.items():
            show(f"{name} per step", k)
    if "sandwich" in phases:
        per, rows = cs.phase_sandwich(timer, dev, gen)
        per.pop("profile", None)
        report["sandwich"], report["sandwich_rows"] = per, rows
        for r in rows:
            print(f"[times] {args.label}: sandwich {r['name']} T={r['T']} C={r['C']} "
                  f"x{r['uses']}: ms {r['ms']:.4f} bound_ms {r['bound_ms']:.4f}", flush=True)
        show("snake_sandwich per 516-frame vocode (109 launches)", per)
        import numpy as np

        mel = np.random.default_rng(6).standard_normal((1, 80, cs.MEL_T)).astype(np.float32)
        report["vocode_profile"] = cs.profile_vocode(cs.Vocoder(device=dev, seed=0), mel,
                                                     f" ({args.label})")
    if "narrow" in phases:
        report["narrow"] = narrow_times(cs, timer, dev, gen)
        for base, k in report["narrow"].items():
            print(f"[times] {args.label}: base {base}, {k['blocks']} blocks at their own T: "
                  f"forward chains ({cs.MAIN_ROWS} rows) {k['forward_ms']:.4f} ms, block "
                  f"backwards (B={cs.TRAIN_B}) {k['backward_ms']:.4f} ms", flush=True)
    if "attention" in phases:
        host = attention_host_us(cs, att, dev, gen)
        enc, enc_call, marshal = encode_us(dev)
        report.update(attention_host_us=host, encode_us=enc, encode_call_us=enc_call,
                      marshal_us=marshal)
        mean = sum(us for _, us in host) / len(host)
        print(f"[times] {args.label}: attention_core host us a call at 6 s, mean {mean:.2f}: "
              + ", ".join(f"{n} {us:.2f}" for n, us in host), flush=True)
        print(f"[times] {args.label}: cuTensorMapEncodeTiled host us "
              + ("not measured (cuTensorMapEncodeTiled refused the map)" if enc is None else
                 f"{enc:.3f} (the call {enc_call:.3f} less ctypes' marshalling {marshal:.3f})"),
              flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
