#!/usr/bin/env python3
"""What the snake sandwich kernel's device time is made of: the kernel
against copies of itself with one part taken out.

    python3 scripts/torch_sandwich_ablation.py [--out chiprun_out/sandwich_ablation.json]

Builds, under ``build/sandwich_ablation/``, ``lm2a_tpu_torch/csrc/sandwich.cu``
as it is and with one part cut by a text substitution (each asserted to
apply): no snake (the phases go straight to the down filter), no MUFU (the
sine's argument instead of its sine), no store, a copy only (each lane
stores its loaded run and returns), the arithmetic only (no load, inputs
made from the run's position, a store that never happens but keeps the
arithmetic live), and no prefetch (each tile's loads issued when it
computes). Their outputs are wrong on purpose; only their
time is read. Each is timed with ``torch.profiler`` (the kernel's device
time, 20 launches) at the plan ``sandwich_plan`` picks for the vocoder's
late stage (B=1, T=132096, C=24, bf16, a channels-first view), once with
the L2 flushed by writing 256 MB before each launch (dirty lines to write
back, as the chip smoke's ``Timer`` leaves it) and once by reading them
(clean lines); a device copy of the same bytes (``Tensor.copy_``, a
device-to-device memcpy) is timed the same two ways. Needs one NVIDIA GPU
and nvcc; it fails without them.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from lm2a_tpu_torch.ops import _build  # noqa: E402
from lm2a_tpu_torch.vocoder import sandwich as sw  # noqa: E402

CUTS = {
    "as is": [],
    "no snake": [("  const float u = al * y;", "  return y;\n  const float u = al * y;")],
    "no MUFU": [("const float s = __sinf(r);", "const float s = r * 0.5f;")],
    "no store": [("  if (r.owner) {", "  if (r.owner && a.T < 0) {")],
    "copy only": [("  float se[RUN], so[RUN];",
                   "  if (r.owner) {\n    float o[RUN];\n    for (int j = 0; j < RUN; ++j) "
                   "o[j] = xv[3 + j];\n    store8(r.zp + r.t0, o);\n  }\n  if (a.T > 0) return;\n"
                   "  float se[RUN], so[RUN];")],
    "arithmetic only": [("    unpack(raw, xv + 3);",
                         "    for (int j = 0; j < RUN; ++j) xv[3 + j] = (r.t0 + j) * 1e-3f;"),
                        ("  if (r.vec) {\n    const uint4* p", "  if (false) {\n    const uint4* p"),
                        ("  if (r.owner) {", "  if (r.owner && out[0] == 12345.f) {")],
    "no prefetch": [("    if (tile + stride < a.tiles) {", "    if (false) {"),
                    ("    sandwich_run<T>(a, cur, raw, al, be);",
                     "    if (tile != warp) {\n      cur = locate<T>(a, tile, lane);\n"
                     "      fetch(cur, raw);\n      al = a.alpha[cur.c];\n      be = a.beta[cur.c];\n"
                     "    }\n    sandwich_run<T>(a, cur, raw, al, be);")],
}


def build(out_dir: str):
    """One library per cut, all nvcc processes at once; name -> path."""
    src = open(os.path.join(_build.CSRC, "sandwich.cu")).read()
    procs = {}
    for i, (name, subs) in enumerate(CUTS.items()):
        text = src
        for a, b in subs:
            if a not in text:
                raise SystemExit(f"cut {name!r} no longer applies to csrc/sandwich.cu: {a!r}")
            text = text.replace(a, b)
        cu = os.path.join(out_dir, f"cut{i}.cu")
        with open(cu, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, f"libcut{i}.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", lib, cu]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for cut {name!r}:\n{log}")
        libs[name] = lib
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "sandwich_ablation.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sandwich ablation: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    out_dir = os.path.join(ROOT, "build", "sandwich_ablation")
    os.makedirs(out_dir, exist_ok=True)
    libs = build(out_dir)
    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)
    t, c = 132096, 24
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((1, c, t), generator=gen).to(dev, torch.bfloat16).transpose(1, 2)
    z = torch.empty_like(x)
    la = (0.3 * torch.randn(c, generator=gen)).to(dev)
    lb = (0.3 * torch.randn(c, generator=gen)).to(dev)
    plan = sw.sandwich_plan(1, t, c, x.dtype, x.stride())

    def device_us(fn, key, dirty, reps=20):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if dirty:
                    flush.zero_()
                else:
                    flush.view(torch.float32).sum()
                fn()
            torch.cuda.synchronize()
        return sum(e.self_device_time_total for e in prof.key_averages() if key(e.key)) / reps

    report = dict(device=smi, T=t, C=c, plan=plan.__dict__, cuts={})
    print(f"[ablation] {smi}; B=1 T={t} C={c} bf16, plan {plan}", flush=True)
    for name, path in libs.items():
        fn = ctypes.CDLL(path).lm2a_snake_sandwich
        fn.argtypes = _build._argtypes[("sandwich", "lm2a_snake_sandwich")]
        fn.restype = ctypes.c_int

        def call():
            err = fn(_build.ptr(x), _build.ptr(z), 0, _build.ptr(la), _build.ptr(lb), 1, sw._TAPS,
                     1, t, c, *x.stride(), *z.stride(), plan.run, plan.warps, plan.tiles,
                     plan.blocks, _build.stream_ptr(dev))
            if err:
                raise RuntimeError(f"cut {name!r}: error {err}")

        us = {k: device_us(call, lambda key: "sandwich" in key, k == "dirty")
              for k in ("dirty", "clean")}
        report["cuts"][name] = us
        print(f"[ablation] {name:15s} device us: L2 dirty {us['dirty']:.2f}, clean "
              f"{us['clean']:.2f}", flush=True)
    is_copy = lambda key: "memcpy" in key.lower() or "copy_kernel" in key.lower()  # noqa: E731
    copy = {k: device_us(lambda: z.copy_(x), is_copy, k == "dirty") for k in ("dirty", "clean")}
    report["copy"] = copy
    print(f"[ablation] Tensor.copy_ of the same bytes, device us: L2 dirty {copy['dirty']:.2f}, "
          f"clean {copy['clean']:.2f}", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
