#!/usr/bin/env python3
"""ms a step a rank of phase 4k's data-parallel ``cli train`` for a tree of
this repository: two gloo processes of 8 rows on the one card, flagship
width, B=16, T=516, the kernel route (``--fused_resblock_grad --opt_backend
pallas``), eager.

    python3 scripts/torch_dp_step_times.py [--tree DIR] [--label NAME] [--out FILE]

Loads ``DIR/chip_smoke.py`` (default: this tree) and runs its own rank
workers on ``DIR/lm2a_tpu_torch``: 4d's pack (``TRAIN_CLIPS`` clips from
``write_clips`` at seed 7, ``cli pack``), then 4k's data-parallel run
(``TRAIN_ARGS``, ``--epochs 1``: 4 steps; ``--coordinator``,
``--num_processes 2``) through ``run_ranks``, each step call timed
synchronised by ``step_hooks``. Prints each rank's step times and their
median with the first step left out, as 4k does. An older commit unpacked
with ``git archive`` into an ignored directory is so timed as this tree
times itself; run the two in one call (older, newer, newer, older) to
compare them. Its files go under ``DIR/build/dp_step_times`` and are
removed at the end. Needs one NVIDIA GPU; it fails without one.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=ROOT, help="root of the tree whose DP step is timed")
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--out", default=None, help="write the times here as JSON")
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    cs = importlib.import_module("chip_smoke")
    if os.path.dirname(os.path.abspath(cs.__file__)) != tree:
        raise SystemExit(f"chip_smoke came from {cs.__file__}, not {tree}")
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    smi = cs.nvidia_smi_line()
    cs._build.build_all()  # once here, not in both ranks at once
    work = os.path.join(tree, "build", "dp_step_times")
    shutil.rmtree(work, ignore_errors=True)
    try:
        clips, pack = os.path.join(work, "clips"), os.path.join(work, "pack")
        cs.write_clips(clips, cs.TRAIN_CLIPS, seed=7)
        cs.run_cli(["pack", "--npz_dir", clips, "--out_dir", pack])
        port = cs.free_port()
        _, res = cs.run_ranks(work, "dp", [
            ["--save_dir", os.path.join(work, "run"), "--npz_dir", pack, *cs.TRAIN_ARGS,
             "--epochs", "1", "--coordinator", f"127.0.0.1:{port}", "--num_processes",
             str(cs.DP_RANKS), "--process_id", str(r)] for r in range(cs.DP_RANKS)])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    steps = [rr["step_ms"] for rr in res]
    median = [float(np.median(m[1:] or m)) for m in steps]
    print(f"[dp] {args.label}: {tree}; ms a step by rank {[[round(v, 2) for v in m] for m in steps]}"
          f", median (first left out) {[round(m, 2) for m in median]}; launches a rank "
          f"{res[0]['launches']}; {smi}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(label=args.label, tree=tree, device=smi, step_ms=steps,
                           median_ms=median), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
