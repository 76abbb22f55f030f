"""The readings that the limits of ``limits/`` are set from: the control and
the planted faults, on the card at a cell's own size. The benchmark's runs
never run this.

    python3 portbench/controls.py --workload <name> --seeds 1,2,3 \\
        --what sound,control,unchanged,halfbatch,altered --seconds 4

- ``sound``: the program as it is (the lower reading);
- ``control``: the reference in the program's place, computed in fp8 (e4m3,
  per-tensor scales), read against the reference in float32 (the upper
  reading);
- faults planted in the program, each one run: ``unchanged``, a step that
  returns its state unchanged (train: the optimizer updates nothing;
  sampling: the sampler's step leaves x as it was); ``ema_unchanged`` (train),
  the optimizer's update with the EMA put back as it was; ``halfbatch``, half of the
  batch left out (train: the loss is the mean over the first half of the
  rows; gen: the second half of the rows get no noise prediction);
  ``altered``, an answer altered where it is produced (sampling: one frame
  of the chain's mel moved by one standard deviation).

Prints one JSON line of readings a seed and fault.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from contextlib import contextmanager
from typing import Iterator

@contextmanager
def plant(fault: str, cell) -> Iterator[None]:
    """The program with ``fault`` planted for the block, for ``cell``'s
    driver and traffic; the original functions are put back after it."""
    import torch

    from lm2a_tpu_torch.diffusion import gaussian
    from lm2a_tpu_torch.inference import sample as sample_mod
    from lm2a_tpu_torch.training import adan, train_step

    undo = []

    def swap(obj, name, new):
        undo.append((obj, name, getattr(obj, name)))
        setattr(obj, name, new)

    train = cell.driver == "train"
    if fault == "unchanged" and train:
        swap(adan.Adan, "apply", lambda self, *a, **k: None)
    elif fault == "ema_unchanged" and train:
        apply = adan.Adan.apply

        def ema_kept(self, params, grads, ema, state, scal):
            kept = {k: e.clone() for k, e in ema.items()}
            apply(self, params, grads, ema, state, scal)
            for k, e in ema.items():
                e.copy_(kept[k])
        swap(adan.Adan, "apply", ema_kept)
    elif fault == "unchanged":
        def frozen(model_fn, x, i, *a, **k):
            i.add_(1)
        def frozen_ddpm(model_fn, schedule, x, i, *a, **k):
            i.add_(1)
        swap(gaussian, "ddim_step", frozen)
        swap(gaussian, "ddpm_step", frozen_ddpm)
    elif fault == "halfbatch" and train:
        loss_fn = train_step.loss_fn

        def half(state, schedule, batch, cfg, **kw):
            b = batch["mel"].shape[0] // 2
            return loss_fn(state, schedule, {k: v[:b] for k, v in batch.items()}, cfg, **kw)
        swap(train_step, "loss_fn", half)
    elif fault == "halfbatch" and int(cell.traffic["batch"]) > 1:
        guided = gaussian.guided_eps

        def half_rows(*a, **k):
            eps = guided(*a, **k)
            return torch.cat([eps[: eps.shape[0] // 2], torch.zeros_like(eps[eps.shape[0] // 2:])])
        swap(gaussian, "guided_eps", half_rows)
    elif fault == "altered" and not train:
        finish = sample_mod._finish

        def altered(models, out):
            mel = finish(models, out).copy()
            mel[..., mel.shape[-1] // 2] += models.dataset_std
            return mel
        swap(sample_mod, "_finish", altered)
    else:
        raise ValueError(f"no fault {fault!r} for {cell.name}")
    try:
        yield
    finally:
        for obj, name, old in reversed(undo):
            setattr(obj, name, old)


def readings(cell, seed: int, seconds: float, what: str, device) -> dict:
    """The numbers the check compares, for one seed: of the program as it
    is, of the control, or of the program with a fault planted."""
    from contextlib import nullcontext

    from portbench.harness import run_cell
    from portbench.reference.precision import FP8

    if what == "control":
        res = run_cell(cell, seed, seconds, False, device, time.perf_counter(), control=FP8)
    else:
        ctx = nullcontext() if what == "sound" else plant(what, cell)
        with ctx:
            res = run_cell(cell, seed, seconds, False, device, time.perf_counter())
    return {k: c["value"] for k, c in res["checks"].items()} | {"correct": res["correct"],
                                                                "_notes": res["_notes"]}


def main(argv) -> int:
    p = argparse.ArgumentParser(description="readings of the control and the faults")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--what", default="sound,control")
    p.add_argument("--seconds", type=float, default=4.0)
    args = p.parse_args(argv)
    import torch

    from portbench import spec

    if not torch.cuda.is_available():
        print("controls: no CUDA device", file=sys.stderr)
        return 3
    cell = spec.load_cell(args.workload)
    for what in args.what.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            r = readings(cell, seed, args.seconds, what, torch.device("cuda", 0))
            print(json.dumps({"workload": cell.name, "what": what, "seed": seed, **r}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.exit(main(sys.argv[1:]))
