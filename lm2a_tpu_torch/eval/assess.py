"""Mel-domain model assessment, the reference's ``val.py`` workflow (port of
``lm2a_tpu/eval/assess.py``).

``assess_batch`` picks a seeded random subset of test npz clips (default 10,
as ``reference/val.py:248,328-332``), generates each with guidance 2.1
(distilled-aware), computes the mel metrics, writes per-sample txt, mel-pair
and metric-bar PNGs, then the averaged metrics, and removes its temp dirs at
the end rather than per sample.

Generation is the port's serving route: ``load_models`` once (on the card
unless ``device="cpu"``), then ``sample_from_npz`` per clip, which runs the
cached sampler chain (a CUDA graph replay on the card after its first
chain) through the resblock kernels and, for a ``fused_attention``
checkpoint, the attention kernel. ``_plt()`` returns None without
matplotlib, and the PNGs are then skipped.
"""

from __future__ import annotations

import os
import random
import shutil
from typing import Dict, List, Optional

import numpy as np

from lm2a_tpu_torch.data.schema import load_sample, normalize_mel_layout
from lm2a_tpu_torch.eval.mel_metrics import compute_metrics
from lm2a_tpu_torch.core.device import DeviceLike
from lm2a_tpu_torch.inference.sample import (
    LoadedModels,
    load_models,
    resolve_eval_guidance,
    sample_from_npz,
)


def _plt():
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        return plt
    except Exception:
        return None


def visualize_mel_pair(real_mel, gen_mel, save_path: str) -> None:
    plt = _plt()
    if plt is None:
        return
    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(12, 8), sharex=True)
    im1 = ax1.imshow(real_mel, aspect="auto", origin="lower")
    ax1.set_title("Real Mel Spectrogram")
    fig.colorbar(im1, ax=ax1)
    im2 = ax2.imshow(gen_mel, aspect="auto", origin="lower")
    ax2.set_title("Generated Mel Spectrogram")
    fig.colorbar(im2, ax=ax2)
    plt.xlabel("Time Frames")
    plt.tight_layout()
    plt.savefig(save_path)
    plt.close(fig)


def visualize_metrics(metrics: Dict[str, float], save_path: str) -> None:
    plt = _plt()
    if plt is None:
        return
    keys = list(metrics.keys())
    values = [float(v) for v in metrics.values()]
    lower_better = {"mse", "mean_error", "std_error"}
    colors = []
    for k, v in zip(keys, values):
        if k in lower_better:
            n = min(max(v / 2.0, 0.0), 1.0)
            colors.append((n, 1 - n, 0))
        else:
            n = min(max(v, 0.0), 1.0)
            colors.append((1 - n, n, 0))
    plt.figure(figsize=(10, 6))
    plt.bar(keys, values, color=colors)
    plt.title("Mel Spectrogram Generation Metrics")
    plt.ylabel("Value")
    plt.grid(axis="y", alpha=0.3)
    for i, v in enumerate(values):
        plt.text(i, v + 0.01, str(round(v, 6)), ha="center")
    plt.savefig(save_path, bbox_inches="tight")
    plt.close()


def assess_single_sample(
    npz_path: str,
    ckpt_path: str,
    out_dir: str,
    steps: int = 1000,
    guidance: Optional[float] = None,
    models: Optional[LoadedModels] = None,
    save_png: bool = True,
    device: DeviceLike = None,
):
    """Generate one clip and score it; returns (metrics, temp_dir).

    ``guidance`` None resolves distilled-aware (``resolve_eval_guidance``):
    2.1 for an undistilled checkpoint (the reference protocol,
    ``reference/val.py:192``), the checkpoint's folded 1.0 for a distilled
    student (an explicit 2.1 would guide it twice)."""
    os.makedirs(out_dir, exist_ok=True)
    if models is None:
        models = load_models(ckpt_path, device=device)
    guidance = resolve_eval_guidance(models, guidance)
    base = os.path.splitext(os.path.basename(npz_path))[0]
    temp_dir = os.path.join(out_dir, f"temp_{base}")

    gen_npz = sample_from_npz(
        npz_path, ckpt_path, temp_dir,
        steps=steps, guidance_weight=guidance, save_png=False, models=models,
    )
    real_mel = normalize_mel_layout(load_sample(npz_path).mel)
    gen_mel = normalize_mel_layout(np.load(gen_npz)["mel"])
    metrics = compute_metrics(real_mel, gen_mel)

    with open(os.path.join(out_dir, f"{base}_metrics.txt"), "w") as f:
        f.write(f"sample: {base}\n" + "=" * 50 + "\n")
        for k, v in metrics.items():
            f.write(f"{k}: {v}\n")
    if save_png:
        visualize_mel_pair(real_mel, gen_mel, os.path.join(out_dir, f"{base}_mel_pair.png"))
        visualize_metrics(metrics, os.path.join(out_dir, f"{base}_metrics.png"))
    shutil.copy(gen_npz, os.path.join(out_dir, f"{base}_gen_mel.npz"))
    return metrics, temp_dir


def assess_batch(
    npz_dir: str,
    ckpt_path: str,
    out_dir: str,
    max_samples: Optional[int] = 10,
    random_sample: bool = True,
    random_seed: int = 42,
    steps: int = 1000,
    guidance: Optional[float] = None,
    save_png: bool = True,
    device: DeviceLike = None,
) -> Dict[str, float]:
    files = [f for f in os.listdir(npz_dir) if f.endswith(".npz")
             and f != "motion_stats.npz"]
    if random_sample and files:
        random.Random(random_seed).shuffle(files)
    else:
        files = sorted(files)
    if max_samples and max_samples < len(files):
        files = files[:max_samples]

    models = load_models(ckpt_path, device=device)  # once: the chain cache serves every clip
    guidance = resolve_eval_guidance(models, guidance)
    if models.distilled_steps:
        print(f"[assess] distilled checkpoint: guidance {guidance}, "
              f"ddim-{models.distilled_steps} single-forward")
    all_metrics: List[Dict[str, float]] = []
    temp_dirs: List[str] = []
    for i, name in enumerate(files):
        print(f"[{i + 1}/{len(files)}] assessing {name}")
        m, tdir = assess_single_sample(
            os.path.join(npz_dir, name), ckpt_path, out_dir,
            steps=steps, guidance=guidance, models=models, save_png=save_png,
        )
        print("  " + "  ".join(f"{k}={v}" for k, v in m.items()))
        all_metrics.append(m)
        temp_dirs.append(tdir)

    avg = {
        k: round(float(np.mean([m[k] for m in all_metrics])), 6)
        for k in all_metrics[0]
    }
    with open(os.path.join(out_dir, "average_metrics.txt"), "w") as f:
        f.write(f"samples: {len(files)}\nrandom: {random_sample}\n"
                f"seed: {random_seed}\n" + "=" * 50 + "\naverages:\n")
        for k, v in avg.items():
            f.write(f"{k}: {v}\n")
    if save_png:
        visualize_metrics(avg, os.path.join(out_dir, "average_metrics.png"))

    for tdir in temp_dirs:  # deferred cleanup, as in the reference
        shutil.rmtree(tdir, ignore_errors=True)
    print("batch assessment averages:", avg)
    return avg
