"""CLI: histogram plots from evaluation_results.json (port of
``lm2a_tpu/cli/graph.py``, the same flags).

The reference's ``sometest/graph.py``: per-sample distributions (beat F1,
CLAP cosine, MFCC acoustic cosine) with mean lines. Needs matplotlib.
"""

import argparse
import json
import os

import numpy as np


def build_parser(p=None):
    p = p or argparse.ArgumentParser(description=__doc__)
    p.add_argument("results", help="evaluation_results.json path")
    p.add_argument("--out_dir", default=".", help="where to write PNGs")
    return p


METRICS = [
    ("beat_f1", "Beat F1"),
    ("cosine_similarity", "CLAP cosine similarity"),
    ("acoustic_similarity", "MFCC acoustic cosine"),
]


def main(args=None):
    args = build_parser().parse_args(args)
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    data = json.load(open(args.results))
    per_sample = data["per_sample_metrics"]
    os.makedirs(args.out_dir, exist_ok=True)
    for key, title in METRICS:
        vals = [r[key] for r in per_sample.values() if r.get(key) is not None]
        if not vals:
            print(f"skip {key}: no values")
            continue
        vals = np.asarray(vals, dtype=np.float64)
        plt.figure(figsize=(8, 5))
        plt.hist(vals, bins=20, alpha=0.8)
        plt.axvline(vals.mean(), color="red", linestyle="--",
                    label=f"mean={vals.mean():.4f}")
        plt.title(title)
        plt.legend()
        out = os.path.join(args.out_dir, f"{key}_hist.png")
        plt.savefig(out, bbox_inches="tight")
        plt.close()
        print("wrote", out)


if __name__ == "__main__":
    main()
