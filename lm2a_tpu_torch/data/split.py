"""Deterministic train/val/test split of npz shards (a copy of
``lm2a_tpu/data/split.py``).

Same contract as ``reference/datasetcode/newsplit_npz.py:25-131``:
sorted file list, ``random.Random(seed).shuffle`` (seed 42 default — using
the same stdlib shuffle so the author's recorded 1246/356/178 split is
reproducible bit-for-bit), ratios 0.7/0.2/0.1 or exact counts, copy-or-move
into ``out/{train,val,test}``, and ``train.txt/val.txt/test.txt`` manifests.
Auxiliary files (``motion_stats.npz``, ``sample_info_list.json``) are
excluded automatically — the footgun the reference documents as "a little
bug" is just handled.
"""

from __future__ import annotations

import os
import random
import shutil
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass
class SplitResult:
    train: list
    val: list
    test: list


def split_dataset(
    npz_dir: str,
    out_dir: str,
    train_ratio: float = 0.7,
    val_ratio: float = 0.2,
    test_ratio: float = 0.1,
    counts: Optional[Tuple[int, int, int]] = None,
    seed: int = 42,
    move: bool = False,
) -> SplitResult:
    files = sorted(
        f
        for f in os.listdir(npz_dir)
        if f.endswith(".npz") and f != "motion_stats.npz"
    )
    if not files:
        raise ValueError(f"no .npz files in {npz_dir}")
    paths = [os.path.join(npz_dir, f) for f in files]
    random.Random(seed).shuffle(paths)

    n = len(paths)
    if counts is not None:
        n_train, n_val, n_test = counts
    else:
        if abs(train_ratio + val_ratio + test_ratio - 1.0) > 1e-6:
            raise ValueError("ratios must sum to 1.0")
        n_train = int(round(n * train_ratio))
        n_val = int(round(n * val_ratio))
        n_test = n - n_train - n_val
    if min(n_train, n_val, n_test) < 0 or n_train + n_val + n_test > n:
        raise ValueError(f"invalid split sizes {n_train}/{n_val}/{n_test} of {n}")

    parts = {
        "train": paths[:n_train],
        "val": paths[n_train : n_train + n_val],
        "test": paths[n_train + n_val : n_train + n_val + n_test],
    }
    op = shutil.move if move else shutil.copy2
    for name, plist in parts.items():
        dest_dir = os.path.join(out_dir, name)
        os.makedirs(dest_dir, exist_ok=True)
        for p in plist:
            op(p, os.path.join(dest_dir, os.path.basename(p)))
        manifest = os.path.join(out_dir, f"{name}.txt")
        with open(manifest, "w") as f:
            f.write("\n".join(os.path.basename(p) for p in plist))
    return SplitResult(parts["train"], parts["val"], parts["test"])
