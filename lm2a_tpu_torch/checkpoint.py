"""Read and write the JAX package's checkpoint directories.

Layout (``lm2a_tpu/training/checkpoint.py``):

    <dir>/ckpt_step_<n>/state.npz   flat state tree, keys = jax.tree_util.keystr
    <dir>/ckpt_step_<n>.meta.json   config + dataset stats + epoch (+ extras)

Keys look like ``.ema_params['unet']['down_0_block_0']['conv1']['kernel']``.
bf16 leaves are stored as their uint16 bit patterns. Reading returns the
``unet`` and ``cond_proj`` parameter trees as flat ``"a/b/kernel"`` dicts of
float32 arrays, preferring the EMA weights. ``save_checkpoint`` here writes
the same layout with parameters only (``.step``, ``.params``,
``.ema_params``): enough for ``load_models`` and for serving, not for
resuming. The trainer's full-state writer, which either package resumes
(optimizer state included), is ``lm2a_tpu_torch.training.checkpoint``.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Dict, Optional, Tuple

import numpy as np

from lm2a_tpu_torch.core.config import LM2AConfig, config_to_dict

STATE_FILE = "state.npz"
_KEY_RE = re.compile(r"^\.(params|ema_params)((?:\['[^']*'\])+)$")
_PART_RE = re.compile(r"\['([^']*)'\]")

Flat = Dict[str, np.ndarray]


def checkpoint_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(ckpt_dir), f"ckpt_step_{step}")


def load_metadata(path: str) -> dict:
    with open(path + ".meta.json") as f:
        return json.load(f)


def _as_f32(a: np.ndarray) -> np.ndarray:
    if a.dtype == np.uint16:  # bf16 bit pattern
        return (a.astype(np.uint32) << 16).view(np.float32)
    return np.asarray(a, dtype=np.float32)


def read_params(path: str, prefer_ema: bool = True) -> Tuple[Flat, Flat]:
    """``(unet, cond_proj)`` flat float32 parameter dicts of a checkpoint."""
    trees: Dict[str, Dict[str, Flat]] = {"params": {}, "ema_params": {}}
    with np.load(os.path.join(path, STATE_FILE)) as z:
        for key in z.files:
            m = _KEY_RE.match(key)
            if not m:
                continue  # step, optimizer state
            parts = _PART_RE.findall(m.group(2))
            trees[m.group(1)].setdefault(parts[0], {})["/".join(parts[1:])] = _as_f32(z[key])
    src = trees["ema_params"] if prefer_ema and trees["ema_params"] else trees["params"]
    if "unet" not in src or "cond_proj" not in src:
        raise ValueError(f"{path}: no unet/cond_proj parameters in {STATE_FILE}")
    return src["unet"], src["cond_proj"]


def save_checkpoint(ckpt_dir: str, step: int, unet: Flat, cond_proj: Flat,
                    cfg: LM2AConfig, *, epoch: int = 0, dataset_mean: float = 0.0,
                    dataset_std: float = 1.0, extra: Optional[dict] = None) -> str:
    """Write flat flax parameter dicts as a JAX-layout checkpoint; the same
    weights go under ``.params`` and ``.ema_params``. Returns its path."""
    path = checkpoint_path(ckpt_dir, step)
    arrays = {".step": np.asarray(step, np.int32)}
    for coll in ("params", "ema_params"):
        for tree_name, flat in (("unet", unet), ("cond_proj", cond_proj)):
            for key, a in flat.items():
                parts = "".join(f"['{p}']" for p in [tree_name] + key.split("/"))
                arrays[f".{coll}{parts}"] = np.asarray(a, np.float32)
    meta = {"step": step, "epoch": epoch, "dataset_mean": float(dataset_mean),
            "dataset_std": float(dataset_std), "config": config_to_dict(cfg)}
    meta.update(extra or {})
    tmp = path + ".tmp-write"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, STATE_FILE), **arrays)
    shutil.rmtree(path, ignore_errors=True)
    os.rename(tmp, path)
    with open(path + ".meta.json", "w") as f:
        json.dump(meta, f, indent=2)
    return path
