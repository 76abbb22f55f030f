"""Time-axis alignment of condition features (numpy, host side).

A numpy-only copy of ``lm2a_tpu/ops/resample.py``:

- ``linear_resample``   per-dim ``np.interp`` over ``linspace(0, T-1, target)``,
  done as one gather + lerp;
- ``match_len``         truncate / repeat-last / interp to a target length.
"""

from __future__ import annotations

import numpy as np


def linear_resample(arr, target_len: int, time_axis: int = 0) -> np.ndarray:
    """Linear interpolation of ``arr`` along ``time_axis`` to ``target_len``."""
    arr = np.asarray(arr)
    T = arr.shape[time_axis]
    if T == target_len:
        return arr.astype(np.float32)
    arr = np.moveaxis(arr, time_axis, 0)
    pos = np.linspace(0.0, T - 1.0, target_len)
    lo = np.clip(np.floor(pos).astype(np.int32), 0, T - 1)
    hi = np.clip(lo + 1, 0, T - 1)
    frac = (pos - lo).astype(np.float32)
    if arr.ndim > 1:
        frac = frac.reshape((target_len,) + (1,) * (arr.ndim - 1))
    out = arr[lo] * (1.0 - frac) + arr[hi] * frac
    return np.moveaxis(out.astype(np.float32), 0, time_axis)


def match_len(arr, target_len: int, mode: str = "repeat"):
    """Force length ``target_len`` along axis 0.

    ``mode='interp'``: linear resample. ``mode='repeat'``: truncate if longer,
    pad by repeating the last frame if shorter; an empty input zero-fills.
    """
    if arr is None:
        return None
    if mode == "interp":
        return linear_resample(arr, target_len, time_axis=0)
    if mode != "repeat":
        raise ValueError(f"unknown match_len mode {mode!r}")

    arr = np.asarray(arr)
    cur = arr.shape[0]
    if cur == target_len:
        return arr.astype(np.float32)
    if cur > target_len:
        return arr[:target_len].astype(np.float32)
    if cur == 0:
        return np.zeros((target_len,) + arr.shape[1:], dtype=np.float32)
    last = np.repeat(arr[-1:], target_len - cur, axis=0)
    return np.concatenate([arr, last], axis=0).astype(np.float32)
