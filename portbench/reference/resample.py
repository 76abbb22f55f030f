"""Condition features at 30 fps resampled to the mel's frames: per channel
linear interpolation at ``linspace(0, T - 1, target)`` (``np.interp``)."""

from __future__ import annotations

import numpy as np


def interp_frames(arr: np.ndarray, target: int) -> np.ndarray:
    """(T, D) -> (target, D), float32."""
    t = arr.shape[0]
    if t == target:
        return arr.astype(np.float32)
    pos = np.linspace(0.0, t - 1.0, target)
    cols = [np.interp(pos, np.arange(t), arr[:, d].astype(np.float64)) for d in range(arr.shape[1])]
    return np.stack(cols, axis=1).astype(np.float32)
