"""Kaiser-windowed sinc anti-aliasing filters and 2x polyphase resamplers.

``kaiser_sinc_filter1d`` is a numpy copy of ``lm2a_tpu/vocoder/filters.py``
(Kaiser beta from the attenuation formula, windowed sinc, unit DC gain).
``upsample2x``/``downsample2x`` are the polyphase forms of BigVGAN's
replicate-pad + zero-stuff + depthwise filter resamplers, on channels-last
``(B, T, C)`` tensors, for even kernel sizes (the vocoder uses 12 taps).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def kaiser_beta(half_size: int, delta_f: float) -> float:
    a = 2.285 * (half_size - 1) * math.pi * delta_f + 7.95
    if a > 50.0:
        return 0.1102 * (a - 8.7)
    if a >= 21.0:
        return 0.5842 * (a - 21.0) ** 0.4 + 0.07886 * (a - 21.0)
    return 0.0


def kaiser_window(kernel_size: int, beta: float) -> np.ndarray:
    """Symmetric (periodic=False) Kaiser window, matching torch/scipy."""
    n = np.arange(kernel_size, dtype=np.float64)
    alpha = (kernel_size - 1) / 2.0
    arg = beta * np.sqrt(np.maximum(0.0, 1.0 - ((n - alpha) / alpha) ** 2))
    return np.i0(arg) / np.i0(np.float64(beta))


def kaiser_sinc_filter1d(cutoff: float, half_width: float, kernel_size: int) -> np.ndarray:
    """(kernel_size,) lowpass FIR; cutoff in cycles/sample, unit DC gain."""
    even = kernel_size % 2 == 0
    half_size = kernel_size // 2
    beta = kaiser_beta(half_size, 4.0 * half_width)
    window = kaiser_window(kernel_size, beta)
    if even:
        time = np.arange(-half_size, half_size, dtype=np.float64) + 0.5
    else:
        time = np.arange(kernel_size, dtype=np.float64) - half_size
    if cutoff == 0:
        return np.zeros(kernel_size, dtype=np.float32)
    filt = 2.0 * cutoff * window * np.sinc(2.0 * cutoff * time)
    filt /= filt.sum()
    return filt.astype(np.float32)


def _edge_pad(x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    # replicate-pad the time axis of (B, T, C)
    return F.pad(x.transpose(1, 2), (left, right), mode="replicate").transpose(1, 2)


def upsample2x(x: torch.Tensor, kernel_size: int = 12) -> torch.Tensor:
    """(B, T, C) -> (B, 2T, C):
    ``y[2i] = 2 sum_a f[2a] xp[i+a+o]``, ``y[2i+1] = 2 sum_a f[2a+1] xp[i+a+o+1]``
    with ``xp`` = x edge-padded by K/2-1 and ``o = (K/2-2)/2``."""
    if kernel_size % 4:
        raise ValueError("upsample2x: the polyphase form needs kernel_size % 4 == 0")
    k = kernel_size
    filt = kaiser_sinc_filter1d(0.25, 0.3, k)
    b, t, c = x.shape
    o = (k // 2 - 2) // 2
    xp = _edge_pad(x, k // 2 - 1, k // 2 - 1)
    even = sum((2.0 * float(filt[2 * a])) * xp[:, o + a: o + a + t] for a in range(k // 2))
    odd = sum((2.0 * float(filt[2 * a + 1])) * xp[:, o + a + 1: o + a + 1 + t]
              for a in range(k // 2))
    return torch.stack([even, odd], dim=2).reshape(b, 2 * t, c)


def downsample2x(x: torch.Tensor, kernel_size: int = 12) -> torch.Tensor:
    """(B, 2T, C) -> (B, T, C): ``y[t] = sum_k f[k] xp[2t + k]`` split into
    even/odd input phases, ``xp`` edge-padded by (K/2-1, K/2)."""
    if kernel_size % 2:
        raise ValueError("downsample2x: the polyphase form needs an even kernel_size")
    k = kernel_size
    filt = kaiser_sinc_filter1d(0.25, 0.3, k)
    t_out = (x.shape[1] + 1) // 2
    xp = _edge_pad(x, k // 2 - 1, k // 2)
    xe, xo = xp[:, 0::2], xp[:, 1::2]
    return sum(float(filt[2 * a]) * xe[:, a: a + t_out] for a in range(k // 2)) + sum(
        float(filt[2 * a + 1]) * xo[:, a: a + t_out] for a in range(k // 2))
