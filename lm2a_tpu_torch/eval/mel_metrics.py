"""Mel-domain evaluation metrics.

Parity with ``reference/val.py:25-113``: MSE, SSIM on jointly
min-max-normalized mels, frame-wise cosine similarity, absolute mean/std
errors, and SNR = 10*log10(var(real) / MSE).

SSIM reproduces the scikit-image semantics the reference invokes
(``channel_axis=0, win_size=7, sigma=1.5, gaussian_weights=True,
use_sample_covariance=False, data_range=1.0``): per-channel 1-D Gaussian
statistics (truncate 3.5, reflect padding), sample-covariance normalization
off, edges cropped by (win_size-1)//2, channel-averaged. skimage itself is
not a dependency of the package, so the formula is implemented here and property-tested.

A copy of ``lm2a_tpu/eval/mel_metrics.py`` (numpy and scipy only) with the port's
imports, so the port imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _gaussian_filter_1d(x: np.ndarray, sigma: float, truncate: float = 3.5):
    """1-D Gaussian filter along the last axis with scipy.ndimage's default
    boundary ('reflect' = edge-repeating, i.e. numpy's 'symmetric' —
    (d c b a | a b c d) — NOT numpy's edge-excluding 'reflect')."""
    r = int(truncate * sigma + 0.5)
    k = np.exp(-0.5 * (np.arange(-r, r + 1) / sigma) ** 2)
    k /= k.sum()
    pad = [(0, 0)] * (x.ndim - 1) + [(r, r)]
    xp = np.pad(x, pad, mode="symmetric")
    out = np.zeros_like(x, dtype=np.float64)
    for i in range(2 * r + 1):
        out += k[i] * xp[..., i : i + x.shape[-1]]
    return out


def ssim_1d_channels(
    x: np.ndarray,
    y: np.ndarray,
    data_range: float = 1.0,
    win_size: int = 7,
    sigma: float = 1.5,
) -> float:
    """SSIM over (C, T) arrays: per-channel 1-D windows, channel-averaged."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2

    ux = _gaussian_filter_1d(x, sigma)
    uy = _gaussian_filter_1d(y, sigma)
    uxx = _gaussian_filter_1d(x * x, sigma)
    uyy = _gaussian_filter_1d(y * y, sigma)
    uxy = _gaussian_filter_1d(x * y, sigma)
    vx = uxx - ux * ux
    vy = uyy - uy * uy
    vxy = uxy - ux * uy

    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / (
        (ux * ux + uy * uy + c1) * (vx + vy + c2)
    )
    pad = (win_size - 1) // 2
    if s.shape[-1] > 2 * pad:
        s = s[..., pad : s.shape[-1] - pad]
    return float(s.mean())


def compute_metrics(real_mel: np.ndarray, gen_mel: np.ndarray) -> Dict[str, float]:
    """All mel-domain metrics for an (80, T) pair; lengths are truncated to
    the shorter clip, as in the reference."""
    real_mel = np.asarray(real_mel, dtype=np.float64)
    gen_mel = np.asarray(gen_mel, dtype=np.float64)
    min_t = min(real_mel.shape[1], gen_mel.shape[1])
    real_mel = real_mel[:, :min_t]
    gen_mel = gen_mel[:, :min_t]

    mse = float(np.mean((real_mel - gen_mel) ** 2))

    # normalize both by the REAL mel's range (reference semantics), clip 0..1
    lo, hi = real_mel.min(), real_mel.max()
    if hi - lo < 1e-6:
        lo = min(lo, gen_mel.min())
        hi = max(hi, gen_mel.max())
    rn = np.clip((real_mel - lo) / (hi - lo + 1e-8), 0.0, 1.0)
    gn = np.clip((gen_mel - lo) / (hi - lo + 1e-8), 0.0, 1.0)
    ssim_score = float(np.clip(ssim_1d_channels(rn, gn), 0.0, 1.0))

    # frame-wise cosine similarity, averaged over time
    num = (real_mel * gen_mel).sum(axis=0)
    den = np.linalg.norm(real_mel, axis=0) * np.linalg.norm(gen_mel, axis=0)
    cos = float(np.mean(num / np.maximum(den, 1e-12)))

    mean_error = float(abs(real_mel.mean() - gen_mel.mean()))
    std_error = float(abs(real_mel.std() - gen_mel.std()))

    real_var = float(np.var(real_mel))
    snr = 0.0 if real_var < 1e-8 else float(10.0 * np.log10(real_var / (mse + 1e-8)))

    return {
        "mse": round(mse, 6),
        "ssim": round(ssim_score, 6),
        "avg_cos_sim": round(cos, 6),
        "mean_error": round(mean_error, 6),
        "std_error": round(std_error, 6),
        "snr": round(snr, 6),
    }
