"""Motion feature derivation: smoothing + velocity/acceleration (port of
``lm2a_tpu/ops/motion.py``).

- Gaussian temporal smoothing (sigma=1.0, radius = max(1, int(3*sigma)),
  zero-padded 'same' convolution, exactly ``np.convolve(..., 'same')``),
- central-difference velocity with one-sided boundaries, scaled by fps,
- central-difference acceleration with one-sided second differences,
- concat [pos, vel, acc] -> (T, 3*D).

Each function takes a numpy array (computed with numpy on the host, the JAX
module's numpy path bit for bit) or a ``torch.Tensor`` (computed on the
tensor's device, as the JAX module computes a ``jnp`` array with ``jnp``).
"""

from __future__ import annotations

import numpy as np
import torch


def _is_torch(x) -> bool:
    return isinstance(x, torch.Tensor)


def gaussian_kernel(sigma: float) -> np.ndarray:
    """Normalized Gaussian kernel covering +/- 3 sigma (min radius 1)."""
    radius = max(1, int(3.0 * sigma))
    xs = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (xs / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_smooth(x, sigma: float = 1.0):
    """Zero-padded 'same' Gaussian smoothing along axis 0 of (T, D)."""
    if sigma <= 0:
        return x
    k = gaussian_kernel(sigma)
    r = (len(k) - 1) // 2
    if _is_torch(x):
        x = x.float()
        xpad = torch.nn.functional.pad(x, (0, 0, r, r))
        out = torch.zeros_like(x)
    else:
        x = np.asarray(x, dtype=np.float32)
        xpad = np.pad(x, ((r, r), (0, 0)))
        out = np.zeros_like(x)
    # correlation == convolution for a symmetric kernel
    for i in range(len(k)):  # len(k) is small (7 for sigma=1)
        ki = float(k[i]) if _is_torch(x) else k[i]  # a float32 value either way
        out = out + ki * xpad[i : i + x.shape[0]]
    return out


def _cat(parts, axis: int):
    if _is_torch(parts[0]):
        return torch.cat(parts, dim=axis)
    return np.concatenate(parts, axis=axis)


def _zeros_like(x):
    return torch.zeros_like(x) if _is_torch(x) else np.zeros_like(x)


def velocity(x, fps: float):
    """Central-difference velocity, one-sided at the boundaries (pos/sec)."""
    T = x.shape[0]
    if T < 2:
        return _zeros_like(x)
    dt = 1.0 / float(fps)
    interior = (x[2:] - x[:-2]) / (2.0 * dt)
    first = (x[1:2] - x[0:1]) / dt
    last = (x[T - 1 : T] - x[T - 2 : T - 1]) / dt
    return _cat([first, interior, last], 0)


def acceleration(x, fps: float):
    """Central second difference; one-sided second difference at boundaries."""
    T = x.shape[0]
    if T < 3:
        return _zeros_like(x)
    dt2 = (1.0 / float(fps)) ** 2
    interior = (x[2:] - 2.0 * x[1:-1] + x[:-2]) / dt2
    first = (x[2:3] - 2.0 * x[1:2] + x[0:1]) / dt2
    last = (x[T - 1 : T] - 2.0 * x[T - 2 : T - 1] + x[T - 3 : T - 2]) / dt2
    return _cat([first, interior, last], 0)


def motion_features(motion, fps: float = 30.0, sigma: float = 1.0):
    """(T, D) raw pose track -> (T, 3*D) [smoothed, velocity, acceleration]."""
    sm = gaussian_smooth(motion, sigma=sigma)
    vel = velocity(sm, fps)
    acc = acceleration(sm, fps)
    out = _cat([sm, vel, acc], 1)
    return out.float() if _is_torch(out) else out.astype(np.float32)
