"""DDPM noise schedule tables (port of ``lm2a_tpu/diffusion/schedule.py``):
linear betas 1e-4 -> 0.02 over T steps and their cumulative alpha products,
fp32 tensors on the sampler's device."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from lm2a_tpu_torch.core.config import DiffusionConfig


def linspace_f32(start: float, stop: float, num: int) -> np.ndarray:
    """``jnp.linspace(start, stop, num)`` in float32 with XLA's arithmetic:
    ``start * (1 - s) + stop * s``, ``s = i * (1 / (num - 1))`` (XLA turns
    the division by a constant into a reciprocal multiply), last = stop.
    Bit-identical on the DDIM grids the tests hold against JAX."""
    start, stop = np.float32(start), np.float32(stop)
    if num == 1:
        return np.array([start], np.float32)
    step = np.arange(num - 1, dtype=np.float32) * (np.float32(1) / np.float32(num - 1))
    out = start * (np.float32(1) - step) + stop * step
    return np.concatenate([out, [stop]]).astype(np.float32)


class Schedule(NamedTuple):
    betas: torch.Tensor  # (T,)
    alphas: torch.Tensor
    alpha_bars: torch.Tensor

    @property
    def timesteps(self) -> int:
        return self.betas.shape[0]


def make_schedule(cfg: DiffusionConfig = DiffusionConfig(), device="cpu") -> Schedule:
    betas = linspace_f32(cfg.beta_start, cfg.beta_end, cfg.timesteps)
    alphas = np.float32(1) - betas
    alpha_bars = np.cumprod(alphas, dtype=np.float32)
    return Schedule(*(torch.as_tensor(a, device=device) for a in (betas, alphas, alpha_bars)))
