"""Timestep embeddings and condition projections (port of
``lm2a_tpu/models/embedding.py``).

- ``sinusoidal_time_embed``: log-spaced sin/cos embedding, half-split (first
  half sin, second half cos), frequencies ``exp(-log(10000) i / (dim/2 - 1))``;
- ``TimestepEmbedding``: sinusoid -> Linear -> SiLU;
- ``CondProjection``: motion (234) -> cond_dim, lyrics (768) -> cond_dim.

Parameters may be held in the compute dtype; inputs are cast to it, as flax
``Dense(dtype=...)`` does. The training form (``forward_train``) keeps the
fp32 parameters as the master copy and casts them to the compute dtype at
each use (``dense``), as flax modules with ``dtype=bf16`` do.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


def dense(lin: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``lin`` in ``dtype``: input, weight and bias cast (differentiably)."""
    return F.linear(x.to(dtype), lin.weight.to(dtype), lin.bias.to(dtype))


def sinusoidal_time_embed(t: torch.Tensor, dim: int,
                          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B,) timesteps -> (B, dim) sin/cos embedding, computed in fp32."""
    half = dim // 2
    freqs = torch.exp(
        torch.arange(half, dtype=torch.float32, device=t.device)
        * (-math.log(10000.0) / (half - 1))
    )
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1).to(dtype)


class TimestepEmbedding(nn.Module):
    """Sinusoid -> Linear(dim) -> SiLU."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim
        self.proj = nn.Linear(dim, dim)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        dt = self.proj.weight.dtype
        return F.silu(self.proj(sinusoidal_time_embed(t, self.dim, dt)))

    def forward_train(self, t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return F.silu(dense(self.proj, sinusoidal_time_embed(t, self.dim, dtype), dtype))


class CondProjection(nn.Module):
    """Project raw motion / lyrics features to the conditioning width."""

    def __init__(self, motion_dim: int = 78 * 3, text_dim: int = 768, out_dim: int = 128):
        super().__init__()
        self.motion_proj = nn.Linear(motion_dim, out_dim)
        self.text_proj = nn.Linear(text_dim, out_dim)

    def forward(self, motion: torch.Tensor, lyrics: torch.Tensor):
        dt = self.motion_proj.weight.dtype
        return self.motion_proj(motion.to(dt)), self.text_proj(lyrics.to(dt))

    def forward_train(self, motion: torch.Tensor, lyrics: torch.Tensor, dtype: torch.dtype):
        return dense(self.motion_proj, motion, dtype), dense(self.text_proj, lyrics, dtype)
