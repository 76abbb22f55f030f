"""Model factory: denoiser + condition projection from a ModelConfig (port of
``lm2a_tpu/models/factory.py``), plus seeded random initialisation."""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from lm2a_tpu_torch.core.config import ModelConfig
from lm2a_tpu_torch.models.embedding import CondProjection
from lm2a_tpu_torch.models.unet1d import Denoiser, UNet1D, UNet1DUltimate


def build_denoiser(cfg: ModelConfig) -> Denoiser:
    """fp32 parameters; ``Denoiser.prepare`` readies it for serving,
    ``forward_train`` trains it. ``arch='v1'`` takes no resblock options
    (``fused_resblock_grad``, ``num_res_blocks``, ``mid_blocks``,
    ``dropout``), as in the JAX factory."""
    if cfg.arch == "ultimate":
        return UNet1DUltimate(
            in_dim=cfg.in_dim, base_dim=cfg.base_dim, dim_mults=tuple(cfg.dim_mults),
            cond_dim=cfg.cond_dim, time_emb_dim=cfg.time_emb_dim,
            num_res_blocks=cfg.num_res_blocks, mid_blocks=cfg.mid_blocks,
            attn_heads=cfg.attn_heads, fused_attention=cfg.fused_attention,
            dropout=cfg.dropout, fused_resblock_grad=cfg.fused_resblock_grad,
        )
    if cfg.arch == "v1":
        return UNet1D(
            in_dim=cfg.in_dim, base_dim=cfg.base_dim, dim_mults=tuple(cfg.dim_mults),
            cond_dim=cfg.cond_dim, time_emb_dim=cfg.time_emb_dim, attn_heads=cfg.attn_heads,
            fused_attention=cfg.fused_attention,
        )
    raise ValueError(f"unknown arch {cfg.arch!r}; use 'ultimate' or 'v1'")


def build_cond_projection(cfg: ModelConfig) -> CondProjection:
    return CondProjection(motion_dim=cfg.motion_dim, text_dim=cfg.text_dim,
                          out_dim=cfg.cond_dim)


@torch.no_grad()
def random_init_(model: nn.Module, seed: int) -> nn.Module:
    """Seeded initialisation in the flax defaults' spirit: Linear/Conv weights
    ~ N(0, 1/fan_in) with fan_in = in_features x kernel taps, zero biases,
    unit GroupNorm scale; other parameters (snake alpha/beta) keep their
    constructor values."""
    gen = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d, nn.ConvTranspose1d)):
            w = m.weight
            if isinstance(m, nn.Linear):
                fan_in = w.shape[1]
            elif isinstance(m, nn.ConvTranspose1d):
                fan_in = w.shape[0] * w.shape[2]
            else:
                fan_in = w.shape[1] * w.shape[2]
            w.copy_(torch.randn(w.shape, generator=gen) / math.sqrt(fan_in))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.GroupNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return model


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
