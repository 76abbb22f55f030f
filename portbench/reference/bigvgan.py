"""The BigVGAN generator (Lee et al. 2023; NVIDIA's ``bigvgan.py`` and
``alias_free_torch``) in its published form, float32, channels-first.

conv_pre (k7) -> per upsample rate: a transposed conv, then the mean of the
AMP blocks (resblock type 1: per dilation, act -> dilated conv -> act ->
conv, added to the input) -> act -> conv_post (k7) -> tanh. Every act is
the anti-aliased SnakeBeta: replicate-pad, 2x zero-stuffed transposed conv
with a 12-tap Kaiser-windowed sinc (cutoff 0.25, half width 0.3), times 2,
cropped; x + sin(alpha x)^2 / (beta + 1e-9) with alpha, beta = exp of the
log-scale parameters; replicate-pad (5, 6) and a stride-2 conv with the
same filter.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from .precision import EXACT, Precision
from .unet import Spec

TAPS = 12


def spec(v: dict) -> Spec:
    s: Spec = {}
    ch = v["upsample_initial_channel"]
    s["conv_pre.weight"] = ((ch, v["num_mels"], 7), "w_conv")
    s["conv_pre.bias"] = ((ch,), "bias")
    for i, (r, k) in enumerate(zip(v["upsample_rates"], v["upsample_kernel_sizes"])):
        s[f"up_{i}.weight"] = ((ch, ch // 2, k), "w_conv_transpose")
        s[f"up_{i}.bias"] = ((ch // 2,), "bias")
        ch //= 2
        for j, (rk, dil) in enumerate(zip(v["resblock_kernel_sizes"],
                                          v["resblock_dilation_sizes"])):
            for n in range(len(dil)):
                for a, c in (("act1", "conv1"), ("act2", "conv2")):
                    s[f"resblock_{i}_{j}.{a}_{n}.alpha"] = ((ch,), "snake")
                    s[f"resblock_{i}_{j}.{a}_{n}.beta"] = ((ch,), "snake")
                    s[f"resblock_{i}_{j}.{c}_{n}.weight"] = ((ch, ch, rk), "w_conv")
                    s[f"resblock_{i}_{j}.{c}_{n}.bias"] = ((ch,), "bias")
    s["activation_post.alpha"] = ((ch,), "snake")
    s["activation_post.beta"] = ((ch,), "snake")
    s["conv_post.weight"] = ((1, ch, 7), "w_conv")
    s["conv_post.bias"] = ((1,), "bias")
    return s


def kaiser_sinc_filter(cutoff: float = 0.25, half_width: float = 0.3,
                       kernel_size: int = TAPS, device=None) -> torch.Tensor:
    half = kernel_size // 2
    delta_f = 4 * half_width
    a = 2.285 * (half - 1) * math.pi * delta_f + 7.95
    if a > 50.0:
        beta = 0.1102 * (a - 8.7)
    elif a >= 21.0:
        beta = 0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21.0)
    else:
        beta = 0.0
    window = torch.kaiser_window(kernel_size, beta=beta, periodic=False, dtype=torch.float64)
    time = torch.arange(-half, half, dtype=torch.float64) + 0.5
    filt = 2 * cutoff * window * torch.sinc(2 * cutoff * time)
    return (filt / filt.sum()).float().to(device)


def snake_alias(x, alpha, beta, filt):
    """Anti-aliased SnakeBeta on (B, C, T)."""
    c = x.shape[1]
    f = filt.view(1, 1, -1).expand(c, 1, -1)
    pad = TAPS // 2 - 1
    y = F.pad(x, (pad, pad), mode="replicate")
    y = 2 * F.conv_transpose1d(y, f, stride=2, groups=c)
    crop = pad * 2 + (TAPS - 2) // 2
    y = y[..., crop:-crop]
    a, b = torch.exp(alpha)[None, :, None], torch.exp(beta)[None, :, None]
    y = y + torch.sin(y * a) ** 2 / (b + 1e-9)
    y = F.pad(y, (TAPS // 2 - 1, TAPS // 2), mode="replicate")
    return F.conv1d(y, f, stride=2, groups=c)


def _conv(p, name, x, q: Precision, dilation: int = 1):
    w = p[f"{name}.weight"]
    k = w.shape[-1]
    return F.conv1d(q(x), q(w), p.get(f"{name}.bias"), dilation=dilation,
                    padding=(k * dilation - dilation) // 2)


@torch.no_grad()
def vocode(p: Dict[str, torch.Tensor], v: dict, mel: torch.Tensor,
           q: Precision = EXACT) -> torch.Tensor:
    """mel (B, num_mels, T) -> waveform (B, hop * T)."""
    filt = kaiser_sinc_filter(device=mel.device)
    nk = len(v["resblock_kernel_sizes"])
    x = _conv(p, "conv_pre", mel.float(), q)
    for i, (r, k) in enumerate(zip(v["upsample_rates"], v["upsample_kernel_sizes"])):
        x = F.conv_transpose1d(q(x), q(p[f"up_{i}.weight"]), p[f"up_{i}.bias"], stride=r,
                               padding=(k - r) // 2)
        acc = 0
        for j, dil in enumerate(v["resblock_dilation_sizes"]):
            name, y = f"resblock_{i}_{j}", x
            for n, d in enumerate(dil):
                t = snake_alias(y, p[f"{name}.act1_{n}.alpha"], p[f"{name}.act1_{n}.beta"], filt)
                t = _conv(p, f"{name}.conv1_{n}", t, q, dilation=d)
                t = snake_alias(t, p[f"{name}.act2_{n}.alpha"], p[f"{name}.act2_{n}.beta"], filt)
                y = y + _conv(p, f"{name}.conv2_{n}", t, q)
            acc = acc + y
        x = acc / nk
    x = snake_alias(x, p["activation_post.alpha"], p["activation_post.beta"], filt)
    return torch.tanh(_conv(p, "conv_post", x, q))[:, 0, :]
