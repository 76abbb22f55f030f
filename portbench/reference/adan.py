"""Global-norm clipping, Adan and the parameter EMA, as the reference trains
(``train.py``: Adan, lr 2e-4, weight decay 1e-4, betas (0.02, 0.08, 0.01),
eps 1e-8, gradient clip 1.0, EMA 0.999), in float32.

Adan (Xie et al. 2022, Algorithm 1) with the moments held at zero on the
first step, which only stores the clipped gradient as the previous one and
applies the weight-decay shrink; bias corrections 1 / (1 - (1 - b)^k) at the
1-indexed step k:

    m <- (1 - b1) m + b1 g
    v <- (1 - b2) v + b2 (g - g_prev)
    n <- (1 - b3) n + b3 (g + (1 - b2)(g - g_prev))^2
    p <- (p - lr (m c_m + (1 - b2) v c_v) / (sqrt(n c_n) + eps)) / (1 + wd lr)
    ema <- ema * decay + p * (1 - decay)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import torch

BETAS = (0.02, 0.08, 0.01)
EPS = 1e-8


@dataclass
class Hyper:
    lr: float = 2e-4
    weight_decay: float = 1e-4
    grad_clip: float = 1.0
    ema_decay: float = 0.999


@dataclass
class State:
    step: int = 0
    m: Dict[str, torch.Tensor] = field(default_factory=dict)
    v: Dict[str, torch.Tensor] = field(default_factory=dict)
    n: Dict[str, torch.Tensor] = field(default_factory=dict)
    prev: Dict[str, torch.Tensor] = field(default_factory=dict)


def corrections(k: int):
    """c_m, c_v, c_n at the 1-indexed step k."""
    return [1.0 / (1.0 - (1.0 - b) ** k) for b in BETAS]


def clipped(grads: Dict[str, torch.Tensor], clip: float) -> Dict[str, torch.Tensor]:
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).float()
    if clip <= 0 or float(norm) < clip:
        return dict(grads)
    return {k: g / norm * clip for k, g in grads.items()}


@torch.no_grad()
def step(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
         ema: Dict[str, torch.Tensor], st: State, h: Hyper) -> Dict[str, torch.Tensor]:
    """One update in place; returns the clipped gradients it used."""
    b1, b2, b3 = BETAS
    g = clipped(grads, h.grad_clip)
    k = st.step + 1
    c_m, c_v, c_n = corrections(k)
    denom = 1.0 + h.weight_decay * h.lr
    for name, p in params.items():
        gi = g[name]
        if st.step == 0:
            for d in (st.m, st.v, st.n):
                d[name] = torch.zeros_like(p)
            st.prev[name] = gi.clone()
            p.div_(denom)
        else:
            diff = gi - st.prev[name]
            st.m[name] = (1 - b1) * st.m[name] + b1 * gi
            st.v[name] = (1 - b2) * st.v[name] + b2 * diff
            st.n[name] = (1 - b3) * st.n[name] + b3 * (gi + (1 - b2) * diff) ** 2
            upd = (st.m[name] * c_m + (1 - b2) * st.v[name] * c_v) / (
                torch.sqrt(st.n[name] * c_n) + EPS)
            p.sub_(h.lr * upd).div_(denom)
            st.prev[name] = gi.clone()
        ema[name].mul_(h.ema_decay).add_(p * (1.0 - h.ema_decay))
    st.step = k
    return g
