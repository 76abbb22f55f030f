"""The diffusion process of LM2A: linear beta schedule, the epsilon loss of one
training step and the DDIM sampler with classifier-free guidance.

Source: the reference's ``models/diffusion.py`` (linear betas 1e-4 to 0.02
over 1000 steps) and ``sample.py`` (CFG weight 2.1, both conditions zeroed
for the unconditional half). DDIM (eta 0) runs on the evenly spaced grid of
``num_steps`` timesteps from T-1 down to 0, float32 ``linspace`` rounded
half to even, with x0 clamped to +-2 and ``ab_prev = 1`` after the last.
DDPM is the ancestral step over every timestep of a schedule of
``num_steps``: ``(x - beta / sqrt(1 - ab) eps) / sqrt(1 - beta) + sqrt(beta)
z``, no noise at t = 0. The per-step scalars are computed in float32 on the
host.

Randomness: one ``torch.Generator`` on the device per training step, drawn
in this order: the CFG keep mask (B, 1, 1), the timesteps, the noise, then
each dropout mask in forward order. A chain draws from its own generator,
seeded with the request's seed: the starting noise, then (DDPM) one draw a
step.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from .precision import EXACT, Precision
from .unet import denoise, project_conditions


def linspace_f32(start: float, stop: float, num: int) -> np.ndarray:
    """float32 linspace as ``start * (1 - s) + stop * s``, s = i * (1 / (num - 1))."""
    start, stop = np.float32(start), np.float32(stop)
    if num == 1:
        return np.array([start], np.float32)
    s = np.arange(num - 1, dtype=np.float32) * (np.float32(1) / np.float32(num - 1))
    return np.concatenate([start * (np.float32(1) - s) + stop * s, [stop]]).astype(np.float32)


class Schedule(NamedTuple):
    betas: np.ndarray
    alpha_bars: np.ndarray


def schedule(d: dict) -> Schedule:
    betas = linspace_f32(d["beta_start"], d["beta_end"], d["timesteps"])
    return Schedule(betas, np.cumprod(np.float32(1) - betas, dtype=np.float32))


def step_seed(seed: int, step: int) -> int:
    """The seed of a training step's generator: ``((seed + 1) << 32) + step``,
    the convention of the trainer's ``--seed`` and step counter."""
    return ((seed + 1) << 32) + step


def training_loss(p_unet: Dict[str, torch.Tensor], p_cond: Dict[str, torch.Tensor], m: dict,
                  sched: Schedule, batch: Dict[str, torch.Tensor], *, mean: float, std: float,
                  cond_drop: float, generator: Optional[torch.Generator],
                  q: Precision = EXACT) -> torch.Tensor:
    """The mean squared error of the predicted noise over one batch of
    (B, T, .) ``mel``, ``motion`` and ``lyrics``; with a generator, the CFG
    condition drop (one mask for both conditions) and dropout."""
    mel = batch["mel"]
    dev = mel.device
    motion_f, text_f = project_conditions(p_cond, batch["motion"], batch["lyrics"], q)
    b = mel.shape[0]
    if generator is not None and cond_drop > 0:
        keep = (~(torch.rand((b, 1, 1), generator=generator, device=dev) < cond_drop)).float()
        motion_f, text_f = motion_f * keep, text_f * keep
    t = torch.randint(0, len(sched.betas), (b,), generator=generator, device=dev)
    noise = torch.randn(mel.shape, generator=generator, device=dev, dtype=torch.float32)
    ab = torch.as_tensor(sched.alpha_bars, device=dev)[t][:, None, None]
    x_t = torch.sqrt(ab) * ((mel - mean) / std) + torch.sqrt(1.0 - ab) * noise
    pred = denoise(p_unet, m, x_t, t, motion_f, text_f, generator, q)
    return torch.mean((noise - pred) ** 2)


def ddim_grid(timesteps: int, num_steps: int):
    ts = np.round(linspace_f32(timesteps - 1, 0, num_steps)).astype(np.int64)
    return ts, np.concatenate([ts[1:], [-1]]).astype(np.int64)


def ddim_coefficients(alpha_bars: np.ndarray, ts, ts_prev) -> np.ndarray:
    """(N, 4) float32: sqrt(1 - ab_t), sqrt(ab_t), sqrt(ab_prev), and the
    direction coefficient sqrt(1 - ab_prev) (eta 0)."""
    one = np.float32(1.0)
    rows = []
    for t, tp in zip(ts.tolist(), ts_prev.tolist()):
        ab_t = alpha_bars[t]
        ab_prev = one if tp < 0 else alpha_bars[tp]
        rows.append([np.sqrt(one - ab_t), np.sqrt(ab_t), np.sqrt(ab_prev),
                     np.sqrt(max(one - ab_prev, np.float32(0.0)))])
    return np.asarray(rows, dtype=np.float32)


def guided_eps(p_unet, m: dict, x, t, motion_f, text_f, weight: float, q: Precision):
    """eps_u + w * clip(eps_c - eps_u, +-5), clipped to +-10, from one forward
    over [unconditional (zero conditions), conditional] rows; a weight of 1
    or less runs the conditional forward alone."""
    if weight <= 1.0:
        return denoise(p_unet, m, x, t, motion_f, text_f, None, q)
    x2, t2 = torch.cat([x, x]), torch.cat([t, t])
    m2 = torch.cat([torch.zeros_like(motion_f), motion_f])
    l2 = torch.cat([torch.zeros_like(text_f), text_f])
    eps_u, eps_c = denoise(p_unet, m, x2, t2, m2, l2, None, q).chunk(2)
    return torch.clamp(eps_u + weight * torch.clamp(eps_c - eps_u, -5.0, 5.0), -10.0, 10.0)


class Chain:
    """The ``method`` chain (``ddim``: ``num_steps`` steps over the schedule
    of ``d``; ``ddpm``: every step of a schedule of ``num_steps`` timesteps)
    under CFG weight ``guidance``: its draws and each of its steps, so that
    it can be held step by step."""

    def __init__(self, d: dict, method: str, num_steps: int, guidance: float,
                 x0_clip: float = 2.0):
        if method not in ("ddim", "ddpm"):
            raise ValueError(f"no sampler {method!r}")
        self.method, self.guidance, self.x0_clip = method, guidance, x0_clip
        if method == "ddim":
            sched = schedule(d)
            self.ts, ts_prev = ddim_grid(d["timesteps"], num_steps)
            self.coef = ddim_coefficients(sched.alpha_bars, self.ts, ts_prev)
        else:
            self.sched = schedule(dict(d, timesteps=num_steps))
            self.ts = np.arange(num_steps - 1, -1, -1, dtype=np.int64)

    def draws(self, seed: int, b: int, t_len: int, m: dict, dev):
        """The standard normal draws of a chain from a device generator seeded
        with ``seed``: the start, then (DDPM) one a step; DDIM's steps get None."""
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        yield torch.randn((b, t_len, m["in_dim"]), generator=gen, device=dev,
                          dtype=torch.float32)
        while True:
            yield (None if self.method == "ddim" else
                   torch.randn((b, t_len, m["in_dim"]), generator=gen, device=dev,
                               dtype=torch.float32))

    @torch.no_grad()
    def step(self, p_unet, m: dict, i: int, x, motion_f, text_f, q: Precision = EXACT,
             noise=None):
        """Step ``i`` from state ``x`` (B, T, in_dim) given projected
        conditions (and, DDPM, the step's draw ``noise``)."""
        b = x.shape[0]
        t = int(self.ts[i])
        tb = torch.full((b,), t, dtype=torch.long, device=x.device)
        x = x.float()
        eps = guided_eps(p_unet, m, x, tb, motion_f, text_f, self.guidance, q)
        if self.method == "ddpm":
            one = np.float32(1.0)
            beta, ab = self.sched.betas[t], self.sched.alpha_bars[t]
            mean = (x - float(beta / np.sqrt(one - ab)) * eps) / float(np.sqrt(one - beta))
            return mean + float(np.sqrt(beta)) * noise if t > 0 else mean
        c = [float(v) for v in self.coef[i]]
        x0 = torch.clamp((x - eps * c[0]) / c[1], -self.x0_clip, self.x0_clip)
        return c[2] * x0 + c[3] * eps
