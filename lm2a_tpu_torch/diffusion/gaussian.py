"""Gaussian diffusion: forward noising, the training loss, and the samplers
with classifier-free guidance (port of ``lm2a_tpu/diffusion/gaussian.py``).

The reverse chains are Python loops of eager forwards (CUDA graphs are later
work). Both samplers take ``x_init`` and the DDPM sampler ``noise_seq`` so
tests can inject the same noise into the JAX and PyTorch chains; otherwise
noise comes from the ``torch.Generator`` the caller passes.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from lm2a_tpu_torch.diffusion.schedule import Schedule, linspace_f32

ModelFn = Callable[..., torch.Tensor]
# ModelFn signature: (x (B,T,C), t (B,) int64, motion_f, text_f, **kw) -> eps


def _bcast(coef: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return coef.reshape(coef.shape + (1,) * (like.ndim - coef.ndim))


def q_sample(schedule: Schedule, x0: torch.Tensor, t: torch.Tensor,
             noise: torch.Tensor) -> torch.Tensor:
    """Forward process q(x_t | x_0) = sqrt(ab_t) x0 + sqrt(1-ab_t) eps."""
    ab = schedule.alpha_bars[t]
    return _bcast(torch.sqrt(ab), x0) * x0 + _bcast(torch.sqrt(1.0 - ab), x0) * noise


def diffusion_loss(model_fn: ModelFn, schedule: Schedule, x0: torch.Tensor,
                   motion_f: Optional[torch.Tensor], text_f: Optional[torch.Tensor],
                   dataset_mean: float = 0.0, dataset_std: float = 1.0,
                   t: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Epsilon-prediction MSE with uniform timesteps, the fp32 mean of
    ``(noise - pred)^2``. ``x0`` is z-normalised by the dataset statistics
    inside the loss. ``t`` and ``noise`` are drawn from ``generator`` unless
    given (the tests inject the JAX package's draws)."""
    b = x0.shape[0]
    if t is None:
        t = torch.randint(0, schedule.timesteps, (b,), generator=generator,
                          device=x0.device)
    if noise is None:
        noise = torch.randn(x0.shape, generator=generator, device=x0.device,
                            dtype=x0.dtype)
    x0n = (x0 - dataset_mean) / dataset_std
    x_t = q_sample(schedule, x0n, t, noise)
    pred = model_fn(x_t, t, motion_f, text_f)
    return torch.mean((noise - pred.float()) ** 2)


def p_sample_step(schedule: Schedule, x_t: torch.Tensor, t: torch.Tensor,
                  eps: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """One ancestral DDPM step x_t -> x_{t-1}:
    ``(x_t - beta/sqrt(1-ab) eps) / sqrt(alpha) + sqrt(beta) noise [t > 0]``."""
    beta = _bcast(schedule.betas[t], x_t)
    alpha = _bcast(schedule.alphas[t], x_t)
    ab = _bcast(schedule.alpha_bars[t], x_t)
    mask = _bcast((t > 0).to(x_t.dtype), x_t)
    mean = (x_t - beta / torch.sqrt(1.0 - ab) * eps) / torch.sqrt(alpha)
    return mean + torch.sqrt(beta) * noise * mask


def guided_eps(model_fn: ModelFn, x, t, motion_f, text_f, guidance_weight: float,
               uncond_fast: bool = False) -> torch.Tensor:
    """Epsilon with CFG. For w > 1: one doubled-batch forward over [uncond
    (zeroed conds), cond]; ``eps_u + w clip(eps_c - eps_u, +-5)`` clipped to
    +-10. A weight <= 1 runs the conditional forward alone. ``uncond_fast``
    tells the model the first half has zero conditions (``uncond_rows``)."""
    if float(guidance_weight) <= 1.0 or motion_f is None or text_f is None:
        return model_fn(x, t, motion_f, text_f)
    x2 = torch.cat([x, x], dim=0)
    t2 = torch.cat([t, t], dim=0)
    m2 = torch.cat([torch.zeros_like(motion_f), motion_f], dim=0)
    l2 = torch.cat([torch.zeros_like(text_f), text_f], dim=0)
    if uncond_fast:
        eps2 = model_fn(x2, t2, m2, l2, uncond_rows=x.shape[0])
    else:
        eps2 = model_fn(x2, t2, m2, l2)
    eps_u, eps_c = eps2.chunk(2, dim=0)
    eps_diff = torch.clamp(eps_c - eps_u, -5.0, 5.0)
    return torch.clamp(eps_u + float(guidance_weight) * eps_diff, -10.0, 10.0)


def _randn(shape, generator, device):
    return torch.randn(shape, generator=generator, device=device, dtype=torch.float32)


@torch.no_grad()
def ddpm_sample(model_fn: ModelFn, schedule: Schedule, shape: tuple,
                motion_f=None, text_f=None, guidance_weight: float = 1.0,
                x_init: Optional[torch.Tensor] = None,
                noise_seq: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                collect_stats: bool = False, uncond_fast: bool = False):
    """Full reverse DDPM over t = T-1 .. 0. ``noise_seq`` is ``(T,) + shape``.
    With ``collect_stats`` also returns a (T, 8) tensor of per-step
    [x min, max, mean, std, eps min, max, mean, std]."""
    device = schedule.betas.device
    b = shape[0]
    x = _randn(shape, generator, device) if x_init is None else x_init.to(device, torch.float32)
    stats = []
    for i, t in enumerate(range(schedule.timesteps - 1, -1, -1)):
        noise = _randn(shape, generator, device) if noise_seq is None else noise_seq[i].to(device)
        tb = torch.full((b,), t, dtype=torch.long, device=device)
        eps = guided_eps(model_fn, x, tb, motion_f, text_f, guidance_weight,
                         uncond_fast=uncond_fast)
        x = p_sample_step(schedule, x, tb, eps.to(x.dtype), noise)
        if collect_stats:
            stats.append(torch.stack([x.min(), x.max(), x.mean(), x.std(unbiased=False),
                                      eps.min(), eps.max(), eps.mean(),
                                      eps.std(unbiased=False)]))
    if collect_stats:
        return x, torch.stack(stats)
    return x


def ddim_time_grid(timesteps: int, num_steps: int):
    """(ts, ts_prev) int64 arrays: the evenly spaced DDIM sub-schedule, the
    JAX grid exactly (float32 linspace, round half to even). Distilled
    checkpoints are only served correctly on this grid."""
    ts = np.round(linspace_f32(timesteps - 1, 0, num_steps)).astype(np.int64)
    return ts, np.concatenate([ts[1:], [-1]]).astype(np.int64)


@torch.no_grad()
def ddim_sample(model_fn: ModelFn, schedule: Schedule, shape: tuple,
                motion_f=None, text_f=None, num_steps: int = 50, eta: float = 0.0,
                guidance_weight: float = 1.0, x_init: Optional[torch.Tensor] = None,
                x0_clip: float = 2.0, generator: Optional[torch.Generator] = None,
                uncond_fast: bool = False) -> torch.Tensor:
    """DDIM over the ``ddim_time_grid`` sub-sequence: x0 prediction clamped to
    +-x0_clip, eta-scaled sigma, ``t_prev < 0`` giving ab_prev = 1 and
    sigma = 0. Per-step scalars are computed in float32, as the JAX chain."""
    device = schedule.betas.device
    b = shape[0]
    x = _randn(shape, generator, device) if x_init is None else x_init.to(device, torch.float32)
    ab_host = schedule.alpha_bars.cpu().numpy()
    f32, one = np.float32, np.float32(1.0)
    ts, ts_prev = ddim_time_grid(schedule.timesteps, num_steps)
    for t, tp in zip(ts.tolist(), ts_prev.tolist()):
        tb = torch.full((b,), t, dtype=torch.long, device=device)
        eps = guided_eps(model_fn, x, tb, motion_f, text_f, guidance_weight,
                         uncond_fast=uncond_fast).to(x.dtype)
        ab_t = ab_host[t]
        ab_prev = one if tp < 0 else ab_host[max(tp, 0)]
        x0 = (x - eps * float(np.sqrt(one - ab_t))) / float(np.sqrt(ab_t))
        x0 = torch.clamp(x0, -x0_clip, x0_clip)
        var_ratio = (one - ab_prev) / (one - ab_t) * (one - ab_t / ab_prev)
        sigma = f32(0.0) if tp < 0 else f32(eta) * np.sqrt(max(var_ratio, f32(0.0)))
        dir_coeff = np.sqrt(max(one - ab_prev - sigma * sigma, f32(0.0)))
        x = float(np.sqrt(ab_prev)) * x0 + float(dir_coeff) * eps
        if sigma > 0 and tp > 0:
            x = x + float(sigma) * _randn(shape, generator, device)
    return x
