"""Gaussian diffusion: forward noising, the training loss, and the samplers
with classifier-free guidance (port of ``lm2a_tpu/diffusion/gaussian.py``).

Each sampler is one step function, (x, step index, device tables,
conditions, generator) -> x, run once per step of the chain: on the card
as replays of one CUDA graph captured per chain geometry
(``core.graphs.GraphedStep``), on the CPU eagerly; the counterpart of the
JAX package's jitted scan. A ``SamplerChain`` holds a geometry's static
state: ``x``, the step counter, the timestep and DDIM coefficient tables on
the device, the CFG weight as an fp32 device scalar (one chain serves every
weight above 1, as the JAX chain's traced weight), the conditions' buffers,
its generator and its captured steps. ``inference.sample`` caches chains
per geometry. Both samplers take ``x_init`` and the DDPM sampler
``noise_seq`` so tests can inject the same noise into the JAX and PyTorch
chains; otherwise noise comes from the chain's ``torch.Generator``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from lm2a_tpu_torch.core import draws
from lm2a_tpu_torch.core.graphs import GraphedStep, stage
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
    given (the tests inject the JAX package's draws); a ``core.draws.RowShard``
    draws them at the global batch shape and keeps this rank's rows."""
    b = x0.shape[0]
    if t is None:
        t = draws.randint(schedule.timesteps, (b,), generator, x0.device)
    if noise is None:
        noise = draws.randn(x0.shape, generator, x0.device, x0.dtype)
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


def guided_eps(model_fn: ModelFn, x, t, motion_f, text_f, guidance_weight,
               uncond_fast: bool = False) -> torch.Tensor:
    """Epsilon with CFG. For w > 1: one doubled-batch forward over [uncond
    (zeroed conds), cond]; ``eps_u + w clip(eps_c - eps_u, +-5)`` clipped to
    +-10. A weight <= 1 runs the conditional forward alone. The weight is a
    Python number or an fp32 device scalar; a tensor is always guided (the
    JAX package's traced weight). ``uncond_fast`` tells the model the first
    half has zero conditions (``uncond_rows``)."""
    guided = isinstance(guidance_weight, torch.Tensor) or float(guidance_weight) > 1.0
    if not guided or motion_f is None or text_f is None:
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
    if not isinstance(guidance_weight, torch.Tensor):
        guidance_weight = float(guidance_weight)
    return torch.clamp(eps_u + guidance_weight * eps_diff, -10.0, 10.0)


def _randn(shape, generator, device):
    return draws.randn(shape, generator, device)


def ddim_time_grid(timesteps: int, num_steps: int):
    """(ts, ts_prev) int64 arrays: the evenly spaced DDIM sub-schedule, the
    JAX grid exactly (float32 linspace, round half to even). Distilled
    checkpoints are only served correctly on this grid."""
    ts = np.round(linspace_f32(timesteps - 1, 0, num_steps)).astype(np.int64)
    return ts, np.concatenate([ts[1:], [-1]]).astype(np.int64)


def ddim_coefficients(alpha_bars: np.ndarray, ts, ts_prev, eta: float) -> np.ndarray:
    """(N, 5) fp32 per-step DDIM scalars, computed on the host in float32 as
    the JAX chain computes them: ``sqrt(1 - ab_t)``, ``sqrt(ab_t)``,
    ``sqrt(ab_prev)``, the direction coefficient and ``sigma`` masked to 0
    unless ``t_prev > 0``; ``t_prev < 0`` gives ab_prev = 1 and sigma = 0."""
    f32, one = np.float32, np.float32(1.0)
    rows = []
    for t, tp in zip(ts.tolist(), ts_prev.tolist()):
        ab_t = alpha_bars[t]
        ab_prev = one if tp < 0 else alpha_bars[max(tp, 0)]
        var_ratio = (one - ab_prev) / (one - ab_t) * (one - ab_t / ab_prev)
        sigma = f32(0.0) if tp < 0 else f32(eta) * np.sqrt(max(var_ratio, f32(0.0)))
        dir_coeff = np.sqrt(max(one - ab_prev - sigma * sigma, f32(0.0)))
        rows.append([np.sqrt(one - ab_t), np.sqrt(ab_t), np.sqrt(ab_prev), dir_coeff,
                     sigma if tp > 0 else f32(0.0)])
    return np.asarray(rows, dtype=np.float32)


class SamplerChain:
    """The static state of one sampler chain geometry (``shape``, method,
    steps) on the schedule's device; see the module docstring. ``pool`` is
    a CUDA graph memory pool its captures share with other chains; an
    ``eager`` chain captures nothing (its steps run collectives: the
    sequence-parallel sampler)."""

    def __init__(self, schedule: Schedule, shape: tuple, method: str,
                 num_steps: Optional[int] = None, eta: float = 0.0, x0_clip: float = 2.0,
                 generator: Optional[torch.Generator] = None, pool=None, eager: bool = False):
        if method not in ("ddpm", "ddim"):
            raise ValueError(f"unknown method {method!r}; use 'ddpm' or 'ddim'")
        dev = schedule.betas.device
        self.schedule, self.shape, self.method = schedule, tuple(shape), method
        self.eta, self.x0_clip = float(eta), float(x0_clip)
        self.device, self.generator, self.pool, self.eager = dev, generator, pool, eager
        self.x = torch.zeros(self.shape, dtype=torch.float32, device=dev)
        self.i = torch.zeros((1,), dtype=torch.long, device=dev)
        self.gw = torch.ones((), dtype=torch.float32, device=dev)
        if method == "ddpm":
            self.ts = torch.arange(schedule.timesteps - 1, -1, -1, dtype=torch.long, device=dev)
            self.coef = None
        else:
            ts, ts_prev = ddim_time_grid(schedule.timesteps, num_steps)
            self.ts = torch.as_tensor(ts, device=dev)
            self.coef = torch.as_tensor(
                ddim_coefficients(schedule.alpha_bars.cpu().numpy(), ts, ts_prev, eta),
                device=dev)
        self.n_steps = self.ts.shape[0]
        self.motion_f = self.text_f = self.noise_seq = None
        self.steps: Dict[tuple, GraphedStep] = {}

    def _static(self, name: str, src: Optional[torch.Tensor]):
        """``src`` copied into the chain's buffer ``name`` (made at the first
        call; later calls must match its shape and dtype), or None."""
        if src is None:
            return None
        buf = getattr(self, name)
        if buf is None:
            buf = torch.empty(src.shape, dtype=src.dtype, device=self.device)
            setattr(self, name, buf)
        if buf.shape != src.shape or buf.dtype != src.dtype:
            raise ValueError(f"sampler chain: {name} {tuple(src.shape)} {src.dtype} does not "
                             f"match the chain's {tuple(buf.shape)} {buf.dtype}")
        return stage(buf, src)

    def start(self, motion_f, text_f, guidance_weight, x_init, noise_seq):
        """Stage one chain's inputs: the conditions, the CFG weight, the
        injected noise, then ``x`` (``x_init`` or a draw from the generator,
        before any step's draws) and the step counter at 0. Returns the
        conditions' buffers and the weight the step passes to ``guided_eps``."""
        conds = None
        if motion_f is not None and text_f is not None:
            conds = (self._static("motion_f", motion_f), self._static("text_f", text_f))
        guided = (isinstance(guidance_weight, torch.Tensor)
                  or float(guidance_weight) > 1.0)
        if guided:
            self.gw.fill_(guidance_weight)
        noise = self._static("noise_seq", noise_seq)
        if x_init is None:
            stage(self.x, _randn(self.shape, self.generator, self.device))
        else:
            stage(self.x, x_init.to(torch.float32))
        self.i.zero_()
        return conds, (self.gw if guided else 1.0), noise

    def graphed(self, key: tuple, fn: Callable[[], object]) -> GraphedStep:
        """The chain's captured step for ``key`` (the model and the static
        choices the step closes over), made at its first use."""
        step = self.steps.get(key)
        if step is None:
            step = self.steps[key] = GraphedStep(fn, device=self.device,
                                                 generators=(self.generator,), pool=self.pool,
                                                 eager=self.eager)
        return step


def _chain_for(chain: Optional[SamplerChain], schedule, shape, method, generator, **kw):
    if chain is None:
        return SamplerChain(schedule, shape, method, generator=generator, **kw)
    if chain.method != method or chain.shape != tuple(shape):
        raise ValueError(f"sampler chain is {chain.method} {chain.shape}, "
                         f"not {method} {tuple(shape)}")
    if generator is not None and generator is not chain.generator:
        raise ValueError("a sampler chain draws from its own generator")
    return chain


def ddpm_step(model_fn: ModelFn, schedule: Schedule, x: torch.Tensor, i: torch.Tensor,
              ts: torch.Tensor, conds, gw, generator: Optional[torch.Generator],
              uncond_fast: bool, noise_seq: Optional[torch.Tensor]) -> torch.Tensor:
    """One reverse DDPM step in place: ``x`` to its next value at timestep
    ``ts[i]``, the step counter ``i`` up by one. Returns eps (for the debug
    statistics)."""
    if noise_seq is None:
        noise = _randn(x.shape, generator, x.device)
    else:
        noise = noise_seq.index_select(0, i)[0]
    tb = ts.index_select(0, i).expand(x.shape[0])
    motion_f, text_f = conds if conds is not None else (None, None)
    eps = guided_eps(model_fn, x, tb, motion_f, text_f, gw, uncond_fast=uncond_fast)
    x.copy_(p_sample_step(schedule, x, tb, eps.to(x.dtype), noise))
    i.add_(1)
    return eps


def ddim_step(model_fn: ModelFn, x: torch.Tensor, i: torch.Tensor, ts: torch.Tensor,
              coef: torch.Tensor, conds, gw, generator: Optional[torch.Generator],
              uncond_fast: bool, eta: float, x0_clip: float) -> None:
    """One DDIM step in place at timestep ``ts[i]``: x0 prediction clamped to
    +-x0_clip, the step's coefficients ``coef[i]`` read from the device table
    (true divisions by tensors, on the card and the CPU alike), the counter
    ``i`` up by one."""
    tb = ts.index_select(0, i).expand(x.shape[0])
    motion_f, text_f = conds if conds is not None else (None, None)
    eps = guided_eps(model_fn, x, tb, motion_f, text_f, gw, uncond_fast=uncond_fast).to(x.dtype)
    c = coef.index_select(0, i)[0]
    x0 = torch.clamp((x - eps * c[0]) / c[1], -x0_clip, x0_clip)
    new = c[2] * x0 + c[3] * eps
    if eta > 0:
        new = new + c[4] * _randn(x.shape, generator, x.device)
    x.copy_(new)
    i.add_(1)


@torch.no_grad()
def ddpm_sample(model_fn: ModelFn, schedule: Schedule, shape: tuple,
                motion_f=None, text_f=None, guidance_weight=1.0,
                x_init: Optional[torch.Tensor] = None,
                noise_seq: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                collect_stats: bool = False, uncond_fast: bool = False,
                chain: Optional[SamplerChain] = None):
    """Full reverse DDPM over t = T-1 .. 0. ``noise_seq`` is ``(T,) + shape``.
    With ``collect_stats`` (run eagerly, the debug telemetry) also returns a
    (T, 8) tensor of per-step [x min, max, mean, std, eps min, max, mean,
    std]. ``chain`` is a cached ``SamplerChain`` of this geometry (else one
    is made for the call, drawing from ``generator``)."""
    chain = _chain_for(chain, schedule, shape, "ddpm", generator)
    conds, gw, noise = chain.start(motion_f, text_f, guidance_weight, x_init, noise_seq)

    sched, x, i, ts, gen = chain.schedule, chain.x, chain.i, chain.ts, chain.generator

    def step():  # closes over the buffers, not the chain: no cycle through its cache
        return ddpm_step(model_fn, sched, x, i, ts, conds, gw, gen, uncond_fast, noise)

    if collect_stats:
        stats = []
        for _ in range(chain.n_steps):
            eps = step()
            stats.append(torch.stack([x.min(), x.max(), x.mean(), x.std(unbiased=False),
                                      eps.min(), eps.max(), eps.mean(),
                                      eps.std(unbiased=False)]))
        return chain.x.clone(), torch.stack(stats)
    run = chain.graphed((model_fn, gw is chain.gw, uncond_fast, conds is not None,
                         noise is not None), step)
    for _ in range(chain.n_steps):
        run()
    return chain.x.clone()


@torch.no_grad()
def ddim_sample(model_fn: ModelFn, schedule: Schedule, shape: tuple,
                motion_f=None, text_f=None, num_steps: int = 50, eta: float = 0.0,
                guidance_weight=1.0, x_init: Optional[torch.Tensor] = None,
                x0_clip: float = 2.0, generator: Optional[torch.Generator] = None,
                uncond_fast: bool = False,
                chain: Optional[SamplerChain] = None) -> torch.Tensor:
    """DDIM over the ``ddim_time_grid`` sub-sequence: x0 prediction clamped to
    +-x0_clip, eta-scaled sigma, ``t_prev < 0`` giving ab_prev = 1 and
    sigma = 0. Per-step scalars are computed in float32 on the host, as the
    JAX chain (``ddim_coefficients``). ``chain`` as in ``ddpm_sample``."""
    chain = _chain_for(chain, schedule, shape, "ddim", generator, num_steps=num_steps,
                       eta=eta, x0_clip=x0_clip)
    if chain.n_steps != num_steps or chain.eta != eta or chain.x0_clip != x0_clip:
        raise ValueError("sampler chain: DDIM steps, eta or x0_clip differ from the call's")
    conds, gw, _ = chain.start(motion_f, text_f, guidance_weight, x_init, None)
    x, i, ts, coef, gen = chain.x, chain.i, chain.ts, chain.coef, chain.generator
    run = chain.graphed((model_fn, gw is chain.gw, uncond_fast, conds is not None),
                        lambda: ddim_step(model_fn, x, i, ts, coef, conds, gw, gen, uncond_fast,
                                          eta, x0_clip))
    for _ in range(chain.n_steps):
        run()
    return chain.x.clone()
