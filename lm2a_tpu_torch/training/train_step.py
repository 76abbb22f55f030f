"""Train and eval steps (port of ``lm2a_tpu/training/train_step.py``).

One optimization step is the reference's hot loop: condition projection,
one shared Bernoulli mask dropping BOTH conditions for classifier-free
guidance, the diffusion loss on the training form of the denoiser, the
backward, then clip + Adan + EMA. bf16 compute on fp32 master parameters.

Randomness comes from a ``torch.Generator`` in a fixed order: the CFG keep
mask, the timesteps, the noise, then the dropout masks block by block. The
kernel route and the plain route draw the same numbers in the same order,
so one generator state gives both the same step. The tests inject the JAX
package's draws instead (``Draws``).

Gradients accumulate into ``.grad`` buffers that are allocated once and
zeroed each step, so the optimizer kernel's table of pointers is built once.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from lm2a_tpu_torch.core.config import LM2AConfig
from lm2a_tpu_torch.core.device import DeviceLike, dtype_from_str, resolve_device
from lm2a_tpu_torch.diffusion.gaussian import diffusion_loss
from lm2a_tpu_torch.diffusion.schedule import Schedule
from lm2a_tpu_torch.models.embedding import CondProjection
from lm2a_tpu_torch.models.factory import build_cond_projection, build_denoiser, random_init_
from lm2a_tpu_torch.models.unet1d import UNet1DUltimate
from lm2a_tpu_torch.training.adan import Adan, AdanState, make_lr_schedule

TREES = ("unet", "cond_proj")


@dataclass
class TrainState:
    """Step counter, the two parameter trees (fp32 modules), the EMA of
    every parameter and the Adan state, keyed ``"<tree>/<parameter name>"``."""

    step: int
    unet: UNet1DUltimate
    cond_proj: CondProjection
    ema: Dict[str, torch.Tensor]
    opt: AdanState

    def params(self) -> Dict[str, torch.Tensor]:
        return {f"{tree}/{n}": p for tree in TREES
                for n, p in getattr(self, tree).named_parameters()}


class Draws(NamedTuple):
    """Injected randomness of one loss: timesteps (B,), noise like the mel,
    CFG keep mask (B, 1, 1) or None."""

    t: torch.Tensor
    noise: torch.Tensor
    keep: Optional[torch.Tensor] = None


def make_optimizer(cfg: LM2AConfig,
                   lr_schedule: Optional[Callable[[int], np.float32]] = None) -> Adan:
    """The Adan of ``cfg.train``; ``lr_schedule`` replaces its step decay
    (``cli distill``'s cosine rate)."""
    tc = cfg.train
    if not tc.fused_opt:
        raise NotImplementedError(
            "fused_opt=False (clip chained before Adan, the round-1 state layout) is not "
            "ported; train with fused_opt=1")
    return Adan(lr_schedule or make_lr_schedule(tc.lr, tc.lr_decay_steps, tc.lr_decay_factors),
                weight_decay=tc.weight_decay, grad_clip=tc.grad_clip or 0.0,
                ema_decay=tc.ema_decay,
                state_dtype=None if tc.opt_dtype in ("", "float32") else dtype_from_str(tc.opt_dtype),
                backend=tc.opt_backend)


def init_train_state(cfg: LM2AConfig, seed: int, device: DeviceLike = None,
                     optimizer: Optional[Adan] = None) -> TrainState:
    """Seeded fp32 parameters (``random_init_``), EMA = parameters, zero
    Adan state, and a zeroed ``.grad`` buffer on every parameter, on CUDA
    unless ``device="cpu"``."""
    dev = resolve_device(device)
    unet = random_init_(build_denoiser(cfg.model), seed).to(dev)
    proj = random_init_(build_cond_projection(cfg.model), seed + 1).to(dev)
    unet.train()
    proj.train()
    state = TrainState(0, unet, proj, {}, AdanState(0))
    params = state.params()
    for p in params.values():
        p.grad = torch.zeros_like(p)
    state.ema = {k: p.detach().clone() for k, p in params.items()}
    state.opt = (optimizer or make_optimizer(cfg)).init(params)
    return state


def loss_fn(state: TrainState, schedule: Schedule, batch, cfg: LM2AConfig, *,
            dataset_mean: float, dataset_std: float, train: bool,
            generator: Optional[torch.Generator] = None,
            draws: Optional[Draws] = None) -> torch.Tensor:
    """The diffusion loss of one batch (dict of (B, T, .) tensors ``mel``,
    ``motion``, ``lyrics``). ``train`` adds the CFG condition drop and
    dropout; the eval form has neither."""
    dt = dtype_from_str(cfg.train.compute_dtype)
    motion_f, text_f = state.cond_proj.forward_train(batch["motion"], batch["lyrics"], dt)
    p = cfg.train.cond_drop_prob
    if train and p > 0.0:
        b = motion_f.shape[0]
        if draws is not None and draws.keep is not None:
            keep = draws.keep.to(motion_f.device, motion_f.dtype)
        else:  # one shared mask zeroes both conditions
            drop = torch.rand((b, 1, 1), generator=generator, device=motion_f.device) < p
            keep = (~drop).to(motion_f.dtype)
        motion_f = motion_f * keep
        text_f = text_f * keep

    def model_fn(x, t, m, l):
        return state.unet.forward_train(x, t, m, l, dtype=dt,
                                        generator=generator if train else None)

    return diffusion_loss(model_fn, schedule, batch["mel"], motion_f, text_f,
                          dataset_mean=dataset_mean, dataset_std=dataset_std,
                          t=None if draws is None else draws.t.to(batch["mel"].device),
                          noise=None if draws is None else draws.noise.to(batch["mel"].device),
                          generator=generator)


def make_update_step(loss_builder: Callable, optimizer: Adan):
    """The grad -> optimizer -> EMA update. ``loss_builder(state, batch,
    **kw) -> scalar loss``; returns ``one_step(state, batch, **kw) -> loss``
    (detached), updating ``state`` in place."""

    def one_step(state: TrainState, batch, **kw) -> torch.Tensor:
        params = state.params()
        grads = [p.grad for p in params.values()]
        torch._foreach_zero_(grads)
        loss = loss_builder(state, batch, **kw)
        loss.backward()
        optimizer.update(params, {k: p.grad for k, p in params.items()}, state.ema, state.opt)
        state.step += 1
        return loss.detach()

    return one_step


def make_train_step(schedule: Schedule, cfg: LM2AConfig, optimizer: Optional[Adan] = None,
                    dataset_mean: float = 0.0, dataset_std: float = 1.0):
    """``train_step(state, batch, generator=None, draws=None) -> loss``."""

    def loss_builder(state, batch, generator=None, draws=None):
        return loss_fn(state, schedule, batch, cfg, dataset_mean=dataset_mean,
                       dataset_std=dataset_std, train=True, generator=generator, draws=draws)

    return make_update_step(loss_builder, optimizer or make_optimizer(cfg))


def make_eval_step(schedule: Schedule, cfg: LM2AConfig, dataset_mean: float = 0.0,
                   dataset_std: float = 1.0):
    """Validation loss on the current parameters: no condition drop, no
    dropout. ``eval_step(state, batch, generator=None, draws=None)``."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch, generator=None, draws=None) -> torch.Tensor:
        return loss_fn(state, schedule, batch, cfg, dataset_mean=dataset_mean,
                       dataset_std=dataset_std, train=False, generator=generator,
                       draws=draws)

    return eval_step
