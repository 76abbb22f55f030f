"""Progressive diffusion distillation (port of ``lm2a_tpu/training/distill.py``).

A student initialised from the teacher learns, at each of its N DDIM times,
to land in ONE deterministic step where the frozen teacher lands in TWO
half-steps (t -> mid -> t_prev), with the teacher's classifier-free
guidance folded in, so the distilled checkpoint samples with one B-row
forward per step on the serving grid (``ddim_time_grid``) at guidance 1.0.

Routes on the card:

- the teacher is a separate ``UNet1DUltimate`` + ``CondProjection`` built
  from copies of EMA tensors and readied for serving (``prepare``): its two
  guided forwards a step run ``forward`` under ``torch.no_grad()``, every
  residual block through ``gn_stats`` and ``conv3_fused`` (and attention
  through its kernel where the config sets ``fused_attention``);
- the student runs the training form (``forward_train`` with no generator:
  no dropout, no condition drop), the blocks the training gate routes
  through the fused chain and its backward kernels;
- the update is ``train_step.make_update_step`` with the ``Adan`` of
  ``train_step.make_optimizer`` at ``opt_backend="pallas"`` (``cli
  distill``'s config): the ``adan_ema`` kernel, one launch a step on the
  card, its plain per-leaf version on the CPU.

Randomness: each step draws its student grid index, then its noise, from
the generator the caller passes (``training.train_step.step_generator(seed,
global step)``), or takes them injected (``DistillDraws``). The K-step form
(``make_device_data_multistep_distill``) is a loop of the single step over
batches gathered on the device, so it equals K single steps bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, NamedTuple, Optional

import numpy as np
import torch

from lm2a_tpu_torch.core.config import LM2AConfig
from lm2a_tpu_torch.core.device import dtype_from_str
from lm2a_tpu_torch.diffusion.gaussian import ddim_time_grid, guided_eps
from lm2a_tpu_torch.diffusion.schedule import Schedule
from lm2a_tpu_torch.models.embedding import CondProjection
from lm2a_tpu_torch.models.factory import build_cond_projection, build_denoiser
from lm2a_tpu_torch.models.unet1d import UNet1DUltimate
from lm2a_tpu_torch.training.adan import Adan
from lm2a_tpu_torch.training.train_step import TrainState, make_update_step, step_generator

LOSS_SPACES = ("eps", "x0_snr", "x0_snr_mm")


def stage_guidance_schedule(num_stages: int, guidance: float):
    """Per-stage teacher CFG weights: the fold happens once, at stage 0;
    every later teacher is an already-guided student (w = 1.0)."""
    return [guidance if i == 0 else 1.0 for i in range(num_stages)]


def student_time_grid(timesteps: int, num_student_steps: int):
    """(ts, ts_prev, ts_mid) int64: the serving DDIM grid and the teacher's
    floored midpoint of each student step (t_prev = -1 gives (t-1)//2)."""
    ts, ts_prev = ddim_time_grid(timesteps, num_student_steps)
    return ts, ts_prev, (ts + ts_prev) // 2


def _ab(schedule: Schedule, t: torch.Tensor) -> torch.Tensor:
    """alpha_bar at t, with t < 0 meaning fully denoised (1.0)."""
    ab = schedule.alpha_bars[torch.clamp(t, min=0)]
    return torch.where(t < 0, torch.ones_like(ab), ab)


def ddim_det_step(x, eps, t, t_prev, schedule: Schedule, x0_clip: float = 2.0):
    """One deterministic (eta = 0) DDIM update with per-sample (B,) times,
    x0 clipped to +-x0_clip, as ``ddim_sample``'s step."""
    ab_t, ab_prev = _ab(schedule, t), _ab(schedule, t_prev)
    shape = ab_t.shape + (1,) * (x.ndim - 1)
    ab_t, ab_prev = ab_t.reshape(shape), ab_prev.reshape(shape)
    x0_pred = (x - eps * torch.sqrt(1.0 - ab_t)) / torch.sqrt(ab_t)
    x0_pred = torch.clamp(x0_pred, -x0_clip, x0_clip)
    return torch.sqrt(ab_prev) * x0_pred + torch.sqrt(1.0 - ab_prev) * eps


class DistillDraws(NamedTuple):
    """Injected randomness of one distill loss: student grid indices (B,)
    and the noise, shaped like the mel."""

    idx: torch.Tensor
    noise: torch.Tensor


@dataclass
class Teacher:
    """The frozen teacher: serving-form modules holding their own weights."""

    unet: UNet1DUltimate
    cond_proj: CondProjection


@torch.no_grad()
def build_teacher(cfg: LM2AConfig, ema: Dict[str, torch.Tensor]) -> Teacher:
    """A teacher from EMA tensors keyed like ``TrainState.ema``
    (``"unet/..."``, ``"cond_proj/..."``), on their device. The modules copy
    the tensors (the student's in-place updates cannot reach them) and are
    readied for serving in the config's compute dtype."""
    dev = next(iter(ema.values())).device
    dt = dtype_from_str(cfg.train.compute_dtype)
    with torch.device("meta"):
        mods = {"unet": build_denoiser(cfg.model), "cond_proj": build_cond_projection(cfg.model)}
    for tree, mod in mods.items():
        mod.to_empty(device=dev)
        mod.load_state_dict({k.split("/", 1)[1]: v for k, v in ema.items()
                             if k.split("/", 1)[0] == tree})
        mod.eval().requires_grad_(False)
    mods["unet"].prepare(dt)
    mods["cond_proj"].to(dt)
    return Teacher(mods["unet"], mods["cond_proj"])


@torch.no_grad()
def start_student(state: TrainState, ema: Dict[str, torch.Tensor]) -> None:
    """A fresh state (``init_train_state``: step 0, zeroed Adan state) made
    the student of a new run: parameters and EMA copied from the teacher's
    EMA."""
    for k, p in state.params().items():
        p.copy_(ema[k])
        state.ema[k].copy_(ema[k])


def distill_loss(state: TrainState, teacher: Teacher, schedule: Schedule, grid, batch,
                 cfg: LM2AConfig, *, dataset_mean: float, dataset_std: float,
                 guidance_weight: float, x0_clip: float, loss_space: str,
                 generator: Optional[torch.Generator] = None,
                 draws: Optional[DistillDraws] = None) -> torch.Tensor:
    """The distillation loss of one batch (see the module docstring).
    ``grid`` is ``student_time_grid`` as tensors on the schedule's device."""
    dt = dtype_from_str(cfg.train.compute_dtype)
    ts_g, ts_prev_g, ts_mid_g = grid
    x0 = (batch["mel"] - dataset_mean) / dataset_std
    b, dev = x0.shape[0], x0.device
    motion_s, text_s = state.cond_proj.forward_train(batch["motion"], batch["lyrics"], dt)
    if draws is None:
        idx = torch.randint(0, ts_g.shape[0], (b,), generator=generator, device=dev)
        noise = torch.randn(x0.shape, generator=generator, device=dev, dtype=x0.dtype)
    else:
        idx, noise = draws.idx.to(dev), draws.noise.to(dev)
    t, t_prev, t_mid = ts_g[idx], ts_prev_g[idx], ts_mid_g[idx]
    ab_t = _ab(schedule, t)[:, None, None]
    a_t, s_t = torch.sqrt(ab_t), torch.sqrt(1.0 - ab_t)
    x_t = a_t * x0 + s_t * noise

    with torch.no_grad():  # the frozen teacher: two half-steps, CFG folded in
        motion_f, text_f = teacher.cond_proj(batch["motion"], batch["lyrics"])
        eps_1 = guided_eps(teacher.unet, x_t, t, motion_f, text_f, guidance_weight).float()
        x_mid = ddim_det_step(x_t.float(), eps_1, t, t_mid, schedule, x0_clip)
        eps_2 = guided_eps(teacher.unet, x_mid, t_mid, motion_f, text_f, guidance_weight).float()
        x_tgt = ddim_det_step(x_mid, eps_2, t_mid, t_prev, schedule, x0_clip)
        # the one-step target: x_tgt = a'' x0~ + s'' eps~ with x_t = a x0~ + s eps~
        ab_pp = _ab(schedule, t_prev)[:, None, None]
        a_pp, s_pp = torch.sqrt(ab_pp), torch.sqrt(1.0 - ab_pp)
        denom = a_pp - (s_pp / s_t) * a_t
        denom = torch.where(denom.abs() < 1e-6, torch.full_like(denom, 1e-6), denom)
        x0_tgt = (x_tgt - (s_pp / s_t) * x_t) / denom

    eps_student = state.unet.forward_train(x_t, t, motion_s, text_s, dtype=dt,
                                           generator=None).float()
    if loss_space == "eps":
        eps_tgt = (x_t - a_t * x0_tgt) / s_t
        return torch.mean((eps_student - eps_tgt) ** 2)
    # x0 regression, truncated-SNR weight w = max(SNR, 1)
    x0_student = (x_t - s_t * eps_student) / a_t
    w = torch.clamp((a_t * a_t) / (s_t * s_t), min=1.0)
    diff = x0_student - x0_tgt
    loss = torch.mean(w * diff ** 2)
    if loss_space == "x0_snr_mm":  # plus the per-sample mean-matching term
        loss = loss + (diff[0].numel() / 64.0) * torch.mean(torch.mean(diff, dim=(1, 2)) ** 2)
    return loss


def make_distill_step(schedule: Schedule, cfg: LM2AConfig, optimizer: Adan,
                      num_student_steps: int, dataset_mean: float = 0.0,
                      dataset_std: float = 1.0, guidance_weight: float = 1.0,
                      x0_clip: float = 2.0, loss_space: str = "x0_snr"):
    """``step(state, teacher, batch, generator=None, draws=None) -> loss``:
    one distill step, ``state`` (the student) updated in place."""
    if loss_space not in LOSS_SPACES:
        raise ValueError(f"loss_space must be one of {LOSS_SPACES}, got {loss_space!r}")
    dev = schedule.betas.device
    grid = tuple(torch.as_tensor(a, device=dev)
                 for a in student_time_grid(schedule.timesteps, num_student_steps))

    def loss_builder(state, batch, teacher, generator=None, draws=None):
        return distill_loss(state, teacher, schedule, grid, batch, cfg,
                            dataset_mean=dataset_mean, dataset_std=dataset_std,
                            guidance_weight=guidance_weight, x0_clip=x0_clip,
                            loss_space=loss_space, generator=generator, draws=draws)

    one_step = make_update_step(loss_builder, optimizer)

    def step(state: TrainState, teacher: Teacher, batch, generator=None, draws=None):
        return one_step(state, batch, teacher=teacher, generator=generator, draws=draws)

    return step


def make_device_data_multistep_distill(schedule: Schedule, cfg: LM2AConfig, optimizer: Adan,
                                       num_student_steps: int, **kw):
    """``multi(state, teacher, data, idx, seed, offsets) -> losses (K,)``: K
    distill steps over a dataset already on the device. ``data`` holds the
    packed (N, T, .) tensors (``data.dataset.upload_dataset``), ``idx`` (K, B) row indices
    on the device, ``offsets`` the K global steps; step k gathers its batch
    with ``index_select`` and draws from ``step_generator(seed,
    offsets[k])``. The same math as ``make_distill_step``'s step."""
    step = make_distill_step(schedule, cfg, optimizer, num_student_steps=num_student_steps, **kw)

    def multi(state, teacher, data, idx, seed: int, offsets):
        losses = []
        for idx_k, off in zip(idx, offsets):
            batch = {k: v.index_select(0, idx_k) for k, v in data.items()}
            gen = step_generator(seed, int(off), idx_k.device)
            losses.append(step(state, teacher, batch, generator=gen))
        return torch.stack(losses)

    return multi


def index_stream(n: int, batch_size: int, seed: int, steps_per_stage: int, k_fuse: int,
                 done: int = 0) -> Iterator[np.ndarray]:
    """The (k, B) row indices of each K-step call of a stage, the JAX
    package's stream (``default_rng(seed).integers(0, n, (k, B))``, k =
    min(k_fuse, steps left)); the draws of the first ``done`` steps are
    replayed and dropped, so a resumed stage continues the stream."""
    rng = np.random.default_rng(seed)
    d = 0
    while d < steps_per_stage:
        k = min(k_fuse, steps_per_stage - d)
        idx = rng.integers(0, n, size=(k, batch_size))
        if d >= done:
            yield idx
        d += k
