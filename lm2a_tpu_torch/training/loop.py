"""Training loop: epochs, validation, logging, checkpoint and resume (port
of the per-step path of ``lm2a_tpu/training/loop.py``).

Batches stream from ``BatchIterator`` (shuffled with ``seed + epoch``)
through ``device_prefetch``; the loss is fetched from the card only on log
steps. Step ``s`` draws its randomness from a generator seeded with
``(seed + 1, s)`` (validation batch ``i`` after step ``s``: ``10_000_000 +
s + i``), so a resumed run draws what an uninterrupted one would. A save
every ``save_interval`` steps keeps the current epoch (a resume re-runs the
partial epoch, as in the JAX package); the final save records the next
epoch unless the run stopped early.

Refused with an error (ROADMAP lists them): ``steps_per_call > 1``,
``device_data``, ``quality_every_epochs`` and the ``rbg`` generator.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from lm2a_tpu_torch.core.config import LM2AConfig
from lm2a_tpu_torch.core.device import DeviceLike, resolve_device
from lm2a_tpu_torch.data.dataset import (
    PACK_META, BatchIterator, PackedDataset, compute_dataset_stats, device_prefetch,
    open_dataset,
)
from lm2a_tpu_torch.diffusion.schedule import make_schedule
from lm2a_tpu_torch.training.checkpoint import (
    CheckpointWriter, latest_checkpoint, restore_checkpoint, save_checkpoint,
)
from lm2a_tpu_torch.training.train_step import (
    init_train_state, make_eval_step, make_optimizer, make_train_step,
)
from lm2a_tpu_torch.utils.logging import TrainLogger
from lm2a_tpu_torch.utils.profiling import StepTimer

VAL_OFFSET = 10_000_000


@dataclass
class TrainResult:
    final_step: int
    final_loss: float
    ckpt_dir: str


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of one step (or validation batch) of a run."""
    g = torch.Generator(device=device)
    g.manual_seed(((seed + 1) << 32) + step)
    return g


def check_supported(cfg: LM2AConfig) -> None:
    tc = cfg.train
    if tc.steps_per_call > 1:
        raise NotImplementedError("steps_per_call > 1 (K steps per dispatch) is not ported")
    if tc.device_data:
        raise NotImplementedError("device_data (a device-resident dataset) is not ported")
    if tc.quality_every_epochs:
        raise NotImplementedError("quality_every_epochs (the sample-quality monitor) is not ported")
    if tc.rng_impl not in ("", "threefry"):
        raise NotImplementedError(f"rng {tc.rng_impl!r} is TPU-specific; the port draws from "
                                  "torch.Generator")


def train(cfg: LM2AConfig, npz_dir: str, save_dir: str, val_npz_dir: Optional[str] = None,
          dataset_mean: Optional[float] = None, dataset_std: Optional[float] = None,
          resume: bool = False, max_steps: Optional[int] = None,
          use_tensorboard: bool = True, device: DeviceLike = None) -> TrainResult:
    check_supported(cfg)
    tc = cfg.train
    dev = resolve_device(device)
    schedule = make_schedule(cfg.diffusion, device=dev)

    if dataset_mean is None or dataset_std is None:
        if os.path.exists(os.path.join(npz_dir, PACK_META)):
            mel = PackedDataset(npz_dir).mel
            dataset_mean, dataset_std = float(np.mean(mel)), float(np.std(mel))
        else:
            dataset_mean, dataset_std = compute_dataset_stats(npz_dir)
        print(f"dataset stats: mean={dataset_mean:.6f} std={dataset_std:.6f}")

    ds = open_dataset(npz_dir, cfg.data.align_mode)
    val_ds = (open_dataset(val_npz_dir, cfg.data.align_mode)
              if val_npz_dir and os.path.isdir(val_npz_dir) else None)

    optimizer = make_optimizer(cfg)
    state = init_train_state(cfg, tc.seed, dev, optimizer)
    start_epoch = 0
    if resume:
        path = latest_checkpoint(save_dir)
        if path:
            meta = restore_checkpoint(path, state)
            start_epoch = int(meta.get("epoch", 0))
            dataset_mean = float(meta.get("dataset_mean", dataset_mean))
            dataset_std = float(meta.get("dataset_std", dataset_std))
            print(f"resumed from {path} at step {state.step}")

    train_step = make_train_step(schedule, cfg, optimizer, dataset_mean, dataset_std)
    eval_step = make_eval_step(schedule, cfg, dataset_mean, dataset_std)
    logger = TrainLogger(save_dir, use_tensorboard=use_tensorboard)
    timer = StepTimer(report_every=max(tc.log_interval * 10, 100))
    writer = CheckpointWriter()

    def ckpt(epoch):
        path = save_checkpoint(save_dir, state, cfg, epoch=epoch, dataset_mean=dataset_mean,
                               dataset_std=dataset_std, keep_last=tc.keep_checkpoints,
                               writer=writer)
        print("saved checkpoint:", path)

    step = state.step
    pending_loss = None
    last_loss = float("nan")
    stop = False
    epoch = start_epoch
    for epoch in range(start_epoch, tc.epochs):
        t0 = time.time()
        it = BatchIterator(ds, tc.batch_size, shuffle=True, seed=tc.seed + epoch)
        for batch in device_prefetch(it, dev):
            pending_loss = train_step(state, batch, generator=step_generator(tc.seed, step, dev))
            ema_dt = timer.tick()
            if ema_dt is not None:
                print(f"step time (ema): {ema_dt * 1e3:.2f} ms")
            if step % tc.log_interval == 0:
                last_loss = float(pending_loss)
                logger.log_step(epoch, step, last_loss, float(optimizer.lr_schedule(step)))
            if tc.save_interval and step % tc.save_interval == 0 and step > 0:
                ckpt(epoch)
            step += 1
            if max_steps is not None and step >= max_steps:
                stop = True
                break

        val_loss = None
        ve = tc.validate_every_epochs
        if val_ds is not None and not stop and bool(ve) and (epoch + 1) % ve == 0:
            vlosses = []
            vit = BatchIterator(val_ds, tc.batch_size, shuffle=False)
            for i, vbatch in enumerate(device_prefetch(vit, dev)):
                if tc.val_cap_batches and i >= tc.val_cap_batches:
                    break
                gen = step_generator(tc.seed, VAL_OFFSET + step + i, dev)
                vlosses.append(eval_step(state, vbatch, generator=gen))
            if vlosses:
                val_loss = float(torch.stack(vlosses).mean())
                print(f"epoch {epoch} val loss: {val_loss:.6f} ({len(vlosses)} batches)")

        if pending_loss is not None:
            last_loss = float(pending_loss)
        logger.log_epoch(epoch, step, last_loss, val_loss, time.time() - t0)
        if stop:
            break

    if start_epoch < tc.epochs:
        ckpt(epoch if stop else epoch + 1)
    writer.wait()
    logger.close()
    return TrainResult(final_step=step, final_loss=last_loss, ckpt_dir=save_dir)
