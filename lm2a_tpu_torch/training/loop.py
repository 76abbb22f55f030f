"""Training loop: epochs, validation, logging, checkpoint and resume (port
of ``lm2a_tpu/training/loop.py``).

Every step and validation batch runs through the compiled steps of
``training/train_step.py``, as the JAX loop calls its jitted ones: on the
card a replay of one captured CUDA graph of the step (the run's first step
is the capture's warm-up), on the CPU the same step eagerly. Three paths,
as in the JAX package:

- per step (``steps_per_call`` 1): batches stream from ``BatchIterator``
  (shuffled with ``seed + epoch``) through ``device_prefetch``, one step a
  call of ``make_multistep_train_step``; the loss is fetched from the card
  only on log steps;
- fused (``steps_per_call`` K > 1): ``SuperbatchStream`` groups of K
  batches, K steps a call of ``make_multistep_train_step``; tail batches
  that do not fill a group run single steps;
- device-resident (``device_data`` with K > 1 and a packed split): the pack
  uploaded once, ``make_device_data_multistep`` called with only the (K, B)
  rows of ``superbatch_indices`` (the same row order, ``default_rng(seed +
  epoch)``, and the same tails); validation through
  ``make_device_data_eval`` over the device-resident val pack when that
  split is packed too, else through ``make_multistep_eval``.

The fused paths log on crossing ``log_interval`` (the call's last loss) and
save when ``step % save_interval < K`` and ``step >= save_interval``. Step
``s`` draws its randomness from a generator seeded with ``(seed + 1, s)``
(validation batch ``i`` after step ``s``: ``10_000_000 + s + i``), so a
resumed run draws what an uninterrupted one would, on every path. A save
keeps the current epoch (a resume re-runs the partial epoch, as in the JAX
package); the final save records the next epoch unless the run stopped
early.

With ``quality_every_epochs`` N and a validation split, the sample-quality
monitor (``training/quality.py``) runs at the end of every N-th epoch,
after validation, over the EMA as the updates left it, and its mean mel
metrics go to ``quality_log.csv`` (as the JAX loop logs them).

Several processes (``core/distributed.py``) train data-parallel over a
``(data, model)`` mesh (``mesh``, else ``make_hybrid_mesh``), as the JAX
loop does: every process reads the seed-identical global batch and keeps
the rows ``local_batch_slice`` gives it, the state starts as rank 0's
(``put_replicated``), each step averages its gradients over the data axis,
and only the primary logs and writes checkpoints (then every rank meets at
a barrier). Such a run takes the per-step path, eagerly on the card; the
fused and device-resident paths are single-process modes, refused there
with the JAX package's message.

Refused with an error (ROADMAP lists it): the ``rbg`` generator.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from lm2a_tpu_torch.core import distributed as collectives
from lm2a_tpu_torch.core.config import LM2AConfig
from lm2a_tpu_torch.core.device import DeviceLike, resolve_device
from lm2a_tpu_torch.core.mesh import DATA_AXIS, make_mesh
from lm2a_tpu_torch.data.dataset import (
    PACK_META, BatchIterator, PackedDataset, SuperbatchStream, compute_dataset_stats,
    device_prefetch, open_dataset, superbatch_indices, upload_dataset,
)
from lm2a_tpu_torch.diffusion.schedule import make_schedule
from lm2a_tpu_torch.training.checkpoint import (
    CheckpointWriter, latest_checkpoint, restore_checkpoint, save_checkpoint,
)
from lm2a_tpu_torch.training.train_step import (
    init_train_state, make_device_data_eval, make_device_data_multistep, make_multistep_eval,
    make_multistep_train_step, make_optimizer,
)
from lm2a_tpu_torch.utils.logging import NullLogger, TrainLogger
from lm2a_tpu_torch.utils.profiling import StepTimer

VAL_OFFSET = 10_000_000


@dataclass
class TrainResult:
    final_step: int
    final_loss: float
    ckpt_dir: str


def check_supported(cfg: LM2AConfig) -> None:
    """Raise for what the port does not run: ``NotImplementedError`` for the
    TPU's generator, ``ValueError`` for an optimizer ``Adan`` refuses (the
    CUDA Adan+EMA kernel under the chained ``fused_opt=False`` layout, as
    the JAX package refuses its Pallas updater there)."""
    tc = cfg.train
    make_optimizer(cfg)
    if tc.rng_impl not in ("", "threefry"):
        raise NotImplementedError(f"rng {tc.rng_impl!r} is TPU-specific; the port draws from "
                                  "torch.Generator")


def _local_rows(batches, sl: Optional[slice]):
    """This rank's rows of each global batch (all of them without a slice)."""
    for batch in batches:
        yield batch if sl is None else {k: v[sl] for k, v in batch.items()}


def train(cfg: LM2AConfig, npz_dir: str, save_dir: str, val_npz_dir: Optional[str] = None,
          dataset_mean: Optional[float] = None, dataset_std: Optional[float] = None,
          resume: bool = False, mesh=None, max_steps: Optional[int] = None,
          use_tensorboard: bool = True, device: DeviceLike = None) -> TrainResult:
    check_supported(cfg)
    tc = cfg.train
    dev = resolve_device(device)
    multihost = collectives.process_count() > 1
    if multihost:
        dev = collectives.rank_device()
    if mesh is None:
        mesh = (collectives.make_hybrid_mesh(device=dev) if multihost
                else make_mesh(device=dev))
    if multihost and (tc.steps_per_call > 1 or tc.device_data):
        # the fused-dispatch / device-resident modes hide per-call overhead
        # on a single host; a multi-process run takes the per-step path
        raise NotImplementedError(
            "steps_per_call>1 / --device_data are single-process modes; "
            "multi-host runs use the standard prefetched path"
        )
    n_data = mesh.shape[DATA_AXIS]
    if tc.batch_size % n_data:
        raise ValueError(f"batch_size {tc.batch_size} does not split over {n_data} data ranks")
    rows = (collectives.local_batch_slice(mesh, tc.batch_size)
            if mesh.size > 1 else None)
    schedule = make_schedule(cfg.diffusion, device=dev)

    if dataset_mean is None or dataset_std is None:
        if os.path.exists(os.path.join(npz_dir, PACK_META)):
            mel = PackedDataset(npz_dir, use_native=False).mel
            dataset_mean, dataset_std = float(np.mean(mel)), float(np.std(mel))
        else:
            dataset_mean, dataset_std = compute_dataset_stats(npz_dir)
        print(f"dataset stats: mean={dataset_mean:.6f} std={dataset_std:.6f}")

    ds = open_dataset(npz_dir, cfg.data.align_mode)
    val_ds = (open_dataset(val_npz_dir, cfg.data.align_mode)
              if val_npz_dir and os.path.isdir(val_npz_dir) else None)
    print(f"batch gatherer: {getattr(ds, 'gatherer', 'per-clip npz reads')}")

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
    if multihost:
        # every process built (or restored) the same state; make it rank 0's
        o = state.opt
        collectives.put_replicated(mesh, [*state.params().values(), *state.ema.values(),
                                          *(t for d in (o.m, o.v, o.n, o.prev_grad)
                                            for t in d.values())])

    stats = dict(dataset_mean=dataset_mean, dataset_std=dataset_std)
    quality = None
    if tc.quality_every_epochs and val_ds is not None:
        from lm2a_tpu_torch.training.quality import QualityMonitor

        quality = QualityMonitor(cfg, state.ema, schedule, val_ds, n_clips=tc.quality_clips,
                                 num_steps=tc.quality_steps, guidance=tc.quality_guidance,
                                 seed=tc.seed, mesh=mesh if multihost else None, **stats)
    multistep = make_multistep_train_step(schedule, cfg, optimizer, mesh=mesh, **stats)
    eval_multi = make_multistep_eval(schedule, cfg, mesh=mesh, **stats)
    bs = tc.batch_size
    k_fuse = max(1, tc.steps_per_call)
    devdata_step = device_data = devdata_eval = val_data = None
    if tc.device_data and k_fuse > 1 and isinstance(ds, PackedDataset):
        nbytes = sum(getattr(ds, k).size * 4 for k in ("mel", "motion", "lyrics"))
        print(f"uploading dataset to device ({nbytes / 1e9:.2f} GB) ...")
        t_up = time.time()
        devdata_step = make_device_data_multistep(schedule, cfg, optimizer, **stats)
        device_data = upload_dataset(ds, dev)
        if isinstance(val_ds, PackedDataset):
            devdata_eval = make_device_data_eval(schedule, cfg, **stats)
            val_data = upload_dataset(val_ds, dev)
        print(f"dataset resident on the device ({time.time() - t_up:.1f}s)")
    elif tc.device_data:
        print("device_data requested but needs steps_per_call>1 and a "
              "packed dataset; falling back to the streaming path")
    sb_stream = None
    if k_fuse > 1 and devdata_step is None:
        sb_stream = SuperbatchStream(ds, bs, k_fuse, base_seed=tc.seed, total_epochs=tc.epochs,
                                     start_epoch=start_epoch)
    primary = collectives.is_primary()
    logger = (TrainLogger(save_dir, use_tensorboard=use_tensorboard) if primary
              else NullLogger())
    timer = StepTimer(report_every=max(tc.log_interval * 10, 100))
    writer = CheckpointWriter()

    def ckpt(epoch):
        # the state is replicated: the primary alone writes it, and the
        # barrier keeps the others from racing ahead of the write
        if primary:
            path = save_checkpoint(save_dir, state, cfg, epoch=epoch,
                                   dataset_mean=dataset_mean, dataset_std=dataset_std,
                                   keep_last=tc.keep_checkpoints, writer=writer)
            print("saved checkpoint:", path)
        collectives.barrier("ckpt")

    def lr_at(s):
        return float(optimizer.lr_schedule(s))

    step = state.step
    pending_loss = None
    last_loss = float("nan")
    stop = False
    epoch = start_epoch

    def fused_call(epoch, tag, run):
        """``run(offsets)`` the K steps of a group ("multi": log on crossing
        log_interval, the JAX save rule) or the one step of a tail batch
        that does not fill a group ("single")."""
        nonlocal step, pending_loss, last_loss
        if tag == "single":
            pending_loss = run([step])[0]
            step += 1
            return
        losses = run(range(step, step + k_fuse))
        pending_loss = losses[-1]
        if step // tc.log_interval != (step + k_fuse) // tc.log_interval:
            last_loss = float(losses[-1])
            logger.log_step(epoch, step + k_fuse - 1, last_loss, lr_at(step))
        step += k_fuse
        if tc.save_interval and step % tc.save_interval < k_fuse and step >= tc.save_interval:
            ckpt(epoch)

    def one(batch):
        """A (B, T, .) batch as a group of one."""
        return {key: v[None] for key, v in batch.items()}

    for epoch in range(start_epoch, tc.epochs):
        t0 = time.time()
        if devdata_step is not None:
            for tag, idx in superbatch_indices(len(ds), bs, k_fuse, seed=tc.seed + epoch):
                fused_call(epoch, tag, lambda offsets, idx=idx: devdata_step(
                    state, device_data, idx, tc.seed, offsets))
                if max_steps is not None and step >= max_steps:
                    stop = True
                    break
        elif k_fuse > 1:
            for tag, batch in device_prefetch(sb_stream.epoch(epoch), dev, tagged=True):
                batches = batch if tag == "multi" else one(batch)
                fused_call(epoch, tag, lambda offsets, batches=batches: multistep(
                    state, batches, tc.seed, offsets))
                if max_steps is not None and step >= max_steps:
                    stop = True
                    break
        else:
            it = BatchIterator(ds, bs, shuffle=True, seed=tc.seed + epoch)
            for batch in device_prefetch(_local_rows(it, rows), dev):
                pending_loss = multistep(state, one(batch), tc.seed, [step])[0]
                ema_dt = timer.tick()
                if ema_dt is not None:
                    print(f"step time (ema): {ema_dt * 1e3:.2f} ms")
                if step % tc.log_interval == 0:
                    last_loss = float(pending_loss)
                    logger.log_step(epoch, step, last_loss, lr_at(step))
                if tc.save_interval and step % tc.save_interval == 0 and step > 0:
                    ckpt(epoch)
                step += 1
                if max_steps is not None and step >= max_steps:
                    stop = True
                    break

        val_loss = None
        ve = tc.validate_every_epochs
        if val_ds is not None and not stop and bool(ve) and (epoch + 1) % ve == 0:
            n_val = len(val_ds) // bs
            if tc.val_cap_batches:
                n_val = min(n_val, tc.val_cap_batches)
            offsets = [VAL_OFFSET + step + i for i in range(n_val)]
            if val_data is not None and n_val:
                vlosses = devdata_eval(state, val_data, np.arange(n_val * bs).reshape(n_val, bs),
                                       tc.seed, offsets)
                val_loss = float(vlosses.mean())
                print(f"epoch {epoch} val loss: {val_loss:.6f} ({n_val} batches, "
                      "device-resident)")
            elif n_val:
                vit = _local_rows(BatchIterator(val_ds, bs, shuffle=False), rows)
                vlosses = [eval_multi(state, one(vbatch), tc.seed, [off])[0]
                           for off, vbatch in zip(offsets, device_prefetch(vit, dev))]
                val_loss = float(torch.stack(vlosses).mean())
                print(f"epoch {epoch} val loss: {val_loss:.6f} ({len(vlosses)} batches)")

        if quality is not None and not stop and (epoch + 1) % tc.quality_every_epochs == 0:
            logger.log_quality(epoch, step, quality.run())

        if pending_loss is not None:
            last_loss = float(pending_loss)
        logger.log_epoch(epoch, step, last_loss, val_loss, time.time() - t0)
        if stop:
            break

    if sb_stream is not None:
        sb_stream.drain()
    if start_epoch < tc.epochs:
        ckpt(epoch if stop else epoch + 1)
    writer.wait()
    logger.close()
    return TrainResult(final_step=step, final_loss=last_loss, ckpt_dir=save_dir)
