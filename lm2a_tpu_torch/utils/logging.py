"""Training observability: stdout, an append-mode CSV and optional
TensorBoard (port of ``lm2a_tpu/utils/logging.py``).

``train_log.csv`` has the JAX package's columns ``epoch, step, train_loss,
val_loss, time_seconds``; TensorBoard scalars ``train/loss``, ``train/lr``
and ``val/loss`` are written when ``torch.utils.tensorboard`` imports.
"""

from __future__ import annotations

import csv
import os
from typing import Optional


class TrainLogger:
    CSV_COLUMNS = ["epoch", "step", "train_loss", "val_loss", "time_seconds"]

    def __init__(self, save_dir: str, use_tensorboard: bool = True):
        os.makedirs(save_dir, exist_ok=True)
        self.save_dir = save_dir
        csv_path = os.path.join(save_dir, "train_log.csv")
        existed = os.path.exists(csv_path)
        self._csv_file = open(csv_path, "a", newline="")
        self._csv = csv.writer(self._csv_file)
        if not existed:
            self._csv.writerow(self.CSV_COLUMNS)
            self._csv_file.flush()
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:  # tensorboard is optional; the CSV is authoritative
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(log_dir=save_dir)

    def log_step(self, epoch: int, step: int, loss: float, lr: float) -> None:
        print(f"epoch {epoch} step {step} loss {loss:.6f} lr {lr:.6f}")
        if self._tb is not None:
            self._tb.add_scalar("train/loss", loss, step)
            self._tb.add_scalar("train/lr", lr, step)
        self._csv.writerow([epoch, step, float(loss), None, ""])
        self._csv_file.flush()

    def log_epoch(self, epoch: int, step: int, train_loss: Optional[float],
                  val_loss: Optional[float], seconds: float) -> None:
        if val_loss is not None and self._tb is not None:
            self._tb.add_scalar("val/loss", val_loss, step)
        self._csv.writerow([epoch, step, train_loss, val_loss, round(seconds, 2)])
        self._csv_file.flush()

    def close(self) -> None:
        self._csv_file.close()
        if self._tb is not None:
            self._tb.close()


class NullLogger:
    """A logger that records nothing."""

    def log_step(self, epoch, step, loss, lr) -> None:
        pass

    def log_epoch(self, epoch, step, train_loss, val_loss, seconds) -> None:
        pass

    def close(self) -> None:
        pass
