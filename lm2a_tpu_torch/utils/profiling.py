"""Step timing (port of ``StepTimer`` in ``lm2a_tpu/utils/profiling.py``)."""

from __future__ import annotations

import time
from typing import Optional


class StepTimer:
    """Wall-clock step timing with exponential smoothing."""

    def __init__(self, report_every: int = 100, smoothing: float = 0.98):
        self.report_every = report_every
        self.smoothing = smoothing
        self._last: Optional[float] = None
        self._ema: Optional[float] = None
        self.steps = 0

    def tick(self) -> Optional[float]:
        """Call once per step; returns the EMA step time on report steps."""
        now = time.perf_counter()
        if self._last is not None:
            dt = now - self._last
            self._ema = dt if self._ema is None else (
                self.smoothing * self._ema + (1 - self.smoothing) * dt)
        self._last = now
        self.steps += 1
        if self.report_every and self.steps % self.report_every == 0:
            return self._ema
        return None

    @property
    def ema_seconds(self) -> Optional[float]:
        return self._ema
