"""Streaming per-dimension moments (numpy, host side): a copy of
``lm2a_tpu/ops/moments.py``.

Each chunk contributes its moments in one vectorised pass and chunks merge
with the parallel Welford combination (same ddof=1 variance as a per-row
Welford loop).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class RunningMoments:
    """Mergeable (count, mean, M2) accumulator over axis-0 rows of (N, D)."""

    count: int = 0
    mean: Optional[np.ndarray] = None
    m2: Optional[np.ndarray] = None

    def update(self, rows: np.ndarray) -> None:
        rows = np.asarray(rows, dtype=np.float64)
        if rows.ndim == 1:
            rows = rows[None, :]
        n_b = rows.shape[0]
        if n_b == 0:
            return
        mean_b = rows.mean(axis=0)
        m2_b = ((rows - mean_b) ** 2).sum(axis=0)
        if self.count == 0:
            self.count, self.mean, self.m2 = n_b, mean_b, m2_b
            return
        n_a, mean_a, m2_a = self.count, self.mean, self.m2
        n = n_a + n_b
        delta = mean_b - mean_a
        self.mean = mean_a + delta * (n_b / n)
        self.m2 = m2_a + m2_b + delta * delta * (n_a * n_b / n)
        self.count = n

    def std(self, ddof: int = 1) -> np.ndarray:
        """Sample std (ddof=1 by default)."""
        if self.count <= ddof or self.mean is None:
            base = self.mean if self.mean is not None else np.zeros(1)
            return np.ones_like(base)
        return np.sqrt(self.m2 / (self.count - ddof))
