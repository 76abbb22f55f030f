"""Random draws at the global batch shape under data parallelism.

The JAX data-parallel step draws its timesteps, noise, CFG keep mask and
dropout masks at the global ``(B, ...)`` shape and shards them, so N ranks
take the draws of one. The port does the same without a collective: every
rank seeds its step generator alike, draws the global shape and keeps its
rows. ``RowShard(generator, rows, global_rows)`` stands for such a
generator; ``rand``, ``randn`` and ``randint`` take it or a plain
``torch.Generator`` (or None), and the draw sites of a train step and of a
sampler chain call them. With ``dim=1`` it shards the time axis instead
(the sequence-parallel sampler, ``parallel/sequence.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Sequence, Tuple, Union

import torch


@dataclass(frozen=True)
class RowShard:
    """``generator`` drawing at ``global_rows`` along dimension ``dim`` (the
    batch rows by default), of which this rank keeps ``rows``; ``also``
    holds further ``(dim, rows, global_rows)`` cuts (rows and time at once:
    the sequence-parallel train step)."""

    generator: torch.Generator
    rows: slice
    global_rows: int
    dim: int = 0
    also: Tuple[Tuple[int, slice, int], ...] = ()

    def cut(self, dim: int, rows: slice, global_rows: int) -> "RowShard":
        """This shard with one more cut along ``dim``."""
        return replace(self, also=self.also + ((dim, rows, global_rows),))


GeneratorLike = Optional[Union[torch.Generator, RowShard]]


def _draw(fn, shape: Sequence[int], generator: GeneratorLike, **kw) -> torch.Tensor:
    if not isinstance(generator, RowShard):
        return fn(*kw.pop("args", ()), tuple(shape), generator=generator, **kw)
    cuts = ((generator.dim, generator.rows, generator.global_rows),) + generator.also
    full, index = list(shape), [slice(None)] * len(shape)
    for d, rows, n in cuts:
        if d >= len(shape):  # a cut along a dimension this draw does not have
            continue
        if shape[d] != rows.stop - rows.start:
            raise ValueError(f"a draw of {shape[d]} rows from a shard of rows {rows}")
        full[d], index[d] = n, rows
    out = fn(*kw.pop("args", ()), tuple(full), generator=generator.generator, **kw)
    return out[tuple(index)]


def rand(shape, generator: GeneratorLike, device) -> torch.Tensor:
    return _draw(torch.rand, shape, generator, device=device)


def randn(shape, generator: GeneratorLike, device, dtype=torch.float32) -> torch.Tensor:
    return _draw(torch.randn, shape, generator, device=device, dtype=dtype)


def randint(high: int, shape, generator: GeneratorLike, device) -> torch.Tensor:
    return _draw(torch.randint, shape, generator, args=(0, high), device=device)
