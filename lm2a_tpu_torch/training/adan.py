"""Adan with gradient clipping and the EMA (port of
``lm2a_tpu/training/adan.py`` and of ``make_optimizer`` in
``lm2a_tpu/training/train_step.py``).

State: first-moment EMA ``m``, gradient-difference EMA ``v``, EMA of
``(g + (1-b2)(g - g_prev))^2`` as ``n``, and ``prev_grad``, each keyed like
the parameters; the moments stay zero on the very first step (warm = 0),
which only stores the clipped gradient and applies the ``1/(1 + wd*lr)``
shrink. Bias corrections are ``1/(1 - (1-b)^step)`` and

    p <- (p - lr / (sqrt(n * c_n) + eps) * (m * c_m + (1-b2) * v * c_v))
         / (1 + wd * lr)

written as the JAX package writes it, ``p + ((p - raw) / denom - p)``.
Global-norm clipping is folded in, ``where(norm < clip, g, (g/norm)*clip)``
at each read. Two routes, one state layout:

- ``'xla'`` (the JAX default): the plain per-leaf expressions in PyTorch,
  then the EMA lerp ``e * decay + p * (1 - decay)``;
- ``'pallas'``: the CUDA kernel of ``ops.adan.AdanEma`` (one
  launch for every leaf on the card), the same arithmetic.

``fused_opt=False`` is the JAX package's chained form,
``optax.chain(clip_by_global_norm, adan)``. Its arithmetic is the folded
form's, bit for bit (the JAX package's own comment on the two forms), so it
takes the plain route's update; what differs is the state's place in a
checkpoint, index 1 of the chain's tuple (``AdanState.chained``:
``.opt_state[1].m[...]``). The CUDA route refuses it, as the JAX package's
Pallas updater does. The raveled ``flat_adan`` of the JAX package (measured
and rejected there, reached by no CLI) is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from lm2a_tpu_torch.core.graphs import stage
from lm2a_tpu_torch.ops.adan import (
    N_SCALARS, AdanEma, adan_ema_plain, global_norm, host_scalars,
)

BETAS = (0.02, 0.08, 0.01)
EPS = 1e-8
STATE_KEYS = ("m", "v", "n", "prev_grad")


@dataclass
class AdanState:
    step: int  # completed steps
    m: Dict[str, torch.Tensor] = field(default_factory=dict)
    v: Dict[str, torch.Tensor] = field(default_factory=dict)
    n: Dict[str, torch.Tensor] = field(default_factory=dict)
    prev_grad: Dict[str, torch.Tensor] = field(default_factory=dict)
    # the chained form's layout: the state at index 1 of (clip state, Adan state)
    chained: bool = False


def init_adan_state(params: Dict[str, torch.Tensor],
                    state_dtype: Optional[torch.dtype] = None,
                    chained: bool = False) -> AdanState:
    """Zero moments shaped like ``params`` (fp32 unless ``state_dtype``)."""
    def zeros():
        return {k: torch.zeros(p.shape, dtype=state_dtype or p.dtype, device=p.device)
                for k, p in params.items()}

    return AdanState(0, zeros(), zeros(), zeros(), zeros(), chained)


def make_lr_schedule(base_lr: float, decay_steps: Tuple[int, ...] = (),
                     decay_factors: Tuple[float, ...] = ()) -> Callable[[int], np.float32]:
    """Step decay with the reference's boundary: the schedule takes the
    1-indexed current step and applies a factor from step ``D + 2`` on.
    Empty lists mean a constant rate. Values are fp32."""
    if len(decay_steps) != len(decay_factors):
        raise ValueError("decay steps and factors must pair up")
    order = sorted(range(len(decay_steps)), key=lambda i: decay_steps[i])
    steps = np.asarray([decay_steps[i] for i in order], dtype=np.int32)
    factors = np.asarray([decay_factors[i] for i in order], dtype=np.float32)

    def schedule(step: int) -> np.float32:
        if not len(order):
            return np.float32(base_lr)
        applied = np.where(np.int32(step) >= steps + 2, factors, np.float32(1.0))
        return np.float32(base_lr) * np.prod(applied, dtype=np.float32)

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Callable[[int], np.float32]:
    """``optax.cosine_decay_schedule(init_value, decay_steps, alpha)`` in fp32:
    ``init * ((1 - alpha) * 0.5 (1 + cos(pi min(step, D) / D)) + alpha)``,
    taken at the 1-indexed step ``Adan.scalars`` passes (``cli distill
    --lr_decay cosine``)."""
    if not decay_steps > 0:
        raise ValueError(f"cosine decay needs decay_steps > 0, got {decay_steps}")
    f32 = np.float32
    d = f32(decay_steps)

    def schedule(step: int) -> np.float32:
        count = min(f32(step), d)
        cosine = f32(0.5) * (f32(1.0) + np.cos(f32(np.pi) * count / d))
        return f32(init_value) * (f32(1.0 - alpha) * cosine + f32(alpha))

    return schedule


class Adan:
    """The optimizer of the train step: clip + Adan + EMA over named
    parameters, in place, on either route. ``fused=False`` is the chained
    form's state layout (see the module docstring), on the plain route only."""

    def __init__(self, lr_schedule: Callable[[int], np.float32], *, weight_decay: float = 0.0,
                 grad_clip: float = 0.0, ema_decay: float = 0.999,
                 state_dtype: Optional[torch.dtype] = None, backend: str = "xla",
                 fused: bool = True):
        if backend not in ("xla", "pallas"):
            raise ValueError(f"opt_backend must be 'xla' or 'pallas', got {backend!r}")
        if not fused and backend == "pallas":
            raise ValueError("opt_backend='pallas' needs fused_opt=1 (bare AdanState layout)")
        self.fused = fused
        self.lr_schedule = lr_schedule
        self.weight_decay, self.grad_clip = weight_decay, float(grad_clip or 0.0)
        self.ema_decay = ema_decay
        self.state_dtype = state_dtype
        self.backend = backend
        self._kernel = AdanEma(BETAS, EPS, self.grad_clip)
        # the clip's gradient norm over the leaves ``apply`` gets (tensor
        # parallelism, whose ``apply`` gets shards, gives the whole gradient's)
        self.norm_fn: Callable[[List[torch.Tensor]], torch.Tensor] = global_norm

    @property
    def chained(self) -> bool:
        """The chain's state layout: unfused and clipping (with no clip the
        JAX package's optimizer is Adan alone, the bare layout)."""
        return not self.fused and self.grad_clip > 0

    def init(self, params: Dict[str, torch.Tensor]) -> AdanState:
        return init_adan_state(params, self.state_dtype, self.chained)

    def host_scalars(self, step: int) -> np.ndarray:
        """The 8 scalars of the step after ``step`` completed steps, on the
        host (slot 1, the gradient norm, 1.0 until ``apply`` writes it)."""
        return host_scalars(step, self.lr_schedule(step + 1), betas=BETAS,
                            weight_decay=self.weight_decay, ema_decay=self.ema_decay)

    def stage_scalars(self, step: int, out: torch.Tensor) -> torch.Tensor:
        """Stage into ``out`` the host scalars of the steps after ``step``
        completed steps: a (K, 8) table for K steps, or (8,) for one (no host
        sync; ``core.graphs.stage``). Returns ``out``."""
        k = out.shape[0] if out.dim() == 2 else 1
        table = np.stack([self.host_scalars(step + j) for j in range(k)])
        return stage(out, table.reshape(out.shape))

    def scalars(self, state: AdanState, grads: List[torch.Tensor]) -> torch.Tensor:
        """The step's 8 scalars on the gradients' device (no host sync)."""
        scal = self.stage_scalars(state.step, torch.empty(N_SCALARS, dtype=torch.float32,
                                                          device=grads[0].device))
        self.write_gnorm(scal, grads)
        return scal

    def write_gnorm(self, scal: torch.Tensor, grads: List[torch.Tensor]) -> None:
        """Slot 1: the global gradient norm when clipping (else it stays 1.0)."""
        if self.grad_clip > 0:
            scal[1] = self.norm_fn(grads)

    @torch.no_grad()
    def apply(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
              ema: Dict[str, torch.Tensor], state: AdanState, scal: torch.Tensor) -> None:
        """The step's device work with its staged scalars ``scal`` (8,) fp32:
        the gradient norm into slot 1, then params, EMA and state updated in
        place. ``state.step`` is the caller's to count (``update``)."""
        names = list(params)
        leaves = [(grads[k], params[k], ema[k], state.m[k], state.v[k], state.n[k],
                   state.prev_grad[k]) for k in names]
        self.write_gnorm(scal, [leaf[0] for leaf in leaves])
        if self.backend == "pallas":
            self._kernel(leaves, scal)
        else:
            for leaf in leaves:
                adan_ema_plain(leaf, scal, betas=BETAS, eps=EPS, clip=self.grad_clip,
                               ema_term=1.0 - self.ema_decay)

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
               ema: Dict[str, torch.Tensor], state: AdanState) -> None:
        """One step: its scalars staged, ``apply``, and ``state.step`` counts up."""
        dev = next(iter(grads.values())).device
        scal = self.stage_scalars(state.step, torch.empty(N_SCALARS, dtype=torch.float32,
                                                          device=dev))
        self.apply(params, grads, ema, state, scal)
        state.step += 1
