"""Fused clip + Adan + EMA update: the CUDA kernel's wrapper and plain version.

Port of ``lm2a_tpu/ops/pallas_opt.py:fused_adan_ema_update``, whose Pallas
kernel ``_make_kernel`` runs through ``_bucket_call`` (small leaves, several
per call) and ``_big_call`` (one call per large leaf). Here one CUDA kernel
(``csrc/adan.cu``, launched by ``AdanEma``) updates every leaf, large and
small alike, in one launch from a device table of per-leaf pointers. The
global gradient norm stays outside the kernel, in plain PyTorch, as it
stays in XLA in the JAX package; the eight step scalars ``[warm, gnorm,
lr, c_m, c_v, c_n, denom, ema_decay]`` live in one fp32 device tensor
(``step_scalars``), so a step needs no host sync.

A leaf is the tuple ``(g, p, ema, m, v, n, prev_grad)``: fp32 gradient,
fp32 parameter and EMA, Adan state in fp32 or bf16 (all leaves alike), all
contiguous; p, ema and the state are updated in place.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from lm2a_tpu_torch.ops import _build
from lm2a_tpu_torch.ops.resblock import _is_cuda, _need

CHUNK = 4096  # elements per chunk (csrc/adan.cu)
MAX_GRID = 132 * 8
N_SCALARS = 8

Leaf = Tuple[torch.Tensor, ...]

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_build.declare("adan", "lm2a_adan_ema",
               [_P, _P, _I, _L, _P, _F, _F, _F, _F, _F, _F, _F, _F, _I, _I, _P])


def step_scalars(step: int, gnorm: torch.Tensor, lr: float, *, betas, weight_decay: float,
                 ema_decay: float, device) -> torch.Tensor:
    """The 8 scalars of the step after ``step`` completed steps, fp32 on
    ``device``: host-side fp32 arithmetic as the JAX package's (bias
    corrections ``1 / (1 - (1-b)^step)`` at the 1-indexed step), then the
    device-side ``gnorm`` written into slot 1 without a host sync."""
    f32 = np.float32
    sf = f32(step + 1)
    c = [f32(1.0) / (f32(1.0) - f32(1.0 - b) ** sf) for b in betas]
    lr32 = f32(lr)
    denom = f32(1.0) + f32(weight_decay) * lr32
    host = np.array([f32(step > 0), 0.0, lr32, c[0], c[1], c[2], denom, f32(ema_decay)],
                    dtype=np.float32)
    t = torch.from_numpy(host)
    if torch.device(device).type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    t[1] = gnorm
    return t


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf (fp32, on the leaves' device)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(grads))))


@torch.no_grad()
def adan_ema_plain(leaf: Leaf, scal: torch.Tensor, *, betas, eps: float, clip: float,
                   ema_term: Optional[float] = None) -> None:
    """One leaf's update in place, the JAX expressions in order.

    The EMA is ``e * ema + pnew * (1 - ema)`` with ``1 - ema`` taken from
    ``scal`` in fp32, as the JAX kernel does; ``ema_term`` (the JAX XLA
    route's Python ``1 - ema_decay``) replaces it for the plain route."""
    g, p, e, m, v, n, pg = leaf
    b1, b2, b3 = betas
    warm, gnorm, lr, c_m, c_v, c_n, denom, ema = scal.unbind(0)
    gg = g.float()
    if clip and clip > 0:
        gg = torch.where(gnorm < clip, gg, (gg / gnorm) * clip)
    mm, vv, nn, pgf = m.float(), v.float(), n.float(), pg.float()
    m2 = mm + warm * ((1.0 - b1) * mm + b1 * gg - mm)
    v2 = vv + warm * ((1.0 - b2) * vv + b2 * (gg - pgf) - vv)
    tgt = (1.0 - b3) * nn + b3 * (gg + (1.0 - b2) * (gg - pgf)) ** 2
    n2 = nn + warm * (tgt - nn)
    raw = lr / (torch.sqrt(n2 * c_n) + eps) * (m2 * c_m + (1.0 - b2) * v2 * c_v)
    pnew = p + ((p - raw) / denom - p)
    p.copy_(pnew)
    e.copy_(e * ema + pnew * ((1.0 - ema) if ema_term is None else ema_term))
    for dst, val in ((m, m2), (v, v2), (n, n2), (pg, gg)):
        dst.copy_(val)


class AdanEma:
    """The kernel's launcher: builds the device table of leaf pointers and
    keeps it while the leaves' storage stays where it was."""

    def __init__(self, betas=(0.02, 0.08, 0.01), eps: float = 1e-8, grad_clip: float = 0.0):
        self.betas, self.eps, self.clip = tuple(betas), eps, float(grad_clip or 0.0)
        self._key = None
        self._table = None

    def _build_table(self, leaves: List[Leaf], dev):
        sdt = leaves[0][3].dtype
        for leaf in leaves:
            g, p, e = leaf[:3]
            _need(all(t.device == dev and t.is_contiguous() for t in leaf),
                  "adan_ema: every tensor of a leaf must be contiguous on one device")
            _need(g.dtype == p.dtype == e.dtype == torch.float32,
                  "adan_ema: g, p and ema must be fp32")
            _need(all(t.dtype == sdt for t in leaf[3:]) and sdt in (torch.float32, torch.bfloat16),
                  "adan_ema: the state must be all fp32 or all bf16")
            _need(all(t.numel() == p.numel() for t in leaf), "adan_ema: leaf sizes differ")
        rec = np.array([[t.data_ptr() for t in leaf] + [leaf[1].numel()] for leaf in leaves],
                       dtype=np.int64)
        chunks = -(-rec[:, 7] // CHUNK)
        first = np.concatenate([[0], np.cumsum(chunks)[:-1]]).astype(np.int64)
        table = torch.from_numpy(rec.reshape(-1)).pin_memory().to(dev, non_blocking=True)
        first_t = torch.from_numpy(first).pin_memory().to(dev, non_blocking=True)
        return table, first_t, int(chunks.sum()), int(sdt == torch.bfloat16)

    @torch.no_grad()
    def __call__(self, leaves: List[Leaf], scal: torch.Tensor) -> None:
        """Update every leaf in place: one launch on the card, the plain
        version per leaf on the CPU."""
        if not leaves:
            return
        if not _is_cuda(leaves[0][1]):
            for leaf in leaves:
                adan_ema_plain(leaf, scal, betas=self.betas, eps=self.eps, clip=self.clip)
            return
        dev = leaves[0][1].device
        _need(scal.dtype == torch.float32 and scal.is_contiguous() and scal.numel() == N_SCALARS
              and scal.device == dev, "adan_ema: scalars must be fp32 (8,) on the leaves' device")
        key = tuple(t.data_ptr() for leaf in leaves for t in leaf)
        if key != self._key:
            self._table = self._build_table(leaves, dev)
            self._key = key
        table, first, n_chunks, bf16_state = self._table
        b1, b2, b3 = self.betas
        _build.launch("adan", "lm2a_adan_ema", "adan_ema",
                      _build.ptr(table), _build.ptr(first), len(leaves), n_chunks,
                      _build.ptr(scal), b1, b2, b3, 1.0 - b1, 1.0 - b2, 1.0 - b3, self.eps,
                      self.clip, bf16_state, min(n_chunks, MAX_GRID),
                      _build.stream_ptr(dev))

