"""The folded cross-attention core: the CUDA kernel's wrapper and plain version.

``CrossAttentionFusion._forward_folded`` (``models/attention.py``) attends
the merged query projection of both branches, ``(B, T, 2C)`` with C = H*hd
(the motion branch's H heads, then the text branch's), over each branch's
key and value projections, ``(B, S, C)`` each: ``softmax(q k^T / sqrt(hd))
v`` over 2H heads, ``(B, T, 2C)`` out in the same channel order, the rows the
folded ``out·fuse`` product reads.

On the card ``fold_core`` is one launch of ``csrc/attention.cu``'s folded
entry (``lm2a_fold_core``, counted as ``fold_core``): the attention
kernel's body over 2H heads, heads [0, H) reading the motion branch's K and
V and heads [H, 2H) the text branch's, each branch's projections read in
place through tensor maps of its own; Q is read from the merged
projection's rows and O written into ``(B, T, 2C)`` rows, so nothing is
stacked, transposed or copied around the launch. The launch plan is
``attention_plan``'s cost model over the 2H heads (``fold_core_plan``).
The arithmetic is ``attention_core``'s (``ops/attention.py``): scores, the
scale and the softmax in fp32, p rounded to bf16 for P.V; its twin is
``fold_core_plain``, ``attention_core_plain`` over the same 2H heads. It is
serving's core: no backward.

It replaces no Pallas kernel: the JAX package leaves this core to XLA, which
fuses the folded einsum, softmax and einsum on the TPU. PyTorch's plain
core made six passes over a ``(B, 2, H, T, S)`` score tensor (bf16 scores,
a divide by a 0-d tensor, two casts, an fp32 softmax) besides the stacks of
K and V: 132M scores a guided step of 8 clips at 6 s. What bounds the
kernel is the exp2 of every score on the MUFU (16 a clock per SM), about as
long as the score's tensor operations at hd 32, and below a few rows the
latency of small grids; it keeps the scores in registers, runs both
branches in one grid (one launch a site, where the unfolded fused route
makes two), and splits the key tiles over a cluster where the grid would
leave most SMs idle.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from lm2a_tpu_torch.ops import _build
from lm2a_tpu_torch.ops.attention import AttentionPlan, attention_candidates, attention_core_plain

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_build.declare("attention", "lm2a_fold_core", [_P] * 6 + [_I] * 5 + [_L] * 8 + [_I] * 7 + [_P])


@functools.lru_cache(maxsize=None)
def fold_core_plan(b: int, h: int, t: int, s: int, hd: int) -> AttentionPlan:
    """The launch of one folded core of ``h`` heads a branch: the
    candidate of least modeled time over the 2h heads of its grid, its
    tiles set by a branch's heads."""
    return min(attention_candidates(b, h, t, s, hd, branches=2), key=lambda c: c[0])[1]


def _heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    return x.reshape(x.shape[0], x.shape[1], n, hd).transpose(1, 2)


def fold_core_plain(q, k_m, v_m, k_t, v_t, heads: int) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch, on any device: ``(B, T, 2C)`` out."""
    b, t, c2 = q.shape
    hd = c2 // (2 * heads)
    k = torch.cat([_heads(k_m, heads, hd), _heads(k_t, heads, hd)], dim=1)
    v = torch.cat([_heads(v_m, heads, hd), _heads(v_t, heads, hd)], dim=1)
    out = attention_core_plain(_heads(q, 2 * heads, hd), k, v)
    return out.transpose(1, 2).reshape(b, t, c2)


def _check(q, kvs, heads):
    def need(cond, msg):
        if not cond:
            raise ValueError(f"fold_core: {msg}")

    need(q.dim() == 3 and all(x.dim() == 3 for x in kvs),
         f"q must be (B, T, 2C) and k, v (B, S, C), got {tuple(q.shape)}, "
         f"{[tuple(x.shape) for x in kvs]}")
    b, t, c2 = q.shape
    need(heads >= 1 and c2 >= 2 * heads and c2 % (2 * heads) == 0,
         f"q's {c2} channels are not two branches of {heads} heads")
    s = kvs[0].shape[1]
    for x, name in zip(kvs, ("k_m", "v_m", "k_t", "v_t")):
        need(tuple(x.shape) == (b, s, c2 // 2),
             f"{name} must be (B, S, C) = ({b}, S, {c2 // 2}), got {tuple(x.shape)}")
        need(x.device == q.device, f"{name} on {x.device}, q on {q.device}")
    need(all(x.dtype == torch.bfloat16 for x in (q, *kvs)),
         f"the CUDA kernel takes bf16 q, k, v, got {[x.dtype for x in (q, *kvs)]}")
    need(t >= 1 and s >= 1, f"empty T or S ({t}, {s})")


def _taken(x: torch.Tensor) -> bool:
    """Rows the tensor maps read as they lie: channels contiguous, rows,
    batches and the start on the 16-byte unit."""
    st = x.stride()
    return st[2] == 1 and st[1] % 8 == 0 and st[0] % 8 == 0 and x.data_ptr() % 16 == 0


def _rows(xs, n: int, c: int, cp: int):
    """``xs``, (B, L, n*C) each, as rows the kernel reads with one set of
    strides: as they are where they can be (``cp == c``), else copied into
    zeroed (B, L, n*cp) rows, each branch's C channels from a multiple of 8."""
    if cp == c and all(_taken(x) for x in xs) and len({x.stride() for x in xs}) == 1:
        return xs
    out = []
    for x in xs:
        b, l = x.shape[:2]
        y = x.new_zeros((b, l, n, cp))
        y[..., :c].copy_(x.reshape(b, l, n, c))
        out.append(y.view(b, l, n * cp))
    return out


def fold_core(q, k_m, v_m, k_t, v_t, heads: int) -> torch.Tensor:
    """Both branches' attention cores of a folded site on the card: ``q``
    (B, T, 2C), ``k_m``, ``v_m``, ``k_t``, ``v_t`` (B, S, C), C = ``heads``
    * hd, bf16."""
    kvs = (k_m, v_m, k_t, v_t)
    if q.device.type != "cuda":
        raise ValueError(f"fold_core: the CUDA kernel takes tensors on the card, not {q.device}")
    _check(q, kvs, heads)
    b, t, c2 = q.shape
    c, s = c2 // 2, k_m.shape[1]
    hd = c // heads
    # rows off the 16-byte unit (C off the 8-channel unit, or a view the
    # maps cannot describe) are copied into padded rows; the output keeps
    # its shape
    cp = -(-c // 8) * 8
    (q,), (k_m, k_t), (v_m, v_t) = _rows([q], 2, c, cp), _rows([k_m, k_t], 1, c, cp), \
        _rows([v_m, v_t], 1, c, cp)
    plan = fold_core_plan(b, heads, t, s, hd)
    out = torch.empty((b, t, 2 * cp), device=q.device, dtype=q.dtype)
    p = _build.ptr
    _build.launch("attention", "lm2a_fold_core", "fold_core",
                  p(q), p(k_m), p(v_m), p(k_t), p(v_t), p(out), b, heads, t, s, hd,
                  q.stride(0), q.stride(1), k_m.stride(0), k_m.stride(1),
                  v_m.stride(0), v_m.stride(1), out.stride(0), out.stride(1), cp, cp,
                  plan.hdq, plan.bn, plan.stages, plan.split, plan.smem,
                  _build.stream_ptr(q.device))
    if cp == c:
        return out
    return out.view(b, t, 2, cp)[..., :c].reshape(b, t, c2)
