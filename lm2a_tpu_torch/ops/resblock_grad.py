"""Fused FiLM-resblock training chain: forward kernels plus a CUDA backward.

Port of the training half of ``lm2a_tpu/ops/pallas_resblock.py``
(``resblock_train_fits``, ``fused_resblock_train`` and its custom VJP, whose
backward is the Pallas kernel ``_resblock_bwd_kernel``).

The forward is the serving chain's four launches (``ops/resblock.py``:
``gn_stats``, ``conv3_fused`` in its ``save_pre`` mode, ``gn_stats``,
``conv3_fused`` with the skip kept apart) and saves what the backward needs:
the block input, the conv-1 output before FiLM (``z1``, for the FiLM-scale
gradient) and after it (``f``), and both GroupNorms' statistics. The
backward (``csrc/resblock_bwd.cu``) is three kernels:

- ``conv3_dgrad``: the input gradient of a SAME conv3 (or of the 1x1 skip),
  with the SiLU backward of the GroupNorm+SiLU that fed it in the epilogue
  and per-(row, channel, 64-frame tile) partial sums of ``d_y`` and
  ``d_y * xhat``; its M tiles run over the flattened B·T rows, so a
  bucket's sums come in a head and a tail piece (``dgrad_plan``), which
  ``gn_bwd`` and the sums below read as they are, head first;
- ``conv3_wgrad``: the weight gradient and the bias gradient's column sums,
  its operand ``silu(gn(.))`` formed in the prologue; where the output tiles
  are fewer than the SMs, K (B*T) is split over a thread-block cluster whose
  fp32 tiles are summed in rank order inside the kernel (``wgrad_plan``);
- ``gn_bwd``: GroupNorm's input gradient from those pieces; for GN2 also
  ``d_z1 = d_f * (1 + scale)`` and tile sums of ``d_f``, ``d_f * z1`` and
  ``d_z1`` (the FiLM shift, FiLM scale and conv-1 bias gradients).

The channel partials are summed here with ``torch.sum`` over a fixed axis,
never with atomics, so the gradients are the same bits from run to run.
Numerics are the JAX kernel's: bf16 conv operands (``silu(gn(.))``, ``g``
and ``d_z1`` rounded to the compute dtype) with fp32 accumulation,
GroupNorm and SiLU in fp32, weight gradients fp32.

Each kernel wrapper launches its CUDA kernel for a CUDA tensor, runs its
plain PyTorch version (``*_plain``, the same arithmetic and the same partial
tiles) for a CPU tensor, and raises for anything else.

A shard of a sequence-parallel step (``parallel/sequence.py``) runs the
chain on its rows of T (``chain_forward_sharded``,
``chain_backward_sharded``): the statistics from ``gn_stats``'s sums form
added over the shards, each conv's input with one neighbour row at each
inner end, and in the backward the output gradient's rows exchanged the
same way. For that ``conv3_dgrad`` and ``conv3_wgrad`` have halo forms
(``halo=(hl, hr)``: the gradient, or the source, carries the halo rows)
and ``gn_bwd`` a totals form (``totals=``, ``count=``: the group totals of
the whole sequence, ``gn_totals`` added over the shards). ``conv3_dgrad``'s
and ``gn_bwd``'s are compile-time forms of their kernels, so the local
forms keep their code; ``conv3_wgrad``'s is the local kernel on
zero-padded gradient rows. Each form's launches count under its own name
(``conv3_dgrad_halo``, ``conv3_wgrad_halo``, ``gn_bwd_totals``).

A rank of a tensor-parallel step (``parallel/tensor.py``) runs the chain
split over the model axis (``chain_forward_tp``, ``chain_backward_tp``):
conv 1 column-parallel on its shard of the output channels, GroupNorm 2 on
the rank's channels, conv 2 row-parallel through ``conv3_fused``'s partial
form, and one all-reduce of its fp32 partial sums. Every backward kernel
writes fp32 and is linear in the gradient it reads, so the local forms run
on the shards and conv 1's partial input gradients are all-reduced once.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from types import SimpleNamespace

import torch

from lm2a_tpu_torch.ops import _build
from lm2a_tpu_torch.ops.resblock import (
    _ALIGN, SMEM_MAX, SPLIT_MAX, WAVE_BLOCKS, WGRAD_CHUNK_US, _check_vec, _is_cuda, _need,
    check_widths, conv3_fused, conv3_fused_plain, gn_finish, gn_stats, gn_stats_plain, gn_sums,
    gn_sums_plain, modeled_us, n_chunks, tile_fits,
)

SMEM_SM, SMEM_RESERVED = 233_472, 1024  # an SM's shared memory; the system's share a block

# conv3_wgrad's second level of K split: up to WGRAD_PARTS fp32 partials of
# the whole gradient, summed by torch.sum after the launch; modeled as a
# fixed PARTS_US plus PARTS_US_PER_MB per MB of partials (a read at about
# two thirds of the card's bandwidth, the write inside the kernel)
WGRAD_PARTS = 4
PARTS_US, PARTS_US_PER_MB = 4.0, 0.5

# The JAX kernel's gate: conv weights at the compute dtype plus their fp32
# gradient accumulators plus ~8 live (T, C) fp32 rows within 15 MiB of VMEM.
BWD_VMEM_BUDGET = 15 * 1024 * 1024
TT = 64  # frames per partial-sum tile (bucket)
_WG_STAGES = 3  # conv3_wgrad's ring of 64-frame g tiles
_DG_STAGES, _DG_LDW = 3, 72  # conv3_dgrad's ring; bf16 stride of its g windows

# conv3_dgrad's cost model, in the manner of conv3_fused's (ops/resblock.py
# modeled_us): a wave of blocks costs DGRAD_BLOCK_US, plus DGRAD_EPILOGUE_US
# for the SiLU backward and bucket sums, plus DGRAD_CHUNK_US per 64-channel K
# chunk of all three taps (DGRAD_TAP1 of that for the 1x1 skip's one tap),
# all keyed by (mw, bn); a grid runs in waves of WAVE_BLOCKS[splits] *
# DGRAD_PER_SM blocks, the blocks an SM holds at once by the kernel's
# registers (ptxas) and shared memory. Fitted to
# scripts/torch_conv_plan_sweep.py on an H100 (PERF.md).
DGRAD_BLOCK_US = {(1, 64): 0.5, (2, 64): 0.5, (1, 128): 0.5}
DGRAD_EPILOGUE_US = {(1, 64): 7.9, (2, 64): 10.2, (1, 128): 9.1}
DGRAD_CHUNK_US = {(1, 64): 1.5, (2, 64): 1.56, (1, 128): 1.89}
DGRAD_PER_SM = {(1, 64): 2, (2, 64): 1, (1, 128): 1}
DGRAD_TAP1 = 0.75

_P, _I = ctypes.c_void_p, ctypes.c_int
_build.declare("resblock_bwd", "lm2a_conv3_dgrad",
               [_P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                _I, _I, _I, _I, _I, _I, _I, _I, _I, _P])
_build.declare("resblock_bwd", "lm2a_conv3_wgrad",
               [_P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                _I, _P])
_build.declare("resblock_bwd", "lm2a_gn_bwd",
               [_P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _P,
                _I, _P])


def resblock_train_fits(t: int, cin: int, cout: int, has_skip: bool,
                        weight_itemsize: int = 2) -> bool:
    """True when the fused-backward geometry fits the JAX kernel's VMEM
    budget; the port routes exactly the blocks the JAX package routes."""
    wcount = 3 * cin * cout + 3 * cout * cout + (cin * cout if has_skip else 0)
    weight_bytes = wcount * weight_itemsize + wcount * 4
    act_bytes = t * max(cin, cout) * 4 * 8
    return weight_bytes + act_bytes <= BWD_VMEM_BUDGET


def n_tiles(t: int) -> int:
    return (t + TT - 1) // TT


def _tile_sums(v: torch.Tensor) -> torch.Tensor:
    """(B, T, C) -> (B, nT, C) sums over each TT-frame tile."""
    b, t, c = v.shape
    nt = n_tiles(t)
    v = torch.nn.functional.pad(v, (0, 0, 0, nt * TT - t))
    return v.view(b, nt, TT, c).sum(2)


def bucket_sums(pieces: torch.Tensor) -> torch.Tensor:
    """(2, 2, B, nT, C) head and tail pieces -> the (2, B, nT, C) bucket sums
    of d_y and d_y * xhat, head + tail. How a bucket splits into pieces
    follows the kernel's M tiles (the plain version puts it all in the
    head), so kernel and plain version are compared on these sums."""
    return pieces[:, 0] + pieces[:, 1]


def _xhat(pre, mean, rstd):
    b, t, c = pre.shape
    g = mean.shape[1]
    xh = (pre.float().reshape(b, t, g, c // g) - mean[:, None, :, None]) * rstd[:, None, :, None]
    return xh.reshape(b, t, c)


def _gn_silu_act(src, mean, rstd, gamma, beta, dtype):
    y = _xhat(src, mean, rstd) * gamma + beta
    return (y * torch.sigmoid(y)).to(dtype).float()


# ---------------------------------------------------------------- plain versions

def _halo_pad(v: torch.Tensor, halo) -> torch.Tensor:
    """(B, hl + T + hr, C) with halo rows -> (B, T + 2, C): a zero row at
    each end that has no halo row (a global edge: the conv pads there)."""
    hl, hr = halo
    return torch.nn.functional.pad(v, (0, 0, 1 - hl, 1 - hr))


def conv3_dgrad_plain(g, w, *, taps: int = 3, pre=None, mean=None, rstd=None,
                      gamma=None, beta=None, halo=None):
    """Input gradient of a SAME conv3 (``taps=3``) or 1x1 conv (``taps=1``).

    ``g`` (B, T, Cout) in the compute dtype, ``w`` (Cout, taps*Cin) with
    ``w[n, k*Cin + c]`` = tap ``k``. Raw: returns ``(d, None)``, fp32 ``d[t]
    = sum_k g[t+1-k] W_k^T``. With ``pre`` (the GroupNorm input) and its
    statistics and affine: ``d_y = d * silu'(y)``, ``y = xhat*gamma + beta``,
    and pieces (2, 2, B, nT, Cin): the tile sums of ``d_y`` and ``d_y *
    xhat``, each as a head piece (here the whole sum) and a tail piece (here
    zero), as the kernel writes them (``bucket_sums`` adds them).

    The halo form (``halo=(hl, hr)``, 3 taps, a shard of a sequence-sharded
    tensor): ``g`` is (B, hl + T + hr, Cout), its row ``hl - 1`` the left
    neighbour's last output gradient row where ``hl`` is 1 and row ``hl + T``
    the right neighbour's first where ``hr`` is 1; a missing one (a global
    edge) is zero. ``pre``, ``d`` and the pieces keep the local T rows."""
    cout = g.shape[-1]
    cin = w.shape[1] // taps
    gf, wf = g.float(), w.float()
    if taps == 1:
        d = gf @ wf
    else:
        gp = _halo_pad(gf, halo or (0, 0))  # (B, T + 2, Cout): frames -1 .. T
        t = gp.shape[1] - 2
        m = [gp @ wf[:, k * cin:(k + 1) * cin] for k in range(3)]
        d = m[0][:, 2:] + m[1][:, 1:t + 1] + m[2][:, :t]
    if pre is None:
        return d, None
    xh = _xhat(pre, mean, rstd)
    y = xh * gamma + beta
    sig = torch.sigmoid(y)
    dy = d * (sig * (1.0 + y * (1.0 - sig)))
    sums = torch.stack([_tile_sums(dy), _tile_sums(dy * xh)])
    return dy, torch.stack([sums, torch.zeros_like(sums)], 1)


def conv3_wgrad_plain(src, g, *, taps: int = 3, mean=None, rstd=None, gamma=None,
                      beta=None, bias: bool = False, halo=None):
    """Weight gradient of a SAME conv3 (or 1x1): ``dW[k] = sum_{b,t}
    a[b, t+k-1]^T g[b, t]`` as (taps*Cin, Cout) fp32 (the JAX kernel layout
    ``(3, Cin, Cout)`` flattened), ``a = silu(gn(src))`` (or ``src`` raw when
    ``mean`` is None) rounded to ``g``'s dtype; with ``bias`` also the fp32
    column sums of ``g``. The halo form (``halo=(hl, hr)``, 3 taps): ``src``
    is (B, hl + T + hr, Cin), its halo rows the neighbours' (normalised with
    the same statistics), a missing one a zero activation; ``g`` keeps the
    local T rows."""
    cdt = g.dtype
    a = (src.to(cdt).float() if mean is None
         else _gn_silu_act(src, mean, rstd, gamma, beta, cdt))
    gf = g.float()
    b, t, cout = gf.shape
    cin = a.shape[-1]
    g2 = gf.reshape(b * t, cout)
    if taps == 1:
        dw = a.reshape(b * t, cin).t() @ g2
    else:
        ap = _halo_pad(a, halo or (0, 0))  # (B, T + 2, Cin): frames -1 .. T
        dw = torch.cat([ap[:, k:k + t].reshape(b * t, cin).t() @ g2 for k in range(3)], 0)
    return dw, (g2.sum(0) if bias else None)


def gn_totals(pieces: torch.Tensor, gamma: torch.Tensor, groups: int) -> torch.Tensor:
    """(2, B, G) group totals of ``gamma * d_y`` and ``gamma * d_y * xhat``
    from conv3_dgrad's (2, 2, B, nT, C) pieces: per channel the bucket sums
    (head + tail) over the tiles, weighted by gamma, then summed over the
    group's channels. A sequence shard's totals, added over the model axis,
    are the whole sequence's (``gn_bwd``'s totals form)."""
    _, _, b, _, c = pieces.shape
    s = bucket_sums(pieces).sum(2) * gamma  # (2, B, C)
    return s.view(2, b, groups, c // groups).sum(-1)


def gn_bwd_plain(dy, pre, mean, rstd, gamma, pieces, *, extra=None, film_scale=None,
                 z1=None, out_dtype=torch.float32, totals=None, count=None):
    """GroupNorm input gradient ``rstd * (gamma*dy - m1 - xhat*m2)`` with
    ``m1, m2`` the group means of ``gamma * dy`` and ``gamma * dy * xhat``
    taken from ``pieces`` (conv3_dgrad's (2, 2, B, nT, C) head and tail
    pieces of the tile sums, head + tail per tile), plus ``extra``. With
    ``film_scale`` (GN2): returns ``d_z1 = d_f * (1 + scale)`` and partials
    (3, B, nT, C): tile sums of ``d_f``, ``d_f * z1``, ``d_z1``; else
    ``(dx, None)``. The totals form (a sequence shard): ``pieces`` None,
    ``totals`` the (2, B, G) group totals of the whole sequence
    (``gn_totals`` added over the shards) and ``count`` its values a group
    (``n * C/G``); everything else stays on the local rows."""
    b, t, c = dy.shape
    g = mean.shape[1]
    cg = c // g
    if totals is None:
        totals, count = gn_totals(pieces, gamma, g), t * cg
    m = totals / float(count)  # (2, B, G)
    m = m.repeat_interleave(cg, dim=-1)[:, :, None, :]  # (2, B, 1, C)
    xh = _xhat(pre, mean, rstd)
    rs = rstd.repeat_interleave(cg, dim=-1)[:, None, :]
    d = rs * (dy * gamma - m[0] - xh * m[1])
    if extra is not None:
        d = d + extra
    if film_scale is None:
        return d.to(out_dtype), None
    dz = d * (1.0 + film_scale[:, None, :])
    return dz.to(out_dtype), torch.stack([_tile_sums(d), _tile_sums(d * z1), _tile_sums(dz)])


# ---------------------------------------------------------------- kernel wrappers

def _check_stats(s, b, groups, dev, name):
    _need(s.dtype == torch.float32 and s.is_contiguous() and tuple(s.shape) == (b, groups)
          and s.device == dev, f"{name}: statistics must be contiguous fp32 (B, G)")


def _check_act(fn, src, mean, rstd, gamma, beta):
    b, t, c = src.shape
    _need(src.dtype in (torch.bfloat16, torch.float32) and src.is_contiguous(),
          f"{fn}: the GroupNorm input must be contiguous bf16 or fp32")
    groups = mean.shape[1]
    # any C/G: a unit of 8 channels that straddles groups reads each
    # channel's own statistics
    _need(c % groups == 0, f"{fn}: C must divide into groups")
    for s, name in ((mean, "mean"), (rstd, "rstd")):
        _check_stats(s, b, groups, src.device, f"{fn} {name}")
    for v, name in ((gamma, "gamma"), (beta, "beta")):
        _check_vec(v, c, src.device, f"{fn} {name}")
    return groups


@dataclass(frozen=True)
class DgradPlan:
    """Launch of one ``conv3_dgrad``: ``mw`` consumer warpgroups (64·mw rows
    of the flattened B·T axis) and one helper, by ``bn`` input channels per
    block; grid ``(mtiles, ntiles, splits)`` with the ``chunks`` K chunks (64
    output channels, all taps) split along z over one thread-block cluster;
    ``smem`` dynamic shared bytes."""

    mw: int
    bn: int
    mtiles: int
    ntiles: int
    splits: int
    smem: int
    chunks: int

    @property
    def bm(self) -> int:
        return 64 * self.mw

    @property
    def blocks(self) -> int:
        return self.mtiles * self.ntiles * self.splits


def _dgrad_smem(mw: int, bn: int, taps: int) -> int:
    bm = 64 * mw
    window = -(-(bm + 3) * _DG_LDW * 2 // 1024) * 1024
    ring = _DG_STAGES * (taps * 64 * bn * 2 + window)
    return _ALIGN + max(ring, 2 * bm * (bn + 4) * 4)  # the epilogue's two fp32 tiles


def m_tiles(b: int, t: int, bm: int, halo: bool) -> int:
    """Tiles of ``bm`` rows over B*T: over the flattened rows, or (a halo
    form where 2T < ``bm``: a tile would meet more than 3 batch rows, whose
    halo rows its window cannot hold) over each batch row apart."""
    return b * -(-t // bm) if halo and 2 * t < bm else -(-(b * t) // bm)


def dgrad_candidates(b: int, t: int, cin: int, cout: int, taps: int, halo: bool = False):
    """Every launch of ``conv3_dgrad`` for this shape that fits the card, as
    (modeled microseconds, DgradPlan), in a fixed order; ``halo``: the halo
    form's M tiles (``m_tiles``)."""
    chunks = -(-cout // 64)
    out = []
    for (mw, bn), chunk_us in DGRAD_CHUNK_US.items():
        if not tile_fits(cin, bn):
            continue
        smem = _dgrad_smem(mw, bn, taps)
        if smem > SMEM_MAX:
            continue
        fixed = DGRAD_BLOCK_US[(mw, bn)] + (DGRAD_EPILOGUE_US[(mw, bn)] if taps == 3 else 0.0)
        if taps == 1:
            chunk_us *= DGRAD_TAP1
        mtiles, ntiles = m_tiles(b, t, 64 * mw, halo), -(-cin // bn)
        per_sm = min(DGRAD_PER_SM[(mw, bn)], SMEM_SM // (smem + SMEM_RESERVED))
        for splits in range(1, min(SPLIT_MAX, chunks) + 1):
            plan = DgradPlan(mw, bn, mtiles, ntiles, splits, smem, chunks)
            waves = -(-plan.blocks // (WAVE_BLOCKS[splits] * per_sm))
            out.append((waves * (fixed + -(-chunks // splits) * chunk_us), plan))
    return out


@functools.lru_cache(maxsize=None)
def dgrad_plan(b: int, t: int, cin: int, cout: int, taps: int, halo: bool = False) -> DgradPlan:
    """Tile, K split and shared memory of ``conv3_dgrad`` (pure; the wrapper
    passes it to the kernel): the candidate of least modeled time
    (``dgrad_candidates``), the first of equals."""
    return min(dgrad_candidates(b, t, cin, cout, taps, halo), key=lambda c: c[0])[1]


def _check_halo(fn, halo, taps, act, rows, t):
    """(hl, hr) of a halo form, checked by name; (0, 0) for the local form."""
    if halo is None:
        return 0, 0
    hl, hr = halo
    _need(taps == 3 and act, f"{fn}: the halo form takes 3 taps with the GroupNorm input")
    _need(hl in (0, 1) and hr in (0, 1), f"{fn}: halo rows (hl, hr) must be 0 or 1, got {halo}")
    _need(rows == hl + t + hr and t >= 1,
          f"{fn}: the halo form's rows must be hl + T + hr = {hl} + {t} + {hr}, got {rows}")
    return hl, hr


def conv3_dgrad(g, w, *, taps: int = 3, pre=None, mean=None, rstd=None, gamma=None,
                beta=None, halo=None):
    """Kernel wrapper of ``conv3_dgrad_plain`` (same arguments; the kernel
    takes 3 taps with ``pre`` or 1 tap raw, the halo form 3 taps with
    ``pre`` and counts as ``conv3_dgrad_halo``)."""
    if not _is_cuda(g):
        return conv3_dgrad_plain(g, w, taps=taps, pre=pre, mean=mean, rstd=rstd,
                                 gamma=gamma, beta=beta, halo=halo)
    dev = g.device
    b, rows, cout = g.shape
    t = pre.shape[1] if halo is not None and pre is not None else rows
    hl, hr = _check_halo("conv3_dgrad", halo, taps, pre is not None, rows, t)
    _need(taps in (1, 3), "conv3_dgrad: taps must be 1 or 3")
    cin = w.shape[1] // taps
    _need(g.dtype == torch.bfloat16 and g.is_contiguous(), "conv3_dgrad: g must be contiguous bf16")
    _need(w.dtype == torch.bfloat16 and w.is_contiguous() and tuple(w.shape) == (cout, taps * cin)
          and w.device == dev, "conv3_dgrad: w must be contiguous bf16 (Cout, taps*Cin)")
    check_widths("conv3_dgrad", Cout=cout, Cin=cin)
    _need((taps == 3) == (pre is not None),
          "conv3_dgrad: the kernel takes 3 taps with pre (the SiLU backward) or 1 tap raw")
    nt = n_tiles(t)
    out = torch.empty((b, t, cin), device=dev, dtype=torch.float32)
    pieces = groups = None
    if pre is not None:
        _need(tuple(pre.shape) == (b, t, cin), "conv3_dgrad: pre must be (B, T, Cin)")
        groups = _check_act("conv3_dgrad", pre, mean, rstd, gamma, beta)
        # each bucket's sums in two pieces: the rows in the block of its
        # first row, and the rest (the next block's M tile)
        pieces = torch.empty((2, 2, b, nt, cin), device=dev, dtype=torch.float32)
    plan = dgrad_plan(b, t, cin, cout, taps, halo is not None)
    P = _build.ptr
    _build.launch("resblock_bwd", "lm2a_conv3_dgrad",
                  "conv3_dgrad" if halo is None else "conv3_dgrad_halo",
                  P(g), P(w), P(pre), int(pre is not None and pre.dtype == torch.float32),
                  P(mean), P(rstd), P(gamma), P(beta), P(out), P(pieces),
                  b, t, cin, cout, taps, groups or 1, nt, plan.mw, plan.bn, plan.mtiles,
                  plan.ntiles, plan.splits, plan.smem, int(halo is not None), hl, hr,
                  _build.stream_ptr(dev))
    return out, pieces


@dataclass(frozen=True)
class WgradPlan:
    """Launch of one ``conv3_wgrad``: ``mw`` consumer warpgroups (64·mw
    output channels of Cout) and one helper, by 64 input channels and all
    taps per block; grid ``(ntiles, ctiles, splits * parts)``: the
    ``chunks`` 64-frame K chunks of B·T split over ``splits * parts`` ranks,
    summed in the kernel over each cluster of ``splits`` and, for ``parts``
    above 1, over the parts' fp32 partials by ``torch.sum`` in a fixed
    order; ``smem`` dynamic shared bytes."""

    mw: int
    ntiles: int
    ctiles: int
    splits: int
    parts: int
    smem: int
    chunks: int

    @property
    def blocks(self) -> int:
        return self.ntiles * self.ctiles * self.splits * self.parts


def wgrad_candidates(b: int, t: int, cin: int, cout: int, taps: int, src_bytes: int = 2):
    """Every launch of ``conv3_wgrad`` for this shape, as (modeled
    microseconds, WgradPlan): ``mw`` consumer warpgroups (64·mw output
    channels) and a helper, by 64 input channels and every tap, a block; the
    K split over a cluster of 1 to SPLIT_MAX blocks, times 1 to WGRAD_PARTS
    partials summed after the launch."""
    chunks = -(-(b * t) // 64)
    rows = 66 if taps == 3 else 64  # source frames a 64-frame chunk reads
    out_mb = taps * cin * cout * 4 / 1e6
    out = []
    for mw, chunk_us in WGRAD_CHUNK_US.items():
        if not tile_fits(cout, 64 * mw):
            continue
        ntiles, ctiles = -(-cout // (64 * mw)), n_chunks(cin)
        body = (2 * taps * 64 * 128                         # two sets of tap tiles
                + _WG_STAGES * 64 * (64 * mw + 8) * 2       # the g ring
                + _WG_STAGES * rows * (64 * src_bytes + 16))  # the source ring
        smem = _ALIGN + max(body, (taps * 64 + 1) * 64 * mw * 4)  # the fp32 tile, transposed
        for parts in range(1, WGRAD_PARTS + 1):
            for splits in range(1, min(SPLIT_MAX, chunks // parts) + 1):
                plan = WgradPlan(mw, ntiles, ctiles, splits, parts, smem, chunks)
                us = modeled_us(plan.blocks, splits, -(-chunks // (splits * parts)), chunk_us)
                if parts > 1:  # the partials written, read back and summed
                    us += PARTS_US + parts * out_mb * PARTS_US_PER_MB
                out.append((us, plan))
    return out


@functools.lru_cache(maxsize=None)
def wgrad_plan(b: int, t: int, cin: int, cout: int, taps: int,
               src_bytes: int = 2) -> WgradPlan:
    """Tile, K split and shared memory of ``conv3_wgrad`` (pure; the wrapper
    passes it to the kernel): the candidate of least modeled time
    (``wgrad_candidates``), the first of equals. ``src_bytes``: the
    activation source's element size (4 for conv 2's fp32 GroupNorm input)."""
    return min(wgrad_candidates(b, t, cin, cout, taps, src_bytes), key=lambda c: c[0])[1]


def conv3_wgrad(src, g, *, taps: int = 3, mean=None, rstd=None, gamma=None, beta=None,
                bias: bool = False, halo=None):
    """Kernel wrapper of ``conv3_wgrad_plain`` (same arguments). The halo
    form (3 taps with the GroupNorm statistics) launches the local kernel
    on ``src`` with its halo rows and ``g`` zero-padded to the same rows: a
    padded row adds nothing, and the zero row past a global end is the
    conv's own padding. It counts as ``conv3_wgrad_halo``."""
    if not _is_cuda(g):
        return conv3_wgrad_plain(src, g, taps=taps, mean=mean, rstd=rstd, gamma=gamma,
                                 beta=beta, bias=bias, halo=halo)
    dev = g.device
    b, t, cout = g.shape
    cin = src.shape[-1]
    hl, hr = _check_halo("conv3_wgrad", halo, taps, mean is not None, src.shape[1], t)
    if halo is not None:
        g = torch.nn.functional.pad(g, (0, 0, hl, hr))
        t = hl + t + hr
    _need(taps in (1, 3), "conv3_wgrad: taps must be 1 or 3")
    _need(g.dtype == torch.bfloat16 and g.is_contiguous(), "conv3_wgrad: g must be contiguous bf16")
    _need(tuple(src.shape) == (b, t, cin) and src.device == dev,
          "conv3_wgrad: src must be (B, hl + T + hr, Cin) on g's device")
    check_widths("conv3_wgrad", Cin=cin, Cout=cout)
    groups = 1
    if mean is None:
        _need(src.dtype == torch.bfloat16 and src.is_contiguous(),
              "conv3_wgrad: the raw operand must be contiguous bf16")
    else:
        groups = _check_act("conv3_wgrad", src, mean, rstd, gamma, beta)
    plan = wgrad_plan(b, t, cin, cout, taps, src.element_size())
    dw = torch.empty((plan.parts, taps * cin, cout), device=dev, dtype=torch.float32)
    db = torch.empty((plan.parts, cout), device=dev, dtype=torch.float32) if bias else None
    P = _build.ptr
    _build.launch("resblock_bwd", "lm2a_conv3_wgrad",
                  "conv3_wgrad" if halo is None else "conv3_wgrad_halo",
                  P(src), int(src.dtype == torch.float32), P(mean), P(rstd), P(gamma),
                  P(beta), P(g), P(dw), P(db), b, t, cin, cout, taps, groups, plan.mw,
                  plan.ntiles, plan.ctiles, plan.splits, plan.parts, plan.smem,
                  _build.stream_ptr(dev))
    if plan.parts == 1:
        return dw[0], (db[0] if bias else None)
    return dw.sum(0), (db.sum(0) if bias else None)


def gn_bwd_plan(c: int, groups: int = 1) -> int:
    """Channels a block of ``gn_bwd`` takes (pure; the wrapper passes it to
    the kernel, whose grid is (nT, ceil(C / cb), B)): 128 where C allows,
    else 64 (a last tile of fewer where C is not a multiple of 64); 64
    where C/G is not a multiple of 4, the kernel's per-channel-group form."""
    return 128 if c % 128 == 0 and (c // groups) % 4 == 0 else 64


def gn_bwd(dy, pre, mean, rstd, gamma, pieces, *, extra=None, film_scale=None, z1=None,
           out_dtype=torch.float32, totals=None, count=None):
    """Kernel wrapper of ``gn_bwd_plain`` (same arguments; the totals form
    counts as ``gn_bwd_totals``)."""
    if not _is_cuda(dy):
        return gn_bwd_plain(dy, pre, mean, rstd, gamma, pieces, extra=extra,
                            film_scale=film_scale, z1=z1, out_dtype=out_dtype, totals=totals,
                            count=count)
    dev = dy.device
    b, t, c = dy.shape
    nt = n_tiles(t)
    _need(dy.dtype == torch.float32 and dy.is_contiguous(), "gn_bwd: dy must be contiguous fp32")
    _need(tuple(pre.shape) == (b, t, c) and pre.is_contiguous()
          and pre.dtype in (torch.bfloat16, torch.float32), "gn_bwd: pre must be (B, T, C)")
    check_widths("gn_bwd", C=c)
    groups = mean.shape[1]
    _need(c % groups == 0, "gn_bwd: C must divide into groups")
    for s, name in ((mean, "mean"), (rstd, "rstd")):
        _check_stats(s, b, groups, dev, f"gn_bwd {name}")
    _check_vec(gamma, c, dev, "gn_bwd gamma")
    if totals is None:
        _need(pieces is not None and pieces.dtype == torch.float32 and pieces.is_contiguous()
              and tuple(pieces.shape) == (2, 2, b, nt, c) and count is None,
              "gn_bwd: pieces must be fp32 (2, 2, B, nT, C)")
    else:
        _need(pieces is None and totals.dtype == torch.float32 and totals.is_contiguous()
              and tuple(totals.shape) == (2, b, groups) and totals.device == dev,
              "gn_bwd: the totals form takes fp32 (2, B, G) totals and no pieces")
        _need(isinstance(count, int) and count >= t * (c // groups),
              "gn_bwd: the totals form's count is the whole sequence's values a group")
    _need(out_dtype in (torch.bfloat16, torch.float32), "gn_bwd: out_dtype bf16 or fp32")
    if extra is not None:
        _need(extra.dtype == torch.float32 and extra.is_contiguous()
              and tuple(extra.shape) == (b, t, c), "gn_bwd: extra must be fp32 (B, T, C)")
    part_out = None
    if film_scale is not None:
        _need(extra is None, "gn_bwd: the kernel takes extra (GN1) or FiLM (GN2), not both")
        _need(film_scale.dtype == torch.float32 and film_scale.is_contiguous()
              and tuple(film_scale.shape) == (b, c), "gn_bwd: film_scale must be fp32 (B, C)")
        _need(z1 is not None and z1.dtype == torch.float32 and z1.is_contiguous()
              and tuple(z1.shape) == (b, t, c), "gn_bwd: z1 must be fp32 (B, T, C)")
        part_out = torch.empty((3, b, nt, c), device=dev, dtype=torch.float32)
    out = torch.empty((b, t, c), device=dev, dtype=out_dtype)
    _need(all(v.data_ptr() % 16 == 0 for v in (dy, pre, extra, z1) if v is not None),
          "gn_bwd: the (B, T, C) tensors must start on a 16-byte boundary")
    P = _build.ptr
    _build.launch("resblock_bwd", "lm2a_gn_bwd", "gn_bwd" if totals is None else "gn_bwd_totals",
                  P(dy), P(pre), int(pre.dtype == torch.float32), P(mean), P(rstd),
                  P(gamma), P(pieces), P(extra), P(film_scale), P(z1), P(out),
                  int(out_dtype == torch.float32), P(part_out), b, t, c, groups, nt,
                  gn_bwd_plan(c, groups), P(totals), count or 0, _build.stream_ptr(dev))
    return out, part_out


# the chain's functions: the kernel wrappers, or their plain versions (gn_sums:
# gn_stats's sums form, for the sequence-sharded chain)
KERNELS = SimpleNamespace(gn_stats=gn_stats, gn_sums=gn_sums, conv3_fused=conv3_fused,
                          dgrad=conv3_dgrad, wgrad=conv3_wgrad, gn_bwd=gn_bwd)
PLAIN = SimpleNamespace(gn_stats=gn_stats_plain, gn_sums=gn_sums_plain,
                        conv3_fused=conv3_fused_plain, dgrad=conv3_dgrad_plain,
                        wgrad=conv3_wgrad_plain, gn_bwd=gn_bwd_plain)


# ---------------------------------------------------------------- the chain

def kernel_layout(w: torch.Tensor, dtype) -> torch.Tensor:
    """Conv1d weight (Cout, Cin, K) -> the kernels' (Cout, K*Cin) in ``dtype``."""
    co, ci, k = w.shape
    return w.detach().permute(0, 2, 1).reshape(co, k * ci).to(dtype).contiguous()


def chain_forward(x, film_scale, film_shift, g1s, g1b, w1, b1, g2s, g2b, w2, b2, sw, sb,
                  groups1: int, groups2: int, k=KERNELS):
    """The training forward: ``(h, xs or None, saved)``. Weights in the
    kernels' layout (``kernel_layout``), norm parameters and biases fp32."""
    film = (film_scale.float().contiguous(), film_shift.float().contiguous())
    mean1, rstd1 = k.gn_stats(x, groups1)
    f, z1 = k.conv3_fused(x, mean1, rstd1, g1s, g1b, w1, b1, film=film,
                          out_dtype=torch.float32, save_pre=True)
    mean2, rstd2 = k.gn_stats(f, groups2)
    out = k.conv3_fused(f, mean2, rstd2, g2s, g2b, w2, b2, out_dtype=x.dtype,
                        **(dict(skip=(x, sw, sb), split_skip=True) if sw is not None else {}))
    h, xs = out if sw is not None else (out, None)
    return h, xs, (x, f, z1, mean1, rstd1, mean2, rstd2, film[0])


def chain_backward(saved, g1s, g1b, w1, g2s, g2b, w2, sw, gh, gxs, k=KERNELS):
    """Every gradient of the chain from the saved forward tensors: a dict
    with ``dx``, ``dscale``, ``dshift`` (B, Cout) fp32, ``dg1s``, ``dg1b``,
    ``db1``, ``dg2s``, ``dg2b``, ``db2`` (fp32 vectors), ``dw1``, ``dw2``
    ((taps*Cin, Cout) fp32, the JAX layout flattened) and, with a skip,
    ``dsw`` (Cin, Cout) and ``dsb``."""
    x, f, z1, mean1, rstd1, mean2, rstd2, sc = saved
    cdt = x.dtype
    gh = gh.to(cdt).contiguous()
    out = {}
    out["dw2"], out["db2"] = k.wgrad(f, gh, taps=3, mean=mean2, rstd=rstd2, gamma=g2s,
                                     beta=g2b, bias=True)
    d_y2, p2 = k.dgrad(gh, w2, taps=3, pre=f, mean=mean2, rstd=rstd2, gamma=g2s, beta=g2b)
    d_z1, q = k.gn_bwd(d_y2, f, mean2, rstd2, g2s, p2, film_scale=sc, z1=z1, out_dtype=cdt)
    out["dg2b"], out["dg2s"] = p2.sum((1, 2, 3)).unbind()  # the pieces, rows and tiles
    out["dshift"], out["dscale"], out["db1"] = q[0].sum(1), q[1].sum(1), q[2].sum((0, 1))
    out["dw1"], _ = k.wgrad(x, d_z1, taps=3, mean=mean1, rstd=rstd1, gamma=g1s, beta=g1b)
    d_y1, p1 = k.dgrad(d_z1, w1, taps=3, pre=x, mean=mean1, rstd=rstd1, gamma=g1s, beta=g1b)
    out["dg1b"], out["dg1s"] = p1.sum((1, 2, 3)).unbind()
    extra = None
    if sw is not None:
        gxs = gxs.to(cdt).contiguous()
        extra, _ = k.dgrad(gxs, sw, taps=1)
        out["dsw"], out["dsb"] = k.wgrad(x, gxs, taps=1, bias=True)
    out["dx"], _ = k.gn_bwd(d_y1, x, mean1, rstd1, g1s, p1, extra=extra, out_dtype=cdt)
    return out


def _shard_stats(k, shard, x, groups: int, n: int):
    """GroupNorm mean and rstd over all ``n`` rows of a sequence-sharded
    tensor: ``gn_stats``'s sums form on this shard's rows, added over the
    model axis, finished as the kernel finishes its own."""
    s, ss = k.gn_sums(x, groups)
    sums = shard.all_reduce(torch.stack([s, ss]))
    return gn_finish(sums[0], sums[1], n * (x.shape[-1] // groups))


def chain_forward_sharded(x, film_scale, film_shift, g1s, g1b, w1, b1, g2s, g2b, w2, b2, sw, sb,
                          groups1: int, groups2: int, shard, n: int, k=KERNELS):
    """``chain_forward`` on this shard's rows ``x`` (B, T_local, Cin) of a
    length-``n`` sequence sharded over the model axis. ``shard`` gives
    ``halo(v, n) -> (v with one neighbour row at each inner end, hl)`` and
    ``all_reduce(t)`` over the axis. The statistics are the whole
    sequence's (``_shard_stats``); each conv reads its input with halo rows
    and the rows computed for the halos are dropped, so ``h``, ``xs``,
    ``f`` and ``z1`` keep the local rows. ``saved`` also holds the halo
    tensors and ``(hl, hr)`` for ``chain_backward_sharded``."""
    film = (film_scale.float().contiguous(), film_shift.float().contiguous())
    tl = x.shape[1]
    mean1, rstd1 = _shard_stats(k, shard, x, groups1, n)
    xe, hl = shard.halo(x, n)
    hr = xe.shape[1] - hl - tl
    f, z1 = k.conv3_fused(xe, mean1, rstd1, g1s, g1b, w1, b1, film=film,
                          out_dtype=torch.float32, save_pre=True)
    f, z1 = f[:, hl:hl + tl].contiguous(), z1[:, hl:hl + tl].contiguous()
    mean2, rstd2 = _shard_stats(k, shard, f, groups2, n)
    fe, _ = shard.halo(f, n)
    out = k.conv3_fused(fe, mean2, rstd2, g2s, g2b, w2, b2, out_dtype=x.dtype,
                        **(dict(skip=(xe, sw, sb), split_skip=True) if sw is not None else {}))
    h, xs = out if sw is not None else (out, None)
    h = h[:, hl:hl + tl]
    xs = xs[:, hl:hl + tl] if xs is not None else None
    return h, xs, (x, f, z1, mean1, rstd1, mean2, rstd2, film[0], xe, fe, (hl, hr))


def chain_backward_sharded(saved, g1s, g1b, w1, g2s, g2b, w2, sw, gh, gxs, shard, n: int,
                           k=KERNELS):
    """``chain_backward`` on a shard (``chain_forward_sharded``'s saved
    tensors). The output gradient's rows at the shard's inner ends go to the
    neighbours, which need them for their own activation rows: each conv's
    ``dgrad`` reads its gradient with halo rows (the halo form), so this
    shard gets the whole gradient of its activation rows and of no others;
    each ``wgrad`` reads the saved input with halo rows. GroupNorm's
    backward takes the group totals (``gn_totals``) added over the model
    axis (``gn_bwd``'s totals form). The parameter, norm and FiLM gradients
    are this shard's part: the caller adds them over the model axis."""
    x, f, z1, mean1, rstd1, mean2, rstd2, sc, xe, fe, halo = saved
    cdt = x.dtype
    gh = gh.to(cdt).contiguous()
    a1 = dict(mean=mean1, rstd=rstd1, gamma=g1s, beta=g1b)
    a2 = dict(mean=mean2, rstd=rstd2, gamma=g2s, beta=g2b)
    out = {}
    out["dw2"], out["db2"] = k.wgrad(fe, gh, taps=3, bias=True, halo=halo, **a2)
    gh_e, _ = shard.halo(gh, n)
    d_y2, p2 = k.dgrad(gh_e, w2, taps=3, pre=f, halo=halo, **a2)
    groups2, groups1 = mean2.shape[1], mean1.shape[1]
    tot2 = shard.all_reduce(gn_totals(p2, g2s, groups2))
    d_z1, q = k.gn_bwd(d_y2, f, mean2, rstd2, g2s, None, film_scale=sc, z1=z1, out_dtype=cdt,
                       totals=tot2, count=n * (f.shape[-1] // groups2))
    out["dg2b"], out["dg2s"] = p2.sum((1, 2, 3)).unbind()
    out["dshift"], out["dscale"], out["db1"] = q[0].sum(1), q[1].sum(1), q[2].sum((0, 1))
    out["dw1"], _ = k.wgrad(xe, d_z1, taps=3, halo=halo, **a1)
    dz1_e, _ = shard.halo(d_z1, n)
    d_y1, p1 = k.dgrad(dz1_e, w1, taps=3, pre=x, halo=halo, **a1)
    tot1 = shard.all_reduce(gn_totals(p1, g1s, groups1))
    out["dg1b"], out["dg1s"] = p1.sum((1, 2, 3)).unbind()
    extra = None
    if sw is not None:
        gxs = gxs.to(cdt).contiguous()
        extra, _ = k.dgrad(gxs, sw, taps=1)
        out["dsw"], out["dsb"] = k.wgrad(x, gxs, taps=1, bias=True)
    out["dx"], _ = k.gn_bwd(d_y1, x, mean1, rstd1, g1s, None, extra=extra, out_dtype=cdt,
                            totals=tot1, count=n * (x.shape[-1] // groups1))
    return out


def tp_cols(c: int, tp):
    """The columns ``[lo, hi)`` of a ``c``-channel tensor that rank
    ``tp.index`` of ``tp.parts`` holds."""
    cs = c // tp.parts
    return tp.index * cs, (tp.index + 1) * cs


def _tp_groups(tp, cs: int, groups: int, device):
    """The group of each of this rank's ``cs`` channels of a
    ``cs * parts``-channel GroupNorm of ``groups`` groups, and the channels
    a group."""
    cg = cs * tp.parts // groups
    lo, _ = tp_cols(cs * tp.parts, tp)
    return torch.arange(lo, lo + cs, device=device) // cg, cg


def tp_group_stats(k, tp, f, groups: int):
    """GroupNorm mean and rstd of a rank's channels ``f`` (B, T, C/TP) of a
    tensor sharded on its channels: the rank's own groups where they divide
    over the ranks (``gn_stats``), else every channel's group's statistics
    (B, C/TP), from per-channel sums added into the groups over the model
    axis (``gn_sums``, one all-reduce, ``gn_finish``)."""
    b, t, cs = f.shape
    if groups % tp.parts == 0:
        return k.gn_stats(f, groups // tp.parts)
    idx, cg = _tp_groups(tp, cs, groups, f.device)
    s, ss = k.gn_sums(f, cs)
    sums = torch.zeros((2, b, groups), dtype=torch.float32, device=f.device)
    tp.all_reduce(sums.index_add_(2, idx, torch.stack([s, ss])))
    mean, rstd = gn_finish(sums[0], sums[1], t * cg)
    return mean[:, idx].contiguous(), rstd[:, idx].contiguous()


def _tp_gn2_bwd(k, tp, d_y2, f, mean2, rstd2, g2s, p2, sc, z1, cdt, groups2: int):
    """GroupNorm 2's backward on a rank's channels: its own groups' pieces,
    or (groups across ranks) the totals form with every channel's group's
    totals added over the model axis."""
    if groups2 % tp.parts == 0:
        return k.gn_bwd(d_y2, f, mean2, rstd2, g2s, p2, film_scale=sc, z1=z1, out_dtype=cdt)
    b, t, cs = f.shape
    idx, cg = _tp_groups(tp, cs, groups2, f.device)
    tot = torch.zeros((2, b, groups2), dtype=torch.float32, device=f.device)
    tp.all_reduce(tot.index_add_(2, idx, gn_totals(p2, g2s, cs)))
    return k.gn_bwd(d_y2, f, mean2, rstd2, g2s, None, film_scale=sc, z1=z1, out_dtype=cdt,
                    totals=tot[:, :, idx].contiguous(), count=t * cg)


def chain_forward_tp(x, film_scale, film_shift, g1s, g1b, w1, b1, g2s, g2b, w2, b2, sw, sb,
                     groups1: int, groups2: int, tp, k=KERNELS):
    """``chain_forward`` split over the model axis of tensor parallelism.
    ``x`` (B, T, Cin) and GroupNorm 1's ``g1s``, ``g1b`` whole; FiLM
    (B, C/TP), ``b1``, ``g2s``, ``g2b`` this rank's channels; ``w1`` its
    (C/TP, 3*Cin) shard (column-parallel), ``w2`` its (C, 3*C/TP) shard
    (row-parallel), ``b2`` whole; the skip ``sw`` (C/TP, Cin), ``sb`` its
    rows. ``tp`` gives ``index``, ``parts``, ``all_reduce(t)`` (a sum over
    the axis, in place) and ``gather(x)`` (the ranks' pieces along the last
    dimension). ``f`` and ``z1`` stay the rank's channels; conv 2's partial
    sums (each rank adds ``b2`` and its skip columns in its own columns)
    are all-reduced into the whole ``h``, the skip's columns gathered into
    the whole ``xs``."""
    film = (film_scale.float().contiguous(), film_shift.float().contiguous())
    mean1, rstd1 = k.gn_stats(x, groups1)
    f, z1 = k.conv3_fused(x, mean1, rstd1, g1s, g1b, w1, b1, film=film,
                          out_dtype=torch.float32, save_pre=True)
    mean2, rstd2 = tp_group_stats(k, tp, f, groups2)
    out = k.conv3_fused(f, mean2, rstd2, g2s, g2b, w2, b2, out_dtype=torch.float32,
                        part=tp_cols(w2.shape[0], tp),
                        **(dict(skip=(x, sw, sb), split_skip=True) if sw is not None else {}))
    h, xs = out if sw is not None else (out, None)
    h = tp.all_reduce(h).to(x.dtype)
    if xs is not None:
        xs = tp.gather(xs)
    return h, xs, (x, f, z1, mean1, rstd1, mean2, rstd2, film[0])


def chain_backward_tp(saved, g1s, g1b, w1, g2s, g2b, w2, sw, gh, gxs, groups2: int, tp,
                      k=KERNELS):
    """``chain_backward`` of ``chain_forward_tp``: ``gh`` and ``gxs`` are
    the whole gradients (every rank of a model line holds them). Conv 2's
    weight gradient is the shard's (its input channels), its bias's the
    whole; GroupNorm 2 and conv 1 run on the rank's channels. Conv 1's
    input gradient ``d_y1`` and its pieces, and the skip's ``extra``, are
    partial sums over the ranks (each is linear in the gradient its kernel
    reads): one all-reduce adds them before GroupNorm 1's backward, whose
    ``dx``, ``dg1s`` and ``dg1b`` are then the whole ones. The other
    gradients are this rank's shards."""
    x, f, z1, mean1, rstd1, mean2, rstd2, sc = saved
    cdt = x.dtype
    gh = gh.to(cdt).contiguous()
    out = {}
    out["dw2"], out["db2"] = k.wgrad(f, gh, taps=3, mean=mean2, rstd=rstd2, gamma=g2s,
                                     beta=g2b, bias=True)
    d_y2, p2 = k.dgrad(gh, w2, taps=3, pre=f, mean=mean2, rstd=rstd2, gamma=g2s, beta=g2b)
    d_z1, q = _tp_gn2_bwd(k, tp, d_y2, f, mean2, rstd2, g2s, p2, sc, z1, cdt, groups2)
    out["dg2b"], out["dg2s"] = p2.sum((1, 2, 3)).unbind()
    out["dshift"], out["dscale"], out["db1"] = q[0].sum(1), q[1].sum(1), q[2].sum((0, 1))
    out["dw1"], _ = k.wgrad(x, d_z1, taps=3, mean=mean1, rstd=rstd1, gamma=g1s, beta=g1b)
    d_y1, p1 = k.dgrad(d_z1, w1, taps=3, pre=x, mean=mean1, rstd=rstd1, gamma=g1s, beta=g1b)
    parts = [d_y1, p1]
    if sw is not None:
        lo, hi = tp_cols(gxs.shape[-1], tp)
        gxs = gxs[..., lo:hi].to(cdt).contiguous()
        extra, _ = k.dgrad(gxs, sw, taps=1)
        out["dsw"], out["dsb"] = k.wgrad(x, gxs, taps=1, bias=True)
        parts.append(extra)
    flat = tp.all_reduce(torch.cat([v.reshape(-1) for v in parts]))
    d_y1, p1, *extra = (v.view_as(like) for v, like in
                        zip(flat.split([v.numel() for v in parts]), parts))
    out["dg1b"], out["dg1s"] = p1.sum((1, 2, 3)).unbind()
    out["dx"], _ = k.gn_bwd(d_y1, x, mean1, rstd1, g1s, p1, extra=extra[0] if extra else None,
                            out_dtype=cdt)
    return out


class _FusedResblockTrain(torch.autograd.Function):
    """The fused chain with its fused backward. Takes the fp32 master
    weights (Conv1d layouts) and does the compute-dtype cast and the
    kernel relayout itself, so weight gradients come back fp32, unrounded.
    With ``shard`` (and the sequence's length ``n``): the chain on this
    shard's rows, its collectives in the forward and the backward
    (``chain_forward_sharded``, ``chain_backward_sharded``). With ``tp``:
    the chain split over the model axis of tensor parallelism, the weights
    this rank's shards (``chain_forward_tp``, ``chain_backward_tp``)."""

    @staticmethod
    def forward(ctx, x, film_scale, film_shift, g1s, g1b, w1, b1, g2s, g2b, w2, b2, sw, sb,
                groups1, groups2, shard=None, n=None, tp=None):
        cdt = x.dtype
        x = x.contiguous()
        kw1, kw2 = kernel_layout(w1, cdt), kernel_layout(w2, cdt)
        ksw = kernel_layout(sw, cdt) if sw is not None else None
        vec = [v.detach().float().contiguous() for v in (g1s, g1b, b1, g2s, g2b, b2)]
        sbf = sb.detach().float().contiguous() if sb is not None else None
        args = (x, film_scale, film_shift, vec[0], vec[1], kw1, vec[2], vec[3], vec[4], kw2,
                vec[5], ksw, sbf, groups1, groups2)
        if tp is not None:
            h, xs, saved = chain_forward_tp(*args, tp)
        elif shard is None:
            h, xs, saved = chain_forward(*args)
        else:
            h, xs, saved = chain_forward_sharded(*args, shard, n)
            ctx.halo = saved[-1]
            saved = saved[:-1]
        ctx.save_for_backward(*saved, vec[0], vec[1], kw1, vec[3], vec[4], kw2, ksw)
        ctx.n_saved, ctx.shard, ctx.n, ctx.tp, ctx.groups2 = len(saved), shard, n, tp, groups2
        ctx.dtypes = (film_scale.dtype, film_shift.dtype)
        ctx.has_skip = sw is not None
        ctx.shapes = (w1.shape, w2.shape, sw.shape if sw is not None else None)
        if xs is None:
            return h
        return h, xs

    @staticmethod
    def backward(ctx, gh, gxs=None):
        t = ctx.saved_tensors
        saved, (g1s, g1b, kw1, g2s, g2b, kw2, ksw) = t[:ctx.n_saved], t[ctx.n_saved:]
        if ctx.tp is not None:
            d = chain_backward_tp(saved, g1s, g1b, kw1, g2s, g2b, kw2, ksw, gh, gxs, ctx.groups2,
                                  ctx.tp)
        elif ctx.shard is None:
            d = chain_backward(saved, g1s, g1b, kw1, g2s, g2b, kw2, ksw, gh, gxs)
        else:
            d = chain_backward_sharded(saved + (ctx.halo,), g1s, g1b, kw1, g2s, g2b, kw2, ksw,
                                       gh, gxs, ctx.shard, ctx.n)
        s1, s2, ss = ctx.shapes

        def conv(dw, shape):  # (taps*Cin, Cout) -> Conv1d (Cout, Cin, taps)
            co, ci, k = shape
            return dw.view(k, ci, co).permute(2, 1, 0).contiguous()

        dsw = conv(d["dsw"], ss) if ctx.has_skip else None
        dsb = d["dsb"] if ctx.has_skip else None
        return (d["dx"], d["dscale"].to(ctx.dtypes[0]), d["dshift"].to(ctx.dtypes[1]),
                d["dg1s"], d["dg1b"], conv(d["dw1"], s1), d["db1"], d["dg2s"], d["dg2b"],
                conv(d["dw2"], s2), d["db2"], dsw, dsb, None, None, None, None, None)


def fused_resblock_train(x, gn1_scale, gn1_bias, conv1_w, conv1_b, film_scale, film_shift,
                         gn2_scale, gn2_bias, conv2_w, conv2_b, skip_w=None, skip_b=None,
                         *, groups1: int, groups2: int, shard=None, n=None, tp=None):
    """Differentiable fused resblock chain (no residual, no dropout), the
    JAX function's argument order.

    ``x`` (B, T, Cin) in the compute dtype, FiLM ``(B, Cout)``, fp32 master
    parameters in Conv1d layouts. Returns ``h`` (no skip) or ``(h, xs)``,
    as ``fused_resblock_chain(add_residual=False)`` does, or None when the
    geometry fails ``resblock_train_fits`` (the caller runs plain PyTorch).
    With ``shard``: ``x`` is a shard's rows of a length-``n`` sequence, and
    the gate reads ``n`` (the shape the JAX kernel sees under GSPMD), so a
    sharded step routes the blocks the unsharded step routes. With ``tp``:
    the weights are this rank's shards (``chain_forward_tp``), and the gate
    reads the whole widths."""
    b, t, cin = x.shape
    cout = conv2_w.shape[0]
    wsize = 2 if x.dtype == torch.bfloat16 else 4
    if not resblock_train_fits(t if shard is None else n, cin, cout, skip_w is not None,
                               weight_itemsize=wsize):
        return None
    return _FusedResblockTrain.apply(x, film_scale, film_shift, gn1_scale, gn1_bias, conv1_w,
                                     conv1_b, gn2_scale, gn2_bias, conv2_w, conv2_b, skip_w,
                                     skip_b, groups1, groups2, shard, n, tp)


def resblock_bwd_plain(x, g1s, g1b, w1, b1, sc, sh, g2s, g2b, w2, skip_w, gh, gxs,
                       *, groups1: int, groups2: int):
    """Counterpart of the JAX ``_resblock_bwd_call``, through the plain
    versions: JAX layouts in (conv ``(3, Cin, Cout)``, skip ``(Cin, Cout)``),
    the same 11 (or 13 with a skip) gradients out, in its shapes:
    ``dx, dg1s (1,Cin), dg1b, dw1 (3,Cin,Cout), db1 (1,Cout), dsc (B,1,Cout),
    dsh, dg2s, dg2b, dw2, db2[, dsw (Cin,Cout), dsb]``."""
    k = PLAIN
    cdt = x.dtype

    def conv(w):  # JAX (3, Cin, Cout) -> kernel (Cout, 3*Cin)
        kk, ci, co = w.shape
        return w.permute(2, 0, 1).reshape(co, kk * ci).to(cdt).contiguous()

    b, t, cin = x.shape
    cout = w1.shape[2]
    kw1, kw2 = conv(w1), conv(w2)
    ksw = skip_w.t().to(cdt).contiguous() if skip_w is not None else None
    vec = [v.float() for v in (g1s, g1b, b1, g2s, g2b)]
    zero = torch.zeros(cout)
    _, _, saved = chain_forward(x, sc, sh, vec[0], vec[1], kw1, vec[2], vec[3], vec[4], kw2,
                                zero, ksw, zero if ksw is not None else None, groups1,
                                groups2, k=k)
    d = chain_backward(saved, vec[0], vec[1], kw1, vec[3], vec[4], kw2, ksw, gh, gxs, k=k)
    row = lambda v: v.reshape(1, -1)  # noqa: E731
    out = [d["dx"], row(d["dg1s"]), row(d["dg1b"]), d["dw1"].view(3, cin, cout), row(d["db1"]),
           d["dscale"].view(b, 1, cout), d["dshift"].view(b, 1, cout), row(d["dg2s"]),
           row(d["dg2b"]), d["dw2"].view(3, cout, cout), row(d["db2"])]
    if skip_w is not None:
        out += [d["dsw"], row(d["dsb"])]
    return tuple(out)
