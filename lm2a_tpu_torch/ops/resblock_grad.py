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
  ``d_y * xhat``;
- ``conv3_wgrad``: the weight gradient and the bias gradient's column sums,
  its operand ``silu(gn(.))`` formed in the prologue; where the output tiles
  are fewer than the SMs, K (B*T) is split over a thread-block cluster whose
  fp32 tiles are summed in rank order inside the kernel (``wgrad_plan``);
- ``gn_bwd``: GroupNorm's input gradient from those partials; for GN2 also
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
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from types import SimpleNamespace

import torch

from lm2a_tpu_torch.ops import _build
from lm2a_tpu_torch.ops.resblock import (
    _ALIGN, CHUNK, SPLIT_MAX, WGRAD_CHUNK_US, _check_vec, _is_cuda, _need, conv3_fused,
    conv3_fused_plain, gn_stats, gn_stats_plain, modeled_us,
)

# conv3_wgrad's second level of K split: up to WGRAD_PARTS fp32 partials of
# the whole gradient, summed by torch.sum after the launch; modeled as a
# fixed PARTS_US plus PARTS_US_PER_MB per MB of partials (a read at about
# two thirds of the card's bandwidth, the write inside the kernel)
WGRAD_PARTS = 4
PARTS_US, PARTS_US_PER_MB = 4.0, 0.5

# The JAX kernel's gate: conv weights at the compute dtype plus their fp32
# gradient accumulators plus ~8 live (T, C) fp32 rows within 15 MiB of VMEM.
BWD_VMEM_BUDGET = 15 * 1024 * 1024
TT = 64  # frames per partial-sum tile (the conv3_dgrad M tile)
_BT, _BK = 64, 32  # conv3_dgrad's tile: 64 output rows/columns, K tiles of 32
_WG_STAGES = 3  # conv3_wgrad's ring of 64-frame g tiles

_P, _I = ctypes.c_void_p, ctypes.c_int
_build.declare("resblock_bwd", "lm2a_conv3_dgrad",
               [_P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P])
_build.declare("resblock_bwd", "lm2a_conv3_wgrad",
               [_P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P])
_build.declare("resblock_bwd", "lm2a_gn_bwd",
               [_P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _P])


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


def _xhat(pre, mean, rstd):
    b, t, c = pre.shape
    g = mean.shape[1]
    xh = (pre.float().reshape(b, t, g, c // g) - mean[:, None, :, None]) * rstd[:, None, :, None]
    return xh.reshape(b, t, c)


def _gn_silu_act(src, mean, rstd, gamma, beta, dtype):
    y = _xhat(src, mean, rstd) * gamma + beta
    return (y * torch.sigmoid(y)).to(dtype).float()


# ---------------------------------------------------------------- plain versions

def conv3_dgrad_plain(g, w, *, taps: int = 3, pre=None, mean=None, rstd=None,
                      gamma=None, beta=None):
    """Input gradient of a SAME conv3 (``taps=3``) or 1x1 conv (``taps=1``).

    ``g`` (B, T, Cout) in the compute dtype, ``w`` (Cout, taps*Cin) with
    ``w[n, k*Cin + c]`` = tap ``k``. Raw: returns ``(d, None)``, fp32 ``d[t]
    = sum_k g[t+1-k] W_k^T``. With ``pre`` (the GroupNorm input) and its
    statistics and affine: ``d_y = d * silu'(y)``, ``y = xhat*gamma + beta``,
    and partials (2, B, nT, Cin): tile sums of ``d_y`` and ``d_y * xhat``."""
    cout = g.shape[-1]
    cin = w.shape[1] // taps
    gf, wf = g.float(), w.float()
    if taps == 1:
        d = gf @ wf
    else:
        m = [gf @ wf[:, k * cin:(k + 1) * cin] for k in range(3)]
        zero = torch.zeros_like(m[0][:, :1])
        d = (torch.cat([m[0][:, 1:], zero], 1) + m[1] + torch.cat([zero, m[2][:, :-1]], 1))
    if pre is None:
        return d, None
    xh = _xhat(pre, mean, rstd)
    y = xh * gamma + beta
    sig = torch.sigmoid(y)
    dy = d * (sig * (1.0 + y * (1.0 - sig)))
    return dy, torch.stack([_tile_sums(dy), _tile_sums(dy * xh)])


def conv3_wgrad_plain(src, g, *, taps: int = 3, mean=None, rstd=None, gamma=None,
                      beta=None, bias: bool = False):
    """Weight gradient of a SAME conv3 (or 1x1): ``dW[k] = sum_{b,t}
    a[b, t+k-1]^T g[b, t]`` as (taps*Cin, Cout) fp32 (the JAX kernel layout
    ``(3, Cin, Cout)`` flattened), ``a = silu(gn(src))`` (or ``src`` raw when
    ``mean`` is None) rounded to ``g``'s dtype; with ``bias`` also the fp32
    column sums of ``g``."""
    cdt = g.dtype
    a = (src.to(cdt).float() if mean is None
         else _gn_silu_act(src, mean, rstd, gamma, beta, cdt))
    gf = g.float()
    b, t, cin = a.shape
    a2 = a.reshape(b * t, cin)
    g2 = gf.reshape(b * t, -1)
    if taps == 1:
        dw = a2.t() @ g2
    else:
        zero = torch.zeros_like(a[:, :1])
        shifted = (torch.cat([zero, a[:, :-1]], 1), a, torch.cat([a[:, 1:], zero], 1))
        dw = torch.cat([s.reshape(b * t, cin).t() @ g2 for s in shifted], 0)
    return dw, (g2.sum(0) if bias else None)


def gn_bwd_plain(dy, pre, mean, rstd, gamma, part, *, extra=None, film_scale=None,
                 z1=None, out_dtype=torch.float32):
    """GroupNorm input gradient ``rstd * (gamma*dy - m1 - xhat*m2)`` with
    ``m1, m2`` the group means of ``gamma * dy`` and ``gamma * dy * xhat``
    taken from ``part`` (conv3_dgrad's tile sums), plus ``extra``. With
    ``film_scale`` (GN2): returns ``d_z1 = d_f * (1 + scale)`` and partials
    (3, B, nT, C): tile sums of ``d_f``, ``d_f * z1``, ``d_z1``; else
    ``(dx, None)``."""
    b, t, c = dy.shape
    g = mean.shape[1]
    cg = c // g
    s = part.sum(2) * gamma  # (2, B, C): gamma * per-row sums
    m = s.view(2, b, g, cg).sum(-1) / float(t * cg)  # (2, B, G)
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
    _need(c % groups == 0 and (c // groups) % 16 == 0,
          f"{fn}: C/G must be a multiple of 16")
    for s, name in ((mean, "mean"), (rstd, "rstd")):
        _check_stats(s, b, groups, src.device, f"{fn} {name}")
    for v, name in ((gamma, "gamma"), (beta, "beta")):
        _check_vec(v, c, src.device, f"{fn} {name}")
    return groups


def conv3_dgrad(g, w, *, taps: int = 3, pre=None, mean=None, rstd=None, gamma=None,
                beta=None):
    """Kernel wrapper of ``conv3_dgrad_plain`` (same arguments)."""
    if not _is_cuda(g):
        return conv3_dgrad_plain(g, w, taps=taps, pre=pre, mean=mean, rstd=rstd,
                                 gamma=gamma, beta=beta)
    dev = g.device
    b, t, cout = g.shape
    _need(taps in (1, 3), "conv3_dgrad: taps must be 1 or 3")
    cin = w.shape[1] // taps
    _need(g.dtype == torch.bfloat16 and g.is_contiguous(), "conv3_dgrad: g must be contiguous bf16")
    _need(w.dtype == torch.bfloat16 and w.is_contiguous() and tuple(w.shape) == (cout, taps * cin)
          and w.device == dev, "conv3_dgrad: w must be contiguous bf16 (Cout, taps*Cin)")
    _need(cout % _BK == 0 and cin % _BT == 0,
          f"conv3_dgrad: needs Cout % {_BK} == 0 and Cin % {_BT} == 0, got {cout}->{cin}")
    nt = n_tiles(t)
    out = torch.empty((b, t, cin), device=dev, dtype=torch.float32)
    part = groups = None
    if pre is not None:
        _need(tuple(pre.shape) == (b, t, cin), "conv3_dgrad: pre must be (B, T, Cin)")
        groups = _check_act("conv3_dgrad", pre, mean, rstd, gamma, beta)
        part = torch.empty((2, b, nt, cin), device=dev, dtype=torch.float32)
    P = _build.ptr
    _build.launch("resblock_bwd", "lm2a_conv3_dgrad", "conv3_dgrad",
                  P(g), P(w), P(pre), int(pre is not None and pre.dtype == torch.float32),
                  P(mean), P(rstd), P(gamma), P(beta), P(out), P(part),
                  b, t, cin, cout, taps, groups or 1, nt, _build.stream_ptr(dev))
    return out, part


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
        if cout % (64 * mw):
            continue
        ntiles, ctiles = cout // (64 * mw), cin // CHUNK
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
                bias: bool = False):
    """Kernel wrapper of ``conv3_wgrad_plain`` (same arguments)."""
    if not _is_cuda(g):
        return conv3_wgrad_plain(src, g, taps=taps, mean=mean, rstd=rstd, gamma=gamma,
                                 beta=beta, bias=bias)
    dev = g.device
    b, t, cout = g.shape
    cin = src.shape[-1]
    _need(taps in (1, 3), "conv3_wgrad: taps must be 1 or 3")
    _need(g.dtype == torch.bfloat16 and g.is_contiguous(), "conv3_wgrad: g must be contiguous bf16")
    _need(tuple(src.shape) == (b, t, cin) and src.device == dev,
          "conv3_wgrad: src must be (B, T, Cin) on g's device")
    _need(cin % _BT == 0 and cout % _BT == 0,
          f"conv3_wgrad: needs Cin and Cout multiples of {_BT}, got {cin}, {cout}")
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
    _build.launch("resblock_bwd", "lm2a_conv3_wgrad", "conv3_wgrad",
                  P(src), int(src.dtype == torch.float32), P(mean), P(rstd), P(gamma),
                  P(beta), P(g), P(dw), P(db), b, t, cin, cout, taps, groups, plan.mw,
                  plan.splits, plan.parts, plan.smem, _build.stream_ptr(dev))
    if plan.parts == 1:
        return dw[0], (db[0] if bias else None)
    return dw.sum(0), (db.sum(0) if bias else None)


def gn_bwd(dy, pre, mean, rstd, gamma, part, *, extra=None, film_scale=None, z1=None,
           out_dtype=torch.float32):
    """Kernel wrapper of ``gn_bwd_plain`` (same arguments)."""
    if not _is_cuda(dy):
        return gn_bwd_plain(dy, pre, mean, rstd, gamma, part, extra=extra,
                            film_scale=film_scale, z1=z1, out_dtype=out_dtype)
    dev = dy.device
    b, t, c = dy.shape
    nt = n_tiles(t)
    _need(dy.dtype == torch.float32 and dy.is_contiguous(), "gn_bwd: dy must be contiguous fp32")
    _need(tuple(pre.shape) == (b, t, c) and pre.is_contiguous()
          and pre.dtype in (torch.bfloat16, torch.float32), "gn_bwd: pre must be (B, T, C)")
    _need(c % _BT == 0, f"gn_bwd: needs C % {_BT} == 0")
    groups = mean.shape[1]
    _need(c % groups == 0, "gn_bwd: C must divide into groups")
    for s, name in ((mean, "mean"), (rstd, "rstd")):
        _check_stats(s, b, groups, dev, f"gn_bwd {name}")
    _check_vec(gamma, c, dev, "gn_bwd gamma")
    _need(part.dtype == torch.float32 and part.is_contiguous()
          and tuple(part.shape) == (2, b, nt, c), "gn_bwd: part must be fp32 (2, B, nT, C)")
    _need(out_dtype in (torch.bfloat16, torch.float32), "gn_bwd: out_dtype bf16 or fp32")
    if extra is not None:
        _need(extra.dtype == torch.float32 and extra.is_contiguous()
              and tuple(extra.shape) == (b, t, c), "gn_bwd: extra must be fp32 (B, T, C)")
    part_out = None
    if film_scale is not None:
        _need(film_scale.dtype == torch.float32 and film_scale.is_contiguous()
              and tuple(film_scale.shape) == (b, c), "gn_bwd: film_scale must be fp32 (B, C)")
        _need(z1 is not None and z1.dtype == torch.float32 and z1.is_contiguous()
              and tuple(z1.shape) == (b, t, c), "gn_bwd: z1 must be fp32 (B, T, C)")
        part_out = torch.empty((3, b, nt, c), device=dev, dtype=torch.float32)
    out = torch.empty((b, t, c), device=dev, dtype=out_dtype)
    P = _build.ptr
    _build.launch("resblock_bwd", "lm2a_gn_bwd", "gn_bwd",
                  P(dy), P(pre), int(pre.dtype == torch.float32), P(mean), P(rstd),
                  P(gamma), P(part), P(extra), P(film_scale), P(z1), P(out),
                  int(out_dtype == torch.float32), P(part_out), b, t, c, groups, nt,
                  _build.stream_ptr(dev))
    return out, part_out


# the chain's five functions: the kernel wrappers, or their plain versions
KERNELS = SimpleNamespace(gn_stats=gn_stats, conv3_fused=conv3_fused, dgrad=conv3_dgrad,
                          wgrad=conv3_wgrad, gn_bwd=gn_bwd)
PLAIN = SimpleNamespace(gn_stats=gn_stats_plain, conv3_fused=conv3_fused_plain,
                        dgrad=conv3_dgrad_plain, wgrad=conv3_wgrad_plain, gn_bwd=gn_bwd_plain)


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
    out["dg2b"], out["dg2s"] = p2[0].sum((0, 1)), p2[1].sum((0, 1))
    out["dshift"], out["dscale"], out["db1"] = q[0].sum(1), q[1].sum(1), q[2].sum((0, 1))
    out["dw1"], _ = k.wgrad(x, d_z1, taps=3, mean=mean1, rstd=rstd1, gamma=g1s, beta=g1b)
    d_y1, p1 = k.dgrad(d_z1, w1, taps=3, pre=x, mean=mean1, rstd=rstd1, gamma=g1s, beta=g1b)
    out["dg1b"], out["dg1s"] = p1[0].sum((0, 1)), p1[1].sum((0, 1))
    extra = None
    if sw is not None:
        gxs = gxs.to(cdt).contiguous()
        extra, _ = k.dgrad(gxs, sw, taps=1)
        out["dsw"], out["dsb"] = k.wgrad(x, gxs, taps=1, bias=True)
    out["dx"], _ = k.gn_bwd(d_y1, x, mean1, rstd1, g1s, p1, extra=extra, out_dtype=cdt)
    return out


class _FusedResblockTrain(torch.autograd.Function):
    """The fused chain with its fused backward. Takes the fp32 master
    weights (Conv1d layouts) and does the compute-dtype cast and the
    kernel relayout itself, so weight gradients come back fp32, unrounded."""

    @staticmethod
    def forward(ctx, x, film_scale, film_shift, g1s, g1b, w1, b1, g2s, g2b, w2, b2, sw, sb,
                groups1, groups2):
        cdt = x.dtype
        x = x.contiguous()
        kw1, kw2 = kernel_layout(w1, cdt), kernel_layout(w2, cdt)
        ksw = kernel_layout(sw, cdt) if sw is not None else None
        vec = [v.detach().float().contiguous() for v in (g1s, g1b, b1, g2s, g2b, b2)]
        sbf = sb.detach().float().contiguous() if sb is not None else None
        h, xs, saved = chain_forward(x, film_scale, film_shift, vec[0], vec[1], kw1, vec[2],
                                     vec[3], vec[4], kw2, vec[5], ksw, sbf, groups1, groups2)
        ctx.save_for_backward(*saved, vec[0], vec[1], kw1, vec[3], vec[4], kw2, ksw)
        ctx.dtypes = (film_scale.dtype, film_shift.dtype)
        ctx.has_skip = sw is not None
        ctx.shapes = (w1.shape, w2.shape, sw.shape if sw is not None else None)
        if xs is None:
            return h
        return h, xs

    @staticmethod
    def backward(ctx, gh, gxs=None):
        t = ctx.saved_tensors
        saved, (g1s, g1b, kw1, g2s, g2b, kw2, ksw) = t[:8], t[8:]
        d = chain_backward(saved, g1s, g1b, kw1, g2s, g2b, kw2, ksw, gh, gxs)
        s1, s2, ss = ctx.shapes

        def conv(dw, shape):  # (taps*Cin, Cout) -> Conv1d (Cout, Cin, taps)
            co, ci, k = shape
            return dw.view(k, ci, co).permute(2, 1, 0).contiguous()

        dsw = conv(d["dsw"], ss) if ctx.has_skip else None
        dsb = d["dsb"] if ctx.has_skip else None
        return (d["dx"], d["dscale"].to(ctx.dtypes[0]), d["dshift"].to(ctx.dtypes[1]),
                d["dg1s"], d["dg1b"], conv(d["dw1"], s1), d["db1"], d["dg2s"], d["dg2b"],
                conv(d["dw2"], s2), d["db2"], dsw, dsb, None, None)


def fused_resblock_train(x, gn1_scale, gn1_bias, conv1_w, conv1_b, film_scale, film_shift,
                         gn2_scale, gn2_bias, conv2_w, conv2_b, skip_w=None, skip_b=None,
                         *, groups1: int, groups2: int):
    """Differentiable fused resblock chain (no residual, no dropout), the
    JAX function's argument order.

    ``x`` (B, T, Cin) in the compute dtype, FiLM ``(B, Cout)``, fp32 master
    parameters in Conv1d layouts. Returns ``h`` (no skip) or ``(h, xs)``,
    as ``fused_resblock_chain(add_residual=False)`` does, or None when the
    geometry fails ``resblock_train_fits`` (the caller runs plain PyTorch)."""
    b, t, cin = x.shape
    cout = conv1_w.shape[0]
    wsize = 2 if x.dtype == torch.bfloat16 else 4
    if not resblock_train_fits(t, cin, cout, skip_w is not None, weight_itemsize=wsize):
        return None
    return _FusedResblockTrain.apply(x, film_scale, film_shift, gn1_scale, gn1_bias, conv1_w,
                                     conv1_b, gn2_scale, gn2_bias, conv2_w, conv2_b, skip_w,
                                     skip_b, groups1, groups2)


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
