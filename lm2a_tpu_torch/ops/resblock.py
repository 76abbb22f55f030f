"""Fused FiLM-resblock forward: the CUDA kernels' wrappers and plain versions.

One ``ResBlockUltimate`` conv chain

    GN1 -> SiLU -> conv3 -> FiLM -> GN2 -> SiLU -> conv3 [-> +1x1 skip] [-> +x]

runs as four launches of two kernels (``csrc/resblock.cu``): ``gn_stats``,
``conv3_fused`` (GN1+SiLU prologue, bias+FiLM epilogue, fp32 intermediate),
``gn_stats`` again, ``conv3_fused`` (GN2+SiLU prologue, skip GEMM as a second
K segment, residual epilogue). It is the port of the TPU kernels in
``lm2a_tpu/ops/pallas_resblock.py`` (``_resblock_kernel`` and the split pair
``_half1_kernel``/``_half2_kernel``) and keeps their numerics: GroupNorm
statistics in fp32 with fast variance and eps 1e-5, conv operands in the
compute dtype (bf16 on the card) with fp32 accumulation, conv biases and FiLM
applied in fp32, an fp32 intermediate between the halves.

Each kernel wrapper (``gn_stats``, ``conv3_fused``) launches its CUDA kernel
for a CUDA tensor, runs its plain PyTorch version (``*_plain``, same
arithmetic) for a CPU tensor, and raises for anything else.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from lm2a_tpu_torch.ops import _build

GN_EPS = 1e-5
# the H100 SXM and the launch limits the plans respect
SMS = 132                # streaming multiprocessors
CLUSTER_MAX = 8          # portable thread-block cluster size
SMEM_MAX = 232_448       # dynamic shared memory a block may opt into
# conv3_fused geometry (csrc/resblock.cu): K walks in chunks of 64 input
# channels; a 3-stage weight ring; bf16 window rows 72 wide (144 bytes)
CHUNK, _NSTAGE, _LDW = 64, 3, 72
# the kernels take every positive channel count: a last K chunk or N tile
# narrower than the kernel's is zero-filled and masked, and a count off the
# 8-channel unit (a bf16 row stride off the 16 bytes cp.async moves) is read
# by the widest access its stride allows (8, 4 or 2 bytes): conv3_fused's
# ODD form, the backward kernels' masked forms
_ALIGN = 1024            # slack for aligning the swizzled tiles to 1024 bytes

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_build.declare("resblock", "lm2a_gn_stats",
               [_P, _I, _P, _P, _I, _I, _I, _I, _I, _F, _P])
_build.declare("resblock", "lm2a_empty_kernel", [_P])
_build.declare("resblock", "lm2a_conv3_fused",
               [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P])


# gn_stats (csrc/resblock.cu): threads a block; T split over a cluster of
# blocks for each (row, group)
GN_THREADS = 512


def gn_stats_plan(b: int, t: int, c: int, groups: int, in_bytes: int = 2) -> int:
    """The cluster size of ``gn_stats`` (pure; the wrapper passes it to the
    kernel): the blocks that split each (row, group)'s T frames, so many
    that the B·G·splits blocks come nearest one block an SM, at most
    CLUSTER_MAX and at most T, and no more than leave each block a full pass
    of its threads over the group's 16-byte vectors (or scalars, where a run
    of C/G channels is not whole vectors). Measured on the H100 (PERF.md),
    a second wave of blocks, or a larger cluster at 16 rows, costs more
    than the few SMs a grid just under one wave leaves idle."""
    cg = c // groups
    vw = 16 // in_bytes if cg % (16 // in_bytes) == 0 else 1
    full = t * cg // vw // GN_THREADS
    nearest = (2 * SMS + b * groups) // (2 * b * groups)
    return max(1, min(CLUSTER_MAX, nearest, full, t))


def k_ranges(chunks: int, splits: int):
    """The K chunks ``[beg, end)`` each rank of a split takes, as the kernels
    compute them: ``chunks * rank // splits``."""
    return [(chunks * r // splits, chunks * (r + 1) // splits) for r in range(splits)]


# The launch plans pick the candidate of least modeled time. The model was
# fitted to an H100's device times of both kernels at forced plans
# (scripts/torch_conv_plan_sweep.py; PERF.md): a block costs about
# BLOCK_US plus CHUNK_US[(mw, bn)] (WGRAD_CHUNK_US[mw]) per K chunk it
# runs; one block runs on an SM at a time (every plan's shared memory or
# registers exceed half an SM's); and a grid runs in waves of at most
# WAVE_BLOCKS[splits] blocks, fewer than the 132 SMs where the K split's
# clusters must each fit in one GPC. Clusters of 7 or 8 blocks placed
# worse still (SPLIT_MAX).
SPLIT_MAX = 6
BLOCK_US = 6.0
CHUNK_US = {(1, 64): 3.05, (2, 64): 3.4, (1, 128): 3.55}
WGRAD_CHUNK_US = {1: 2.95, 2: 2.68}
WAVE_BLOCKS = {1: SMS, 2: SMS, 3: 108, 4: 120, 5: 110, 6: 96}


def modeled_us(blocks: int, splits: int, chunks_per_block: int, chunk_us: float) -> float:
    return -(-blocks // WAVE_BLOCKS[splits]) * (BLOCK_US + chunks_per_block * chunk_us)


@dataclass(frozen=True)
class ConvPlan:
    """Launch of one ``conv3_fused``: ``mw`` consumer warpgroups (64·mw output
    rows of the flattened B·T axis) and one helper warpgroup, by ``bn``
    output channels per block; grid ``(mtiles, ntiles, splits)`` with the K
    split along z as one thread-block cluster; ``chunks`` the K chunks of
    each N segment (the conv, and the kept-apart skip's N tiles after it);
    ``smem`` dynamic shared bytes."""

    mw: int
    bn: int
    mtiles: int
    ntiles: int
    splits: int
    smem: int
    chunks: Tuple[int, ...]

    @property
    def bm(self) -> int:
        return 64 * self.mw

    @property
    def threads(self) -> int:  # the consumer warpgroups and one helper
        return 128 * (self.mw + 1)

    @property
    def blocks(self) -> int:
        return self.mtiles * self.ntiles * self.splits


def _conv3_smem(mw: int, bn: int, splits: int, in_bytes: int) -> int:
    """Dynamic shared bytes of ``conv3_fused``: ``ConvGeo::smem`` in
    ``csrc/resblock.cu``, which the C entry holds the plan to."""
    bm = 64 * mw
    body = (_NSTAGE * 3 * bn * 128                    # the weight ring
            + 2 * (bm + 3) * _LDW * 2                 # two activated windows
            + _NSTAGE * (bm + 2) * (64 * in_bytes + 16))  # the raw input ring
    return _ALIGN + max(body, bm * bn * 4 if splits > 1 else 0)


def n_chunks(c: int) -> int:
    """K chunks of 64 channels over ``c`` (the last one zero-filled past ``c``)."""
    return -(-c // CHUNK)


def tile_fits(c: int, tile: int) -> bool:
    """A tile width the plans consider for ``c`` channels: one that divides
    ``c``, or any where ``c`` is not a multiple of 64 (its last tile is then
    partial whatever the width): the flagship's plans stay as they were."""
    return c % tile == 0 or c % CHUNK != 0


def conv3_candidates(rows: int, t: int, cin: int, cout: int, cin2: int = 0,
                     split_skip: bool = False, in_bytes: int = 2):
    """Every launch of ``conv3_fused`` for this conv that fits the card, as
    (modeled microseconds, ConvPlan), in a fixed order."""
    m = rows * t
    chunks = ((n_chunks(cin), n_chunks(cin2)) if split_skip
              else (n_chunks(cin) + n_chunks(cin2),))
    out = []
    for (mw, bn), chunk_us in CHUNK_US.items():
        if not tile_fits(cout, bn):
            continue
        mtiles, ntiles = -(-m // (64 * mw)), (2 if split_skip else 1) * -(-cout // bn)
        for splits in range(1, min(SPLIT_MAX, *chunks) + 1):
            smem = _conv3_smem(mw, bn, splits, in_bytes)
            if smem > SMEM_MAX:
                continue
            plan = ConvPlan(mw, bn, mtiles, ntiles, splits, smem, chunks)
            out.append((modeled_us(plan.blocks, splits, -(-max(chunks) // splits), chunk_us),
                        plan))
    return out


@functools.lru_cache(maxsize=None)
def conv3_plan(rows: int, t: int, cin: int, cout: int, cin2: int = 0,
               split_skip: bool = False, in_bytes: int = 2) -> ConvPlan:
    """Tile sizes, K split and shared memory of ``conv3_fused`` (pure; the
    wrapper passes the result to the kernel): the candidate of least modeled
    time (``conv3_candidates``), the first of equals. ``in_bytes``: the
    GN+SiLU input's element size (4 for conv 2's fp32 intermediate)."""
    return min(conv3_candidates(rows, t, cin, cout, cin2, split_skip, in_bytes),
               key=lambda c: c[0])[1]


@dataclass
class ResblockWeights:
    """One block's chain parameters in the kernels' layout.

    Conv weights are ``(Cout, 3*Cin)`` in the compute dtype with
    ``w[n, k*Cin + c]`` = tap ``k`` (JAX ``(3, Cin, Cout)[k, c, n]``); the
    skip is ``(Cout, Cin)``. Norm parameters and biases stay fp32, as the TPU
    kernel reads them."""

    gn1_scale: torch.Tensor
    gn1_bias: torch.Tensor
    conv1_w: torch.Tensor
    conv1_b: torch.Tensor
    gn2_scale: torch.Tensor
    gn2_bias: torch.Tensor
    conv2_w: torch.Tensor
    conv2_b: torch.Tensor
    skip_w: Optional[torch.Tensor]
    skip_b: Optional[torch.Tensor]
    groups1: int
    groups2: int

    @classmethod
    def from_jax(cls, gn1_scale, gn1_bias, conv1_w, conv1_b, gn2_scale, gn2_bias,
                 conv2_w, conv2_b, skip_w=None, skip_b=None, *, groups1: int,
                 groups2: int, dtype=torch.float32, device="cpu"):
        """From JAX layouts: conv ``(3, Cin, Cout)``, skip ``(Cin, Cout)``."""

        def vec(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)

        def conv(w):
            w = torch.as_tensor(np.asarray(w, np.float32))
            k, cin, cout = w.shape
            return w.permute(2, 0, 1).reshape(cout, k * cin).to(device, dtype).contiguous()

        has_skip = skip_w is not None
        return cls(
            vec(gn1_scale), vec(gn1_bias), conv(conv1_w), vec(conv1_b),
            vec(gn2_scale), vec(gn2_bias), conv(conv2_w), vec(conv2_b),
            (torch.as_tensor(np.asarray(skip_w, np.float32)).t().to(device, dtype)
             .contiguous() if has_skip else None),
            vec(skip_b) if has_skip else None,
            groups1, groups2,
        )


# ---------------------------------------------------------------- plain versions

def gn_stats_plain(x: torch.Tensor, groups: int, eps: float = GN_EPS):
    """Per (row, group) fp32 mean and rstd over T x C/G (fast variance)."""
    b, t, c = x.shape
    xf = x.float().reshape(b, t, groups, c // groups)
    mean = xf.mean(dim=(1, 3))
    var = (xf * xf).mean(dim=(1, 3)) - mean * mean
    return mean, torch.rsqrt(var + eps)


def _gn_silu(a, mean, rstd, gamma, beta):
    b, t, c = a.shape
    g = mean.shape[1]
    y = (a.float().reshape(b, t, g, c // g) - mean[:, None, :, None]) * rstd[:, None, :, None]
    y = y.reshape(b, t, c) * gamma + beta
    return y * torch.sigmoid(y)


def conv3_fused_plain(a, mean, rstd, gamma, beta, w, bias, *, film=None,
                      skip=None, residual=None, split_skip=False,
                      out_dtype=torch.float32, save_pre=False):
    """SAME conv3 over ``silu(groupnorm(a))`` with the kernel's epilogues.

    ``film=(scale, shift)`` (B, Cout) fp32; ``skip=(x, w2, b2)`` adds the
    1x1 projection ``x @ w2.T + b2``, returned apart as ``(h, xs)`` when
    ``split_skip``; ``residual`` adds an identity input. ``save_pre`` (the
    training forward) also returns the fp32 conv + bias before FiLM,
    ``(h, z1)``."""
    act = _gn_silu(a, mean, rstd, gamma, beta).to(w.dtype).float()
    ap = torch.nn.functional.pad(act, (0, 0, 1, 1))
    taps = torch.cat([ap[:, :-2], ap[:, 1:-1], ap[:, 2:]], dim=-1)  # (B, T, 3Cin)
    h = taps @ w.float().t() + bias
    if save_pre:
        return _film(h, film).to(out_dtype), h
    return _epilogue(h, film, skip, residual, split_skip, out_dtype)


def _film(h, film):
    if film is None:
        return h
    scale, shift = film
    return h * (1.0 + scale[:, None, :]) + shift[:, None, :]


def _epilogue(h, film, skip, residual, split_skip, out_dtype):
    h = _film(h, film)
    if skip is not None:
        x, w2, b2 = skip
        xs = x.to(w2.dtype).float() @ w2.float().t() + b2
        if split_skip:
            return h.to(out_dtype), xs.to(out_dtype)
        return (xs + h).to(out_dtype)
    if residual is not None:
        return (residual.float() + h).to(out_dtype)
    return h.to(out_dtype)


# ---------------------------------------------------------------- kernel wrappers

def _is_cuda(x: torch.Tensor) -> bool:
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {x.device}")


def _need(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def check_widths(fn: str, **widths: int) -> None:
    """Raise by name unless every channel count is positive (what the
    resblock kernels take)."""
    bad = ", ".join(f"{k}={v}" for k, v in widths.items() if v <= 0)
    _need(not bad, f"{fn}: channel counts must be positive, got {bad}")


def _check_vec(v, n, device, name):
    _need(v.dtype == torch.float32 and v.is_contiguous() and v.numel() == n
          and v.device == device, f"{name}: need contiguous fp32 ({n},) on {device}")


def gn_stats(x: torch.Tensor, groups: int, eps: float = GN_EPS):
    """GroupNorm statistics of ``x`` (B, T, C): ``(mean, rstd)``, each (B, G) fp32."""
    if not _is_cuda(x):
        return gn_stats_plain(x, groups, eps)
    b, t, c = x.shape
    _need(x.dtype in (torch.bfloat16, torch.float32) and x.is_contiguous(),
          "gn_stats: x must be contiguous bf16 or fp32")
    _need(c % groups == 0, "gn_stats: C must divide into groups")
    mean = torch.empty((b, groups), device=x.device, dtype=torch.float32)
    rstd = torch.empty_like(mean)
    splits = gn_stats_plan(b, t, c, groups, x.element_size())
    _build.launch("resblock", "lm2a_gn_stats", "gn_stats",
                  _build.ptr(x), int(x.dtype == torch.float32), _build.ptr(mean),
                  _build.ptr(rstd), b, t, c, groups, splits, eps, _build.stream_ptr(x.device))
    return mean, rstd


def empty_kernel(device) -> None:
    """One launch of a kernel that does nothing, on the current stream and
    counted nowhere: the floor of any launch's device time, which
    ``chip_smoke.py`` prints beside the small kernels' times."""
    err = _build.library("resblock").lm2a_empty_kernel(_build.stream_ptr(device))
    if err != 0:
        raise RuntimeError(f"CUDA empty kernel failed: cudaError_t {err}")


def conv3_fused(a, mean, rstd, gamma, beta, w, bias, *, film=None, skip=None,
                residual=None, split_skip=False, out_dtype=torch.float32,
                save_pre=False):
    """Kernel wrapper of ``conv3_fused_plain`` (same arguments)."""
    if not _is_cuda(a):
        return conv3_fused_plain(a, mean, rstd, gamma, beta, w, bias, film=film,
                                 skip=skip, residual=residual,
                                 split_skip=split_skip, out_dtype=out_dtype,
                                 save_pre=save_pre)
    dev = a.device
    b, t, cin = a.shape
    cout = w.shape[0]
    groups = mean.shape[1]
    _need(a.dtype in (torch.bfloat16, torch.float32) and a.is_contiguous(),
          "conv3_fused: a must be contiguous bf16 or fp32")
    _need(w.dtype == torch.bfloat16 and w.is_contiguous()
          and tuple(w.shape) == (cout, 3 * cin),
          "conv3_fused: the CUDA path takes bf16 weights (Cout, 3*Cin); "
          "load the models with compute_dtype='bfloat16'")
    check_widths("conv3_fused", Cin=cin, Cout=cout)
    _need(cin % groups == 0, "conv3_fused: Cin must divide into groups")
    for v, n, name in ((gamma, cin, "gamma"), (beta, cin, "beta"), (bias, cout, "bias")):
        _check_vec(v, n, dev, name)
    for s, name in ((mean, "mean"), (rstd, "rstd")):
        _need(s.dtype == torch.float32 and s.is_contiguous()
              and tuple(s.shape) == (b, groups), f"conv3_fused: {name} must be fp32 (B, G)")
    _need((a.dtype, out_dtype) in ((torch.bfloat16, torch.float32),
                                   (torch.float32, torch.bfloat16)),
          "conv3_fused: the CUDA path takes bf16 -> fp32 (conv 1) or fp32 -> bf16 "
          f"(conv 2), got {a.dtype} -> {out_dtype}")
    fs = fh = x2 = w2 = b2 = res = None
    cin2 = 0
    if film is not None:
        fs, fh = film
        for v in (fs, fh):
            _need(v.dtype == torch.float32 and v.is_contiguous()
                  and tuple(v.shape) == (b, cout), "conv3_fused: film must be fp32 (B, Cout)")
    if skip is not None:
        x2, w2, b2 = skip
        cin2 = x2.shape[-1]
        _need(x2.dtype == torch.bfloat16 and x2.is_contiguous()
              and tuple(x2.shape) == (b, t, cin2),
              "conv3_fused: skip input must be contiguous bf16 (B, T, Cin2)")
        check_widths("conv3_fused", Cin2=cin2)
        _need(w2.dtype == torch.bfloat16 and w2.is_contiguous()
              and tuple(w2.shape) == (cout, cin2), "conv3_fused: skip weight (Cout, Cin2) bf16")
        _check_vec(b2, cout, dev, "skip bias")
        _need(split_skip or film is None,
              "conv3_fused: a summed skip shares conv 2's accumulator, which takes no FiLM")
    elif residual is not None:
        res = residual
        _need(res.dtype == torch.bfloat16 and res.is_contiguous()
              and tuple(res.shape) == (b, t, cout), "conv3_fused: residual (B, T, Cout) bf16")
    out = torch.empty((b, t, cout), device=dev, dtype=out_dtype)
    _need(not save_pre or (skip is None and residual is None),
          "conv3_fused: save_pre is the conv-1 mode (no skip, no residual)")
    out2 = (torch.empty((b, t, cout), device=dev, dtype=torch.bfloat16)
            if skip is not None and split_skip else None)
    pre = torch.empty((b, t, cout), device=dev, dtype=torch.float32) if save_pre else None
    plan = conv3_plan(b, t, cin, cout, cin2, out2 is not None, a.element_size())
    P = _build.ptr
    _build.launch(
        "resblock", "lm2a_conv3_fused", "conv3_fused",
        P(a), int(a.dtype == torch.float32), P(mean), P(rstd), P(gamma), P(beta),
        P(w), P(bias), P(fs), P(fh), P(x2), P(w2), P(b2), P(res),
        P(out), int(out_dtype == torch.float32), P(out2), P(pre),
        b, t, cin, cout, cin2, groups, plan.mw, plan.bn, plan.mtiles, plan.ntiles,
        plan.splits, plan.smem, _build.stream_ptr(dev),
    )
    if pre is not None:
        return out, pre
    return (out, out2) if out2 is not None else out


# ---------------------------------------------------------------- the chain

def _chain(x, p: ResblockWeights, film_scale, film_shift, add_residual, gn, conv):
    cdt = p.conv1_w.dtype
    x = x.to(cdt).contiguous()
    film = (film_scale.float().contiguous(), film_shift.float().contiguous())
    mean1, rstd1 = gn(x, p.groups1)
    f = conv(x, mean1, rstd1, p.gn1_scale, p.gn1_bias, p.conv1_w, p.conv1_b,
             film=film, out_dtype=torch.float32)
    mean2, rstd2 = gn(f, p.groups2)
    kw = dict(out_dtype=cdt)
    if p.skip_w is not None:
        kw.update(skip=(x, p.skip_w, p.skip_b), split_skip=not add_residual)
    elif add_residual:
        kw.update(residual=x)
    return conv(f, mean2, rstd2, p.gn2_scale, p.gn2_bias, p.conv2_w, p.conv2_b, **kw)


def fused_resblock_chain(x: torch.Tensor, p: ResblockWeights,
                         film_scale: torch.Tensor, film_shift: torch.Tensor,
                         *, add_residual: bool = True):
    """The block's conv chain. Returns the block output when ``add_residual``
    (no-attention blocks), else ``h`` — or ``(h, xs)`` when a 1x1 skip exists
    — for the caller to attend and add, as ``fused_resblock_chain`` of the
    JAX package. ``film_*`` are (B, Cout) in any float dtype."""
    return _chain(x, p, film_scale, film_shift, add_residual, gn_stats, conv3_fused)


def resblock_chain_plain(x: torch.Tensor, p: ResblockWeights,
                         film_scale: torch.Tensor, film_shift: torch.Tensor,
                         *, add_residual: bool = True):
    """``fused_resblock_chain`` through the plain versions on any device:
    the yardstick the kernels are held against on the card."""
    return _chain(x, p, film_scale, film_shift, add_residual, gn_stats_plain,
                  conv3_fused_plain)
