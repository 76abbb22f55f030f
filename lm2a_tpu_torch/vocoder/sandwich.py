"""Fused anti-aliased Snake sandwich: the CUDA kernel's wrapper, launch plan and plain version.

``downsample2x(snake_{alpha,beta}(upsample2x(x)))`` in one pass
(``csrc/sandwich.cu``), the port of the TPU kernel
``lm2a_tpu/vocoder/pallas_sandwich.py:_sandwich_kernel``. All arithmetic is
fp32 whatever the storage dtype; the output has the input's dtype and memory
layout. ``snake_sandwich`` launches the kernel for a CUDA tensor and runs
``snake_sandwich_plain`` (the same function in PyTorch) for a CPU tensor.
``logscale=True`` takes ``alpha`` and ``beta`` as the log-scale module
parameters and exponentiates them inside (the kernel once per run), so the
vocoder launches nothing else per activation.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Sequence

import torch

from lm2a_tpu_torch.ops import _build
from lm2a_tpu_torch.vocoder.filters import downsample2x, kaiser_sinc_filter1d, upsample2x

TAPS = 12
# the kernel's geometry (csrc/sandwich.cu): a lane owns a run of RUN
# consecutive outputs of one row; a warp tile is 32 runs of which lanes
# 1..STORED store (lanes 0 and 31 feed their neighbours the halos)
RUN = 8
STORED = 30
MAX_WARPS = 16

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_build.declare("sandwich", "lm2a_snake_sandwich",
               [_P, _P, _I, _P, _P, _I, _P, _I, _I, _I, _L, _L, _L, _L, _L, _L,
                _I, _I, _I, _I, _P])
_build.declare("sandwich", "lm2a_sandwich_blocks_per_sm", [_I, _I])
# host copy of the taps; the C entry passes them to the kernel by value
_TAPS = (ctypes.c_float * TAPS)(*kaiser_sinc_filter1d(0.25, 0.3, TAPS).tolist())


@dataclass(frozen=True)
class SandwichPlan:
    run: int     # outputs a lane owns (RUN)
    warps: int   # warps a block
    tiles: int   # the most warp tiles (32 runs, 30 stored) a warp takes
    blocks: int  # the grid; its warps stride over the tiles


SMS = 132  # the H100's SMs
# warps of the kernel an SM holds at once: 65536 registers over the
# registers a thread (64 for both dtypes in ptxas's report on sm_90a) times
# 32. A card test holds blocks_per_sm against the CUDA occupancy calculator
# for each dtype.
RESIDENT_WARPS = 32


def blocks_per_sm(warps: int) -> int:
    return min(32, RESIDENT_WARPS // warps)


def blocks_per_sm_on_card(dtype: torch.dtype, warps: int) -> int:
    """The CUDA occupancy calculator's resident blocks for the built kernel
    (needs the card); ``blocks_per_sm`` is held against it."""
    n = _build.library("sandwich").lm2a_sandwich_blocks_per_sm(
        int(dtype == torch.float32), warps)
    if n < 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveBlocksPerMultiprocessor failed: "
                           f"cudaError_t {-n}")
    return n


def sandwich_tiles(b: int, t: int, c: int) -> int:
    """Warp tiles of a (B, T, C) tensor: its B·C·ceil(T/RUN) runs, 30 stored
    a tile."""
    return -(-b * c * -(-t // RUN) // STORED)


def plan_for(b: int, t: int, c: int, warps: int, blocks: int) -> SandwichPlan:
    """The plan of ``warps`` a block on ``blocks`` blocks, at most one per
    ``warps`` tiles, with the tiles a warp takes that the kernel checks."""
    n = sandwich_tiles(b, t, c)
    blocks = max(1, min(blocks, -(-n // warps)))
    return SandwichPlan(RUN, warps, -(-n // (blocks * warps)), blocks)


def sandwich_candidates(b: int, t: int, c: int):
    """Launch plans the kernel takes for a (B, T, C) tensor: 2-16 warps a
    block on a half, one, two or four waves of resident blocks (the warps
    striding over the tiles) or on one tile a warp;
    ``scripts/torch_sandwich_plan_sweep.py`` times them."""
    out = []
    for warps in (2, 4, 8, 16):
        wave = SMS * blocks_per_sm(warps)
        for blocks in (wave // 2, wave, 2 * wave, 4 * wave, 1 << 30):
            p = plan_for(b, t, c, warps, blocks)
            if p not in out:
                out.append(p)
    return out


def sandwich_plan(b: int, t: int, c: int, dtype: torch.dtype,
                  strides: Sequence[int]) -> SandwichPlan:
    """The launch plan of ``snake_sandwich`` (pure; the wrapper passes it to
    the kernel, whose C entry refuses any other): 4 warps a block and at
    most one wave of resident blocks, whose warps stride over the tiles with
    the next tile's loads in flight. Neither the dtype (both take 64
    registers) nor the layout (strided rows take scalar loads in the same
    grid) changes it."""
    del dtype, strides
    return plan_for(b, t, c, 4, SMS * blocks_per_sm(4))


def snake(y: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """SnakeBeta ``y + sin(alpha y)^2 / (beta + 1e-9)``, per channel (last axis).

    The sine is taken in float64 and rounded: PyTorch's vectorised float32
    sine on the CPU is not accurate to the last place on every code path.
    The kernel's (a reduction to [-pi, pi], then the hardware sine) is
    within ~2^-21 of it."""
    s = torch.sin((alpha * y).double()).to(y.dtype)
    return y + s ** 2 / (beta + 1e-9)


def snake_sandwich_plain(x: torch.Tensor, alpha: torch.Tensor,
                         beta: torch.Tensor, logscale: bool = False) -> torch.Tensor:
    """(B, T, C) -> (B, T, C), fp32 math, output in ``x.dtype``; with
    ``logscale`` the parameters are exponentiated first."""
    if logscale:
        alpha, beta = torch.exp(alpha.float()), torch.exp(beta.float())
    y = upsample2x(x.float(), TAPS)
    y = snake(y, alpha.float(), beta.float())
    return downsample2x(y, TAPS).to(x.dtype)


def _dense(x: torch.Tensor) -> bool:
    # a permutation of a contiguous tensor: empty_like keeps its strides
    order = sorted(range(x.dim()), key=x.stride, reverse=True)
    return x.permute(order).is_contiguous()


def snake_sandwich(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
                   logscale: bool = False) -> torch.Tensor:
    """Fused sandwich of ``x`` (B, T, C) with per-channel ``alpha``, ``beta``:
    the values themselves, or with ``logscale`` their logarithms (the
    log-scale module's raw parameters). Any dense layout of ``x`` is read
    through its strides; the vocoder passes channels-first activations as a
    ``(B, T, C)`` view so the kernel reads along time."""
    if x.device.type == "cpu":
        return snake_sandwich_plain(x, alpha, beta, logscale)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    b, t, c = x.shape
    if min(b, t, c) < 1:
        raise ValueError("snake_sandwich: x must not be empty")
    if b * c * -(-t // RUN) + 2 * STORED >= 2 ** 31:
        raise ValueError("snake_sandwich: more than 2^31 runs of outputs")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError("snake_sandwich: x must be bf16 or fp32")
    if not _dense(x):
        raise ValueError("snake_sandwich: x must be a dense tensor")
    for v, name in ((alpha, "alpha"), (beta, "beta")):
        if not (v.dtype == torch.float32 and v.is_contiguous() and v.numel() == c
                and v.device == x.device):
            raise ValueError(f"snake_sandwich: {name} must be contiguous fp32 (C,)")
    z = torch.empty_like(x)  # same strides as x (dense input)
    plan = sandwich_plan(b, t, c, x.dtype, x.stride())
    _build.launch(
        "sandwich", "lm2a_snake_sandwich", "snake_sandwich",
        _build.ptr(x), _build.ptr(z), int(x.dtype == torch.float32),
        _build.ptr(alpha), _build.ptr(beta), int(logscale), _TAPS, b, t, c,
        *x.stride(), *z.stride(), plan.run, plan.warps, plan.tiles, plan.blocks,
        _build.stream_ptr(x.device),
    )
    return z
