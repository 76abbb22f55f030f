"""Fused anti-aliased Snake sandwich: the CUDA kernel's wrapper and plain version.

``downsample2x(snake_{alpha,beta}(upsample2x(x)))`` in one pass
(``csrc/sandwich.cu``), the port of the TPU kernel
``lm2a_tpu/vocoder/pallas_sandwich.py:_sandwich_kernel``. All arithmetic is
fp32 whatever the storage dtype; the output has the input's dtype and memory
layout. ``snake_sandwich`` launches the kernel for a CUDA tensor and runs
``snake_sandwich_plain`` (the same function in PyTorch) for a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch

from lm2a_tpu_torch.ops import _build
from lm2a_tpu_torch.vocoder.filters import downsample2x, kaiser_sinc_filter1d, upsample2x

TAPS = 12

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_build.declare("sandwich", "lm2a_snake_sandwich",
               [_P, _P, _I, _P, _P, _P, _I, _I, _I, _L, _L, _L, _L, _L, _L, _P])
# host copy of the taps; the C entry passes them to the kernel by value
_TAPS = (ctypes.c_float * TAPS)(*kaiser_sinc_filter1d(0.25, 0.3, TAPS).tolist())


def snake(y: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """SnakeBeta ``y + sin(alpha y)^2 / (beta + 1e-9)``, per channel (last axis).

    The sine is taken in float64 and rounded: PyTorch's vectorised float32
    sine on the CPU is not accurate to the last place on every code path,
    and the kernel's ``sinf`` is."""
    s = torch.sin((alpha * y).double()).to(y.dtype)
    return y + s ** 2 / (beta + 1e-9)


def snake_sandwich_plain(x: torch.Tensor, alpha: torch.Tensor,
                         beta: torch.Tensor) -> torch.Tensor:
    """(B, T, C) -> (B, T, C), fp32 math, output in ``x.dtype``."""
    y = upsample2x(x.float(), TAPS)
    y = snake(y, alpha.float(), beta.float())
    return downsample2x(y, TAPS).to(x.dtype)


def _dense(x: torch.Tensor) -> bool:
    # a permutation of a contiguous tensor: empty_like keeps its strides
    order = sorted(range(x.dim()), key=x.stride, reverse=True)
    return x.permute(order).is_contiguous()


def snake_sandwich(x: torch.Tensor, alpha: torch.Tensor,
                   beta: torch.Tensor) -> torch.Tensor:
    """Fused sandwich of ``x`` (B, T, C) with per-channel ``alpha``, ``beta``
    (already exponentiated when the module is log-scale). Any dense layout of
    ``x`` is read through its strides; the vocoder passes channels-first
    activations as a ``(B, T, C)`` view so the kernel reads along time."""
    if x.device.type == "cpu":
        return snake_sandwich_plain(x, alpha, beta)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    b, t, c = x.shape
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError("snake_sandwich: x must be bf16 or fp32")
    if not _dense(x):
        raise ValueError("snake_sandwich: x must be a dense tensor")
    for v, name in ((alpha, "alpha"), (beta, "beta")):
        if not (v.dtype == torch.float32 and v.is_contiguous() and v.numel() == c
                and v.device == x.device):
            raise ValueError(f"snake_sandwich: {name} must be contiguous fp32 (C,)")
    z = torch.empty_like(x)  # same strides as x (dense input)
    _build.launch(
        "sandwich", "lm2a_snake_sandwich", "snake_sandwich",
        _build.ptr(x), _build.ptr(z), int(x.dtype == torch.float32),
        _build.ptr(alpha), _build.ptr(beta), _TAPS, b, t, c,
        *x.stride(), *z.stride(), _build.stream_ptr(x.device),
    )
    return z
