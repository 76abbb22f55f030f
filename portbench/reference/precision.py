"""The precision the reference computes in.

``EXACT`` is float32 with TF32 off (``exact_math``). ``FP8`` is the control:
the nearest precision below the bfloat16 the configurations state. Each
operand of a matrix product or convolution is scaled so that its largest
magnitude maps to the largest finite float8 e4m3 value, rounded to e4m3
and scaled back; the product itself accumulates in float32, as an fp8
tensor-core path would.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Iterator

import torch

E4M3_MAX = 448.0


class Precision:
    """Rounds the operands of products; the identity is exact float32."""

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return x


class Fp8(Precision):
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if x.device.type == "meta":
            return x
        scale = x.detach().abs().amax().float().clamp(min=1e-30) / E4M3_MAX
        # the rounding is a constant under autograd: gradients pass through
        q = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
        return x + (q - x).detach()


EXACT = Precision()
FP8 = Fp8()


@contextmanager
def exact_math() -> Iterator[None]:
    """float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
