"""``adan_ema``: clip, Adan and the EMA over every parameter in one launch
(``csrc/adan.cu``), once a training step with the CUDA optimizer. A
parameter's gradient, value, EMA and four moments are read and all but the
gradient written, fp32: 52 bytes; about 30 fp32 operations."""

import math

from portbench.reference import unet as ref

from .geometry import per_unit

LAUNCH = "adan_ema"
PATTERNS = ("adan_ema_kernel",)
PEAK = "fp32"


def launches(cell):
    if cell.config["train"].get("opt_backend") != "pallas":
        return []
    m = cell.model
    n = sum(math.prod(s) for spec in (ref.spec(m), ref.cond_spec(m)) for s, _ in spec.values())
    return per_unit(cell, [(52.0 * n, 30.0 * n)])
