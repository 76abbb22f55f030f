"""Readers shared by the metric files. ``ctx`` is ``harness.Context``."""

from __future__ import annotations

from portbench.kernels.geometry import PEAK_BF16


def span_ms(name: str):
    """The mean host-clock milliseconds of the benchmark's span ``name``."""
    def read(ctx):
        v = ctx.spans.mean(name)
        return None if v is None else v * 1e3
    return read


def roofline(kernel: str):
    """A kernel's least time over its device time in the trace, in percent."""
    def read(ctx):
        k = ctx.kernel(kernel)
        if k is None or k[1] <= 0:
            return None
        return 100.0 * k[0] / k[1]
    return read


def kernels_roofline(ctx):
    """All of the port's kernels on the path together: their least times
    over their device times, in percent."""
    ks = [v for v in ctx.kernels.values() if v["device_s"] > 0]
    if not ks:
        return None
    return 100.0 * sum(k["least_s"] for k in ks) / sum(k["device_s"] for k in ks)


def mfu(ctx):
    """The model's FLOPs (counted on the reference) done in the untraced
    part of the window, a second, over the bf16 tensor peak, in percent."""
    return None if ctx.flops_rate is None else 100.0 * ctx.flops_rate / PEAK_BF16


def device_idle(ctx):
    """The share of the traced window in which no operation ran on the
    device, in percent."""
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)


def by_pattern(name: str, kernels):
    """The reader that metric ``name``'s part before the first dot names:
    ``kernel_roofline``, ``mfu``, ``device_idle``, or ``<kernel>_roofline``
    for a kernel file of ``kernels`` (the part after the dot names the
    cells' end-to-end metric it is split by, and reads alike)."""
    base = name.split(".")[0]
    fixed = {"kernel_roofline": kernels_roofline, "mfu": mfu, "device_idle": device_idle}
    if base in fixed:
        return fixed[base]
    if base.endswith("_roofline") and base[: -len("_roofline")] in kernels:
        return roofline(base[: -len("_roofline")])
    raise KeyError(f"no reader for the metric {name!r}: add metrics/{name}.py")
