"""``conv3_wgrad``: the weight gradient of a gated block's convs (``csrc/resblock_bwd.cu``), training only."""

from .geometry import bwd_costs, gated_blocks, per_unit

LAUNCH = "conv3_wgrad"
PATTERNS = ("conv3_wgrad_kernel",)
PEAK = "bf16"


def launches(cell):
    b, step = int(cell.traffic["batch"]), []
    for _, tl, cin, cout, skip, _ in gated_blocks(cell.model, int(cell.traffic["mel_t"])):
        step += bwd_costs(b, tl, cin, cout, skip)[LAUNCH]
    return per_unit(cell, step)
