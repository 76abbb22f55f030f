"""``conv3_dgrad``: the input gradient of a gated block's convs through the SiLU backward (``csrc/resblock_bwd.cu``), training only."""

from .geometry import bwd_costs, gated_blocks, per_unit

LAUNCH = "conv3_dgrad"
PATTERNS = ("conv3_dgrad_kernel",)
PEAK = "bf16"


def launches(cell):
    b, step = int(cell.traffic["batch"]), []
    for _, tl, cin, cout, skip, _ in gated_blocks(cell.model, int(cell.traffic["mel_t"])):
        step += bwd_costs(b, tl, cin, cout, skip)[LAUNCH]
    return per_unit(cell, step)
