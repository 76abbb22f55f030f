"""``gn_stats``: a GroupNorm's mean and rstd (``csrc/resblock.cu``), before each
``conv3_fused`` and, in serving, for the ultimate UNet's output norm."""

from .geometry import forward_rows, gated_blocks, gn_cost, per_unit, resblock_geometries

LAUNCH = "gn_stats"
PATTERNS = ("gn_stats_kernel",)
PEAK = "fp32"


def launches(cell):
    m, t = cell.model, int(cell.traffic["mel_t"])
    if m["arch"] != "ultimate":
        return []
    b, step = int(cell.traffic["batch"]), []
    for _, tl, cin, cout, _, _ in gated_blocks(m, t):
        step += [gn_cost(b, tl, cin, 2), gn_cost(b, tl, cout, 4)]
    r, fwd = forward_rows(cell), []
    for _, tl, cin, cout, _, _ in resblock_geometries(m, t):
        fwd += [gn_cost(r, tl, cin, 2), gn_cost(r, tl, cout, 4)]
    fwd.append(gn_cost(r, t, m["base_dim"], 2))  # out_gn
    return per_unit(cell, step, fwd)
