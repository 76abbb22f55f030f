"""``conv3_fused``: GroupNorm-SiLU and a k3 conv in one launch (``csrc/resblock.cu``),
two a FiLM resblock of the ultimate UNet in serving, two a gated block in
training (conv 1 also saves its fp32 pre-activation)."""

from .geometry import conv_cost, gated_blocks, per_unit, resblock_geometries, forward_rows

LAUNCH = "conv3_fused"
PATTERNS = ("conv3_fused_kernel",)
PEAK = "bf16"


def launches(cell):
    m, t = cell.model, int(cell.traffic["mel_t"])
    if m["arch"] != "ultimate":
        return []
    b, step = int(cell.traffic["batch"]), []
    for _, tl, cin, cout, skip, _ in gated_blocks(m, t):
        nbytes, ops = conv_cost(b, tl, cin, 2, cout, 0, 4, False, False)
        step.append((nbytes + b * tl * cout * 4, ops))
        step.append(conv_cost(b, tl, cout, 4, cout, cin if skip else 0, 2, False, skip))
    r, fwd = forward_rows(cell), []
    for _, tl, cin, cout, skip, add_res in resblock_geometries(m, t):
        fwd.append(conv_cost(r, tl, cin, 2, cout, 0, 4, False, False))
        fwd.append(conv_cost(r, tl, cout, 4, cout, cin if skip else 0, 2,
                             add_res and not skip, skip and not add_res))
    return per_unit(cell, step, fwd)
