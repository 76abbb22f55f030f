"""``attention``: the attention core softmax(QK^T / sqrt(hd)) V (``csrc/attention.cu``),
on the fused attention route: two a cross-attention site (motion, lyrics),
keys the clip's condition frames. A served forward's unconditional CFG rows
run it once a branch at one query and one key (a constant)."""

from .geometry import attention_cost, forward_rows, per_unit, resblock_geometries, v1_attention_sites

LAUNCH = "attention"
PATTERNS = ("attention_kernel", "attention_chunked_kernel")
PEAK = "bf16"


def _sites(m, t):
    if m["arch"] == "v1":
        return [(tl, c) for _, tl, c in v1_attention_sites(m, t)]
    return [(tl, cout) for _, tl, _, cout, _, add_res in resblock_geometries(m, t) if not add_res]


def launches(cell):
    m, t = cell.model, int(cell.traffic["mel_t"])
    if not m.get("fused_attention"):
        return []
    h = m["attn_heads"]
    b = int(cell.traffic["batch"])
    step = [attention_cost(b, h, tl, t, c // h) for tl, c in _sites(m, t) for _ in range(2)]
    rows = forward_rows(cell)
    cond = rows // 2 if rows > b else rows
    fwd = []
    for tl, c in _sites(m, t):
        if rows > cond:
            fwd += [attention_cost(1, h, 1, 1, c // h)] * 2
        fwd += [attention_cost(cond, h, tl, t, c // h)] * 2
    return per_unit(cell, step, fwd)
