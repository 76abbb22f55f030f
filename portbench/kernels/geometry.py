"""The shapes each kernel runs at, and the bytes and operations of one launch,
worked out from a cell's configuration and traffic. Copied from
``chip_smoke.py`` (``resblock_geometries``, ``sandwich_geometries``,
``v1_attention_sites``, ``conv_cost``, ``bwd_costs``) and from the training
gate of ``ops/resblock_grad.py`` (``resblock_train_fits``), so that this
yardstick stays as it is when those files change.

Every cost counts each input byte read once and each output byte written
once. The peaks are NVIDIA's H100 SXM data sheet's dense rates.
"""

from __future__ import annotations

from typing import List, Tuple

PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
PEAKS = {"bf16": PEAK_BF16, "fp32": PEAK_FP32}

Cost = Tuple[float, float]  # (bytes, operations) of one launch

# the training gate: the blocks whose fused backward fits the JAX kernel's
# VMEM budget run the fused train chain (ops/resblock_grad.py)
BWD_VMEM_BUDGET = 15 * 1024 * 1024
TT = 64  # frames of a partial-sum tile of the backward's bucket sums


def least_seconds(cost: Cost, peak: str) -> float:
    nbytes, ops = cost
    return max(nbytes / PEAK_BYTES, ops / PEAKS[peak])


def resblock_geometries(m: dict, t: int):
    """(name, T, Cin, Cout, has_skip, add_residual) of every FiLM resblock of
    the ultimate UNet at input length ``t``, in forward order."""
    dims = [m["base_dim"] * k for k in m["dim_mults"]]
    out, ts, prev = [], [], m["base_dim"]
    for i, d in enumerate(dims):
        for b in range(m["num_res_blocks"]):
            attn = b == m["num_res_blocks"] - 1
            out.append((f"down_{i}_block_{b}", t, prev, d, prev != d, not attn))
            prev = d
        ts.append(t)
        t = (t + 2 - 4) // 2 + 1  # k4 s2 p(1,1)
    for b in range(m["mid_blocks"]):
        out.append((f"mid_block_{b}", t, prev, prev, False, False))
    for i, d in enumerate(reversed(dims)):
        t = ts.pop()
        for b in range(m["num_res_blocks"]):
            cin = 2 * d if b == 0 else d
            out.append((f"up_{i}_block_{b}", t, cin, d, cin != d, b != 0))
        prev = d
    return out


def train_fits(t: int, cin: int, cout: int, has_skip: bool, weight_itemsize: int = 2) -> bool:
    wcount = 3 * cin * cout + 3 * cout * cout + (cin * cout if has_skip else 0)
    return wcount * (weight_itemsize + 4) + t * max(cin, cout) * 4 * 8 <= BWD_VMEM_BUDGET


def gated_blocks(m: dict, t: int):
    """The ultimate blocks the fused train chain takes (with the fused
    backward switched on), in forward order."""
    if m["arch"] != "ultimate" or not m.get("fused_resblock_grad"):
        return []
    return [g for g in resblock_geometries(m, t) if train_fits(g[1], g[2], g[3], g[4])]


def v1_attention_sites(m: dict, t: int):
    """(name, T, C) of the v1 UNet's blocks, every one of which attends."""
    dims = [m["base_dim"] * k for k in m["dim_mults"]]
    prev, out, skips = m["base_dim"], [], []
    for i, dim in enumerate(dims):
        out.append((f"down_{i}_res", t, prev))
        skips.append((t, prev))
        t, prev = (t + 2 - 4) // 2 + 1, dim
    out.append(("mid_res", t, prev))
    for i, dim in enumerate(reversed(dims)):
        t, skip_c = skips.pop()
        prev = dim + skip_c
        out.append((f"up_{i}_res", t, prev))
    return out


def sandwich_geometries(v: dict, mel_t: int):
    """(name, T, C, uses per vocode) of every snake sandwich of BigVGAN."""
    ch, t, out = v["upsample_initial_channel"], mel_t, []
    per_stage = sum(2 * len(d) for d in v["resblock_dilation_sizes"])
    for i, r in enumerate(v["upsample_rates"]):
        ch, t = ch // 2, t * r
        out.append((f"stage_{i}", t, ch, per_stage))
    out.append(("activation_post", t, ch, 1))
    return out


def conv_cost(b: int, t: int, cin: int, in_bytes: int, cout: int, cin2: int, out_bytes: int,
              residual: bool, split: bool) -> Cost:
    """One ``conv3_fused`` launch: GroupNorm-SiLU prologue, conv3 over the
    (b, t, cin) input, an optional 1x1 skip GEMM over cin2 channels (its
    output written apart when ``split``) or an identity residual."""
    nbytes = (b * t * cin * in_bytes + cout * 3 * cin * 2 + 4 * (2 * cin + cout + 2 * b * cout)
              + b * t * cout * out_bytes)
    if cin2:
        nbytes += b * t * cin2 * 2 + cout * cin2 * 2 + 4 * cout
        if split:
            nbytes += b * t * cout * 2
    if residual:
        nbytes += b * t * cout * 2
    return nbytes, 2.0 * b * t * cout * (3 * cin + cin2)


def gn_cost(b: int, t: int, c: int, in_bytes: int, groups: int = 8) -> Cost:
    """One ``gn_stats`` launch: the mean and rstd of (b, groups) over (t, c)."""
    return b * t * c * in_bytes + 8 * b * groups, 3.0 * b * t * c


def bwd_costs(b: int, t: int, cin: int, cout: int, skip: bool, f_bytes: int = 4):
    """The backward kernels of one block, per kernel name: lists of launches.
    The convs' operations are their GEMMs' multiply-adds at the bf16 tensor
    peak; their fp32 GroupNorm + SiLU pro- or epilogue is left out (at most
    15% of the GEMM's time at C = 256 at the fp32 peak)."""
    nt = (t + TT - 1) // TT
    bt = b * t
    dg = [(bt * cout * 2 + cout * 3 * cout * 2 + bt * cout * f_bytes + bt * cout * 4
           + 4 * b * nt * cout * 4, 2.0 * bt * cout * 3 * cout),
          (bt * cout * 2 + cout * 3 * cin * 2 + bt * cin * 2 + bt * cin * 4 + 4 * b * nt * cin * 4,
           2.0 * bt * cin * 3 * cout)]
    wg = [(bt * cout * f_bytes + bt * cout * 2 + 3 * cout * cout * 4 + cout * 4,
           2.0 * 3 * cout * cout * bt),
          (bt * cin * 2 + bt * cout * 2 + 3 * cin * cout * 4, 2.0 * 3 * cin * cout * bt)]
    gn = [(bt * cout * (4 + f_bytes + 2 + 4) + 7 * b * nt * cout * 4, 12.0 * bt * cout),
          (bt * cin * (4 + 2 + 2) + 4 * b * nt * cin * 4, 10.0 * bt * cin)]
    if skip:
        dg.append((bt * cout * 2 + cin * cout * 2 + bt * cin * 4, 2.0 * bt * cin * cout))
        wg.append((bt * cin * 2 + bt * cout * 2 + cin * cout * 4 + cout * 4,
                   2.0 * cin * cout * bt))
        gn[1] = (gn[1][0] + bt * cin * 4, gn[1][1] + bt * cin)
    return {"conv3_dgrad": dg, "conv3_wgrad": wg, "gn_bwd": gn}


def attention_cost(b: int, heads: int, t: int, s: int, hd: int) -> Cost:
    """One attention-core launch over bf16 (b, heads, t|s, hd) Q, K, V and O:
    the two products' multiply-adds at the bf16 tensor peak."""
    return 2 * (2 * b * heads * t * hd + 2 * b * heads * s * hd), 4.0 * b * heads * t * s * hd


def sandwich_cost(b: int, t: int, c: int) -> Cost:
    """One snake sandwich over a bf16 (b, c, t) activation: read once, written
    once; 58 fp32 operations an input sample (two 6-tap output phases, two
    snakes, one 12-tap output)."""
    return 2 * b * t * c * 2 + 2 * c * 4, 58.0 * b * t * c


def train_steps(cell) -> int:
    """Training steps a unit of the cell's traffic takes (its ``steps_per_call``)."""
    return int(cell.traffic.get("steps_per_call", 0))


def sampler_forwards(cell) -> int:
    """Denoiser forwards a unit of the cell's traffic makes: its sampler's
    ``steps`` (a DDIM or a DDPM step is one forward, CFG's rows doubled in it)."""
    return int(cell.traffic.get("steps", 0))


def forward_rows(cell) -> int:
    """Rows of each of those forwards: the batch, doubled by CFG."""
    b = int(cell.traffic["batch"])
    return 2 * b if float(cell.traffic.get("guidance", 1.0)) > 1 else b


def per_unit(cell, per_step=(), per_forward=(), per_vocode=()) -> List[Cost]:
    """A kernel's launches in one unit of the cell's traffic, by the counts
    its traffic file gives: ``train_steps`` steps, ``sampler_forwards``
    forwards, and one vocode of one clip where ``vocode`` is set."""
    return (list(per_step) * train_steps(cell) + list(per_forward) * sampler_forwards(cell)
            + (list(per_vocode) if cell.traffic.get("vocode") else []))
