"""Launch plan of the Hopper ``conv3_dgrad`` (``dgrad_plan``) and its tiling
rules, on the CPU.

The plan is pure Python, so it is checked at the input-gradient GEMMs of
every flagship block (conv 2, conv 1 and the 1x1 skip's) at 1 and 16 rows
and T = 1, 37, 65, 516: every row of the flattened B*T axis in one tile,
every input channel in one N tile, every 64-channel K chunk taken by exactly
one rank of the split, clusters within the portable size, shared memory
within the card's limit and large enough for the ring and the epilogue's two
fp32 tiles, and the plan one of least modeled time.

An emulation then runs the kernel's tiling in PyTorch: M tiles over the
flattened rows, tap k of row r reading window row r + 2 - k (frame t + 1 - k)
or the zero row where that frame leaves its batch row, the split's ranks
summed in rank order, the SiLU backward, and each (b, t // 64) bucket's sums
of d_y and d_y * xhat in a head piece (the rows in the tile of the bucket's
first row) and a tail piece (the rest, or zero) added at the end. It matches
``conv3_dgrad_plain`` up to fp32 summation order: 1e-5 relative, as
``chip_smoke.TOL_REL_L2["conv3_dgrad"]`` asks of the kernel.
"""

import pytest
import torch

import chip_smoke
from lm2a_tpu_torch.core.config import ModelConfig
from lm2a_tpu_torch.ops import resblock as rb
from lm2a_tpu_torch.ops import resblock_grad as rg

from _torch_port_util import one_torch_thread  # noqa: F401

FLAGSHIP = chip_smoke.resblock_geometries(ModelConfig(), chip_smoke.MEL_T)


def _gemms():
    """(name, Cin, Cout, taps) of each block's input-gradient GEMMs: conv 2
    (Cout -> Cout), conv 1 (Cout -> Cin) and the skip's (1 tap)."""
    out = []
    for name, _, cin, cout, skip, _ in FLAGSHIP:
        out += [(f"{name}.conv2", cout, cout, 3), (f"{name}.conv1", cin, cout, 3)]
        if skip:
            out.append((f"{name}.skip", cin, cout, 1))
    return out


CASES = [(b, t, *g) for b in (1, 16) for t in (1, 37, 65, 516) for g in _gemms()]


@pytest.mark.parametrize("b,t,name,cin,cout,taps", CASES,
                         ids=[f"B{c[0]}-T{c[1]}-{c[2]}" for c in CASES])
def test_dgrad_plan(b, t, name, cin, cout, taps):
    p = rg.dgrad_plan(b, t, cin, cout, taps)
    assert (p.mw, p.bn) in rg.DGRAD_CHUNK_US
    assert p.mtiles * p.bm >= b * t > (p.mtiles - 1) * p.bm  # every row once
    assert p.ntiles * p.bn == cin  # every input channel once
    assert p.chunks * 64 >= cout > (p.chunks - 1) * 64
    assert 1 <= p.splits <= rb.SPLIT_MAX <= rb.CLUSTER_MAX
    ranges = rb.k_ranges(p.chunks, p.splits)
    assert [j for beg, end in ranges for j in range(beg, end)] == list(range(p.chunks))
    assert all(end > beg for beg, end in ranges)
    window = -(-(p.bm + 3) * 72 * 2 // 1024) * 1024
    assert p.smem <= rb.SMEM_MAX
    assert p.smem >= 3 * (taps * 64 * p.bn * 2 + window)  # the ring
    assert p.smem >= 2 * p.bm * (p.bn + 4) * 4  # the epilogue's d_y and d_y * xhat
    cands = rg.dgrad_candidates(b, t, cin, cout, taps)
    best = min(c for c, _ in cands)
    assert any(q == p and c == best for c, q in cands)


# ---------------------------------------------------------------- emulation

def emulate_dgrad(g, w, plan, t, taps, act=None):
    """conv3_dgrad as the kernel tiles it. ``g`` (B*T, Cout) fp32 holding
    bf16 values, ``w`` (Cout, taps*Cin). ``act``: (xhat, gamma, beta) of the
    SiLU backward, (B*T, Cin) and (Cin,); returns (d or d_y, partials)."""
    m_all, cout = g.shape
    cin = w.shape[1] // taps
    b = m_all // t
    nt = rg.n_tiles(t)
    out = torch.zeros(m_all, cin)
    pieces = torch.full((2, 2, b, nt, cin), float("nan"))  # every element written once
    bm = plan.bm
    for mt in range(plan.mtiles):
        m0 = mt * bm
        q = torch.arange(m0 - 1, m0 + bm + 1)
        win = torch.zeros(bm + 3, cout)  # the last row: the zero row
        ok = (q >= 0) & (q < m_all)
        win[:bm + 2][ok] = g[q[ok]]
        m = torch.arange(m0, m0 + bm)
        tt = m % t
        rows = []
        for k in range(taps):
            src = tt + 1 - k if taps == 3 else tt
            valid = (m < m_all) & (src >= 0) & (src < t)
            rows.append(torch.where(valid, torch.arange(bm) + (2 - k if taps == 3 else 1), bm + 2))
        tile = None
        for beg, end in rb.k_ranges(plan.chunks, plan.splits):  # rank order
            acc = torch.zeros(bm, cin)
            for j in range(beg, end):
                ks = slice(64 * j, min(64 * j + 64, cout))
                for k in range(taps):
                    acc += win[rows[k], ks] @ w[ks, k * cin:(k + 1) * cin]
            tile = acc if tile is None else tile + acc
        nrow = min(bm, m_all - m0)
        d = tile[:nrow]
        if act is None:
            out[m0:m0 + nrow] = d
            continue
        xh, gamma, beta = act
        xh = xh[m0:m0 + nrow]
        y = xh * gamma + beta
        sig = torch.sigmoid(y)
        dy = d * (sig * (1.0 + y * (1.0 - sig)))
        out[m0:m0 + nrow] = dy
        for which, src in enumerate((dy, dy * xh)):
            r = 0
            while r < nrow:  # the pieces of the buckets in this tile, in row order
                mm = m0 + r
                bi, ti = mm // t, mm % t
                bucket = ti // rg.TT
                bs, be = bi * t + bucket * rg.TT, bi * t + min(bucket * rg.TT + rg.TT, t)
                r_end = min(be - m0, nrow)
                s = src[r:r_end].sum(0)
                if bs >= m0:
                    pieces[which, 0, bi, bucket] = s
                    if be <= m0 + bm:
                        pieces[which, 1, bi, bucket] = 0.0
                else:
                    pieces[which, 1, bi, bucket] = s
                r = r_end
    if act is None:
        return out, None
    assert not torch.isnan(pieces).any()
    return out, pieces[:, 0] + pieces[:, 1]


def _rel(a, b):
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("b,t", [(2, 1), (3, 37), (2, 65), (16, 64), (3, 129), (2, 300)])
@pytest.mark.parametrize("mw,bn,splits", [(1, 64, 1), (2, 64, 2), (1, 128, 3)])
@pytest.mark.parametrize("cout", [96, 128])
def test_dgrad_tiling_emulation(b, t, mw, bn, splits, cout):
    """Flattened M tiles across batch rows and buckets, reversed taps, a
    32-wide last K chunk (Cout 96), the split's rank order and the bucket
    pieces give the plain version's d_y and partials."""
    gen = torch.Generator().manual_seed(b * t + mw * bn + splits + cout)
    cin, groups = 128, 8
    g = torch.randn((b, t, cout), generator=gen).to(torch.bfloat16)
    w = (torch.randn((cout, 3 * cin), generator=gen) * cout ** -0.5).to(torch.bfloat16)
    pre = torch.randn((b, t, cin), generator=gen)
    mean, rstd = rb.gn_stats_plain(pre, groups)
    gamma = torch.randn(cin, generator=gen) * 0.1 + 1.0
    beta = torch.randn(cin, generator=gen) * 0.1
    chunks = -(-cout // 64)
    splits = min(splits, chunks)
    plan = rg.DgradPlan(mw, bn, -(-(b * t) // (64 * mw)), cin // bn, splits, 0, chunks)
    xh = rg._xhat(pre, mean, rstd).reshape(b * t, cin)
    got, gp = emulate_dgrad(g.float().reshape(b * t, cout), w.float(), plan, t, 3,
                            (xh, gamma, beta))
    want, wp = rg.conv3_dgrad_plain(g, w, taps=3, pre=pre, mean=mean, rstd=rstd, gamma=gamma,
                                    beta=beta)
    tol = chip_smoke.TOL_REL_L2["conv3_dgrad"]
    assert _rel(got.reshape(b, t, cin), want) <= tol
    wp = rg.bucket_sums(wp)
    assert gp.shape == wp.shape and _rel(gp, wp) <= tol
    # the skip's raw product, one tap
    w1 = (torch.randn((cout, cin), generator=gen) * cout ** -0.5).to(torch.bfloat16)
    got1, _ = emulate_dgrad(g.float().reshape(b * t, cout), w1.float(), plan, t, 1)
    want1, _ = rg.conv3_dgrad_plain(g, w1, taps=1)
    assert _rel(got1.reshape(b, t, cin), want1) <= tol


NARROW = [(b, t, cin, cout) for b, t in ((2, 37), (1, 65)) for cin, cout in
          ((16, 16), (16, 32), (48, 48), (48, 96), (96, 96), (144, 48), (32, 40),
           # widths off the 8-channel unit: bases 12 and 20, an odd-width block
           (12, 12), (12, 24), (20, 40), (80, 20), (21, 42), (42, 21))]


@pytest.mark.parametrize("b,t,cin,cout", NARROW, ids=[f"B{c[0]}-T{c[1]}-{c[2]}x{c[3]}" for c in NARROW])
def test_dgrad_plan_and_emulation_at_narrow_widths(b, t, cin, cout):
    """Channel counts 16·k (and 40, and 12 to 80 off the 8-channel unit):
    ceil(Cin / BN) N tiles, a last K chunk of 12 to 56 channels (zero rows
    past it), C/G 1 to 21 at
    default_num_groups; the emulated kernel gives the plain version's d_y
    and partials within ``chip_smoke.TOL_REL_L2``."""
    p = rg.dgrad_plan(b, t, cin, cout, 3)
    assert p.ntiles == -(-cin // p.bn) and p.chunks == -(-cout // 64)
    assert p.mtiles * p.bm >= b * t > (p.mtiles - 1) * p.bm
    gen = torch.Generator().manual_seed(b * t + cin + cout)
    groups = chip_smoke.default_num_groups(cin)
    g = torch.randn((b, t, cout), generator=gen).to(torch.bfloat16)
    w = (torch.randn((cout, 3 * cin), generator=gen) * cout ** -0.5).to(torch.bfloat16)
    pre = torch.randn((b, t, cin), generator=gen)
    mean, rstd = rb.gn_stats_plain(pre, groups)
    gamma = torch.randn(cin, generator=gen) * 0.1 + 1.0
    beta = torch.randn(cin, generator=gen) * 0.1
    xh = rg._xhat(pre, mean, rstd).reshape(b * t, cin)
    got, gp = emulate_dgrad(g.float().reshape(b * t, cout), w.float(), p, t, 3,
                            (xh, gamma, beta))
    want, wp = rg.conv3_dgrad_plain(g, w, taps=3, pre=pre, mean=mean, rstd=rstd, gamma=gamma,
                                    beta=beta)
    tol = chip_smoke.TOL_REL_L2["conv3_dgrad"]
    assert _rel(got.reshape(b, t, cin), want) <= tol
    assert _rel(gp, rg.bucket_sums(wp)) <= tol
