"""Launch plans of the Hopper conv kernels (``conv3_plan``, ``wgrad_plan``).

The plans are pure Python, so they are checked here on the CPU at every
flagship geometry (15 blocks at 1, 2, 4 and 16 rows and at T=12920) and at
the edge lengths T = 1, 37, 65, 129 and 300: every output tile covered once,
every K chunk taken by exactly one rank of a split, clusters within the
portable size, shared memory within the card's opt-in limit, and the 2- and
4-row flagship convs on at least 132 blocks unless the measured cost model
puts every full wave above the plan chosen. Two emulations then run the kernels' tiling and index rules
(window rows, the zero row for a tap that leaves its batch row, the rank
order of the split sums) in PyTorch on the CPU and match the plain versions
exactly up to fp32 summation order.
"""

import pytest
import torch

import chip_smoke
from lm2a_tpu_torch.core.config import ModelConfig
from lm2a_tpu_torch.ops import resblock as rb
from lm2a_tpu_torch.ops import resblock_grad as rg

FLAGSHIP = chip_smoke.resblock_geometries(ModelConfig(), chip_smoke.MEL_T)
LONG = chip_smoke.resblock_geometries(ModelConfig(), chip_smoke.LONG_T)
EDGE_T = [1, 37, 65, 129, 300]


def _convs(geoms):
    """(name, T, Cin, Cout, Cin2, split_skip) of both convs of each block."""
    out = []
    for name, t, cin, cout, skip, add_res in geoms:
        out.append((f"{name}.conv1", t, cin, cout, 0, False))
        out.append((f"{name}.conv2", t, cout, cout, cin if skip else 0, skip and not add_res))
    return out


FWD_CASES = ([(rows, *c) for rows in (1, 2, 4, 16) for c in _convs(FLAGSHIP)]
             + [(2, *c) for c in _convs(LONG)]
             + [(rows, f"edge_T{t}", t, cin, cout, cin2, split)
                for rows in (1, 2, 4) for t in EDGE_T
                for cin, cout, cin2, split in ((128, 128, 0, False), (256, 128, 256, False),
                                               (256, 128, 256, True), (2048, 1024, 0, False))])


def _assert_k_split(chunks, ranks):
    ranges = rb.k_ranges(chunks, ranks)
    taken = [k for beg, end in ranges for k in range(beg, end)]
    assert taken == list(range(chunks))  # each chunk once, ranks in order
    assert all(end > beg for beg, end in ranges)  # no rank idles in a cluster


def _assert_least_modeled(candidates, plan, blocks_of):
    """The plan is a candidate of least modeled time; when it launches fewer
    than SMS blocks, every candidate that fills a wave is modeled slower."""
    best = min(c for c, _ in candidates)
    assert any(p == plan and c == best for c, p in candidates)
    if blocks_of(plan) < rb.SMS:
        assert all(c > best for c, p in candidates if blocks_of(p) >= rb.SMS)


@pytest.mark.parametrize("rows,name,t,cin,cout,cin2,split", FWD_CASES,
                         ids=[f"r{c[0]}-{c[1]}-T{c[2]}-{c[3]}x{c[4]}"
                              + (f"+{c[5]}{'s' if c[6] else ''}" if c[5] else "")
                              for c in FWD_CASES])
def test_conv3_plan(rows, name, t, cin, cout, cin2, split):
    p = rb.conv3_plan(rows, t, cin, cout, cin2, split)
    m = rows * t
    # M: every frame of the flattened axis in exactly one tile, no empty tile
    assert p.mtiles * p.bm >= m > (p.mtiles - 1) * p.bm
    # N: the conv's channels, then the kept-apart skip's, in whole tiles
    assert p.ntiles * p.bn == (2 if split else 1) * cout and cout % p.bn == 0
    assert p.mw in (1, 2) and p.bn in (64, 128)
    assert p.threads <= 1024
    assert 1 <= p.splits <= rb.SPLIT_MAX <= rb.CLUSTER_MAX
    for chunks in p.chunks:
        _assert_k_split(chunks, p.splits)
    assert p.smem <= rb.SMEM_MAX
    ring = 3 * 3 * p.bn * 128
    window = 2 * (p.bm + 3) * 72 * 2
    assert p.smem >= ring + window + 3 * (p.bm + 2) * (64 * 2 + 16)
    assert rb.conv3_plan(rows, t, cin, cout, cin2, split, 4).smem <= rb.SMEM_MAX
    if p.splits > 1:
        assert p.smem >= p.bm * p.bn * 4  # the fp32 tile the cluster sums
    # at least SMS blocks, unless the measured model says a full wave is slower
    _assert_least_modeled(rb.conv3_candidates(rows, t, cin, cout, cin2, split), p,
                          lambda q: q.blocks)


# the distillation teacher's guided forward: 2B = 32 rows at every flagship conv3
DISTILL_CASES = [(chip_smoke.DISTILL_ROWS, *c) for c in _convs(FLAGSHIP)]


@pytest.mark.parametrize("rows,name,t,cin,cout,cin2,split", DISTILL_CASES,
                         ids=[f"r{c[0]}-{c[1]}" for c in DISTILL_CASES])
def test_conv3_plan_at_the_distill_teachers_rows(rows, name, t, cin, cout, cin2, split):
    assert rows == 32
    test_conv3_plan(rows, name, t, cin, cout, cin2, split)


def test_conv3_plan_beats_the_full_waves_it_declines():
    """Where a flagship conv at 2 or 4 rows launches fewer than 132 blocks,
    the model puts a full wave (or two) above it: a second wave of 6 us
    plus the chunks costs more than the idle SMs."""
    for rows in (2, 4):
        for name, t, cin, cout, c2, s in _convs(FLAGSHIP):
            cands = rb.conv3_candidates(rows, t, cin, cout, c2, s)
            plan = rb.conv3_plan(rows, t, cin, cout, c2, s)
            full = [c for c, p in cands if p.blocks >= rb.SMS]
            best = min(c for c, _ in cands)
            assert plan.blocks >= rb.SMS or min(full) > best, (rows, name)


WGRAD_CASES = ([(b, name, t, ci, co, taps) for b in (1, 2, 4, 16)
                for name, t, cin, cout, skip, _ in FLAGSHIP
                for ci, co, taps in ((cout, cout, 3), (cin, cout, 3)) + (((cin, cout, 1),) if skip else ())]
               + [(b, f"edge_T{t}", t, ci, co, taps) for b in (1, 2, 16) for t in EDGE_T
                  for ci, co, taps in ((128, 128, 3), (256, 128, 1), (2048, 1024, 3))])


@pytest.mark.parametrize("b,name,t,cin,cout,taps", WGRAD_CASES,
                         ids=[f"B{c[0]}-{c[1]}-T{c[2]}-{c[3]}x{c[4]}-k{c[5]}" for c in WGRAD_CASES])
def test_wgrad_plan(b, name, t, cin, cout, taps):
    p = rg.wgrad_plan(b, t, cin, cout, taps)
    assert p.mw in (1, 2)
    assert p.ntiles * 64 * p.mw == cout and p.ctiles * 64 == cin  # each output once
    assert p.chunks * 64 >= b * t > (p.chunks - 1) * 64
    # a cluster of `splits` blocks summed in the kernel, `parts` partials after it
    assert 1 <= p.splits <= rb.SPLIT_MAX <= rb.CLUSTER_MAX and 1 <= p.parts <= rg.WGRAD_PARTS
    _assert_k_split(p.chunks, p.splits * p.parts)
    assert p.smem <= rb.SMEM_MAX
    assert p.smem >= 2 * taps * 64 * 128 + 3 * 64 * (64 * p.mw + 8) * 2 + 3 * 64 * 144
    assert rg.wgrad_plan(b, t, cin, cout, taps, 4).smem <= rb.SMEM_MAX
    if p.splits > 1:
        assert p.smem >= (taps * 64 + 1) * 64 * p.mw * 4
    if p.ntiles * p.ctiles >= rb.SMS:
        assert p.splits * p.parts == 1  # split K only where the tiles are fewer than the SMs
    _assert_least_modeled(rg.wgrad_candidates(b, t, cin, cout, taps), p, lambda q: q.blocks)


# ---------------------------------------------------------------- emulations

def _round_bf16(x):
    return x.to(torch.bfloat16).float()


def emulate_conv3(act, w, plan, t):
    """conv3_fused's GEMM as the kernel tiles it: ``act`` the activated
    (B*T, Cin) operand (fp32 holding bf16 values), ``w`` (Cout, 3*Cin). Each
    M tile reads window rows q = m0 - 1 + j; row m of tap k reads window row
    (m - m0) + k, or the zero row where frame t + k - 1 leaves [0, T). Split
    ranks sum their chunks' products; the tile is their sum in rank order."""
    m_all, cin = act.shape
    cout = w.shape[0]
    out = torch.zeros(m_all, cout)
    nch = rb.n_chunks(cin)
    # channels past Cin, up to the last chunk's 64, are zeros (zero-filled
    # window and weight tile)
    kp = nch * rb.CHUNK
    act = torch.nn.functional.pad(act, (0, kp - cin))
    w = torch.cat([torch.nn.functional.pad(w[:, k * cin:(k + 1) * cin], (0, kp - cin))
                   for k in range(3)], dim=1)
    cin = kp
    for mt in range(plan.mtiles):
        m0 = mt * plan.bm
        q = torch.arange(m0 - 1, m0 + plan.bm + 1)
        win = torch.zeros(plan.bm + 3, cin)  # last row: the zero row
        ok = (q >= 0) & (q < m_all)
        win[:plan.bm + 2][ok] = act[q[ok]]
        m = torch.arange(m0, m0 + plan.bm)
        tt = m % t
        rows = []
        for k in range(3):
            valid = (m < m_all) & (tt + k - 1 >= 0) & (tt + k - 1 < t)
            rows.append(torch.where(valid, torch.arange(plan.bm) + k, plan.bm + 2))
        parts = []
        for beg, end in rb.k_ranges(nch, plan.splits):
            acc = torch.zeros(plan.bm, cout)
            for j in range(beg, end):
                cs = slice(j * 64, j * 64 + 64)
                for k in range(3):
                    acc += win[rows[k], cs] @ w[:, k * cin + j * 64:k * cin + j * 64 + 64].t()
            parts.append(acc)
        tile = parts[0]
        for extra in parts[1:]:
            tile = tile + extra
        keep = m < m_all
        out[m[keep]] = tile[keep]
    return out


@pytest.mark.parametrize("rows,t", [(2, 1), (3, 37), (2, 65), (4, 129), (2, 300), (1, 64)])
@pytest.mark.parametrize("cin", [64, 512])
def test_conv3_tiling_emulation(rows, t, cin):
    """Tap shifts never cross a batch row, padded rows are dropped, and the
    split's rank sums give the plain conv3 (before its epilogue)."""
    gen = torch.Generator().manual_seed(rows * t + cin)
    cout = 128
    act = _round_bf16(torch.randn((rows, t, cin), generator=gen))
    w = _round_bf16(torch.randn((cout, 3 * cin), generator=gen) * cin ** -0.5)
    plan = rb.conv3_plan(rows, t, cin, cout)
    got = emulate_conv3(act.reshape(rows * t, cin), w, plan, t)
    ap = torch.nn.functional.pad(act, (0, 0, 1, 1))
    want = torch.cat([ap[:, :-2], ap[:, 1:-1], ap[:, 2:]], dim=-1) @ w.t()
    torch.testing.assert_close(got.reshape(rows, t, cout), want, atol=1e-4, rtol=1e-5)


def emulate_wgrad(act, g, plan, t, taps):
    """conv3_wgrad as the kernel tiles it: K chunks of 64 flattened frames;
    tap k's tile column jc holds act(q0 + jc + k - 1) when that frame lies in
    the same batch row as q0 + jc, else 0; ranks summed in rank order."""
    bt, cin = act.shape
    parts = []
    for beg, end in rb.k_ranges(plan.chunks, plan.splits * plan.parts):
        acc = torch.zeros(taps, cin, g.shape[1])
        for j in range(beg, end):
            qc = torch.arange(j * 64, j * 64 + 64)
            gq = torch.where((qc < bt)[:, None], g[qc.clamp(max=bt - 1)], torch.zeros(()))
            for k in range(taps):
                shift = k - 1 if taps == 3 else 0
                src = qc + shift
                ok = (qc < bt) & ((qc % t) + shift >= 0) & ((qc % t) + shift < t)
                tile = torch.where(ok[:, None], act[src.clamp(0, bt - 1)], torch.zeros(()))
                acc[k] += tile.t() @ gq
        parts.append(acc)
    total = parts[0]
    for extra in parts[1:]:
        total = total + extra
    return total.reshape(taps * cin, -1)


@pytest.mark.parametrize("b,t", [(2, 1), (3, 37), (2, 65), (2, 129), (1, 300)])
@pytest.mark.parametrize("taps", [1, 3])
def test_wgrad_tiling_emulation(b, t, taps):
    gen = torch.Generator().manual_seed(b * t + taps)
    cin, cout = 64, 64
    act = _round_bf16(torch.randn((b, t, cin), generator=gen))
    g = _round_bf16(torch.randn((b, t, cout), generator=gen)).to(torch.bfloat16)
    plan = rg.wgrad_plan(b, t, cin, cout, taps)
    got = emulate_wgrad(act.reshape(b * t, cin), g.float().reshape(b * t, cout), plan, t, taps)
    want, _ = rg.conv3_wgrad_plain(act.to(torch.bfloat16), g, taps=taps)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)


# ---------------------------------------------------------------- narrow base widths

def _narrow_convs():
    """Both convs of every block of base widths 16, 32, 48 and 96 (channel
    counts 16·k: K chunks and N tiles narrower than 64)."""
    out = []
    for base in (16, 32, 48, 96):
        geos = chip_smoke.resblock_geometries(ModelConfig(base_dim=base), 64)
        out += [(base, *c) for c in _convs(geos)]
    return out


NARROW_CASES = [(rows, *c) for rows in (1, 2, 4, 16) for c in _narrow_convs()]


@pytest.mark.parametrize("rows,base,name,t,cin,cout,cin2,split", NARROW_CASES,
                         ids=[f"r{c[0]}-b{c[1]}-{c[2]}" for c in NARROW_CASES])
def test_conv3_plan_at_narrow_widths(rows, base, name, t, cin, cout, cin2, split):
    """Every output channel in ceil(Cout / BN) N tiles (twice with a kept-apart
    skip), every input channel in ceil(Cin / 64) K chunks (the last one
    zero-filled past Cin), each chunk taken by one rank of the split."""
    p = rb.conv3_plan(rows, t, cin, cout, cin2, split)
    assert p.mtiles * p.bm >= rows * t > (p.mtiles - 1) * p.bm
    assert p.ntiles == (2 if split else 1) * -(-cout // p.bn)
    want = (rb.n_chunks(cin), rb.n_chunks(cin2)) if split else (rb.n_chunks(cin) + rb.n_chunks(cin2),)
    assert p.chunks == want
    for chunks in p.chunks:
        _assert_k_split(chunks, p.splits)
    assert p.smem <= rb.SMEM_MAX
    w = rg.wgrad_plan(rows, t, cin, cout, 3)
    assert w.ntiles == -(-cout // (64 * w.mw)) and w.ctiles == -(-cin // 64)
    _assert_k_split(w.chunks, w.splits * w.parts)


@pytest.mark.parametrize("rows,t", [(2, 37), (3, 65), (1, 64)])
@pytest.mark.parametrize("cin", [16, 48, 96, 136])
def test_conv3_tiling_emulation_at_narrow_widths(rows, t, cin):
    """A last K chunk narrower than 64 channels, zero-filled in the window
    and the weight tile as the kernel fills it, gives the plain conv3."""
    gen = torch.Generator().manual_seed(rows * t + cin)
    cout = 48
    act = _round_bf16(torch.randn((rows, t, cin), generator=gen))
    w = _round_bf16(torch.randn((cout, 3 * cin), generator=gen) * cin ** -0.5)
    plan = rb.conv3_plan(rows, t, cin, cout)
    got = emulate_conv3(act.reshape(rows * t, cin), w, plan, t)
    ap = torch.nn.functional.pad(act, (0, 0, 1, 1))
    want = torch.cat([ap[:, :-2], ap[:, 1:-1], ap[:, 2:]], dim=-1) @ w.t()
    torch.testing.assert_close(got.reshape(rows, t, cout), want, atol=1e-4, rtol=1e-5)
