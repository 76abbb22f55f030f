"""The two GroupNorm kernels' plain versions and launch rules, on the CPU.

``gn_stats_plain`` (``lm2a_tpu_torch/ops/resblock.py``) against the JAX
package's ``_gn_fwd_stats`` and the GroupNorm of ``resblock_chain_reference``
(``lm2a_tpu/ops/pallas_resblock.py``), and ``gn_bwd_plain``
(``ops/resblock_grad.py``) against ``_gn_bwd``, at the flagship's (T, C)
pairs with G = 8, B = 1, and at ragged T. Inputs from numpy under a seed,
fp32 on both sides: 1e-5 relative L2 (sums in another order only).

Then the interface between ``conv3_dgrad`` and ``gn_bwd``: each 64-frame
bucket's sums as a head and a tail piece, which ``gn_bwd`` and the chain's
sums read head first; any split of a bucket gives what its whole sum gave.

Then the kernels' launch rules, which the CPU can hold: ``gn_stats_plan``
(the cluster that splits T) covers every frame once, stays within the
portable cluster size and comes nearest one block an SM; the kernel's walk over (frame,
vector) units by fixed steps visits every unit once; and an emulation of
``gn_bwd``'s blocks (a 64-frame bucket by the plan's 128 or 64 channels,
the group means from the pieces of every group a block touches, the buckets
split among a channel's threads, the FiLM sums in row order) gives the
plain version's output.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import lm2a_tpu.ops.pallas_resblock as prb
from lm2a_tpu_torch.ops import resblock as rb
from lm2a_tpu_torch.ops import resblock_grad as rg

from _torch_port_util import one_torch_thread  # noqa: F401

REL = 1e-5
# the flagship's GroupNorm inputs (T, C) at 6 s: every block's GN1 and GN2
FLAGSHIP_TC = [(516, 256), (258, 256), (258, 512), (129, 512), (129, 1024), (64, 1024),
               (129, 2048), (258, 1024), (516, 512)]
RAGGED_TC = [(1, 256), (37, 256), (300, 512)]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _x(seed, b, t, c):
    rng = np.random.default_rng(seed)
    return (1.5 * rng.standard_normal((b, t, c)) + 0.3).astype(np.float32)


@pytest.mark.parametrize("t,c", FLAGSHIP_TC + RAGGED_TC)
def test_gn_stats_plain_matches_jax(t, c):
    groups, cg = 8, c // 8
    x = _x(t + c, 1, t, c)
    mean, rstd = rb.gn_stats_plain(torch.tensor(x), groups)
    p_assign = prb._group_matrices(c, groups, jnp.float32)
    xhat, rstd_c = prb._gn_fwd_stats(jnp.asarray(x[0]), p_assign, t * cg)
    rep = lambda v: v[0].repeat_interleave(cg).numpy()  # noqa: E731
    assert _rel(np.tile(rep(rstd), (t, 1)), np.asarray(rstd_c).repeat(t, 0)) <= REL
    mine = (x[0] - rep(mean)) * rep(rstd)
    assert _rel(mine, np.asarray(xhat)) <= REL
    # resblock_chain_reference's GroupNorm: the same fast variance, per row
    hf = x.reshape(1, t, groups, cg)
    m = hf.mean(axis=(1, 3))
    want = 1.0 / np.sqrt((hf * hf).mean(axis=(1, 3)) - m * m + 1e-5)
    assert _rel(mean.numpy(), m) <= REL and _rel(rstd.numpy(), want) <= REL


def _pieces(sums: torch.Tensor, seed: int) -> torch.Tensor:
    """(2, B, nT, C) bucket sums as head and tail pieces split at random."""
    r = torch.as_tensor(np.random.default_rng(seed).random(sums.shape), dtype=torch.float32)
    head = sums * r
    return torch.stack([head, sums - head], 1)


def _gn_bwd_case(seed, b, t, c, groups):
    rng = np.random.default_rng(seed)
    pre = torch.tensor(_x(seed, b, t, c))
    dy = torch.tensor(rng.standard_normal((b, t, c)).astype(np.float32))
    gamma = torch.tensor((1 + 0.1 * rng.standard_normal(c)).astype(np.float32))
    mean, rstd = rb.gn_stats_plain(pre, groups)
    xh = rg._xhat(pre, mean, rstd)
    sums = torch.stack([rg._tile_sums(dy), rg._tile_sums(dy * xh)])
    return pre, dy, gamma, mean, rstd, sums


@pytest.mark.parametrize("t,c", FLAGSHIP_TC + RAGGED_TC)
def test_gn_bwd_plain_matches_jax(t, c):
    groups, cg = 8, c // 8
    pre, dy, gamma, mean, rstd, sums = _gn_bwd_case(t * c, 1, t, c, groups)
    pieces = torch.stack([sums, torch.zeros_like(sums)], 1)
    got, _ = rg.gn_bwd_plain(dy, pre, mean, rstd, gamma, pieces)
    p_assign = prb._group_matrices(c, groups, jnp.float32)
    xhat, rstd_c = prb._gn_fwd_stats(jnp.asarray(pre[0].numpy()), p_assign, t * cg)
    want = prb._gn_bwd(jnp.asarray(dy[0].numpy()), xhat, rstd_c, jnp.asarray(gamma.numpy()),
                       p_assign, t * cg)
    assert _rel(got[0].numpy(), np.asarray(want)) <= REL
    # FiLM mode: d_z1 = d (1 + scale) and the bucket sums of d, d z1, d_z1
    rng = np.random.default_rng(t)
    scale = torch.tensor(0.2 * rng.standard_normal((1, c)).astype(np.float32))
    z1 = torch.tensor(rng.standard_normal((1, t, c)).astype(np.float32))
    dz, part = rg.gn_bwd_plain(dy, pre, mean, rstd, gamma, pieces, film_scale=scale, z1=z1)
    d = np.asarray(want)
    dzw = d * (1 + scale[0].numpy())
    assert _rel(dz[0].numpy(), dzw) <= REL
    nt = rg.n_tiles(t)
    pad = lambda v: np.pad(v, ((0, nt * 64 - t), (0, 0))).reshape(nt, 64, c).sum(1)  # noqa: E731
    for got_s, want_s in zip(part[:, 0].numpy(), (pad(d), pad(d * z1[0].numpy()), pad(dzw))):
        assert _rel(got_s, want_s) <= REL


@pytest.mark.parametrize("b,t,c,groups", [(2, 37, 128, 8), (3, 200, 256, 4), (1, 516, 256, 8)])
def test_pieces_give_what_head_plus_tail_gave(b, t, c, groups):
    """Any split of a bucket's sums into head and tail gives gn_bwd_plain's
    result on the whole sums, and conv3_dgrad_plain's pieces hold the whole
    sum in the head (its tail zero)."""
    pre, dy, gamma, mean, rstd, sums = _gn_bwd_case(b * t + c, b, t, c, groups)
    whole = torch.stack([sums, torch.zeros_like(sums)], 1)
    split = _pieces(sums, seed=c)
    assert torch.allclose(rg.bucket_sums(split), sums, rtol=1e-6, atol=1e-5)
    scale = torch.full((b, c), 0.1)
    for kw in (dict(), dict(extra=dy * 0.5), dict(film_scale=scale, z1=pre)):
        a = rg.gn_bwd_plain(dy, pre, mean, rstd, gamma, whole, **kw)
        s = rg.gn_bwd_plain(dy, pre, mean, rstd, gamma, split, **kw)
        for x, y in zip(a, s):
            if x is not None:
                assert _rel(y.numpy(), x.numpy()) <= REL
    # conv3_dgrad_plain: whole sums in the head piece
    rng = np.random.default_rng(1)
    g = torch.tensor(rng.standard_normal((b, t, 64)).astype(np.float32)).to(torch.bfloat16)
    w = torch.tensor((0.1 * rng.standard_normal((64, 3 * c))).astype(np.float32)).to(
        torch.bfloat16)
    d_y, pieces = rg.conv3_dgrad_plain(g, w, taps=3, pre=pre, mean=mean, rstd=rstd,
                                       gamma=gamma, beta=torch.zeros(c))
    assert pieces.shape == (2, 2, b, rg.n_tiles(t), c) and not pieces[:, 1].any()
    xh = rg._xhat(pre, mean, rstd)
    assert torch.equal(pieces[:, 0], torch.stack([rg._tile_sums(d_y), rg._tile_sums(d_y * xh)]))


# ---------------------------------------------------------------- gn_stats plan

PLAN_SHAPES = [  # (rows, T, C): serving 2/4 rows, generate_long 16, single pass, training
    (r, t, c) for r in (1, 2, 4, 16) for t, c in FLAGSHIP_TC + [(1, 256), (63, 256)]
] + [(2, 12920, 256), (2, 6460, 512), (2, 3230, 1024), (2, 1615, 1024), (2, 3230, 2048)]


@pytest.mark.parametrize("in_bytes", [2, 4])
@pytest.mark.parametrize("groups", [8, 4, 2, 1])
@pytest.mark.parametrize("b,t,c", PLAN_SHAPES)
def test_gn_stats_plan(b, t, c, groups, in_bytes):
    s = rb.gn_stats_plan(b, t, c, groups, in_bytes)
    assert 1 <= s <= rb.CLUSTER_MAX and s <= t
    ranges = [(t * r // s, t * (r + 1) // s) for r in range(s)]  # as the kernel splits T
    assert ranges[0][0] == 0 and ranges[-1][1] == t
    assert all(lo < hi and hi == ranges[i + 1][0] if i + 1 < s else lo < hi
               for i, (lo, hi) in enumerate(ranges))
    # the grid nearest one block an SM, within the caps: the portable
    # cluster size, T, and one full pass of a block's threads over its units
    cg = c // groups
    vw = 16 // in_bytes if cg % (16 // in_bytes) == 0 else 1
    cap = max(1, min(rb.CLUSTER_MAX, t, t * cg // vw // rb.GN_THREADS))
    assert s == min(range(1, cap + 1), key=lambda k: (abs(b * groups * k - rb.SMS), -k))
    assert s == 1 or t * cg // vw // s >= rb.GN_THREADS


# the distillation teacher's guided forward: 2B = 32 rows at every flagship GroupNorm
DISTILL_PLAN_SHAPES = [(chip_smoke.DISTILL_ROWS, t, c) for t, c in FLAGSHIP_TC]


@pytest.mark.parametrize("in_bytes", [2, 4])
@pytest.mark.parametrize("groups", [8, 4, 2, 1])
@pytest.mark.parametrize("b,t,c", DISTILL_PLAN_SHAPES)
def test_gn_stats_plan_at_the_distill_teachers_rows(b, t, c, groups, in_bytes):
    assert b == 32
    test_gn_stats_plan(b, t, c, groups, in_bytes)


def _walk(tid: int, v_per_frame: int, nf: int, threads: int):
    """The (frame, vector) units one thread of gn_stats visits, stepped as
    the kernel steps them (no division per element)."""
    df, dv = threads // v_per_frame, threads % v_per_frame
    f, v = tid // v_per_frame, tid % v_per_frame
    out = []
    while f < nf:
        out.append((f, v))
        f, v = f + df, v + dv
        if v >= v_per_frame:
            f, v = f + 1, v - v_per_frame
    return out


@pytest.mark.parametrize("v_per_frame", [1, 4, 5, 8, 32, 64, 512, 1024, 1536])
@pytest.mark.parametrize("nf", [1, 3, 97])
def test_gn_stats_walk_visits_every_unit_once(v_per_frame, nf):
    threads = 64 if v_per_frame in (1, 4, 5) else rb.GN_THREADS  # a few steps a thread
    seen = [u for tid in range(threads) for u in _walk(tid, v_per_frame, nf, threads)]
    assert sorted(seen) == [(f, v) for f in range(nf) for v in range(v_per_frame)]


# ---------------------------------------------------------------- gn_bwd blocks

GB_THREADS, TT = 256, 64


def _window(c0, cb, cg):  # resblock_bwd.cu gn_bwd_window
    return ((c0 + cb - 1) // cg - c0 // cg + 1) * cg


def emulate_gn_bwd(dy, pre, mean, rstd, gamma, pieces, extra=None, film_scale=None, z1=None):
    """gn_bwd as its blocks compute it: grid (nT, ceil(C / CB), B), a last
    block holding fewer channels where CB does not divide C, each channel's
    own group's statistics and means."""
    b_, t, c = dy.shape
    groups = mean.shape[1]
    cg, nt = c // groups, rg.n_tiles(t)
    cb_plan = rg.gn_bwd_plan(c, groups)
    rp = GB_THREADS // (cb_plan // 4)  # frames at a time: 4 channels a thread
    out = torch.full_like(dy, float("nan"))
    part = torch.full((3, b_, nt, c), float("nan")) if film_scale is not None else None
    for b in range(b_):
        for c0 in range(0, c, cb_plan):
            cb = min(cb_plan, c - c0)
            g_lo, w = c0 // cg, _window(c0, cb, cg)
            w0, ngr = g_lo * cg, w // cg
            ns = 1 if w >= GB_THREADS else GB_THREADS // w
            acc = torch.zeros(2, ns, w)
            for sl in range(ns):
                for k in range(nt * sl // ns, nt * (sl + 1) // ns):
                    e = pieces[:, :, b, k, w0:w0 + w]
                    acc[:, sl] += e[:, 0] + e[:, 1]
            a = torch.zeros(2, w)
            for sl in range(ns):
                a += acc[:, sl]
            mm = (a * gamma[w0:w0 + w]).view(2, ngr, cg).sum(-1) / (t * cg)
            gi = torch.arange(c0, c0 + cb) // cg
            mu, rs = mean[b, gi], rstd[b, gi]
            m1, m2 = mm[0, gi - g_lo], mm[1, gi - g_lo]
            ga = gamma[c0:c0 + cb]
            for tile in range(nt):
                rows = torch.arange(tile * TT, min(tile * TT + TT, t))
                xh = (pre[b, rows, c0:c0 + cb].float() - mu) * rs
                d = rs * (dy[b, rows, c0:c0 + cb] * ga - m1 - xh * m2)
                if extra is not None:
                    d = d + extra[b, rows, c0:c0 + cb]
                if film_scale is None:
                    out[b, rows, c0:c0 + cb] = d
                    continue
                dz = d * (1 + film_scale[b, c0:c0 + cb])
                out[b, rows, c0:c0 + cb] = dz
                # each thread's frames r0, r0 + rp, ... then the rp rows in order
                q = torch.stack([d, d * z1[b, rows, c0:c0 + cb], dz])
                q = torch.nn.functional.pad(q, (0, 0, 0, TT - len(rows)))
                part[:, b, tile, c0:c0 + cb] = q.view(3, TT // rp, rp, cb).sum(1).sum(1)
    assert not torch.isnan(out).any() and (part is None or not torch.isnan(part).any())
    return out, part


@pytest.mark.parametrize("c", [64, 128, 192, 256, 320, 512, 1024, 2048])
def test_gn_bwd_plan(c):
    cb = rg.gn_bwd_plan(c)
    assert cb in (64, 128) and c % cb == 0 and (cb == 128 or c % 128)


@pytest.mark.parametrize("c", [16, 32, 48, 96, 144, 200])
def test_gn_bwd_plan_at_narrow_widths(c):
    """Widths off the 64-channel block: 64-channel blocks, the last one
    partial; C/G not a multiple of 4 never takes a 128-channel block."""
    groups = 8
    cb = rg.gn_bwd_plan(c, groups)
    assert cb == 64 and -(-c // cb) * cb >= c
    assert rg.gn_bwd_plan(256, 8) == 128 and rg.gn_bwd_plan(256, 128) == 64  # C/G 2


@pytest.mark.parametrize("b,t,c,groups", [
    (2, 37, 128, 8), (1, 130, 192, 8), (2, 64, 256, 8), (1, 70, 2048, 1), (1, 65, 2048, 8),
    (2, 5, 320, 4), (1, 129, 512, 2),
    # the narrow bases' widths: C/G 2, 4, 6, 12 and last blocks of 16 to 48
    (2, 37, 16, 8), (1, 70, 32, 8), (2, 65, 48, 8), (1, 40, 96, 8), (2, 9, 144, 8),
])
@pytest.mark.parametrize("mode", ["plain", "extra", "film"])
def test_gn_bwd_block_emulation(b, t, c, groups, mode):
    """Blocks of 128 or 64 channels (C = 192, 320: 64) whose groups cross
    them, groups wider than the threads (C = 2048, G = 1), ragged and short
    buckets: the emulated blocks give the plain version's outputs."""
    pre, dy, gamma, mean, rstd, sums = _gn_bwd_case(b * t + c + groups, b, t, c, groups)
    pieces = _pieces(sums, seed=t)
    kw = {}
    if mode == "extra":
        kw = dict(extra=0.5 * dy.flip(1))
    elif mode == "film":
        kw = dict(film_scale=torch.full((b, c), -0.3), z1=pre.flip(2))
    got = emulate_gn_bwd(dy, pre, mean, rstd, gamma, pieces, **kw)
    want = rg.gn_bwd_plain(dy, pre, mean, rstd, gamma, pieces, **kw)
    for x, y in zip(got, want):
        if y is None:
            assert x is None
        else:
            assert _rel(x.numpy(), y.numpy()) <= REL
