"""Launch plan of the Hopper attention kernel (``attention_plan``) and its
split-KV rule, on the CPU.

The plan is pure Python, so it is checked here at every geometry of the
fused route (the 9 cross-attention sites at 6 s with 1, 2 and 16
conditioned rows, the CFG constant at T = S = 1, the 150 s single pass) and
at T, S in {1, 37, 1023, 1025} for a spread of head dims from 1 to 256
(``HEAD_DIMS``: every tile width, windows and per-head maps): every query row in one
block, every key tile taken by exactly one rank of the split, clusters
within the portable size, a ring of at least 3 stages, shared memory within
the card's opt-in limit and large enough for the Q tile, the ring and the
split's combine buffer, and the plan one of least modeled time.

An emulation then runs the kernel's arithmetic in PyTorch on the CPU: key
tiles of the plan's width, an online softmax per rank (scores in fp32, p =
2^(s log2(e)/sqrt(hd) - m) against the rank's running max, rounded to bf16
for P.V, l over the unrounded p), and the ranks' (m, l, O) combined in rank
order. It is held against ``attention_core_plain`` and against the JAX
package's ``attention_core_reference`` (fp32, on the same bf16 values) with
``chip_smoke.TOL["attention"]``, the tolerance the kernel meets on the card:
two bf16 ulps of the output, plus the rounding of p against a running (and
per-rank) max instead of the global one.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from lm2a_tpu.ops import pallas_attention as jpa
from lm2a_tpu_torch.core.config import ModelConfig
from lm2a_tpu_torch.ops import attention as att
from lm2a_tpu_torch.ops import resblock as rb

from _torch_port_util import one_torch_thread  # noqa: F401

HEADS = ModelConfig().attn_heads
# every tile width (16 to 256), window maps (hd off the 8-channel unit) and
# per-head maps, the head dims of base 48 and 96 (6, 12, 24, 48) and of v1 at
# its default widths (96, 192)
HEAD_DIMS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 100, 128, 136, 192, 250, 256)


def _sites(mel_t):
    return [(t, c // HEADS) for _, t, c in chip_smoke.attention_sites(ModelConfig(), mel_t)]


FLAGSHIP = sorted({(b, HEADS, t, chip_smoke.MEL_T, hd)
                   for b in (1, chip_smoke.N_CLIPS, chip_smoke.WINDOW_ROWS)
                   for t, hd in _sites(chip_smoke.MEL_T)}
                  | {(1, HEADS, 1, 1, hd) for _, hd in _sites(chip_smoke.MEL_T)}
                  | {(1, HEADS, t, chip_smoke.LONG_T, hd) for t, hd in _sites(chip_smoke.LONG_T)})
EDGE = [(1, 2, t, s, hd) for hd in HEAD_DIMS for t in (1, 37, 1023, 1025)
        for s in (1, 37, 1023, 1025)]


@pytest.mark.parametrize("b,h,t,s,hd", FLAGSHIP + EDGE,
                         ids=[f"B{c[0]}-H{c[1]}-T{c[2]}-S{c[3]}-hd{c[4]}" for c in FLAGSHIP + EDGE])
def test_attention_plan(b, h, t, s, hd):
    p = att.attention_plan(b, h, t, s, hd)
    assert p.rows == att.BM == 128
    assert p.mtiles * p.rows >= t > (p.mtiles - 1) * p.rows  # every query row once
    assert p.bn in att.KEY_TILES and p.tiles == math.ceil(s / p.bn)
    assert 1 <= p.split <= min(rb.SPLIT_MAX, p.tiles) and rb.SPLIT_MAX <= rb.CLUSTER_MAX
    ranges = rb.k_ranges(p.tiles, p.split)  # the kernel's tiles * rank // split
    assert [j for beg, end in ranges for j in range(beg, end)] == list(range(p.tiles))
    assert all(end > beg for beg, end in ranges)  # no rank without keys
    # only the last tile may be ragged, and it holds at least one key
    assert (p.tiles - 1) * p.bn < s <= p.tiles * p.bn
    assert att.MIN_STAGES <= p.stages <= att.MAX_STAGES
    # Q and K tiles hold the head from its offset in the window; V and O
    # parts of at most 128 channels cover the head
    hoff = max((i * hd) % 8 for i in range(h)) if hd % 8 else 0
    assert p.hdq in att.TILE_CHANNELS and p.hdq >= hd + hoff
    assert p.hdq == min(c for c in att.TILE_CHANNELS if c >= hd + hoff)
    hdv = min(p.hdq, 128)
    assert p.vparts * hdv >= hd and p.vparts == -(-p.hdq // hdv)
    assert p.hdq <= 128 or p.bn == 64  # S, P, Q and O in the consumers' registers
    rows = p.rows + att.MAX_SPLIT  # split * ceil(128 / split) rows at most
    need = p.rows * p.hdq * 2 + max(p.stages * p.bn * (p.hdq + hdv) * 2,
                                    (rows * (hdv + 4 + 2) + p.rows // 2 * (att.MAX_SPLIT + 1)) * 4)
    assert need + att._ALIGN <= p.smem <= rb.SMEM_MAX
    cands = att.attention_candidates(b, h, t, s, hd)
    best = min(c for c, _ in cands)
    assert any(q == p and c == best for c, q in cands)
    assert p.blocks(b, h) == p.split * p.mtiles * h * p.vparts * b


# head dims whose tile passes 256 channels: the kernel's chunked form (above
# 256, and 251-255 at a window offset with 8 heads)
WIDE = [(h, hd) for hd in (257, 300, 320, 384, 512, 1000) for h in (1, 2, 8)] \
    + [(8, hd) for hd in range(249, 256)]


@pytest.mark.parametrize("h,hd", WIDE, ids=[f"H{h}-hd{hd}" for h, hd in WIDE])
@pytest.mark.parametrize("t,s", [(1, 1), (37, 1025), (129, 516)])
def test_attention_plan_chunked(h, hd, t, s):
    """The chunked form: Q and K tiles of a multiple of CHUNK channels that
    hold the head from its window offset, one V part of CHUNK channels per
    chunk, 64-key tiles, no split, a ring of (Q chunk, K chunk) stages that
    fits the card; every head dim up to 256 keeps its form."""
    p = att.attention_plan(2, h, t, s, hd)
    hoff = max((i * hd) % 8 for i in range(h)) if hd % 8 else 0
    need = hd + hoff
    assert att.chunked(p.hdq) == (need > 256)
    if need <= 256:
        assert p.hdq in att.TILE_CHANNELS
        return
    assert p.hdq % att.CHUNK == 0 and p.hdq - att.CHUNK < need <= p.hdq
    assert p.vparts == p.hdq // att.CHUNK and p.bn == 64 and p.split == 1
    assert p.tiles == math.ceil(s / 64) and p.mtiles == math.ceil(t / att.BM)
    assert att.MIN_STAGES <= p.stages <= att.MAX_STAGES
    assert p.smem == att._ALIGN + p.stages * (att.BM + 64) * att.CHUNK * 2 <= rb.SMEM_MAX
    assert att.attention_smem(p.hdq, 64, p.stages + 1) > rb.SMEM_MAX  # the deepest ring


def test_attention_plan_splits_the_small_6s_grids():
    """At 6 s two clips' conditioned rows give 16-80 blocks without a split;
    the plan splits the keys where that leaves most SMs idle."""
    for t, hd in _sites(chip_smoke.MEL_T):
        p = att.attention_plan(chip_smoke.N_CLIPS, HEADS, t, chip_smoke.MEL_T, hd)
        if p.mtiles * HEADS * chip_smoke.N_CLIPS * 2 <= rb.SMS:
            assert p.split > 1, (t, hd, p)


# ---------------------------------------------------------------- emulation

LOG2E = 1.4426950408889634


def emulate_attention(q, k, v, plan):
    """The kernel's arithmetic on fp32 tensors holding bf16 values: per rank
    of the split an online softmax over key tiles of ``plan.bn``, then the
    ranks combined in rank order; bf16 out."""
    hd, s = q.shape[-1], k.shape[2]
    scale = torch.tensor(LOG2E, dtype=torch.float32) / torch.sqrt(torch.tensor(float(hd)))
    parts = []
    for beg, end in rb.k_ranges(plan.tiles, plan.split):
        m = torch.full(q.shape[:-1], -math.inf)
        l = torch.zeros(q.shape[:-1])
        o = torch.zeros(q.shape)
        for j in range(beg, end):
            keys = slice(j * plan.bn, min((j + 1) * plan.bn, s))  # the masked keys give p = 0
            sc = q @ k[:, :, keys].transpose(-1, -2)
            mx = torch.maximum(m, sc.amax(-1))
            corr = torch.exp2((m - mx) * scale)
            p = torch.exp2(sc * scale - (mx * scale)[..., None])
            l = l * corr + p.sum(-1)
            o = o * corr[..., None] + p.to(torch.bfloat16).float() @ v[:, :, keys]
            m = mx
        parts.append((m * scale, l, o))
    mmax = torch.stack([pm for pm, _, _ in parts]).amax(0)
    acc, lsum = torch.zeros(q.shape), torch.zeros(q.shape[:-1])
    for pm, pl, po in parts:  # rank order
        w = torch.exp2(pm - mmax)
        acc = acc + w[..., None] * po
        lsum = lsum + w * pl
    return (acc / lsum[..., None]).to(torch.bfloat16)


def _plans(b, h, t, s, hd):
    """The default plan and, per key tile, no split, a split of 2 and the
    largest split the tiles allow."""
    out = {att.attention_plan(b, h, t, s, hd)}
    for _, p in att.attention_candidates(b, h, t, s, hd):
        if p.split in (1, 2, min(rb.SPLIT_MAX, p.tiles)):
            out.add(p)
    return sorted(out, key=lambda p: (p.bn, p.split))


@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("t,s", [(1, 1), (37, 1023), (1025, 37), (100, 1025)])
def test_split_kv_emulation(hd, t, s):
    rng = np.random.default_rng(hd * 7 + t + s)
    b, h = 1, 2
    q, k, v = (torch.tensor(rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)
               for shape in ((b, h, t, hd), (b, h, s, hd), (b, h, s, hd)))
    plain = att.attention_core_plain(q, k, v)
    ref = torch.tensor(np.asarray(jpa.attention_core_reference(
        *(jnp.asarray(x.float().numpy()) for x in (q, k, v)))))
    tol = chip_smoke.TOL["attention"]
    plans = _plans(b, h, t, s, hd)
    assert any(p.split > 1 for p in plans) == (s > 64)
    for plan in plans:
        got = emulate_attention(q.float(), k.float(), v.float(), plan).float()
        torch.testing.assert_close(got, plain.float(), **tol)
        torch.testing.assert_close(got, ref, **tol)
