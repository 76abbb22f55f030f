"""The port's CUDA kernels against their plain PyTorch versions, on the card.

A CUDA kernel has no CPU mode, so every test here needs an NVIDIA GPU and
skips without one. On a machine with a card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q

(``--noconftest`` because ``tests/conftest.py`` sets up JAX, which these
tests do not use.) ``chip_smoke.py`` holds the kernels at the flagship
geometries; these take the edges it does not reach: ragged and short time
tiles, T below the sandwich's halo, fp32 sandwich inputs, every epilogue of
``conv3_fused`` the chain uses, the attention kernel at head dims from 1
to 256 (``HEAD_DIMS``: every tile width, window and per-head maps, V in
two parts above 128) and above (``WIDE_HEAD_DIMS``: the chunked form), T = S = 1, S around the JAX package's streaming threshold, ragged T
and S, strided views and batches up to 16; the resblock backward kernels at
T of 1, 2, 3 and off the 64-frame tile, C/G = 16, the 2048-channel concat
input, with and without the skip, one by one and as a whole block, and
through the autograd Function; the Adan+EMA kernel on leaves of 1 and of
odd sizes, fp32 and bf16 state, clipping on and off, a zero gradient with
clipping on; the wrappers' refusals and their launch counts. For the Hopper
designs of ``conv3_fused`` and ``conv3_wgrad`` (wgmma, cp.async rings, K
split over a thread-block cluster): every ``conv3_fused`` mode at 1, 2, 4
and 16 rows with M tiles that straddle batch rows, K chunks that do not
divide by the cluster split, ``conv3_wgrad`` with one and three taps, with
and without the bias, raw and GN+SiLU operands, B*T off the 64-frame chunk,
and both kernels giving the same bits on two launches. For the Hopper
designs of the attention kernel (wgmma, a TMA-fed K/V ring, split-KV over a
cluster) and of ``conv3_dgrad`` (the wgmma main loop over flattened rows):
every head dim at ragged T and S under split and unsplit plans forced
through the plan function, ``conv3_dgrad`` with 3 taps (pre bf16, fp32) and
1 tap raw under every plan at T = 1, 37, 65, 300 with M tiles across batch
rows, both giving the same bits on two launches, and their refusals. For
the Hopper designs of ``gn_stats`` (T split over a cluster) and ``gn_bwd``
(cp.async-staged tiles, the group means from conv3_dgrad's head and tail
pieces): T = 1 to 12920, C/G from 5 to 2048 channels, every cluster size,
a misaligned input, channel blocks that groups cross, plain, extra and FiLM
modes, bf16 and fp32, the same bits twice; for the Hopper design of the
snake sandwich (runs of 8 outputs a lane, overlapping warp tiles, one wave
of blocks striding over the tiles): T at the edges of a run and of a warp
tile, both layouts, bf16 and fp32, one block and one tile a warp, 1-16
warps a block, a view one frame off the 16-byte grid, a steep snake (large
|alpha y|, small beta), log-scale parameters raw and exponentiated, the
plan's resident blocks against the occupancy calculator, ``SnakeAlias``
launching no ``exp``, the same bits twice; and every C entry's refusal of
a launch plan that is not its own (``conv3_fused``, ``conv3_wgrad``,
``gn_stats``, ``gn_bwd``, the sandwich), with nothing launched. The folded
cross-attention core (``ops/fold_core.py``, one launch over both branches'
2H heads) against ``fold_core_plain`` at the flagship's sites at 1 and 8
rows, T = S = 1, S past 1024, a tensor-parallel rank's 1 and 3 heads, v1's
hd 96 and 192, windows, padded rows and the chunked form, the same bits as
the attention kernel over stacked K and V where the plans agree; the whole
bf16 folded ``CrossAttentionFusion`` on the card against the CPU's; a
captured flagship step's 18 ``fold_core`` launches. For the
compiled steps (CUDA graph replays): a cached DDIM chain (the default
attention route) and a cached DDPM chain (the fused route) at base width 64,
and two calls of K = 2 device-resident train steps at base width 128,
against the same steps run eagerly (the same bits and launches); a capture
in which a wrapper refuses its plan raising, the step never running eagerly
instead; the training route at C/G = 8 on the backward kernels (``cli
train`` and one train and one distill step against the CPU within
``chip_smoke.ROUTE_TOL``). Narrow base widths: every block of base widths
16, 32, 48 and 96 (C/G 2, 4, 6, 12; K chunks and N tiles narrower than the
kernels' 64) through ``gn_stats``, ``conv3_fused``, ``conv3_dgrad``,
``conv3_wgrad`` and ``gn_bwd`` against their plain versions, attention at
head dims 2 to 192, a base-32 fused-attention forward and
chain, one ``cli train --fused_resblock_grad`` step at base width 32
against the CPU; the masked forms at every block of base widths 12 and 20 and
at an odd width (Cin 21, Cout 42), against their plain versions; v1 (its
default head dims at a quarter of its width): two train steps against the
CPU within ``chip_smoke.ROUTE_TOL``, and K = 2 device-data steps as graph
replays against the same steps eager. ``conv3_fused``'s partial form
(tensor parallelism's row-parallel conv 2) on each rank's shard of a
flagship conv 2, an odd width and groups that straddle ranks, with each
epilogue, against its plain version and summed over the ranks against the
whole conv 2.

Tolerances are those of ``chip_smoke.py``: 1e-2 absolute + relative on bf16
outputs (one bf16 ulp, where the kernel's and torch's SiLU round an operand
to neighbouring bf16 values), 3e-2 on a whole chain; GroupNorm statistics
1e-4 / 1e-3; the fp32 sandwich 1e-5 (fp32 sums in another order, and
the MUFU sine within ~2^-21 of the plain version's), a steep fp32 snake
``STEEP_F32_TOL`` (its reason there); the
attention kernel ``chip_smoke.TOL["attention"]`` (bf16 output: two ulps, and
the p rounding of the running max against the global one); the training
kernels ``chip_smoke.TOL_REL_L2`` (relative L2) and ``TOL["adan_ema"]``, each
with its reason there.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from lm2a_tpu_torch.ops import _build
from lm2a_tpu_torch.ops import attention as att
from lm2a_tpu_torch.ops import resblock as rb
from lm2a_tpu_torch.vocoder import sandwich as sw

pytestmark = pytest.mark.cuda

TOL = dict(chip_smoke.TOL, snake_sandwich_f32=dict(atol=1e-5, rtol=1e-5))
# fp32 card against fp32 host, relative L2: the same products summed in
# another order by cuDNN, cuBLAS and the CPU's kernels (TF32 off)
FP32_REL = 1e-5
# the attention kernel's head dims under test: every tile width (16 to 256),
# window maps (hd off the 8-channel unit: 1-6, 12, 100, 250) and per-head
# maps, base 48's and 96's 6, 12, 24, 48 and v1's 96 and 192
HEAD_DIMS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 100, 128, 136, 192, 250, 256)
# the chunked form (tiles past 256 channels): per-head maps above 256 and
# windows at 257 and 249-255 with 8 heads, where the head's offset in its
# 8-channel unit takes the tile past 256
WIDE_HEAD_DIMS = [(4, hd) for hd in (320, 384, 512)] + [(8, hd) for hd in range(249, 258)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, tol):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        torch.testing.assert_close(g.float(), w.float(), **tol)


@pytest.mark.parametrize("rows", [2, 4])  # one clip or two, each doubled by CFG
@pytest.mark.parametrize("t", [1, 37, 64, 65, 300])
@pytest.mark.parametrize("cin,cout,add_residual", [
    (128, 128, True),    # identity residual in the conv-2 epilogue
    (128, 128, False),   # attention block: h alone
    (256, 128, True),    # 1x1 skip GEMM summed in the epilogue
    (256, 128, False),   # attention block with skip: (h, xs)
])
def test_chain_matches_plain(dev, rows, t, cin, cout, add_residual):
    gen = torch.Generator().manual_seed(t + cin + cout)
    w, x, (fs, fh) = chip_smoke.random_chain(gen, rows, t, cin, cout, cin != cout, dev)
    _build.reset_launches()
    got = rb.fused_resblock_chain(x, w, fs, fh, add_residual=add_residual)
    torch.cuda.synchronize()
    assert _build.LAUNCHES == {"gn_stats": 2, "conv3_fused": 2}
    _close(got, rb.resblock_chain_plain(x, w, fs, fh, add_residual=add_residual),
           TOL["chain"])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t", [1, 37, 516])
def test_gn_stats_matches_plain(dev, dtype, t):
    gen = torch.Generator().manual_seed(t)
    x = (1.5 * torch.randn((2, t, 256), generator=gen) + 0.3).to(dev, dtype)
    _close(rb.gn_stats(x, 8), rb.gn_stats_plain(x, 8), TOL["gn_stats"])


@pytest.mark.parametrize("t", [5, 64, 129])
def test_conv3_each_epilogue(dev, t):
    gen = torch.Generator().manual_seed(t)
    w, x, film = chip_smoke.random_chain(gen, 2, t, 256, 128, True, dev)
    m1, r1 = rb.gn_stats(x, w.groups1)
    args1 = (x, m1, r1, w.gn1_scale, w.gn1_bias, w.conv1_w, w.conv1_b)
    # save_pre: the training forward's (f, z1), z1 the conv before FiLM
    for kw in (dict(film=film), dict(), dict(film=film, save_pre=True), dict(save_pre=True)):
        _close(rb.conv3_fused(*args1, **kw), rb.conv3_fused_plain(*args1, **kw),
               TOL["conv3_fused"])
    f = rb.conv3_fused(*args1, film=film)
    m2, r2 = rb.gn_stats(f, w.groups2)
    args2 = (f, m2, r2, w.gn2_scale, w.gn2_bias, w.conv2_w, w.conv2_b)
    res = torch.randn((2, t, 128), generator=gen).to(dev, torch.bfloat16)
    for kw in (dict(skip=(x, w.skip_w, w.skip_b)),
               dict(skip=(x, w.skip_w, w.skip_b), split_skip=True),
               dict(residual=res), dict()):
        kw["out_dtype"] = torch.bfloat16
        _close(rb.conv3_fused(*args2, **kw), rb.conv3_fused_plain(*args2, **kw),
               TOL["conv3_fused"])


def test_conv3_refuses_what_it_cannot_take(dev):
    gen = torch.Generator().manual_seed(0)
    w, x, film = chip_smoke.random_chain(gen, 1, 8, 128, 128, False, dev)
    m, r = rb.gn_stats(x, w.groups1)
    args = (m, r, w.gn1_scale, w.gn1_bias)
    _build.reset_launches()
    with pytest.raises(ValueError, match="bf16 weights"):
        rb.conv3_fused(x, *args, w.conv1_w.float(), w.conv1_b, film=film)
    with pytest.raises(ValueError, match="contiguous"):
        rb.conv3_fused(x[:, ::2], *args, w.conv1_w, w.conv1_b)
    with pytest.raises(ValueError, match="bias"):
        rb.conv3_fused(x, *args, w.conv1_w, w.conv1_b.cpu())
    with pytest.raises(ValueError, match="bf16 -> fp32"):  # only the chain's two pairs
        rb.conv3_fused(x, *args, w.conv1_w, w.conv1_b, out_dtype=torch.bfloat16)
    assert not _build.LAUNCHES


@pytest.mark.parametrize("t", [1, 5, 2047, 2048, 2049, 4100])
@pytest.mark.parametrize("layout", ["channels_first", "channels_last"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_sandwich_matches_plain(dev, t, layout, dtype):
    gen = torch.Generator().manual_seed(t)
    c = 24
    if layout == "channels_first":  # as the vocoder passes it: a (B, T, C) view
        x = torch.randn((2, c, t), generator=gen).to(dev, dtype).transpose(1, 2)
    else:
        x = torch.randn((2, t, c), generator=gen).to(dev, dtype)
    alpha = torch.exp(0.3 * torch.randn(c, generator=gen)).to(dev)
    beta = torch.exp(0.3 * torch.randn(c, generator=gen)).to(dev)
    _build.reset_launches()
    got = sw.snake_sandwich(x, alpha, beta)
    torch.cuda.synchronize()
    assert _build.LAUNCHES == {"snake_sandwich": 1}
    assert got.stride() == x.stride()
    tol = TOL["snake_sandwich" if dtype == torch.bfloat16 else "snake_sandwich_f32"]
    _close(got, sw.snake_sandwich_plain(x, alpha, beta), tol)


# ---------------------------------------------------------------- Hopper sandwich redesign

# fp32 sandwich where the snake is steep: alpha = e^2, inputs x8 (|alpha y| to
# ~300) and beta = e^-3. The snake's slope 1 + alpha sin(2 alpha y) / beta
# reaches ~150, so the few-ulp difference of y between the kernel's FMA chain
# and the plain version's rounded products (|y| <= ~40: ~1e-5) becomes ~2e-3
# of z; 4e-3 absolute holds that with a margin of 2, rtol as the fp32 sandwich.
STEEP_F32_TOL = dict(atol=4e-3, rtol=1e-5)


def _forced_sandwich_plan(warps, blocks):
    """A plan function giving ``warps`` a block on ``blocks`` blocks (at
    most one per ``warps`` tiles), as the kernel takes it."""
    return lambda b, t, c, dtype, strides: sw.plan_for(b, t, c, warps, blocks)


def _sandwich_inputs(dev, b, t, c, dtype, layout, seed, scale=1.0, log_alpha=None,
                     log_beta=None):
    gen = torch.Generator().manual_seed(seed)
    if layout == "channels_first":  # as the vocoder passes it: a (B, T, C) view
        x = (scale * torch.randn((b, c, t), generator=gen)).to(dev, dtype).transpose(1, 2)
    else:
        x = (scale * torch.randn((b, t, c), generator=gen)).to(dev, dtype)
    la = (0.3 * torch.randn(c, generator=gen) if log_alpha is None
          else torch.full((c,), float(log_alpha)))
    lb = (0.3 * torch.randn(c, generator=gen) if log_beta is None
          else torch.full((c,), float(log_beta)))
    return x, la.to(dev), lb.to(dev)


@pytest.mark.parametrize("blocks", [1, 1 << 30])
@pytest.mark.parametrize("t", [1, 2, 3, 7, 8, 9, 15, 16, 17, 239, 240, 241, 479, 480, 481, 961])
@pytest.mark.parametrize("layout", ["channels_first", "channels_last"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_sandwich_run_and_tile_edges(dev, monkeypatch, blocks, t, layout, dtype):
    """T at the edges of a lane's run of 8 and of a warp tile (30 stored
    runs: 240 outputs), rows of 3 channels so that warp tiles cross rows,
    on one block (its 4 warps stride over every tile) and on one tile a
    warp, both layouts; the same bits from two launches."""
    monkeypatch.setattr(sw, "sandwich_plan", _forced_sandwich_plan(4, blocks))
    x, la, lb = _sandwich_inputs(dev, 2, t, 3, dtype, layout, seed=t + blocks % 7)
    alpha, beta = la.exp(), lb.exp()
    _build.reset_launches()
    got = sw.snake_sandwich(x, alpha, beta)
    torch.cuda.synchronize()
    assert _build.LAUNCHES == {"snake_sandwich": 1}
    assert got.stride() == x.stride()
    tol = TOL["snake_sandwich" if dtype == torch.bfloat16 else "snake_sandwich_f32"]
    _close(got, sw.snake_sandwich_plain(x, alpha, beta), tol)
    assert torch.equal(got, sw.snake_sandwich(x, alpha, beta))


@pytest.mark.parametrize("blocks", [1, 7, 1 << 30])
@pytest.mark.parametrize("warps", [1, 4, 16])
def test_sandwich_every_block_shape(dev, monkeypatch, warps, blocks):
    """1, 4 and 16 warps a block on 1 block, 7 blocks (the warps stride over
    many tiles, loading each next one ahead) and one tile a warp, at a
    vocoder geometry (T = 2064, 64 channels), bf16; the same bits twice."""
    monkeypatch.setattr(sw, "sandwich_plan", _forced_sandwich_plan(warps, blocks))
    x, la, lb = _sandwich_inputs(dev, 1, 2064, 64, torch.bfloat16, "channels_first", seed=warps)
    got = sw.snake_sandwich(x, la, lb, logscale=True)
    _close(got, sw.snake_sandwich_plain(x, la, lb, logscale=True), TOL["snake_sandwich"])
    assert torch.equal(got, sw.snake_sandwich(x, la, lb, logscale=True))


@pytest.mark.parametrize("warps", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_sandwich_resident_blocks_match_the_card(dev, dtype, warps):
    """The plan's table of resident warps gives the blocks an SM holds, as
    the CUDA occupancy calculator finds them for the built kernel."""
    assert sw.blocks_per_sm(warps) == sw.blocks_per_sm_on_card(dtype, warps)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t", [16, 37, 512])
def test_sandwich_misaligned_view(dev, t, dtype):
    """A channels-first view that starts one frame into its buffer: every
    row off the 16-byte grid, so the kernel takes scalar loads and still
    stores its (aligned) output by vectors."""
    b, c = 2, 5
    gen = torch.Generator().manual_seed(t)
    flat = torch.randn(b * c * t + 1, generator=gen).to(dev, dtype)
    x = flat[1:].view(b, c, t).transpose(1, 2)
    assert x.data_ptr() % 16 != 0
    alpha = torch.exp(0.3 * torch.randn(c, generator=gen)).to(dev)
    beta = torch.exp(0.3 * torch.randn(c, generator=gen)).to(dev)
    got = sw.snake_sandwich(x, alpha, beta)
    tol = TOL["snake_sandwich" if dtype == torch.bfloat16 else "snake_sandwich_f32"]
    _close(got, sw.snake_sandwich_plain(x, alpha, beta), tol)
    assert torch.equal(got, sw.snake_sandwich(x, alpha, beta))


@pytest.mark.parametrize("logscale", [False, True])
@pytest.mark.parametrize("layout", ["channels_first", "channels_last"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_sandwich_steep_snake(dev, dtype, layout, logscale):
    """Large |alpha y| (alpha = e^2, inputs x8: the sine's argument is
    reduced over ~50 periods) and a small beta (e^-3), with the parameters
    raw (logscale) or exponentiated; bf16 under ``TOL``, fp32 under
    ``STEEP_F32_TOL`` (its reason above)."""
    x, la, lb = _sandwich_inputs(dev, 2, 2064, 24, dtype, layout, seed=11, scale=8.0,
                                 log_alpha=2.0, log_beta=-3.0)
    a, b = (la, lb) if logscale else (la.exp(), lb.exp())
    got = sw.snake_sandwich(x, a, b, logscale=logscale)
    tol = TOL["snake_sandwich"] if dtype == torch.bfloat16 else STEEP_F32_TOL
    _close(got, sw.snake_sandwich_plain(x, a, b, logscale=logscale), tol)
    assert torch.equal(got, sw.snake_sandwich(x, a, b, logscale=logscale))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t", [5, 2064])
def test_sandwich_logscale_on_and_off(dev, t, dtype):
    """Raw log-scale parameters with ``logscale=True`` against their
    exponentials with it off: the kernel's expf and torch.exp agree to an
    ulp, so the two launches agree under the sandwich's tolerance, and each
    matches the plain version."""
    x, la, lb = _sandwich_inputs(dev, 2, t, 24, dtype, "channels_first", seed=t)
    tol = TOL["snake_sandwich" if dtype == torch.bfloat16 else "snake_sandwich_f32"]
    _build.reset_launches()
    raw = sw.snake_sandwich(x, la, lb, logscale=True)
    done = sw.snake_sandwich(x, la.exp(), lb.exp())
    torch.cuda.synchronize()
    assert _build.LAUNCHES == {"snake_sandwich": 2}
    _close(raw, sw.snake_sandwich_plain(x, la, lb, logscale=True), tol)
    _close(done, sw.snake_sandwich_plain(x, la.exp(), lb.exp()), tol)
    _close(raw, done, tol)


def test_sandwich_refuses_a_plan_it_does_not_take(dev, monkeypatch):
    """Runs other than 8, warps outside 1..16, no blocks, a block
    with no tile, and a count of tiles a warp that is not the grid's are
    refused before any launch."""
    x, la, lb = _sandwich_inputs(dev, 1, 300, 24, torch.bfloat16, "channels_first", seed=3)
    good = sw.sandwich_plan(1, 300, 24, x.dtype, x.stride())
    n = sw.sandwich_tiles(1, 300, 24)
    bad = [dataclasses.replace(good, run=16), dataclasses.replace(good, run=4),
           dataclasses.replace(good, warps=0), dataclasses.replace(good, warps=17),
           dataclasses.replace(good, blocks=0),
           dataclasses.replace(good, blocks=-(-n // good.warps) + 1),  # a block with no tile
           dataclasses.replace(good, tiles=good.tiles + 1),
           dataclasses.replace(good, tiles=good.tiles - 1)]
    _build.reset_launches()
    for p in bad:
        monkeypatch.setattr(sw, "sandwich_plan", lambda *a, p=p: p)
        with pytest.raises(RuntimeError, match="launch plan"):
            sw.snake_sandwich(x, la, lb, logscale=True)
    assert not _build.LAUNCHES


def test_snake_alias_launches_no_exp(dev, monkeypatch):
    """The vocoder's activation passes its raw log-scale parameters to the
    kernel: one launch, no torch.exp."""
    from lm2a_tpu_torch.vocoder.bigvgan import SnakeAlias

    mod = SnakeAlias(24).to(dev)
    with torch.no_grad():
        mod.alpha.copy_(0.2 * torch.arange(24, device=dev) / 24)
        mod.beta.copy_(-0.1 * torch.arange(24, device=dev) / 24)
    x = torch.randn((2, 24, 300), device=dev, dtype=torch.bfloat16)
    calls = []
    real_exp = torch.exp
    monkeypatch.setattr(torch, "exp", lambda *a, **k: calls.append(1) or real_exp(*a, **k))
    _build.reset_launches()
    got = mod(x)
    torch.cuda.synchronize()
    assert not calls and _build.LAUNCHES == {"snake_sandwich": 1}
    monkeypatch.undo()
    want = sw.snake_sandwich_plain(x.transpose(1, 2), mod.alpha.exp(), mod.beta.exp())
    _close(got, want.transpose(1, 2), TOL["snake_sandwich"])


def _attn_inputs(dev, b, h, t, s, hd, seed, layout="projections"):
    """bf16 q (B, H, T, hd) and k, v (B, H, S, hd); "projections" gives the
    strided views the model passes (heads split off channels-last (B, T, E))."""
    gen = torch.Generator().manual_seed(seed)

    def make(n):
        if layout == "projections":
            return (torch.randn((b, n, h * hd), generator=gen).to(dev, torch.bfloat16)
                    .view(b, n, h, hd).transpose(1, 2))
        return torch.randn((b, h, n, hd), generator=gen).to(dev, torch.bfloat16)

    return make(t), make(s), make(s)


@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("t,s", [(1, 1), (64, 64), (129, 516), (37, 300)])
def test_attention_matches_plain(dev, hd, t, s):
    h = 4 if hd % 8 == 0 else 8  # windows: H*hd rows on the 16-byte unit
    q, k, v = _attn_inputs(dev, 2, h, t, s, hd, seed=hd + t + s)
    _build.reset_launches()
    got = att.attention_core(q, k, v)
    torch.cuda.synchronize()
    assert _build.LAUNCHES == {"attention": 1}
    assert got.shape == q.shape and got.transpose(1, 2).is_contiguous()
    _close(got, att.attention_core_plain(q, k, v), TOL["attention"])


@pytest.mark.parametrize("s", [1023, 1024, 1025])
def test_attention_around_the_streaming_threshold(dev, s):
    q, k, v = _attn_inputs(dev, 1, 8, 200, s, 32, seed=s)
    _close(att.attention_core(q, k, v), att.attention_core_plain(q, k, v), TOL["attention"])


@pytest.mark.parametrize("b,t,s,hd", [(16, 516, 516, 32), (16, 64, 516, 128), (3, 1615, 2000, 64)])
@pytest.mark.parametrize("layout", ["projections", "contiguous"])
def test_attention_batches_and_layouts(dev, b, t, s, hd, layout):
    q, k, v = _attn_inputs(dev, b, 8, t, s, hd, seed=b + t, layout=layout)
    _close(att.attention_core(q, k, v), att.attention_core_plain(q, k, v), TOL["attention"])


@pytest.mark.parametrize("h,hd", WIDE_HEAD_DIMS, ids=[f"H{h}-hd{hd}" for h, hd in WIDE_HEAD_DIMS])
@pytest.mark.parametrize("t,s", [(1, 1), (65, 129), (129, 516), (300, 1025)])
def test_attention_wide_head_dims_match_plain(dev, h, hd, t, s):
    """Head dims whose tile passes 256 channels (the chunked form), ragged T
    and S, one launch, the same bits from two launches."""
    q, k, v = _attn_inputs(dev, 2, h, t, s, hd, seed=hd + t + s)
    _build.reset_launches()
    got = att.attention_core(q, k, v)
    torch.cuda.synchronize()
    assert _build.LAUNCHES == {"attention": 1}
    _close(got, att.attention_core_plain(q, k, v), TOL["attention"])
    assert torch.equal(got, att.attention_core(q, k, v))


def test_attention_refuses_what_it_cannot_take(dev):
    q, k, v = _attn_inputs(dev, 1, 2, 16, 16, 32, seed=0)
    _build.reset_launches()
    with pytest.raises(ValueError, match="bf16"):
        att.attention_core(q.float(), k.float(), v.float())
    q0, k0, v0 = _attn_inputs(dev, 1, 2, 16, 16, 0, seed=0)
    with pytest.raises(ValueError, match="head dim 0 below 1"):
        att.attention_core(q0, k0, v0)
    assert not _build.LAUNCHES
    # the layouts it refused before ``pad_rows``: hd at stride 2, rows of
    # H*hd = 6 channels, heads apart at hd 2; now copied into rows the
    # kernel reads, and the kernel launched on them
    q2, k2, v2 = _attn_inputs(dev, 1, 3, 16, 16, 2, seed=0)
    q4, k4, v4 = _attn_inputs(dev, 1, 4, 16, 16, 2, seed=0, layout="contiguous")
    for args in ((torch.cat([q, q], dim=-1)[..., ::2], k, v), (q2, k2, v2), (q4, k4, v4)):
        _close(att.attention_core(*args), att.attention_core_plain(*args), TOL["attention"])
    assert _build.LAUNCHES == {"attention": 3}
    _build.reset_launches()
    # what it refused before the chunked form: head dims above 256 (300 at
    # per-head maps, 253 at a window offset that takes its tile past 256)
    for h, hd in ((2, 300), (8, 253)):
        qw, kw, vw = _attn_inputs(dev, 1, h, 16, 16, hd, seed=hd)
        _close(att.attention_core(qw, kw, vw), att.attention_core_plain(qw, kw, vw),
               TOL["attention"])
    assert _build.LAUNCHES == {"attention": 2}


@pytest.mark.parametrize("h,hd", [(3, 5), (5, 3)])
@pytest.mark.parametrize("t,s", [(1, 1), (37, 129), (516, 516)])
def test_attention_rows_off_the_16_byte_unit(dev, h, hd, t, s):
    """Rows of H*hd = 15 channels (30 bytes): the wrapper pads them to 16
    channels (``pad_rows``) and launches the kernel; the output keeps its
    shape and matches the plain version on the unpadded inputs."""
    q, k, v = _attn_inputs(dev, 2, h, t, s, hd, seed=h * t + s)
    assert not att.layout_taken(q)
    _build.reset_launches()
    out = att.attention_core(q, k, v)
    assert _build.LAUNCHES == {"attention": 1} and out.shape == q.shape
    _close(out, att.attention_core_plain(q, k, v), TOL["attention"])


# ---------------------------------------------------------------- training kernels

def _rel_l2(got, want) -> float:
    got, want = got.float(), want.float()
    n = float(want.norm())
    return float((got - want).norm()) / n if n > 0 else float(got.norm())


def _bwd_inputs(dev, b, t, cin, cout, has_skip, seed):
    """A block's saved forward (through the kernels) and its output gradients."""
    from lm2a_tpu_torch.ops import resblock_grad as rg

    gen = torch.Generator().manual_seed(seed)
    w, x, (fs, fh) = chip_smoke.random_chain(gen, b, t, cin, cout, has_skip, dev)
    h, xs, saved = rg.chain_forward(x, fs, fh, w.gn1_scale, w.gn1_bias, w.conv1_w, w.conv1_b,
                                    w.gn2_scale, w.gn2_bias, w.conv2_w, w.conv2_b, w.skip_w,
                                    w.skip_b, w.groups1, w.groups2)
    gh = torch.randn(h.shape, generator=gen).to(dev, torch.bfloat16)
    gx = torch.randn(h.shape, generator=gen).to(dev, torch.bfloat16) if has_skip else None
    return w, saved, gh, gx


BWD_GEOMETRIES = [  # (B, T, Cin, Cout, skip): ragged and short T, C/G = 16, 2048 in
    (2, 1, 128, 128, False), (2, 2, 128, 128, False), (2, 3, 256, 128, True),
    (3, 37, 128, 128, False), (2, 65, 256, 128, True), (2, 130, 128, 256, True),
    (1, 5, 2048, 1024, True), (16, 64, 128, 128, False),
    # C/G = 8 (64 channels at 8 groups): base width 64's blocks
    (2, 37, 64, 64, False), (2, 65, 64, 128, True), (3, 70, 128, 64, True),
]


@pytest.mark.parametrize("b,t,cin,cout,has_skip", BWD_GEOMETRIES)
def test_resblock_backward_matches_plain(dev, b, t, cin, cout, has_skip):
    from lm2a_tpu_torch.ops import resblock_grad as rg

    w, saved, gh, gx = _bwd_inputs(dev, b, t, cin, cout, has_skip, seed=t + cin)
    args = (saved, w.gn1_scale, w.gn1_bias, w.conv1_w, w.gn2_scale, w.gn2_bias, w.conv2_w,
            w.skip_w, gh, gx)
    _build.reset_launches()
    got = rg.chain_backward(*args)
    torch.cuda.synchronize()
    assert _build.LAUNCHES == {"conv3_dgrad": 2 + has_skip, "conv3_wgrad": 2 + has_skip,
                               "gn_bwd": 2}
    want = rg.chain_backward(*args, k=rg.PLAIN)
    assert set(got) == set(want)
    for name in want:
        assert got[name].dtype == want[name].dtype and got[name].shape == want[name].shape
        assert torch.isfinite(got[name]).all(), name
        assert _rel_l2(got[name], want[name]) <= chip_smoke.TOL_REL_L2["resblock_bwd"], name


@pytest.mark.parametrize("b,t,cin,cout,has_skip", BWD_GEOMETRIES[:5] + BWD_GEOMETRIES[-3:])
def test_backward_kernels_one_by_one(dev, b, t, cin, cout, has_skip):
    """Each kernel against its plain version on the same inputs."""
    from lm2a_tpu_torch.ops import resblock_grad as rg

    w, saved, gh, gx = _bwd_inputs(dev, b, t, cin, cout, has_skip, seed=7 * t + cout)
    x, f, z1, mean1, rstd1, mean2, rstd2, sc = saved
    act2 = dict(mean=mean2, rstd=rstd2, gamma=w.gn2_scale, beta=w.gn2_bias)
    calls = [
        ("conv3_dgrad", lambda m: m(gh, w.conv2_w, taps=3, pre=f, **act2),
         rg.conv3_dgrad, rg.conv3_dgrad_plain),
        ("conv3_wgrad", lambda m: m(f, gh, taps=3, bias=True, **act2),
         rg.conv3_wgrad, rg.conv3_wgrad_plain),
    ]
    if has_skip:
        calls += [("conv3_dgrad", lambda m: m(gx, w.skip_w, taps=1), rg.conv3_dgrad,
                   rg.conv3_dgrad_plain),
                  ("conv3_wgrad", lambda m: m(x, gx, taps=1, bias=True), rg.conv3_wgrad,
                   rg.conv3_wgrad_plain)]
    for name, call, kernel, plain in calls:
        for i, (g, p) in enumerate(zip(call(kernel), call(plain))):
            if p is not None:
                if name == "conv3_dgrad" and i == 1:  # head and tail pieces, split by M tile
                    g, p = rg.bucket_sums(g), rg.bucket_sums(p)
                assert _rel_l2(g, p) <= chip_smoke.TOL_REL_L2[name], name
    d_y2, p2 = rg.conv3_dgrad_plain(gh, w.conv2_w, taps=3, pre=f, **act2)
    for film in (True, False):
        kw = dict(film_scale=sc, z1=z1, out_dtype=torch.bfloat16) if film else dict(
            out_dtype=torch.bfloat16, extra=torch.randn_like(d_y2))
        g, gp = rg.gn_bwd(d_y2, f, mean2, rstd2, w.gn2_scale, p2, **kw)
        p, pp = rg.gn_bwd_plain(d_y2, f, mean2, rstd2, w.gn2_scale, p2, **kw)
        assert g.dtype == torch.bfloat16 and _rel_l2(g, p) <= chip_smoke.TOL_REL_L2["gn_bwd"]
        if film:
            assert _rel_l2(gp, pp) <= chip_smoke.TOL_REL_L2["gn_bwd_partials"]


def test_fused_train_chain_autograd(dev):
    """Gradients through the autograd Function (fp32 master weights in,
    fp32 weight gradients out) against the plain backward."""
    from lm2a_tpu_torch.ops import resblock_grad as rg

    gen = torch.Generator().manual_seed(3)
    cin, cout, b, t = 128, 256, 2, 70
    conv1 = torch.nn.Conv1d(cin, cout, 3, padding=1).to(dev)
    conv2 = torch.nn.Conv1d(cout, cout, 3, padding=1).to(dev)
    skip = torch.nn.Conv1d(cin, cout, 1).to(dev)
    vecs = [torch.nn.Parameter(torch.randn(c, generator=gen).to(dev) * 0.1 + o)
            for c, o in ((cin, 1.0), (cin, 0.0), (cout, 1.0), (cout, 0.0))]
    x = torch.randn((b, t, cin), generator=gen).to(dev, torch.bfloat16).requires_grad_()
    fs, fh = (torch.randn((b, cout), generator=gen).to(dev, torch.bfloat16).requires_grad_()
              for _ in range(2))
    h, xs = rg.fused_resblock_train(x, vecs[0], vecs[1], conv1.weight, conv1.bias, fs, fh,
                                    vecs[2], vecs[3], conv2.weight, conv2.bias, skip.weight,
                                    skip.bias, groups1=8, groups2=8)
    (h.float().square().sum() + xs.float().sum()).backward()
    assert conv1.weight.grad.dtype == torch.float32 and x.grad.dtype == torch.bfloat16
    assert fs.grad.dtype == torch.bfloat16 and conv2.bias.grad.shape == (cout,)
    for p in (conv1.weight, conv2.weight, skip.weight, x, fs, fh, *vecs):
        assert torch.isfinite(p.grad.float()).all()


# each kernel's sequence-sharded form, by the name its launches count under
HALO_FORMS = {"conv3_dgrad": "conv3_dgrad_halo", "conv3_wgrad": "conv3_wgrad_halo",
              "gn_bwd": "gn_bwd_totals"}


@pytest.mark.parametrize("base", [12, 20, 64])
@pytest.mark.parametrize("t", [1, 2, 63, 64, 65, 129])
@pytest.mark.parametrize("parts", [1, 3])
def test_halo_and_totals_forms_match_plain(dev, base, t, parts):
    """The sequence-sharded backward's forms on each of ``parts`` shards of
    ``t`` frames (hl, hr in {0, 1}), a skip block (Cin base -> Cout 2 base):
    ``conv3_dgrad``'s halo form (pre fp32 and bf16), ``conv3_wgrad``'s halo
    form (fp32 and bf16 sources, with and without the bias), ``gn_bwd``'s
    totals form (FiLM and extra), each against its plain version on the same
    inputs and twice for the same bits, each launch counted under its
    form's name."""
    from lm2a_tpu_torch.ops import resblock_grad as rg

    cin, cout, b, n = base, 2 * base, 2, parts * t
    w, saved, gh, gx = _bwd_inputs(dev, b, n, cin, cout, True, seed=base + 7 * t + parts)
    x, f, z1, mean1, rstd1, mean2, rstd2, sc = saved
    a1 = dict(mean=mean1, rstd=rstd1, gamma=w.gn1_scale, beta=w.gn1_bias)
    a2 = dict(mean=mean2, rstd=rstd2, gamma=w.gn2_scale, beta=w.gn2_bias)
    dz1 = torch.randn(gh.shape, generator=torch.Generator().manual_seed(t)).to(dev, torch.bfloat16)
    d_y2, p2 = rg.conv3_dgrad_plain(gh, w.conv2_w, taps=3, pre=f, **a2)
    d_y1, p1 = rg.conv3_dgrad_plain(dz1, w.conv1_w, taps=3, pre=x, **a1)
    extra, _ = rg.conv3_dgrad_plain(gx, w.skip_w, taps=1)
    g1, g2 = mean1.shape[1], mean2.shape[1]
    tot1, tot2 = rg.gn_totals(p1, w.gn1_scale, g1), rg.gn_totals(p2, w.gn2_scale, g2)
    for i in range(parts):
        hl, hr = int(i > 0), int(i < parts - 1)
        lo, hi = i * t, (i + 1) * t
        loc = lambda v: v[:, lo:hi].contiguous()  # noqa: E731
        ext = lambda v: v[:, lo - hl:hi + hr].contiguous()  # noqa: E731
        halo = (hl, hr)
        calls = [
            ("conv3_dgrad", lambda m: m.dgrad(ext(gh), w.conv2_w, taps=3, pre=loc(f), halo=halo,
                                              **a2)),
            ("conv3_dgrad", lambda m: m.dgrad(ext(dz1), w.conv1_w, taps=3, pre=loc(x),
                                              halo=halo, **a1)),
            ("conv3_wgrad", lambda m: m.wgrad(ext(f), loc(gh), taps=3, bias=True, halo=halo,
                                              **a2)),
            ("conv3_wgrad", lambda m: m.wgrad(ext(x), loc(dz1), taps=3, halo=halo, **a1)),
            ("gn_bwd", lambda m: m.gn_bwd(loc(d_y2), loc(f), mean2, rstd2, w.gn2_scale, None,
                                          film_scale=sc, z1=loc(z1), out_dtype=torch.bfloat16,
                                          totals=tot2, count=n * (cout // g2))),
            ("gn_bwd", lambda m: m.gn_bwd(loc(d_y1), loc(x), mean1, rstd1, w.gn1_scale, None,
                                          extra=loc(extra), out_dtype=torch.bfloat16,
                                          totals=tot1, count=n * (cin // g1))),
        ]
        for name, call in calls:
            _build.reset_launches()
            got = call(rg.KERNELS)
            assert _build.LAUNCHES == {HALO_FORMS[name]: 1}, name
            again, want = call(rg.KERNELS), call(rg.PLAIN)
            for j, (g, a, p) in enumerate(zip(got, again, want)):
                if p is None:
                    continue
                assert torch.equal(g, a), (name, j, "two launches differ")
                if name == "conv3_dgrad" and j == 1:  # head and tail pieces, split by M tile
                    g, p = rg.bucket_sums(g), rg.bucket_sums(p)
                tol = chip_smoke.TOL_REL_L2["gn_bwd_partials" if name == "gn_bwd" and j == 1
                                            else name]
                assert torch.isfinite(g.float()).all() and _rel_l2(g, p) <= tol, (name, j, i)


def test_halo_and_totals_forms_refuse_what_they_cannot_take(dev):
    from lm2a_tpu_torch.ops import resblock_grad as rg

    w, saved, gh, gx = _bwd_inputs(dev, 2, 8, 64, 128, True, seed=1)
    x, f, z1, mean1, rstd1, mean2, rstd2, sc = saved
    a2 = dict(mean=mean2, rstd=rstd2, gamma=w.gn2_scale, beta=w.gn2_bias)
    _build.reset_launches()
    with pytest.raises(ValueError, match="hl \\+ T \\+ hr"):
        rg.conv3_dgrad(gh, w.conv2_w, taps=3, pre=f, halo=(1, 1), **a2)
    with pytest.raises(ValueError, match="3 taps"):
        rg.conv3_dgrad(gx, w.skip_w, taps=1, halo=(0, 0))
    with pytest.raises(ValueError, match="0 or 1"):
        rg.conv3_wgrad(torch.cat([f[:, :1]] * 2 + [f], 1), gh, taps=3, halo=(2, 0), **a2)
    with pytest.raises(ValueError, match="3 taps with the GroupNorm"):
        rg.conv3_wgrad(x, gx, taps=1, halo=(0, 0))
    _, p2 = rg.conv3_dgrad_plain(gh, w.conv2_w, taps=3, pre=f, **a2)
    d_y2 = torch.zeros(f.shape, device=dev)
    with pytest.raises(ValueError, match="totals form"):
        rg.gn_bwd(d_y2, f, mean2, rstd2, w.gn2_scale, p2, film_scale=sc, z1=z1,
                  totals=rg.gn_totals(p2, w.gn2_scale, mean2.shape[1]), count=8 * 16)
    assert not _build.LAUNCHES


ADAN_NUMELS = [1, 3, 4095, 4097, 70001, 3 * 256 * 256]


@pytest.mark.parametrize("state_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("clip", [1.0, 0.0])
def test_adan_ema_matches_plain(dev, state_dtype, clip):
    from lm2a_tpu_torch.ops import adan

    gen = torch.Generator().manual_seed(5)

    def leaves():
        out = []
        for n in ADAN_NUMELS:
            r = lambda: torch.randn(n, generator=gen)  # noqa: E731
            out.append((r().to(dev) * 0.1, r().to(dev), r().to(dev), r().to(dev, state_dtype),
                        (r() * 0.01).to(dev, state_dtype), r().abs().to(dev, state_dtype) * 1e-4,
                        r().to(dev, state_dtype)))
        return out

    got = leaves()
    want = [tuple(t.clone() for t in leaf) for leaf in got]
    launcher = adan.AdanEma(grad_clip=clip)
    for step in range(3):  # step 0: moments frozen
        gnorm = adan.global_norm([leaf[0] for leaf in got])
        scal = adan.step_scalars(step, gnorm, 2e-4, betas=launcher.betas, weight_decay=1e-4,
                                 ema_decay=0.999, device=dev)
        _build.reset_launches()
        launcher(got, scal)
        assert _build.LAUNCHES == {"adan_ema": 1}
        for leaf in want:
            adan.adan_ema_plain(leaf, scal.clone(), betas=launcher.betas, eps=launcher.eps,
                                clip=clip)
        torch.cuda.synchronize()
        for g_leaf, w_leaf in zip(got, want):
            for g, w in zip(g_leaf[1:], w_leaf[1:]):
                torch.testing.assert_close(g.float(), w.float(), **chip_smoke.TOL["adan_ema"])


def test_adan_ema_zero_gradient_with_clip(dev):
    """gnorm = 0 with clipping on: nothing is divided by zero."""
    from lm2a_tpu_torch.ops import adan

    leaf = tuple(torch.zeros(37, device=dev) for _ in range(7))
    ref = tuple(t.clone() for t in leaf)
    launcher = adan.AdanEma(grad_clip=1.0)
    for step in range(2):
        scal = adan.step_scalars(step, adan.global_norm([leaf[0]]), 2e-4,
                                 betas=launcher.betas, weight_decay=1e-4, ema_decay=0.999,
                                 device=dev)
        launcher([leaf], scal)
        adan.adan_ema_plain(ref, scal, betas=launcher.betas, eps=launcher.eps, clip=1.0)
    torch.cuda.synchronize()
    for g, w in zip(leaf, ref):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, w, atol=0.0, rtol=0.0)


def test_training_kernels_refuse_what_they_cannot_take(dev):
    from lm2a_tpu_torch.ops import adan
    from lm2a_tpu_torch.ops import resblock_grad as rg

    g = torch.zeros((1, 8, 64), device=dev, dtype=torch.bfloat16)
    w = torch.zeros((64, 3 * 64), device=dev, dtype=torch.bfloat16)
    _build.reset_launches()
    with pytest.raises(ValueError, match="bf16"):
        rg.conv3_dgrad(g.float(), w)
    with pytest.raises(ValueError, match="must be positive, got Cout=0"):
        rg.conv3_dgrad(g[..., :0].contiguous(), w[:0])
    with pytest.raises(ValueError, match="must be positive, got Cin=0"):
        rg.conv3_wgrad(g[..., :0].contiguous(), g)
    leaf = tuple(torch.zeros(5, device=dev) for _ in range(7))
    scal = torch.zeros(8, device=dev)
    with pytest.raises(ValueError, match="fp32"):
        adan.AdanEma()([(leaf[0].double(),) + leaf[1:]], scal)
    assert not _build.LAUNCHES


# ---------------------------------------------------------------- Hopper conv redesign

def _conv_modes(gen, dev, rows, t, cin, cout):
    """Every conv3_fused mode the chain and the training forward use, as
    (label, kwargs for conv 1 or conv 2, which conv)."""
    w, x, film = chip_smoke.random_chain(gen, rows, t, cin, cout, True, dev)
    m1, r1 = rb.gn_stats(x, w.groups1)
    args1 = (x, m1, r1, w.gn1_scale, w.gn1_bias, w.conv1_w, w.conv1_b)
    f = rb.conv3_fused(*args1, film=film)
    m2, r2 = rb.gn_stats(f, w.groups2)
    args2 = (f, m2, r2, w.gn2_scale, w.gn2_bias, w.conv2_w, w.conv2_b)
    res = torch.randn((rows, t, cout), generator=gen).to(dev, torch.bfloat16)
    bf = torch.bfloat16
    return [
        ("film", args1, dict(film=film)), ("plain", args1, dict()),
        ("save_pre film", args1, dict(film=film, save_pre=True)),
        ("save_pre", args1, dict(save_pre=True)),
        ("skip summed", args2, dict(skip=(x, w.skip_w, w.skip_b), out_dtype=bf)),
        ("skip apart", args2, dict(skip=(x, w.skip_w, w.skip_b), split_skip=True, out_dtype=bf)),
        ("residual", args2, dict(residual=res, out_dtype=bf)), ("none", args2, dict(out_dtype=bf)),
    ]


@pytest.mark.parametrize("rows", [1, 2, 4, 16])
@pytest.mark.parametrize("t", [37, 129])
def test_conv3_every_mode_at_main_path_rows(dev, rows, t):
    """Each mode against its plain version, with M tiles that straddle batch
    rows (T = 37, 129: rows fold into one flattened axis)."""
    gen = torch.Generator().manual_seed(rows * t)
    for label, args, kw in _conv_modes(gen, dev, rows, t, 256, 128):
        _build.reset_launches()
        got = rb.conv3_fused(*args, **kw)
        torch.cuda.synchronize()
        assert _build.LAUNCHES == {"conv3_fused": 1}, label
        _close(got, rb.conv3_fused_plain(*args, **kw), TOL["conv3_fused"])


@pytest.mark.parametrize("rows,t,cin,cout,cin2", [
    (1, 64, 704, 64, 0),     # 11 K chunks over a split of 6
    (2, 37, 320, 128, 192),  # 5 + 3 chunks, the skip summed in one accumulator
    (3, 65, 192, 64, 0),     # M = 195 in one tile, taps at the three row edges
    (8, 65, 128, 128, 0),    # 64-row M tiles that straddle batch rows
    (1, 1, 128, 128, 128),   # T = 1: both outer taps read zeros
])
def test_conv3_split_k_and_row_edges(dev, rows, t, cin, cout, cin2):
    gen = torch.Generator().manual_seed(cin + t)
    w, x, film = chip_smoke.random_chain(gen, rows, t, cin, cout, bool(cin2), dev)
    plan = rb.conv3_plan(rows, t, cin, cout)
    if cin == 704:
        assert plan.splits > 1 and (cin // 64) % plan.splits != 0
    m1, r1 = rb.gn_stats(x, w.groups1)
    args1 = (x, m1, r1, w.gn1_scale, w.gn1_bias, w.conv1_w, w.conv1_b)
    _close(rb.conv3_fused(*args1, film=film), rb.conv3_fused_plain(*args1, film=film),
           TOL["conv3_fused"])
    if cin2:
        f = rb.conv3_fused(*args1, film=film)
        m2, r2 = rb.gn_stats(f, w.groups2)
        args2 = (f, m2, r2, w.gn2_scale, w.gn2_bias, w.conv2_w, w.conv2_b)
        xs = torch.randn((rows, t, cin2), generator=gen).to(dev, torch.bfloat16)
        sw_ = (torch.randn((cout, cin2), generator=gen) * cin2 ** -0.5).to(dev, torch.bfloat16)
        kw = dict(skip=(xs, sw_, w.conv2_b), out_dtype=torch.bfloat16)
        _close(rb.conv3_fused(*args2, **kw), rb.conv3_fused_plain(*args2, **kw),
               TOL["conv3_fused"])


def test_conv3_refuses_film_with_a_summed_skip(dev):
    gen = torch.Generator().manual_seed(1)
    w, x, film = chip_smoke.random_chain(gen, 1, 8, 128, 128, True, dev)
    m, r = rb.gn_stats(x, w.groups1)
    _build.reset_launches()
    with pytest.raises(ValueError, match="FiLM"):
        rb.conv3_fused(x, m, r, w.gn1_scale, w.gn1_bias, w.conv1_w, w.conv1_b, film=film,
                       skip=(x, w.skip_w, w.skip_b))
    assert not _build.LAUNCHES


@pytest.mark.parametrize("b,t", [(3, 37), (2, 300), (16, 65), (1, 1)])
@pytest.mark.parametrize("taps,bias,act", [(3, True, True), (3, False, True), (1, True, False),
                                           (1, False, True), (3, True, False)])
def test_wgrad_taps_bias_and_ragged_k(dev, b, t, taps, bias, act):
    """B*T off the 64-frame K chunk (and K chunks across batch rows), the
    split over a cluster, one and three taps, bias on and off, GN+SiLU or
    raw operand, fp32 and bf16 GroupNorm inputs."""
    from lm2a_tpu_torch.ops import resblock_grad as rg

    gen = torch.Generator().manual_seed(b * t + taps)
    cin, cout = 128, 64
    for src_dtype in ((torch.float32, torch.bfloat16) if act else (torch.bfloat16,)):
        src = torch.randn((b, t, cin), generator=gen).to(dev, src_dtype)
        g = torch.randn((b, t, cout), generator=gen).to(dev, torch.bfloat16)
        kw = dict(taps=taps, bias=bias)
        if act:
            mean, rstd = rb.gn_stats(src, 8)
            kw.update(mean=mean, rstd=rstd,
                      gamma=(1 + 0.1 * torch.randn(cin, generator=gen)).to(dev),
                      beta=(0.1 * torch.randn(cin, generator=gen)).to(dev))
        _build.reset_launches()
        got = rg.conv3_wgrad(src, g, **kw)
        torch.cuda.synchronize()
        assert _build.LAUNCHES == {"conv3_wgrad": 1}
        want = rg.conv3_wgrad_plain(src, g, **kw)
        assert (got[1] is None) == (not bias)
        for gg, ww in zip(got, want):
            if ww is not None:
                assert gg.shape == ww.shape and torch.isfinite(gg).all()
                assert _rel_l2(gg, ww) <= chip_smoke.TOL_REL_L2["conv3_wgrad"]


@pytest.mark.parametrize("rows,t,cin,cout", [(2, 64, 1024, 1024), (4, 129, 512, 256)])
def test_conv3_and_wgrad_give_the_same_bits_twice(dev, rows, t, cin, cout):
    """Split-K sums run in rank order: two launches on the same inputs agree
    bit for bit."""
    from lm2a_tpu_torch.ops import resblock_grad as rg

    gen = torch.Generator().manual_seed(t)
    w, x, film = chip_smoke.random_chain(gen, rows, t, cin, cout, False, dev)
    m1, r1 = rb.gn_stats(x, w.groups1)
    args1 = (x, m1, r1, w.gn1_scale, w.gn1_bias, w.conv1_w, w.conv1_b)
    assert rb.conv3_plan(rows, t, cin, cout).splits > 1
    f1, f2 = rb.conv3_fused(*args1, film=film), rb.conv3_fused(*args1, film=film)
    assert torch.equal(f1, f2)
    g = torch.randn((rows, t, cout), generator=gen).to(dev, torch.bfloat16)
    kw = dict(taps=3, mean=m1, rstd=r1, gamma=w.gn1_scale, beta=w.gn1_bias, bias=True)
    a, b = rg.conv3_wgrad(x, g, **kw), rg.conv3_wgrad(x, g, **kw)
    wp = rg.wgrad_plan(rows, t, cin, cout, 3)
    assert wp.splits * wp.parts > 1 or (cin // 64) * (cout // 64) >= rb.SMS
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("b,t,cin,cout,taps", [(16, 516, 256, 256, 3), (16, 258, 512, 256, 1)])
def test_wgrad_partials_after_the_cluster_sum(dev, b, t, cin, cout, taps):
    """K split over clusters and over partials summed after the launch: the
    plain version's gradient, and the same bits on two launches."""
    from lm2a_tpu_torch.ops import resblock_grad as rg

    plan = rg.wgrad_plan(b, t, cin, cout, taps)
    assert plan.parts > 1
    gen = torch.Generator().manual_seed(t + taps)
    src = torch.randn((b, t, cin), generator=gen).to(dev, torch.bfloat16)
    g = torch.randn((b, t, cout), generator=gen).to(dev, torch.bfloat16)
    mean, rstd = rb.gn_stats(src, 8)
    kw = dict(taps=taps, mean=mean, rstd=rstd, gamma=(1 + 0.1 * torch.randn(cin, generator=gen)).to(dev),
              beta=(0.1 * torch.randn(cin, generator=gen)).to(dev), bias=True)
    _build.reset_launches()
    got = rg.conv3_wgrad(src, g, **kw)
    again = rg.conv3_wgrad(src, g, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES == {"conv3_wgrad": 2}
    for gg, ww, aa in zip(got, rg.conv3_wgrad_plain(src, g, **kw), again):
        assert _rel_l2(gg, ww) <= chip_smoke.TOL_REL_L2["conv3_wgrad"]
        assert torch.equal(gg, aa)


# ---------------------------------------------------------------- Hopper attention and dgrad

def _attn_plans(b, h, t, s, hd):
    """No split and the largest split of each key tile width, and the plan's own."""
    plans = {att.attention_plan(b, h, t, s, hd)}
    for _, p in att.attention_candidates(b, h, t, s, hd):
        if p.split in (1, min(rb.SPLIT_MAX, p.tiles)):
            plans.add(p)
    return sorted(plans, key=lambda p: (p.bn, p.split))


@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("t,s", [(1, 37), (37, 1), (65, 129), (129, 1025), (300, 700)])
def test_attention_every_plan_at_ragged_lengths(dev, monkeypatch, hd, t, s):
    """Ragged T and S (the last key tile masked), split-KV and no-split plans
    forced through the plan function, and the same bits from two launches."""
    h = 3 if hd % 8 == 0 else 8  # windows: H*hd rows on the 16-byte unit
    q, k, v = _attn_inputs(dev, 2, h, t, s, hd, seed=3 * hd + t + s)
    want = att.attention_core_plain(q, k, v)
    plans = _attn_plans(2, h, t, s, hd)
    assert any(p.split > 1 for p in plans) == (s > 64)
    for plan in plans:
        monkeypatch.setattr(att, "attention_plan", lambda *a, plan=plan: plan)
        _build.reset_launches()
        got = att.attention_core(q, k, v)
        torch.cuda.synchronize()
        assert _build.LAUNCHES == {"attention": 1}
        _close(got, want, TOL["attention"])
        assert torch.equal(got, att.attention_core(q, k, v)), plan


@pytest.mark.parametrize("b,t,s,hd", [(2, 516, 516, 32), (2, 64, 516, 128), (1, 12920, 1200, 32)])
def test_attention_flagship_plans_give_the_same_bits_twice(dev, b, t, s, hd):
    q, k, v = _attn_inputs(dev, b, 8, t, s, hd, seed=t + hd)
    got = att.attention_core(q, k, v)
    _close(got, att.attention_core_plain(q, k, v), TOL["attention"])
    assert torch.equal(got, att.attention_core(q, k, v))


def test_attention_refuses_a_plan_it_does_not_take(dev, monkeypatch):
    q, k, v = _attn_inputs(dev, 1, 2, 16, 100, 32, seed=1)
    plan = att.attention_plan(1, 2, 16, 100, 32)
    _build.reset_launches()
    for bad in (dataclasses.replace(plan, split=plan.tiles + 1),  # more ranks than key tiles
                dataclasses.replace(plan, stages=2),
                dataclasses.replace(plan, smem=plan.smem - 1024),  # less than the ring takes
                dataclasses.replace(plan, stages=plan.stages + 1)):  # the ring past smem
        monkeypatch.setattr(att, "attention_plan", lambda *a, bad=bad: bad)
        with pytest.raises(RuntimeError, match="launch plan"):
            att.attention_core(q, k, v)
    assert not _build.LAUNCHES


# ---------------------------------------------------------------- the folded core

# the fused route's bf16 tolerance against the JAX package's bf16 route
# (``BF16_TOL`` of tests/test_torch_attention.py: two bf16 ulps, and 2^-8
# absolute for the rounding of p before the normalisation)
FOLD_TOL = dict(atol=2.0 ** -8, rtol=2.0 ** -7)


def _fold_inputs(dev, b, h, t, s, hd, seed):
    """bf16 q (B, T, 2C) and k_m, v_m, k_t, v_t (B, S, C), C = h * hd."""
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn((b, t, 2 * h * hd), generator=gen).to(dev, torch.bfloat16)
    return q, [torch.randn((b, s, h * hd), generator=gen).to(dev, torch.bfloat16)
               for _ in range(4)]


def _flagship_fold_sites():
    mc = chip_smoke.ModelConfig()
    return sorted({(t, c // mc.attn_heads)
                   for _, t, c in chip_smoke.attention_sites(mc, chip_smoke.MEL_T)})


# the flagship's site geometries at serve's 1 and gen's 8 conditioned rows,
# the CFG constant, keys past 1024, the partial form's 1 and 3 heads of one
# rank, v1's hd 96 and 192, window maps (hd 4 at rows on the 16-byte unit,
# hd 3 at rows padded to it) and the chunked form
FOLD_CASES = ([(b, 8, t, chip_smoke.MEL_T, hd) for t, hd in _flagship_fold_sites()
               for b in (1, 8)]
              + [(1, 8, 1, 1, hd) for hd in (32, 64, 128)] + [(1, 8, 200, 2000, 32)]
              + [(b, h, t, chip_smoke.MEL_T, hd) for h in (1, 3) for b in (1, 8)
                 for t, hd in ((258, 64), (129, 128))]
              + [(2, 8, 258, chip_smoke.MEL_T, 96), (2, 8, 129, chip_smoke.MEL_T, 192)]
              + [(2, 8, 37, 129, 4), (2, 4, 37, 129, 3), (2, 2, 65, 129, 320)])


@pytest.mark.parametrize("b,h,t,s,hd", FOLD_CASES,
                         ids=[f"B{c[0]}-H{c[1]}-T{c[2]}-S{c[3]}-hd{c[4]}" for c in FOLD_CASES])
def test_fold_core_matches_plain(dev, b, h, t, s, hd):
    """One launch over both branches against ``fold_core_plain`` (the same
    arithmetic over the same 2H heads), the same bits from two launches,
    and, where the plans agree, the same bits as the attention kernel over
    the branches' K and V stacked."""
    from lm2a_tpu_torch.ops import fold_core as fc

    q, kvs = _fold_inputs(dev, b, h, t, s, hd, seed=7 * b + h + t + hd)
    _build.reset_launches()
    got = fc.fold_core(q, *kvs, h)
    torch.cuda.synchronize()
    assert _build.LAUNCHES == {"fold_core": 1}
    assert got.shape == q.shape and got.is_contiguous()
    _close(got, fc.fold_core_plain(q, *kvs, h), TOL["attention"])
    assert torch.equal(got, fc.fold_core(q, *kvs, h))
    if hd % 8 == 0 and fc.fold_core_plan(b, h, t, s, hd) == att.attention_plan(b, 2 * h, t, s, hd):
        heads = [x.view(b, x.shape[1], -1, hd).transpose(1, 2) for x in (q, *kvs)]
        k, v = torch.cat([heads[1], heads[3]], 1), torch.cat([heads[2], heads[4]], 1)
        same = att.attention_core(heads[0], k, v).transpose(1, 2).reshape(q.shape)
        assert torch.equal(got, same)


def test_fold_core_refuses_what_it_cannot_take(dev, monkeypatch):
    from lm2a_tpu_torch.ops import fold_core as fc

    q, kvs = _fold_inputs(dev, 1, 2, 16, 100, 32, seed=1)
    _build.reset_launches()
    with pytest.raises(ValueError, match="bf16"):
        fc.fold_core(q.float(), *kvs, 2)
    with pytest.raises(ValueError, match="two branches"):
        fc.fold_core(q, *kvs, 3)
    plan = fc.fold_core_plan(1, 2, 16, 100, 32)
    for bad in (dataclasses.replace(plan, split=plan.tiles + 1),
                dataclasses.replace(plan, smem=plan.smem - 1024)):
        monkeypatch.setattr(fc, "fold_core_plan", lambda *a, bad=bad: bad)
        with pytest.raises(RuntimeError, match="launch plan"):
            fc.fold_core(q, *kvs, 2)
    assert not _build.LAUNCHES


@pytest.mark.parametrize("rows,t,s,mel_dim", [(8, 516, 516, 256), (1, 258, 516, 512),
                                              (8, 64, 516, 1024), (1, 1, 1, 1024)])
def test_folded_fusion_on_the_card_matches_the_cpu(dev, rows, t, s, mel_dim):
    """The whole bf16 folded ``CrossAttentionFusion`` forward on the card
    (merged Q projection, both branches' K/V projections, the kernel, the
    folded out·fuse product) against the CPU's plain folded form on the same
    bf16 weights and inputs."""
    import copy

    from lm2a_tpu_torch.models.attention import CrossAttentionFusion

    torch.manual_seed(mel_dim + t)
    cpu = CrossAttentionFusion(mel_dim, cond_dim=128, num_heads=8)
    cpu.fold(torch.bfloat16)
    cpu = cpu.to(torch.bfloat16).eval()
    card = copy.deepcopy(cpu).to(dev)
    card.folded = {k: v.to(dev) for k, v in cpu.folded.items()}
    gen = torch.Generator().manual_seed(t + s)
    x = torch.randn((rows, t, mel_dim), generator=gen).bfloat16()
    mot, txt = (torch.randn((rows, s, 128), generator=gen).bfloat16() for _ in range(2))
    _build.reset_launches()
    with torch.no_grad():
        got = card(x.to(dev), mot.to(dev), txt.to(dev)).cpu()
        want = cpu(x, mot, txt)
    assert _build.LAUNCHES == {"fold_core": 1}
    _close(got, want, FOLD_TOL)


def test_graphed_flagship_step_runs_the_folded_core(dev):
    """One guided flagship forward (2 rows, the first CFG-unconditional)
    captured in a CUDA graph: the capture's record holds 18 ``fold_core``
    launches (9 sites, each with its CFG constant) and no ``attention``, a
    replay counts them, and its output is the eager warm-up's, bit for bit."""
    from lm2a_tpu_torch.core import graphs
    from lm2a_tpu_torch.core.config import ModelConfig
    from lm2a_tpu_torch.models.factory import build_denoiser, random_init_

    mc = ModelConfig()
    unet = random_init_(build_denoiser(mc), 3).to(dev).eval()
    unet = unet.requires_grad_(False).prepare(torch.bfloat16)
    gen = torch.Generator().manual_seed(2)
    t = chip_smoke.MEL_T
    x = torch.randn((2, t, 80), generator=gen).to(dev)
    m, l = (torch.randn((2, t, 128), generator=gen).to(dev, torch.bfloat16) for _ in range(2))
    tt = torch.tensor([500, 500], device=dev)
    outs = []

    def fwd():
        with torch.no_grad():
            outs.append(unet(x, tt, m, l, uncond_rows=1))

    step = graphs.GraphedStep(fwd, device=dev)
    step()  # the warm-up, eager, then the capture
    eager = outs[0].clone()
    assert step.graph is not None
    assert step.launches["fold_core"] == 18 == chip_smoke.fold_core_launches(mc)["fold_core"]
    assert "attention" not in step.launches
    _build.reset_launches()
    step()
    torch.cuda.synchronize()
    assert _build.LAUNCHES == step.launches and step.replays == 1
    assert torch.equal(outs[-1], eager)


def _dgrad_case(dev, b, t, cin, cout, seed):
    from lm2a_tpu_torch.ops import resblock_grad as rg

    gen = torch.Generator().manual_seed(seed)
    g = torch.randn((b, t, cout), generator=gen).to(dev, torch.bfloat16)
    w3 = (torch.randn((cout, 3 * cin), generator=gen) * cout ** -0.5).to(dev, torch.bfloat16)
    w1 = (torch.randn((cout, cin), generator=gen) * cout ** -0.5).to(dev, torch.bfloat16)
    pre = torch.randn((b, t, cin), generator=gen).to(dev)
    mean, rstd = rg.gn_stats(pre, 8)
    act = dict(mean=mean, rstd=rstd, gamma=(torch.randn(cin, generator=gen) * 0.1 + 1).to(dev),
               beta=(torch.randn(cin, generator=gen) * 0.1).to(dev))
    return g, w3, w1, pre, act


@pytest.mark.parametrize("b,t", [(3, 1), (2, 37), (3, 65), (2, 300), (16, 64)])
@pytest.mark.parametrize("pre_dtype", [torch.bfloat16, torch.float32])
def test_dgrad_every_plan_across_batch_rows(dev, monkeypatch, b, t, pre_dtype):
    """3 taps with pre (bf16, fp32) and 1 tap raw under every plan shape and
    split: M tiles across batch rows and 64-frame buckets, ragged T, the
    bucket sums' head and tail pieces, and the same bits twice."""
    from lm2a_tpu_torch.ops import resblock_grad as rg

    cin, cout = 128, 192
    g, w3, w1, pre, act = _dgrad_case(dev, b, t, cin, cout, seed=b * t)
    pre = pre.to(pre_dtype)
    tol = chip_smoke.TOL_REL_L2["conv3_dgrad"]
    for taps, w, kw in ((3, w3, dict(pre=pre, **act)), (1, w1, {})):
        want = rg.conv3_dgrad_plain(g, w, taps=taps, **kw)
        for _, plan in rg.dgrad_candidates(b, t, cin, cout, taps):
            monkeypatch.setattr(rg, "dgrad_plan", lambda *a, plan=plan: plan)
            _build.reset_launches()
            got = rg.conv3_dgrad(g, w, taps=taps, **kw)
            torch.cuda.synchronize()
            assert _build.LAUNCHES == {"conv3_dgrad": 1}
            for i, (x, y) in enumerate(zip(got, want)):
                if y is None:
                    assert x is None
                    continue
                assert x.dtype == y.dtype and x.shape == y.shape
                if i == 1:  # head and tail pieces, split by the plan's M tiles
                    x, y = rg.bucket_sums(x), rg.bucket_sums(y)
                assert _rel_l2(x, y) <= tol, (taps, plan)
            again = rg.conv3_dgrad(g, w, taps=taps, **kw)
            assert all(x is None or torch.equal(x, y) for x, y in zip(got, again)), plan


@pytest.mark.parametrize("b,t,cin,cout", [(16, 516, 256, 256), (16, 258, 256, 512),
                                          (4, 129, 1024, 96)])
def test_dgrad_default_plan_at_training_shapes(dev, b, t, cin, cout):
    """The plan's own launch at flagship training shapes (and a 32-wide last
    K chunk), pre fp32 as conv 2 reads it."""
    from lm2a_tpu_torch.ops import resblock_grad as rg

    g, w3, _, pre, act = _dgrad_case(dev, b, t, cin, cout, seed=t)
    got = rg.conv3_dgrad(g, w3, taps=3, pre=pre, **act)
    want = rg.conv3_dgrad_plain(g, w3, taps=3, pre=pre, **act)
    for x, y in ((got[0], want[0]), (rg.bucket_sums(got[1]), rg.bucket_sums(want[1]))):
        assert _rel_l2(x, y) <= chip_smoke.TOL_REL_L2["conv3_dgrad"]
    again = rg.conv3_dgrad(g, w3, taps=3, pre=pre, **act)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


def test_dgrad_refuses_modes_it_does_not_take(dev):
    from lm2a_tpu_torch.ops import resblock_grad as rg

    g, w3, w1, pre, act = _dgrad_case(dev, 2, 16, 64, 64, seed=0)
    _build.reset_launches()
    with pytest.raises(ValueError, match="3 taps with pre"):
        rg.conv3_dgrad(g, w3, taps=3)
    with pytest.raises(ValueError, match="3 taps with pre"):
        rg.conv3_dgrad(g, w1, taps=1, pre=pre, **act)
    assert not _build.LAUNCHES


def test_dgrad_refuses_a_plan_it_does_not_take(dev, monkeypatch):
    """A plan whose grid or shared memory is not the kernel's for the shape
    is refused before any launch (too few M tiles would leave rows of the
    output unwritten, too little shared memory would overrun the ring)."""
    from lm2a_tpu_torch.ops import resblock_grad as rg

    b, t, cin, cout = 2, 100, 128, 192
    g, w3, _, pre, act = _dgrad_case(dev, b, t, cin, cout, seed=5)
    plan = rg.dgrad_plan(b, t, cin, cout, 3)
    _build.reset_launches()
    for bad in (dataclasses.replace(plan, mtiles=plan.mtiles - 1),
                dataclasses.replace(plan, ntiles=plan.ntiles + 1),
                dataclasses.replace(plan, smem=plan.smem - 1024),
                dataclasses.replace(plan, splits=rg.dgrad_plan(b, t, cin, cout, 3).chunks + 1),
                dataclasses.replace(plan, mw=3)):
        monkeypatch.setattr(rg, "dgrad_plan", lambda *a, bad=bad: bad)
        with pytest.raises(RuntimeError, match="launch plan"):
            rg.conv3_dgrad(g, w3, taps=3, pre=pre, **act)
    assert not _build.LAUNCHES


# ---------------------------------------------------------------- plan checks of the conv entries

def test_conv3_fused_refuses_a_plan_it_does_not_take(dev, monkeypatch):
    """A plan whose grid, split or shared memory is not the kernel's for the
    shape, or whose tile it has no instance of, is refused before any launch
    (too few M or N tiles would leave output unwritten, too little shared
    memory would overrun the ring). Conv 1 and conv 2 with the skip apart."""
    gen = torch.Generator().manual_seed(11)
    rows, t, cin, cout = 2, 100, 256, 128
    w, x, film = chip_smoke.random_chain(gen, rows, t, cin, cout, True, dev)
    m1, r1 = rb.gn_stats(x, w.groups1)
    args1 = (x, m1, r1, w.gn1_scale, w.gn1_bias, w.conv1_w, w.conv1_b)
    f = rb.conv3_fused(*args1, film=film)
    m2, r2 = rb.gn_stats(f, w.groups2)
    args2 = (f, m2, r2, w.gn2_scale, w.gn2_bias, w.conv2_w, w.conv2_b)
    calls = [((rows, t, cin, cout, 0, False, 2), args1, dict(film=film)),
             ((rows, t, cout, cout, cin, True, 4), args2,
              dict(skip=(x, w.skip_w, w.skip_b), split_skip=True, out_dtype=torch.bfloat16))]
    real = rb.conv3_plan
    for key, args, kw in calls:
        plan = real(*key)
        bad = [dataclasses.replace(plan, mtiles=plan.mtiles - 1),
               dataclasses.replace(plan, mtiles=plan.mtiles + 1),
               dataclasses.replace(plan, ntiles=plan.ntiles - 1),
               dataclasses.replace(plan, smem=plan.smem - 1024),
               dataclasses.replace(plan, splits=min(plan.chunks) + 1),
               dataclasses.replace(plan, splits=0),
               dataclasses.replace(plan, mw=3),
               dataclasses.replace(plan, bn=96)]
        _build.reset_launches()
        for p in bad:
            monkeypatch.setattr(rb, "conv3_plan", lambda *a, p=p: p)
            with pytest.raises(RuntimeError, match="launch plan"):
                rb.conv3_fused(*args, **kw)
        torch.cuda.synchronize()
        assert not _build.LAUNCHES
        monkeypatch.setattr(rb, "conv3_plan", real)
        _close(rb.conv3_fused(*args, **kw), rb.conv3_fused_plain(*args, **kw),
               TOL["conv3_fused"])


@pytest.mark.parametrize("taps", [3, 1])
def test_wgrad_refuses_a_plan_it_does_not_take(dev, monkeypatch, taps):
    """conv3_wgrad's entry refuses a grid, split, partial count, shared
    memory or tile that is not the kernel's for the shape, before any launch."""
    from lm2a_tpu_torch.ops import resblock_grad as rg

    b, t, cin, cout = 2, 100, 128, 256
    gen = torch.Generator().manual_seed(taps)
    src = torch.randn((b, t, cin), generator=gen).to(dev, torch.bfloat16)
    g = torch.randn((b, t, cout), generator=gen).to(dev, torch.bfloat16)
    mean, rstd = rb.gn_stats(src, 8)
    kw = dict(taps=taps, mean=mean, rstd=rstd, gamma=torch.ones(cin, device=dev),
              beta=torch.zeros(cin, device=dev), bias=True)
    plan = rg.wgrad_plan(b, t, cin, cout, taps)
    bad = [dataclasses.replace(plan, ntiles=plan.ntiles - 1),
           dataclasses.replace(plan, ctiles=plan.ctiles + 1),
           dataclasses.replace(plan, smem=plan.smem - 1024),
           dataclasses.replace(plan, splits=0),
           dataclasses.replace(plan, splits=9),
           dataclasses.replace(plan, splits=plan.chunks + 1, parts=1),
           dataclasses.replace(plan, parts=rg.WGRAD_PARTS + 1, splits=1),
           dataclasses.replace(plan, mw=3)]
    _build.reset_launches()
    for p in bad:
        monkeypatch.setattr(rg, "wgrad_plan", lambda *a, p=p: p)
        with pytest.raises(RuntimeError, match="launch plan"):
            rg.conv3_wgrad(src, g, **kw)
    torch.cuda.synchronize()
    assert not _build.LAUNCHES


# ---------------------------------------------------------------- Hopper GroupNorm redesign

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("groups", [8, 4, 2, 1])
@pytest.mark.parametrize("t", [1, 63, 64, 129, 12920])
@pytest.mark.parametrize("c", [256, 2048, 40])
def test_gn_stats_edge_shapes(dev, c, t, groups, dtype):
    """T split over the cluster as the plan gives it, 16-byte vectors (and
    scalars where C/G is not whole vectors: C = 40), groups up to the whole
    of C = 2048; the same bits twice."""
    gen = torch.Generator().manual_seed(t + c + groups)
    x = (1.5 * torch.randn((2, t, c), generator=gen) + 0.3).to(dev, dtype)
    _build.reset_launches()
    got = rb.gn_stats(x, groups)
    torch.cuda.synchronize()
    assert _build.LAUNCHES == {"gn_stats": 1}
    _close(got, rb.gn_stats_plain(x, groups), TOL["gn_stats"])
    again = rb.gn_stats(x, groups)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,t,c", [(4, 129, 256), (16, 516, 256), (2, 12920, 256), (4, 129, 2048)])
def test_gn_stats_every_cluster_size(dev, monkeypatch, b, t, c, dtype):
    """Every split of T from 1 to 8 blocks, forced through the plan function,
    at the main path's row counts; the plan's own split among them."""
    gen = torch.Generator().manual_seed(b + t)
    x = (torch.randn((b, t, c), generator=gen) - 0.7).to(dev, dtype)
    want = rb.gn_stats_plain(x, 8)
    assert 1 <= rb.gn_stats_plan(b, t, c, 8, x.element_size()) <= 8
    for splits in range(1, 9):
        monkeypatch.setattr(rb, "gn_stats_plan", lambda *a, s=splits: s)
        _close(rb.gn_stats(x, 8), want, TOL["gn_stats"])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t", [1, 64, 2584, 12920])
@pytest.mark.parametrize("c,groups", [(256, 8), (2048, 32), (40, 4)])
def test_gn_sums_matches_plain(dev, dtype, t, c, groups):
    """The sums form of ``gn_stats`` (the sequence-parallel forward's): one
    launch, its sums finished into the plain statistics and the statistics
    form's, the same bits twice."""
    gen = torch.Generator().manual_seed(t + c)
    x = (1.5 * torch.randn((2, t, c), generator=gen) + 0.3).to(dev, dtype)
    _build.reset_launches()
    s, ss = rb.gn_sums(x, groups)
    torch.cuda.synchronize()
    assert _build.LAUNCHES == {"gn_stats": 1}
    ps, pss = rb.gn_sums_plain(x, groups)
    torch.testing.assert_close(s, ps, rtol=1e-4, atol=1e-2)
    torch.testing.assert_close(ss, pss, rtol=1e-4, atol=1e-2)
    n = t * (c // groups)
    _close(rb.gn_finish(s, ss, n), rb.gn_stats_plain(x, groups), TOL["gn_stats"])
    _close(rb.gn_finish(s, ss, n), rb.gn_stats(x, groups), TOL["gn_stats"])
    assert all(torch.equal(a, b) for a, b in zip((s, ss), rb.gn_sums(x, groups)))


@pytest.mark.parametrize("t", [516, 5168])
def test_sequence_sharded_forward_one_shard_is_the_forward(dev, t):
    """``parallel.sequence``'s forward at one shard (no process group: the
    statistics from the sums form, every window the whole axis) against the
    serving forward, bf16, on the kernels, within ``UNET_REL_L2``."""
    from lm2a_tpu_torch.core.config import ModelConfig
    from lm2a_tpu_torch.core.mesh import make_mesh
    from lm2a_tpu_torch.models.factory import build_denoiser, random_init_
    from lm2a_tpu_torch.parallel.sequence import SeqShard, sequence_sharded_forward

    unet = random_init_(build_denoiser(ModelConfig(base_dim=64)), 3).to(dev).eval()
    unet = unet.requires_grad_(False).prepare(torch.bfloat16)
    gen = torch.Generator().manual_seed(t)
    x = torch.randn((2, t, 80), generator=gen).to(dev)
    m, l = (torch.randn((2, t, 128), generator=gen).to(dev, torch.bfloat16) for _ in range(2))
    tt = torch.tensor([500, 500], device=dev)
    with torch.no_grad():
        want = unet(x, tt, m, l, uncond_rows=1)
        _build.reset_launches()
        got = sequence_sharded_forward(unet, SeqShard(make_mesh(device=dev)), x, tt, m, l, t,
                                       uncond_rows=1)
    torch.cuda.synchronize()
    n_blocks = len(unet.resblocks())
    assert _build.LAUNCHES == {"gn_stats": 2 * n_blocks + 1, "conv3_fused": 2 * n_blocks,
                               **chip_smoke.fold_core_launches(ModelConfig(base_dim=64), mel_t=t)}
    rel = float((got - want).norm() / want.norm())
    assert rel <= chip_smoke.UNET_REL_L2, rel


def test_gn_stats_misaligned_input_and_refused_splits(dev, monkeypatch):
    """A contiguous view that does not start on a 16-byte boundary takes the
    scalar loads; a split outside 1..min(8, T) is refused before launch."""
    gen = torch.Generator().manual_seed(2)
    flat = torch.randn(2 * 65 * 256 + 1, generator=gen).to(dev, torch.bfloat16)
    x = flat[1:].view(2, 65, 256)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    _close(rb.gn_stats(x, 8), rb.gn_stats_plain(x, 8), TOL["gn_stats"])
    _build.reset_launches()
    for s in (0, 9, 66):
        monkeypatch.setattr(rb, "gn_stats_plan", lambda *a, s=s: s)
        with pytest.raises(RuntimeError, match="launch plan"):
            rb.gn_stats(x, 8)
    assert not _build.LAUNCHES


def _gn_bwd_inputs(dev, b, t, c, groups, pre_dtype, seed):
    from lm2a_tpu_torch.ops import resblock_grad as rg

    gen = torch.Generator().manual_seed(seed)
    pre = (torch.randn((b, t, c), generator=gen) + 0.2).to(dev, pre_dtype)
    dy = torch.randn((b, t, c), generator=gen).to(dev)
    gamma = (1 + 0.1 * torch.randn(c, generator=gen)).to(dev)
    mean, rstd = rb.gn_stats_plain(pre, groups)
    xh = rg._xhat(pre, mean, rstd)
    sums = torch.stack([rg._tile_sums(dy), rg._tile_sums(dy * xh)])
    head = sums * torch.rand(sums.shape, generator=gen).to(dev)  # a bucket split anyhow
    pieces = torch.stack([head, sums - head], 1).contiguous()
    return pre, dy, gamma, mean, rstd, pieces, gen


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("mode", ["plain", "extra", "film"])
@pytest.mark.parametrize("c,groups", [(128, 8), (192, 8), (256, 4), (2048, 1)])
@pytest.mark.parametrize("t", [1, 37, 64, 100, 130])
def test_gn_bwd_edge_shapes(dev, t, c, groups, mode, out_dtype):
    """T below one bucket and off the 64-frame buckets, channel blocks of 64
    (C = 192) and 128 that groups cross, a group of 2048 channels; with and
    without the extra term, FiLM mode; bf16 and fp32 output, pre fp32 in
    FiLM mode (GN2 reads f) and bf16 otherwise (GN1 reads x); pieces split
    at random; the same bits twice."""
    from lm2a_tpu_torch.ops import resblock_grad as rg

    b = 3
    pre_dtype = torch.float32 if mode == "film" else torch.bfloat16
    pre, dy, gamma, mean, rstd, pieces, gen = _gn_bwd_inputs(dev, b, t, c, groups, pre_dtype,
                                                             seed=t * c + groups)
    kw = dict(out_dtype=out_dtype)
    if mode == "extra":
        kw["extra"] = torch.randn((b, t, c), generator=gen).to(dev)
    elif mode == "film":
        kw.update(film_scale=(0.2 * torch.randn((b, c), generator=gen)).to(dev),
                  z1=torch.randn((b, t, c), generator=gen).to(dev))
    _build.reset_launches()
    got = rg.gn_bwd(dy, pre, mean, rstd, gamma, pieces, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES == {"gn_bwd": 1}
    want = rg.gn_bwd_plain(dy, pre, mean, rstd, gamma, pieces, **kw)
    assert got[0].dtype == out_dtype and got[0].shape == want[0].shape
    assert _rel_l2(got[0], want[0]) <= chip_smoke.TOL_REL_L2["gn_bwd"]
    if mode == "film":
        assert got[1].shape == want[1].shape
        assert _rel_l2(got[1], want[1]) <= chip_smoke.TOL_REL_L2["gn_bwd_partials"]
    else:
        assert got[1] is None
    again = rg.gn_bwd(dy, pre, mean, rstd, gamma, pieces, **kw)
    assert all(x is None or torch.equal(x, y) for x, y in zip(got, again))


def test_gn_bwd_refuses_what_it_cannot_take(dev):
    from lm2a_tpu_torch.ops import resblock_grad as rg

    pre, dy, gamma, mean, rstd, pieces, _ = _gn_bwd_inputs(dev, 2, 70, 128, 8,
                                                           torch.bfloat16, seed=1)
    flat = torch.empty(dy.numel() + 1, device=dev)
    flat[1:] = dy.flatten()
    _build.reset_launches()
    with pytest.raises(ValueError, match="16-byte"):
        rg.gn_bwd(flat[1:].view(dy.shape), pre, mean, rstd, gamma, pieces)
    with pytest.raises(ValueError, match="pieces"):
        rg.gn_bwd(dy, pre, mean, rstd, gamma, rg.bucket_sums(pieces).contiguous())
    with pytest.raises(ValueError, match="not both"):
        rg.gn_bwd(dy, pre, mean, rstd, gamma, pieces, extra=dy, z1=dy,
                  film_scale=torch.zeros((2, 128), device=dev))
    assert not _build.LAUNCHES


def test_gn_bwd_refuses_a_plan_it_does_not_take(dev, monkeypatch):
    """A channel block the kernel has no instance of, or one that does not
    divide C, is refused before any launch; both of its own run."""
    from lm2a_tpu_torch.ops import resblock_grad as rg

    pre, dy, gamma, mean, rstd, pieces, _ = _gn_bwd_inputs(dev, 2, 70, 192, 8,
                                                           torch.bfloat16, seed=2)
    want = rg.gn_bwd_plain(dy, pre, mean, rstd, gamma, pieces)
    _build.reset_launches()
    for cb in (32, 96, 128, 256):
        monkeypatch.setattr(rg, "gn_bwd_plan", lambda *a, cb=cb: cb)
        with pytest.raises(RuntimeError, match="launch plan"):
            rg.gn_bwd(dy, pre, mean, rstd, gamma, pieces)
    assert not _build.LAUNCHES
    monkeypatch.setattr(rg, "gn_bwd_plan", lambda *a: 64)
    got = rg.gn_bwd(dy, pre, mean, rstd, gamma, pieces)
    assert _rel_l2(got[0], want[0]) <= chip_smoke.TOL_REL_L2["gn_bwd"]


# ---------------------------------------------------------------- distillation

# base width 128 (C/G = 16); test_train_and_distill_at_c_over_g_8 takes it to 64
DISTILL_CFG = dataclasses.replace(
    chip_smoke.LM2AConfig(), model=chip_smoke.ModelConfig(
        base_dim=128, dim_mults=(1, 2), cond_dim=16, time_emb_dim=32, num_res_blocks=1,
        mid_blocks=1, attn_heads=2, fused_resblock_grad=True),
    train=dataclasses.replace(chip_smoke.LM2AConfig().train, weight_decay=0.0,
                              opt_backend="pallas"))


def test_distill_step_on_the_card_matches_the_cpu(dev):
    """The first two distill steps (x0_snr, teacher guidance 2.1, injected
    draws, bf16) of the fresh student that ``start_student`` makes, as ``cli
    distill`` starts (the teacher's EMA, step 0, Adan zeroed), each from the
    same state on both sides: the card (the teacher's serving forwards
    through gn_stats and conv3_fused, the gated student blocks through the
    backward kernels, adan_ema) against the CPU (the plain versions).

    - each step launches ``distill_launches_per_step``;
    - the loss, each gradient leaf and the whole gradient within
      ``chip_smoke.ROUTE_TOL``'s bounds (the routes round to bf16 at
      different places, as 4e's kernel and plain routes do);
    - the card's update (parameters, EMA, Adan state) equals Adan's plain
      update of the same state with the card's own gradient, on the card,
      within ``chip_smoke.TOL["adan_ema"]``.

    The parameters' step is not held to ``ROUTE_TOL``'s step bound here.
    Adan's first updates do not scale with the gradient: the first stores
    it and moves nothing; the second divides by sqrt(n) with n = (1.92 g1 -
    0.92 g0)^2, near 0 where the two draws' gradients nearly cancel. Route
    rounding in those elements becomes a step of many lr on either side
    (``scripts/torch_distill_route_steps.py`` reads the gap, PERF.md)."""
    from lm2a_tpu_torch.diffusion.schedule import make_schedule
    from lm2a_tpu_torch.ops import adan as adan_op
    from lm2a_tpu_torch.training import distill
    from lm2a_tpu_torch.training.adan import BETAS, EPS
    from lm2a_tpu_torch.training.checkpoint import load_state_arrays, state_arrays
    from lm2a_tpu_torch.training.train_step import init_train_state, make_optimizer

    cfg, b, t = DISTILL_CFG, 2, 64
    gen = torch.Generator().manual_seed(11)
    batch = {"mel": -4.6 + 1.9 * torch.randn((b, t, 80), generator=gen),
             "motion": torch.randn((b, t, 234), generator=gen),
             "lyrics": torch.randn((b, t, 768), generator=gen)}
    draws = [distill.DistillDraws(torch.tensor(idx), torch.randn((b, t, 80), generator=gen))
             for idx in ([0, 3], [2, 1])]
    teacher_ema = init_train_state(cfg, 5, "cpu").ema
    kw = dict(dataset_mean=-4.6, dataset_std=1.9, guidance_weight=2.1, loss_space="x0_snr")

    def student(d):
        optimizer = make_optimizer(cfg)
        state = init_train_state(cfg, 0, d, optimizer)
        ema = {k: v.to(d) for k, v in teacher_ema.items()}
        distill.start_student(state, ema)
        step = distill.make_distill_step(make_schedule(cfg.diffusion, device=d), cfg, optimizer,
                                         4, **kw)
        return state, distill.build_teacher(cfg, ema), step, optimizer

    sides = {d: student(d) for d in (torch.device("cpu"), dev)}
    pre = state_arrays(sides[dev][0])
    tol = chip_smoke.ROUTE_TOL
    for i, dr in enumerate(draws):
        out = {}
        for d, (state, teacher, step, _) in sides.items():
            load_state_arrays(state, pre)
            _build.reset_launches()
            loss = float(step(state, teacher, {k: v.to(d) for k, v in batch.items()}, draws=dr))
            out[d.type] = dict(loss=loss, launches=dict(_build.LAUNCHES), grads={
                n: p.grad.detach().clone() for n, p in state.params().items()})
        assert out["cpu"]["launches"] == {}
        assert out["cuda"]["launches"] == chip_smoke.distill_launches_per_step(cfg.model, t), i
        k, p = out["cuda"], out["cpu"]
        assert abs(k["loss"] - p["loss"]) <= tol["loss_rel"] * abs(p["loss"]), (i, k["loss"],
                                                                               p["loss"])
        gsum = float(torch.sqrt(sum(g.square().sum() for g in p["grads"].values())))
        num = 0.0
        for name, gp in p["grads"].items():
            diff = float((k["grads"][name].cpu() - gp).norm())
            assert diff <= tol["leaf_rel_l2"] * float(gp.norm()) + tol["leaf_floor"] * gsum, (
                i, name)
            num += diff * diff
        assert num ** 0.5 <= tol["grad_rel_l2"] * gsum, i

        # the card's update against the plain one of the same state and gradient
        ref, _, _, optimizer = student(dev)
        load_state_arrays(ref, pre)
        names = list(ref.params())
        grads = [k["grads"][n] for n in names]
        scal = optimizer.scalars(ref.opt, grads)
        with torch.no_grad():
            for n, g in zip(names, grads):
                leaf = (g, ref.params()[n], ref.ema[n], ref.opt.m[n], ref.opt.v[n],
                        ref.opt.n[n], ref.opt.prev_grad[n])
                adan_op.adan_ema_plain(leaf, scal, betas=BETAS, eps=EPS,
                                       clip=optimizer.grad_clip)
        ref.step += 1
        ref.opt.step += 1
        got, want = state_arrays(sides[dev][0]), state_arrays(ref)
        assert set(got) == set(want)
        for key, w in want.items():
            torch.testing.assert_close(torch.from_numpy(got[key]), torch.from_numpy(w),
                                       **chip_smoke.TOL["adan_ema"], msg=f"step {i}: {key}")
        pre = got


def test_fused_attention_teacher_distill_step_on_the_card(dev):
    """One distill step (x0_snr, teacher guidance 2.1, injected draws, bf16)
    with ``fused_attention`` set (teacher and student on the attention
    kernel, base width 128: head dims 16 to 64): the card's launches those
    of ``chip_smoke.distill_launches_per_step``, its loss and whole gradient
    against the CPU's within ``chip_smoke.ROUTE_TOL``."""
    from lm2a_tpu_torch.diffusion.schedule import make_schedule
    from lm2a_tpu_torch.training import distill
    from lm2a_tpu_torch.training.train_step import init_train_state, make_optimizer

    cfg = dataclasses.replace(DISTILL_CFG, model=dataclasses.replace(DISTILL_CFG.model,
                                                                     fused_attention=True))
    b, t = 2, 64
    gen = torch.Generator().manual_seed(12)
    batch = {"mel": -4.6 + 1.9 * torch.randn((b, t, 80), generator=gen),
             "motion": torch.randn((b, t, 234), generator=gen),
             "lyrics": torch.randn((b, t, 768), generator=gen)}
    draws = distill.DistillDraws(torch.tensor([1, 3]), torch.randn((b, t, 80), generator=gen))
    teacher_ema = init_train_state(cfg, 5, "cpu").ema
    out = {}
    for d in (torch.device("cpu"), dev):
        optimizer = make_optimizer(cfg)
        state = init_train_state(cfg, 0, d, optimizer)
        ema = {k: v.to(d) for k, v in teacher_ema.items()}
        distill.start_student(state, ema)
        step = distill.make_distill_step(make_schedule(cfg.diffusion, device=d), cfg, optimizer,
                                         4, dataset_mean=-4.6, dataset_std=1.9,
                                         guidance_weight=2.1, loss_space="x0_snr")
        teacher = distill.build_teacher(cfg, ema)
        assert teacher.unet.fused_attention
        _build.reset_launches()
        loss = float(step(state, teacher, {k: v.to(d) for k, v in batch.items()}, draws=draws))
        out[d.type] = dict(loss=loss, launches=dict(_build.LAUNCHES), grads=[
            p.grad.detach().float().cpu().clone() for p in state.params().values()])
    assert out["cpu"]["launches"] == {}
    assert out["cuda"]["launches"] == chip_smoke.distill_launches_per_step(cfg.model, t)
    tol = chip_smoke.ROUTE_TOL
    k, p = out["cuda"], out["cpu"]
    assert np.isfinite(k["loss"]) and abs(k["loss"] - p["loss"]) <= tol["loss_rel"] * abs(p["loss"])
    gsum = float(torch.sqrt(sum(g.square().sum() for g in p["grads"])))
    diff = float(torch.sqrt(sum((a - g).square().sum() for a, g in zip(k["grads"], p["grads"]))))
    assert diff <= tol["grad_rel_l2"] * gsum, (diff, gsum)


def test_distill_teacher_forward_at_32_rows(dev):
    """The distill teacher's guided serving forward at 2B = 32 rows (B = 16,
    T = 516) at the flagship's depth and a quarter of its width, same bf16
    weights: the card's kernels against the CPU's plain versions within
    ``chip_smoke.UNET_REL_L2``, with 31 gn_stats and 30 conv3_fused launches
    and one folded core a site (the doubled batch whole: no CFG constant)."""
    from lm2a_tpu_torch.diffusion.gaussian import guided_eps
    from lm2a_tpu_torch.training import distill
    from lm2a_tpu_torch.training.train_step import init_train_state

    cfg = dataclasses.replace(chip_smoke.LM2AConfig(),
                              model=chip_smoke.ModelConfig(base_dim=64))
    b, t = chip_smoke.DISTILL_ROWS // 2, chip_smoke.MEL_T
    ema = init_train_state(cfg, 3, "cpu").ema
    gen = torch.Generator().manual_seed(12)
    x = torch.randn((b, t, 80), generator=gen)
    steps = torch.randint(0, 1000, (b,), generator=gen)
    motion, lyrics = torch.randn((b, t, 234), generator=gen), torch.randn((b, t, 768), generator=gen)
    eps = {}
    for d in (torch.device("cpu"), dev):
        teacher = distill.build_teacher(cfg, {k: v.to(d) for k, v in ema.items()})
        rows = []
        handle = teacher.unet.register_forward_pre_hook(lambda m, a: rows.append(a[0].shape[0]))
        _build.reset_launches()
        with torch.no_grad():
            m, l = teacher.cond_proj(motion.to(d), lyrics.to(d))
            eps[d.type] = guided_eps(teacher.unet, x.to(d), steps.to(d), m, l, 2.1).cpu()
        handle.remove()
        assert rows == [chip_smoke.DISTILL_ROWS]
        launches = dict(_build.LAUNCHES)
    n_blocks = len(chip_smoke.resblock_geometries(cfg.model, t))
    assert launches == {"gn_stats": 2 * n_blocks + 1, "conv3_fused": 2 * n_blocks,
                        **chip_smoke.fold_core_launches(cfg.model, guided=False, mel_t=t)} == {
        "gn_stats": 31, "conv3_fused": 30, "fold_core": 9}
    assert eps["cuda"].shape == (b, t, 80) and torch.isfinite(eps["cuda"]).all()
    assert chip_smoke.rel_l2(eps["cuda"], eps["cpu"]) <= chip_smoke.UNET_REL_L2


# ---------------------------------------------------------------- compiled steps (CUDA graphs)

NARROW = chip_smoke.ModelConfig(base_dim=64, dim_mults=(1, 2), cond_dim=16, time_emb_dim=32,
                                num_res_blocks=1, mid_blocks=1, attn_heads=2)


def _narrow_ckpt(tmp_path, **model):
    cfg = dataclasses.replace(chip_smoke.LM2AConfig(),
                              model=dataclasses.replace(NARROW, **model))
    return chip_smoke.write_checkpoint(str(tmp_path / "ckpt"), cfg, seed=0)


@pytest.mark.parametrize("method,steps", [("ddim", 6), ("ddpm", 12)])
def test_graphed_chain_equals_its_eager_run(dev, tmp_path, method, steps):
    """A chain through the sampler cache (the first step the capture's
    warm-up, every later one a replay) against the same chain with every
    step eager, one seed, CFG 2.1, base width 64 (C/G = 8, every block on
    the kernels): the same bits, the same launches, and a second guided
    weight reusing the entry."""
    from lm2a_tpu_torch.core import graphs
    from lm2a_tpu_torch.inference.sample import generate_mel, load_models

    ckpt = _narrow_ckpt(tmp_path, fused_attention=method == "ddpm")
    models = load_models(ckpt, device=dev)
    gen = torch.Generator().manual_seed(4)
    motion, lyrics = (torch.randn((40, c), generator=gen).numpy() for c in (234, 768))
    kw = dict(guidance_weight=2.1, method=method, seed=9, batch=2,
              **({"ddim_steps": steps} if method == "ddim" else {"steps": steps}))
    out = {}
    for label in ("graph", "graph again", "eager"):
        _build.reset_launches()
        ctx = graphs.eager_on_card() if label == "eager" else contextlib.nullcontext()
        with ctx:
            out[label] = (generate_mel(models, motion, lyrics, 64, **kw)[0],
                          dict(_build.LAUNCHES))
    (key, chain), = models._samplers.items()
    step, = chain.steps.values()
    assert step.graph is not None and step.replays == 2 * steps - 1
    for label in ("graph again", "eager"):
        assert (out[label][0] == out["graph"][0]).all(), label
        assert out[label][1] == out["graph"][1], label
    n_blocks = len(chip_smoke.resblock_geometries(models.cfg.model, 64))
    assert out["graph"][1]["conv3_fused"] == 2 * n_blocks * steps
    generate_mel(models, motion, lyrics, 64, **dict(kw, guidance_weight=3.0))
    assert len(models._samplers) == 1 and step.replays == 3 * steps - 1


def test_graphed_train_steps_equal_their_eager_run(dev):
    """Two calls of K = 2 device-data steps (base width 128, the gated
    blocks on the backward kernels, adan_ema): the graphed run (the first
    step the warm-up, three replays) against the same steps eager from the
    same state: losses and the whole state the same bits, the same launches."""
    from lm2a_tpu_torch.core import graphs
    from lm2a_tpu_torch.diffusion.schedule import make_schedule
    from lm2a_tpu_torch.training.checkpoint import state_arrays
    from lm2a_tpu_torch.training.train_step import init_train_state, make_device_data_multistep

    cfg = dataclasses.replace(DISTILL_CFG, train=dataclasses.replace(
        DISTILL_CFG.train, weight_decay=1e-4))
    gen = torch.Generator().manual_seed(3)
    data = {"mel": -4.6 + 1.9 * torch.randn((6, 64, 80), generator=gen),
            "motion": torch.randn((6, 64, 234), generator=gen),
            "lyrics": torch.randn((6, 64, 768), generator=gen)}
    data = {k: v.to(dev) for k, v in data.items()}
    idx = [[[0, 4], [5, 1]], [[2, 3], [3, 0]]]
    out = {}
    for label in ("graph", "eager"):
        state = init_train_state(cfg, 0, dev)
        multi = make_device_data_multistep(make_schedule(cfg.diffusion, device=dev), cfg,
                                           dataset_mean=-4.6, dataset_std=1.9)
        _build.reset_launches()
        with graphs.eager_on_card() if label == "eager" else contextlib.nullcontext():
            losses = [multi(state, data, torch.tensor(i), 7, [2 * c, 2 * c + 1])
                      for c, i in enumerate(idx)]
        torch.cuda.synchronize()
        out[label] = (torch.cat(losses).cpu(), state_arrays(state), dict(_build.LAUNCHES))
    assert torch.equal(out["graph"][0], out["eager"][0])
    assert out["graph"][2] == out["eager"][2]
    per_step, _ = chip_smoke.train_launches_per_step(cfg.model, 64)
    assert out["graph"][2] == {k: 4 * v for k, v in per_step.items()}
    for key, want in out["eager"][1].items():
        assert (out["graph"][1][key] == want).all(), key


# v1 at a quarter of its default width with 2 heads: the default's head dims
# (32, 32, 64, 128, 192, 96, 64) on the attention kernel
V1_CFG = dataclasses.replace(
    chip_smoke.LM2AConfig(), model=chip_smoke.ModelConfig(
        arch="v1", base_dim=64, cond_dim=32, time_emb_dim=64, attn_heads=2,
        fused_attention=True),
    train=dataclasses.replace(chip_smoke.LM2AConfig().train, opt_backend="pallas"))


def _v1_batch(n, t, seed):
    gen = torch.Generator().manual_seed(seed)
    return {"mel": -4.6 + 1.9 * torch.randn((n, t, 80), generator=gen),
            "motion": torch.randn((n, t, 234), generator=gen),
            "lyrics": torch.randn((n, t, 768), generator=gen)}


def test_v1_train_steps_on_the_card_match_the_cpu(dev):
    """Two ``cli train --arch v1 --fused_attention`` steps (bf16, injected
    draws, 2 rows, T=64) from the same state: the card (the attention
    kernel's forward at head dims 32 to 192, the plain recompute for its
    backward, ``adan_ema``) against the CPU (the plain versions): each
    step's launches, the loss, every gradient leaf and the whole gradient
    within ``chip_smoke.ROUTE_TOL`` (``chip_smoke.card_vs_host_steps``; the
    parameters' step is printed, not held: Adan's first updates do not
    scale with the gradient, as the distill step's test notes)."""
    from lm2a_tpu_torch.diffusion.schedule import make_schedule
    from lm2a_tpu_torch.training.checkpoint import load_state_arrays, state_arrays
    from lm2a_tpu_torch.training.train_step import init_train_state, make_train_step

    cfg, t = V1_CFG, 64
    host = torch.device("cpu")
    arrays = state_arrays(init_train_state(cfg, 4, host))
    sides = {}
    for label, d in (("card", dev), ("host", host)):
        state = init_train_state(cfg, 0, d)
        load_state_arrays(state, arrays)
        sides[label] = (state, make_train_step(make_schedule(cfg.diffusion, device=d), cfg,
                                               dataset_mean=-4.6, dataset_std=1.9))
    _build.reset_launches()
    out = chip_smoke.card_vs_host_steps(sides, _v1_batch(2, t, 21), cfg, 2, chip_smoke.ROUTE_TOL,
                                        "v1 train step", "[v1 test]", "card vs CPU",
                                        gate_update=False)
    assert len(out) == 2
    per_step = chip_smoke.v1_launches_per_step(cfg.model, t)
    assert dict(_build.LAUNCHES) == {k: 2 * v for k, v in per_step.items()}


def test_v1_graphed_train_steps_equal_their_eager_run(dev):
    """Two calls of K = 2 device-data v1 steps (``--steps_per_call 2
    --device_data``, the attention kernel at v1's head dims, ``adan_ema``):
    the graphed run (the first step the warm-up, three replays) against the
    same steps eager from the same state: losses and the whole state the
    same bits, the same launches, four steps' worth."""
    from lm2a_tpu_torch.core import graphs
    from lm2a_tpu_torch.diffusion.schedule import make_schedule
    from lm2a_tpu_torch.training.checkpoint import state_arrays
    from lm2a_tpu_torch.training.train_step import init_train_state, make_device_data_multistep

    cfg = V1_CFG
    data = {k: v.to(dev) for k, v in _v1_batch(6, 64, 22).items()}
    idx = [[[0, 4], [5, 1]], [[2, 3], [3, 0]]]
    out = {}
    for label in ("graph", "eager"):
        state = init_train_state(cfg, 0, dev)
        multi = make_device_data_multistep(make_schedule(cfg.diffusion, device=dev), cfg,
                                           dataset_mean=-4.6, dataset_std=1.9)
        _build.reset_launches()
        with graphs.eager_on_card() if label == "eager" else contextlib.nullcontext():
            losses = [multi(state, data, torch.tensor(i), 7, [2 * c, 2 * c + 1])
                      for c, i in enumerate(idx)]
        torch.cuda.synchronize()
        out[label] = (torch.cat(losses).cpu(), state_arrays(state), dict(_build.LAUNCHES))
    assert torch.isfinite(out["graph"][0]).all()
    assert torch.equal(out["graph"][0], out["eager"][0])
    assert out["graph"][2] == out["eager"][2]
    per_step = chip_smoke.v1_launches_per_step(cfg.model, 64)
    assert out["graph"][2] == {k: 4 * v for k, v in per_step.items()}
    for key, want in out["eager"][1].items():
        assert (out["graph"][1][key] == want).all(), key


def test_a_capture_that_a_wrapper_refuses_raises(dev, monkeypatch):
    """A kernel wrapper refusing a launch plan inside a capture (ERR_PLAN:
    here only while capturing) fails the capture loudly; the step keeps
    raising and never runs eagerly instead; the stream is left capturing
    nothing."""
    from lm2a_tpu_torch.core import graphs

    gen = torch.Generator().manual_seed(11)
    w, x, film = chip_smoke.random_chain(gen, 2, 64, 128, 128, False, dev)
    real = rb.conv3_plan

    def plan(*a):
        p = real(*a)
        if torch.cuda.is_current_stream_capturing():
            return dataclasses.replace(p, smem=p.smem - 1024)
        return p

    monkeypatch.setattr(rb, "conv3_plan", plan)
    out = []
    step = graphs.GraphedStep(lambda: out.append(rb.fused_resblock_chain(x, w, *film)),
                              device=dev)
    _build.reset_launches()
    with pytest.raises(RuntimeError, match="launch plan"):
        step()
    assert len(out) == 1 and step.graph is None  # the warm-up ran; the capture did not
    with pytest.raises(RuntimeError, match="capture failed"):
        step()
    assert len(out) == 1 and not torch.cuda.is_current_stream_capturing()
    assert _build.LAUNCHES == {"gn_stats": 2, "conv3_fused": 2}  # the warm-up's alone
    torch.cuda.synchronize()


def test_train_and_distill_at_c_over_g_8(dev, tmp_path):
    """Base width 64 at 8 groups (C/G = 8 in the 64-channel blocks): the
    JAX gate routes every block to the fused train chain, and on the card
    every one of them runs the forward and backward kernels. ``cli train
    --fused_resblock_grad`` runs on the card (two steps, the launches of
    all its blocks), and one train step and one distill step from one state
    match the CPU within ``chip_smoke.ROUTE_TOL`` (loss, each gradient
    leaf, the whole gradient)."""
    _train_and_distill_route(dev, tmp_path, 64)


def test_train_and_distill_at_base_width_32(dev, tmp_path):
    """The same at base width 32 (C/G 4 in its 32-channel blocks, K chunks
    of 32): every block on the forward and backward kernels, one train and
    one distill step within ``chip_smoke.ROUTE_TOL`` of the CPU."""
    _train_and_distill_route(dev, tmp_path, 32)


def _train_and_distill_route(dev, tmp_path, base):
    from lm2a_tpu_torch.diffusion.schedule import make_schedule
    from lm2a_tpu_torch.ops import resblock_grad as rg
    from lm2a_tpu_torch.training import distill
    from lm2a_tpu_torch.training.checkpoint import load_state_arrays, state_arrays
    from lm2a_tpu_torch.training.train_step import (
        Draws, init_train_state, make_optimizer, make_train_step,
    )

    cfg = dataclasses.replace(DISTILL_CFG, model=dataclasses.replace(DISTILL_CFG.model,
                                                                     base_dim=base))
    geos = chip_smoke.resblock_geometries(cfg.model, 64)
    assert any(base in (cin, cout) for _, _, cin, cout, _, _ in geos)
    assert all(rg.resblock_train_fits(t, cin, cout, skip, 2) for _, t, cin, cout, skip, _ in geos)

    clips = str(tmp_path / "clips")
    chip_smoke.write_clips(clips, 4, seed=3, mel_t=64, motion_t=23)
    chip_smoke.run_cli(["pack", "--npz_dir", clips, "--out_dir", str(tmp_path / "pack")])
    _build.reset_launches()
    chip_smoke.run_cli(["train", "--npz_dir", str(tmp_path / "pack"), "--save_dir",
                        str(tmp_path / "run"), "--batch_size", "2", "--base_dim", str(base),
                        "--dim_mults", "1,2", "--cond_dim", "16", "--time_emb_dim", "32",
                        "--num_res_blocks", "1", "--mid_blocks", "1", "--attn_heads", "2",
                        "--epochs", "1", "--fused_resblock_grad", "--opt_backend", "pallas",
                        "--no_tensorboard"])
    per_step, gated = chip_smoke.train_launches_per_step(cfg.model, 64)
    assert gated == len(geos)
    assert dict(_build.LAUNCHES) == {k: 2 * v for k, v in per_step.items()}

    gen = torch.Generator().manual_seed(13)
    batch = {"mel": -4.6 + 1.9 * torch.randn((2, 64, 80), generator=gen),
             "motion": torch.randn((2, 64, 234), generator=gen),
             "lyrics": torch.randn((2, 64, 768), generator=gen)}
    tol = chip_smoke.ROUTE_TOL
    pre = state_arrays(init_train_state(cfg, 0, "cpu"))
    teacher_ema = init_train_state(cfg, 5, "cpu").ema

    def one(d, kind):
        optimizer = make_optimizer(cfg)
        state = init_train_state(cfg, 0, d, optimizer)
        load_state_arrays(state, pre)
        sched = make_schedule(cfg.diffusion, device=d)
        b = {k: v.to(d) for k, v in batch.items()}
        if kind == "train":  # injected draws, no generator: no condition drop, no dropout
            noise = torch.randn((2, 64, 80), generator=torch.Generator().manual_seed(2))
            keep = torch.ones((2, 1, 1))
            loss = make_train_step(sched, cfg, optimizer, -4.6, 1.9)(
                state, b, draws=Draws(torch.tensor([3, 700]), noise, keep))
        else:
            ema = {k: v.to(d) for k, v in teacher_ema.items()}
            distill.start_student(state, ema)
            step = distill.make_distill_step(sched, cfg, optimizer, 4, dataset_mean=-4.6,
                                             dataset_std=1.9, guidance_weight=2.1)
            dr = distill.DistillDraws(torch.tensor([0, 3]),
                                      torch.randn((2, 64, 80),
                                                  generator=torch.Generator().manual_seed(4)))
            loss = step(state, distill.build_teacher(cfg, ema), b, draws=dr)
        return float(loss), {n: p.grad.detach().cpu().clone() for n, p in state.params().items()}

    for kind in ("train", "distill"):
        (lk, gk), (lp, gp) = one(dev, kind), one(torch.device("cpu"), kind)
        assert abs(lk - lp) <= tol["loss_rel"] * abs(lp), (kind, lk, lp)
        gsum = float(torch.sqrt(sum(g.square().sum() for g in gp.values())))
        num = 0.0
        for name, g in gp.items():
            diff = float((gk[name] - g).norm())
            assert diff <= tol["leaf_rel_l2"] * float(g.norm()) + tol["leaf_floor"] * gsum, (
                kind, name)
            num += diff * diff
        assert num ** 0.5 <= tol["grad_rel_l2"] * gsum, kind


# ---------------------------------------------------------------- narrow base widths

NARROW_BASES = (16, 32, 48, 96)  # C/G 2, 4, 6 and 12 at default_num_groups


def _narrow_blocks(base):
    """Each distinct (Cin, Cout, skip, add_residual) of a base-``base`` model
    (the default dim_mults 1, 2, 4): widths 16·k, partial K chunks and N tiles."""
    geos = chip_smoke.resblock_geometries(chip_smoke.ModelConfig(base_dim=base), 64)
    return sorted({g[2:] for g in geos})


@pytest.mark.parametrize("base", NARROW_BASES)
@pytest.mark.parametrize("rows,t", [(2, 37), (4, 65)])
def test_narrow_widths_forward_kernels(dev, base, rows, t):
    """``gn_stats`` and ``conv3_fused`` at every block of base widths 16,
    32, 48 and 96 against their plain versions: the kernels take widths
    that are multiples of 8 and any C/G, with no plain-version route."""
    for cin, cout, skip, add_res in _narrow_blocks(base):
        gen = torch.Generator().manual_seed(base + cin + cout + t)
        w, x, (fs, fh) = chip_smoke.random_chain(gen, rows, t, cin, cout, skip, dev)
        _build.reset_launches()
        got = rb.fused_resblock_chain(x, w, fs, fh, add_residual=add_res)
        torch.cuda.synchronize()
        assert _build.LAUNCHES == {"gn_stats": 2, "conv3_fused": 2}, (cin, cout)
        _close(got, rb.resblock_chain_plain(x, w, fs, fh, add_residual=add_res), TOL["chain"])
        m1, r1 = rb.gn_stats(x, w.groups1)
        args1 = (x, m1, r1, w.gn1_scale, w.gn1_bias, w.conv1_w, w.conv1_b)
        for kw in (dict(film=(fs, fh)), dict(film=(fs, fh), save_pre=True)):
            _close(rb.conv3_fused(*args1, **kw), rb.conv3_fused_plain(*args1, **kw),
                   TOL["conv3_fused"])
        _close(rb.gn_stats(x, w.groups1), rb.gn_stats_plain(x, w.groups1), TOL["gn_stats"])


@pytest.mark.parametrize("base", NARROW_BASES)
def test_narrow_widths_backward_kernels(dev, base):
    """``conv3_dgrad``, ``conv3_wgrad`` and ``gn_bwd`` at every block of the
    narrow bases, one by one and as a whole block backward, against their
    plain versions within ``chip_smoke.TOL_REL_L2``."""
    for cin, cout, skip, _ in _narrow_blocks(base):
        test_backward_kernels_one_by_one(dev, 2, 37, cin, cout, skip)
        test_resblock_backward_matches_plain(dev, 3, 65, cin, cout, skip)


def _odd_blocks(which):
    """Blocks whose widths are off the 8-channel unit: every distinct block
    of base width 12 or 20 (widths 12·k and 20·k, C/G 3, 5, 6 and 10), or an
    odd-width pair (Cin 21 -> Cout 42 with a skip, and 42 -> 42 with the
    residual; C/G 21)."""
    if which == "odd":
        return [(21, 42, True, False), (42, 42, False, True)]
    return _narrow_blocks(int(which[4:]))


@pytest.mark.parametrize("which", ["base12", "base20", "odd"])
def test_widths_off_the_8_channel_unit_run_against_plain(dev, which):
    """Widths off the 8-channel unit, through the kernels' masked forms:
    ``gn_stats`` + ``conv3_fused`` (the chain and conv 1's modes) and
    ``conv3_dgrad``, ``conv3_wgrad``, ``gn_bwd`` (one by one and as a whole
    block backward) at every such block, against their plain versions
    (``TOL``, ``chip_smoke.TOL_REL_L2``)."""
    for cin, cout, skip, add_res in _odd_blocks(which):
        for rows, t in ((2, 37), (4, 65)):
            gen = torch.Generator().manual_seed(cin + cout + t)
            w, x, (fs, fh) = chip_smoke.random_chain(gen, rows, t, cin, cout, skip, dev)
            _build.reset_launches()
            got = rb.fused_resblock_chain(x, w, fs, fh, add_residual=add_res)
            torch.cuda.synchronize()
            assert _build.LAUNCHES == {"gn_stats": 2, "conv3_fused": 2}, (cin, cout)
            _close(got, rb.resblock_chain_plain(x, w, fs, fh, add_residual=add_res), TOL["chain"])
            m1, r1 = rb.gn_stats(x, w.groups1)
            args1 = (x, m1, r1, w.gn1_scale, w.gn1_bias, w.conv1_w, w.conv1_b)
            for kw in (dict(film=(fs, fh)), dict(film=(fs, fh), save_pre=True)):
                _close(rb.conv3_fused(*args1, **kw), rb.conv3_fused_plain(*args1, **kw),
                       TOL["conv3_fused"])
        test_backward_kernels_one_by_one(dev, 2, 37, cin, cout, skip)
        test_resblock_backward_matches_plain(dev, 3, 65, cin, cout, skip)


def test_base_width_32_fused_attention_on_the_card(dev, tmp_path):
    """A base-32 checkpoint on the fused attention route at 8 heads (head
    dims 4, 8 and 16; C/G 4 and 8): one guided forward on the card's
    kernels against the CPU's plain versions within
    ``chip_smoke.UNET_REL_L2``, every block on ``gn_stats`` and
    ``conv3_fused`` and every attention core on the kernel, then a DDIM
    chain through ``generate_mel`` with finite output."""
    from lm2a_tpu_torch.diffusion.gaussian import guided_eps
    from lm2a_tpu_torch.inference.sample import generate_mel, load_models

    ckpt = _narrow_ckpt(tmp_path, base_dim=32, attn_heads=8, fused_attention=True)
    gen = torch.Generator().manual_seed(21)
    b, t = 2, 64
    x = torch.randn((b, t, 80), generator=gen)
    steps = torch.tensor([10, 700])
    motion, lyrics = torch.randn((b, t, 234), generator=gen), torch.randn((b, t, 768), generator=gen)
    eps, launches = {}, {}
    for d in (torch.device("cpu"), dev):
        models = load_models(ckpt, device=d)
        _build.reset_launches()
        with torch.no_grad():
            m, l = models.cond_proj(motion.to(d), lyrics.to(d))
            eps[d.type] = guided_eps(models.denoiser, x.to(d), steps.to(d), m, l, 2.1,
                                     uncond_fast=True).cpu()
        launches[d.type] = dict(_build.LAUNCHES)
    n_blocks = len(chip_smoke.resblock_geometries(models.cfg.model, t))
    n_attn = len(chip_smoke.attention_sites(models.cfg.model, t))
    assert launches["cuda"]["gn_stats"] == 2 * n_blocks + 1
    assert launches["cuda"]["conv3_fused"] == 2 * n_blocks
    assert launches["cuda"]["attention"] >= 2 * n_attn  # two branches, the CFG constant's too
    assert torch.isfinite(eps["cuda"]).all()
    assert chip_smoke.rel_l2(eps["cuda"], eps["cpu"]) <= chip_smoke.UNET_REL_L2
    mel = generate_mel(models, motion[0].numpy(), lyrics[0].numpy(), t, guidance_weight=2.1,
                       method="ddim", ddim_steps=4, seed=0, batch=1)[0]
    assert mel.shape == (1, 80, t) and torch.isfinite(torch.from_numpy(mel)).all()


def test_first_divergence_names_the_module_a_replay_departs_at(dev):
    """``chip_smoke.first_divergence`` (what the smoke prints when a replay
    is not the eager run's bits): nothing for a module that replays the
    same bits, and the first module whose output departs under the graph."""

    class Departs(torch.nn.Module):
        def forward(self, x):
            return x + float(torch.cuda.is_current_stream_capturing())

    net = torch.nn.Sequential(torch.nn.Linear(8, 8), torch.nn.ReLU()).to(dev)
    x = torch.randn((4, 8), device=dev)
    assert chip_smoke.first_divergence(net, lambda: net(x)).startswith("none")
    net = torch.nn.Sequential(torch.nn.Linear(8, 8), Departs(), torch.nn.ReLU()).to(dev)
    assert chip_smoke.first_divergence(net, lambda: net(x)).startswith("1 (max abs 1.000e+00)")


@pytest.mark.parametrize("cout,parts,b,t", [(1024, 2, 2, 129), (42, 2, 2, 65), (24, 3, 2, 65)],
                         ids=["flagship-shard", "odd", "groups-straddle"])
@pytest.mark.parametrize("mode", ["residual", "skip", "split_skip", "none"])
def test_partial_form_matches_plain(dev, cout, parts, b, t, mode):
    """``conv3_fused``'s partial form (tensor parallelism's row-parallel conv
    2) on each rank's input channels and columns: a flagship conv 2 shard
    (C = 1024, Cin 512 a rank), an odd width (42 over 2: 21 channels a rank,
    a rank's columns off the 8-channel unit) and GroupNorm groups that
    straddle ranks (24 channels, 8 groups, 3 ranks: each channel's own
    group's statistics), with each epilogue (the residual, a summed skip, a
    kept-apart skip, none): each rank's launch against its plain version
    and twice for the same bits, counted as ``conv3_fused_part``, and the
    ranks' sums against the whole conv 2 (plain, fp32 out)."""
    from lm2a_tpu_torch.ops import resblock_grad as rg

    cin2 = cout // 2
    groups = chip_smoke.default_num_groups(cout)
    w, x, film = chip_smoke.random_chain(torch.Generator().manual_seed(cout + t), b, t, cin2,
                                         cout, mode in ("skip", "split_skip"), dev)
    f = torch.randn((b, t, cout), generator=torch.Generator().manual_seed(t)).to(dev)
    m2, r2 = rb.gn_stats(f, groups)
    kw_whole = dict(out_dtype=torch.float32)
    if mode in ("skip", "split_skip"):
        kw_whole.update(skip=(x, w.skip_w, w.skip_b), split_skip=mode == "split_skip")
    elif mode == "residual":
        res = torch.randn((b, t, cout), generator=torch.Generator().manual_seed(1)).to(
            dev, torch.bfloat16)
        kw_whole.update(residual=res)
    want = rb.conv3_fused_plain(f, m2, r2, w.gn2_scale, w.gn2_bias, w.conv2_w, w.conv2_b,
                                **kw_whole)
    want = want if isinstance(want, tuple) else (want,)
    cs, total, skips = cout // parts, 0.0, []

    class Rank:
        index = None

        def __init__(self, i):
            self.index, self.parts = i, parts

        def all_reduce(self, s):
            return s

    for i in range(parts):
        lo, hi = rg.tp_cols(cout, Rank(i))
        fl = f[..., lo:hi].contiguous()
        # a rank's statistics: its own groups, or each channel's group's (the sums
        # over every rank's channels, as the model axis's all-reduce gives them)
        if groups % parts == 0:
            ml, rl = rb.gn_stats(fl, groups // parts)
        else:
            idx = torch.arange(lo, hi, device=dev) // (cout // groups)
            ml, rl = m2[:, idx].contiguous(), r2[:, idx].contiguous()
        w2 = w.conv2_w.view(cout, 3, cout)[:, :, lo:hi].reshape(cout, 3 * cs).contiguous()
        kw = dict(kw_whole, part=(lo, hi))
        if "skip" in kw:
            kw["skip"] = (x, w.skip_w[lo:hi].contiguous(), w.skip_b[lo:hi].contiguous())
        args = (fl, ml, rl, w.gn2_scale[lo:hi].contiguous(), w.gn2_bias[lo:hi].contiguous(), w2,
                w.conv2_b)
        _build.reset_launches()
        got = rb.conv3_fused(*args, **kw)
        assert _build.LAUNCHES == {"conv3_fused_part": 1}
        again, plain = rb.conv3_fused(*args, **kw), rb.conv3_fused_plain(*args, **kw)
        got, again, plain = ((v,) if not isinstance(v, tuple) else v for v in (got, again, plain))
        for g, a, p in zip(got, again, plain):
            assert torch.equal(g, a), "two launches differ"
            torch.testing.assert_close(g.float(), p.float(), **chip_smoke.TOL["conv3_fused"])
        total = total + got[0]
        skips += list(got[1:])
    torch.testing.assert_close(total, want[0], **chip_smoke.TOL["conv3_fused"])
    if skips:
        torch.testing.assert_close(torch.cat(skips, -1).float(), want[1].float(),
                                   **chip_smoke.TOL["conv3_fused"])


def test_partial_form_refuses_what_it_cannot_take(dev):
    w, x, film = chip_smoke.random_chain(torch.Generator().manual_seed(0), 2, 9, 64, 64, False,
                                         dev)
    f = torch.randn((2, 9, 32), device=dev)
    m, r = rb.gn_stats(f, 4)
    w2 = w.conv2_w.view(64, 3, 64)[:, :, :32].reshape(64, 96).contiguous()
    args = (f, m, r, w.gn2_scale[:32].contiguous(), w.gn2_bias[:32].contiguous(), w2, w.conv2_b)
    with pytest.raises(ValueError, match="partial form"):
        rb.conv3_fused(*args, out_dtype=torch.bfloat16, part=(0, 32))
    with pytest.raises(ValueError, match="partial form"):
        rb.conv3_fused(*args, out_dtype=torch.float32, part=(32, 96))


@pytest.mark.parametrize("parts,c,heads", [(3, 24, 2), (3, 48, 3)],
                         ids=["straddle-replicated-site", "one-head-a-rank"])
def test_split_v1_block_on_the_card_matches_the_cpu_ranks(dev, tmp_path, parts, c, heads):
    """A ``ResBlockV1`` split over 3 gloo ranks on the one card against the
    same ranks on the CPU: GroupNorm 2's 8 groups straddle the ranks; at 2
    heads the site runs replicated on its gathered weights, at 3 it splits
    (one head a rank). The training form in fp32 (TF32 off): the output and
    the gradients of ``sum(out * cot)`` for the inputs and every parameter
    (a split leaf's the rank's shard) within relative L2 ``FP32_REL`` (fp32
    sums of cuDNN and cuBLAS in another order than the CPU's), with a floor
    of 1e-6 of the whole gradient for the key biases (zero in exact
    arithmetic). The serving form in bf16 on the attention kernel's route,
    with and without the CFG constant, against the CPU's plain versions in
    bf16 within ``chip_smoke.UNET_REL_L2``: every call launches the kernel,
    on the heads the rank holds."""
    from _torch_rank_jobs import v1_block_payload
    from _torch_ranks import spawn

    payload = v1_block_payload(np.random.default_rng(parts * c), c, heads, t=37, s=21)
    meta = dict(arch="v1", c=c, temb=16, cond=8, heads=heads, model_axis=parts,
                dtype="bfloat16", fused=True)
    card = spawn("tp_modules", parts, tmp_path / "card", dict(payload, meta=dict(
        meta, device="cuda")), timeout=300.0)
    host = spawn("tp_modules", parts, tmp_path / "host", dict(payload, meta=dict(
        meta, device="cpu")), timeout=300.0)
    split_site = heads % parts == 0
    for r, (g, h) in enumerate(zip(card, host)):
        assert g["split_v1"] == h["split_v1"] and "conv2.weight" in g["split_v1"]
        assert ("cross_attn.attn_text.q_proj.weight" in g["split_v1"]) == split_site
        # serving: both branches, then the CFG constant's and the conditioned row's
        assert g["train_launches"] == {} and g["serve_launches"] == {"attention": 6}, r
        assert g["heads"] == [heads // parts if split_site else heads] * 6, r
        for k in ("v1|serve", "v1|uncond"):
            assert chip_smoke.rel_l2_np({k: g[k]}, {k: h[k]}, [k]) <= chip_smoke.UNET_REL_L2, k
        grads = ["v1|out"] + [k for k in h if k.startswith("v1|d_") or k.startswith("v1|grad|")]
        scale = float(np.sqrt(sum(np.sum(np.square(h[k].astype(np.float64))) for k in grads)))
        for k in grads:
            d = np.linalg.norm(g[k].astype(np.float64) - h[k])
            assert d <= FP32_REL * np.linalg.norm(h[k]) + 1e-6 * scale, (k, d)
