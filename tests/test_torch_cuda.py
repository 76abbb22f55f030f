"""The port's CUDA kernels against their plain PyTorch versions, on the card.

A CUDA kernel has no CPU mode, so every test here needs an NVIDIA GPU and
skips without one. On a machine with a card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q

(``--noconftest`` because ``tests/conftest.py`` sets up JAX, which these
tests do not use.) ``chip_smoke.py`` holds the kernels at the flagship
geometries; these take the edges it does not reach: ragged and short time
tiles, T below the sandwich's halo, fp32 sandwich inputs, every epilogue of
``conv3_fused`` the chain uses, the attention kernel at every head dim it
takes, T = S = 1, S around the JAX package's streaming threshold, ragged T
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
and both kernels giving the same bits on two launches.

Tolerances are those of ``chip_smoke.py``: 1e-2 absolute + relative on bf16
outputs (one bf16 ulp, where the kernel's and torch's SiLU round an operand
to neighbouring bf16 values), 3e-2 on a whole chain; GroupNorm statistics
1e-4 / 1e-3; the fp32 sandwich 1e-5 (fp32 sums in another order); the
attention kernel ``chip_smoke.TOL["attention"]`` (bf16 output: two ulps, and
the p rounding of the running max against the global one); the training
kernels ``chip_smoke.TOL_REL_L2`` (relative L2) and ``TOL["adan_ema"]``, each
with its reason there.
"""

import pytest
import torch

import chip_smoke
from lm2a_tpu_torch.ops import _build
from lm2a_tpu_torch.ops import attention as att
from lm2a_tpu_torch.ops import resblock as rb
from lm2a_tpu_torch.vocoder import sandwich as sw

pytestmark = pytest.mark.cuda

TOL = dict(chip_smoke.TOL, snake_sandwich_f32=dict(atol=1e-5, rtol=1e-5))


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


@pytest.mark.parametrize("hd", att.HEAD_DIMS)
@pytest.mark.parametrize("t,s", [(1, 1), (64, 64), (129, 516), (37, 300)])
def test_attention_matches_plain(dev, hd, t, s):
    q, k, v = _attn_inputs(dev, 2, 4, t, s, hd, seed=hd + t + s)
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


def test_attention_refuses_what_it_cannot_take(dev):
    q, k, v = _attn_inputs(dev, 1, 2, 16, 16, 32, seed=0)
    _build.reset_launches()
    with pytest.raises(ValueError, match="bf16"):
        att.attention_core(q.float(), k.float(), v.float())
    q48, k48, v48 = _attn_inputs(dev, 1, 2, 16, 16, 48, seed=0)
    with pytest.raises(ValueError, match="head dim 48"):
        att.attention_core(q48, k48, v48)
    with pytest.raises(ValueError, match="hd contiguous"):  # hd at stride 2
        att.attention_core(torch.cat([q, q], dim=-1)[..., ::2], k, v)
    assert not _build.LAUNCHES


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


@pytest.mark.parametrize("b,t,cin,cout,has_skip", BWD_GEOMETRIES[:5])
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
        for g, p in zip(call(kernel), call(plain)):
            if p is not None:
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
    with pytest.raises(ValueError, match="Cout % 32"):
        rg.conv3_dgrad(g[..., :48].contiguous(), w[:48])
    with pytest.raises(ValueError, match="multiples of 64"):
        rg.conv3_wgrad(g[..., :32].contiguous(), g)
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
