"""The port's CUDA kernels against their plain PyTorch versions, on the card.

A CUDA kernel has no CPU mode, so every test here needs an NVIDIA GPU and
skips without one. On a machine with a card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q

(``--noconftest`` because ``tests/conftest.py`` sets up JAX, which these
tests do not use.) ``chip_smoke.py`` holds the kernels at the flagship
geometries; these take the edges it does not reach: ragged and short time
tiles, T below the sandwich's halo, fp32 sandwich inputs, every epilogue of
``conv3_fused`` the chain uses, the wrappers' refusals and their launch counts.

Tolerances are those of ``chip_smoke.py``: 1e-2 absolute + relative on bf16
outputs (one bf16 ulp, where the kernel's and torch's SiLU round an operand
to neighbouring bf16 values), 3e-2 on a whole chain; GroupNorm statistics
1e-4 / 1e-3; the fp32 sandwich 1e-5 (fp32 sums in another order).
"""

import pytest
import torch

import chip_smoke
from lm2a_tpu_torch.ops import _build
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
    for kw in (dict(film=film), dict()):
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
