"""The snake sandwich kernel's launch rules and arithmetic, on the CPU.

``csrc/sandwich.cu`` has no CPU mode, so what the CPU can hold is held
here, against ``snake_sandwich_plain`` (``lm2a_tpu_torch/vocoder/sandwich.py``)
and the JAX package's ``fused_snake_sandwich`` in interpret mode
(``lm2a_tpu/vocoder/pallas_sandwich.py``):

- ``sandwich_plan`` at every sandwich geometry of the four vocoder configs
  at mel T = 1, 32, 516 and at ragged T: the plan the C entry takes (its
  rule mirrored here, with the refusals the card tests send it), at most
  one wave of resident blocks, and a grid-stride walk that stores every run
  of every row once;
- the multiply-shift division the kernel finds a run's row and channel by,
  with the host's magic numbers;
- an emulation of the kernel in numpy fp32: lanes owning runs of 8 outputs,
  warp tiles of 32 runs storing 30, the input and phase halos by shuffles,
  the edge clamps, the sine's reduction by the 2pi hi/lo split (the
  hardware sine replaced by float64's, so the emulation holds the
  arithmetic around it, and the card tests hold the MUFU), and FMA chains
  rounded once a step; against the plain version and the JAX kernel at
  1e-5 (the tolerance of ``tests/test_torch_sandwich.py``: sums in another
  order only), the reduction alone at |alpha y| up to 1e3;
- ``logscale=True`` against exponentiated parameters, and ``SnakeAlias``
  handing its raw parameters to the kernel;
- ``chip_smoke.activation1d``, BigVGAN's own PyTorch form that the chip run
  times beside the kernel, against the plain version.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from lm2a_tpu.vocoder.pallas_sandwich import fused_snake_sandwich
from lm2a_tpu_torch.vocoder import bigvgan
from lm2a_tpu_torch.vocoder import sandwich as sw
from lm2a_tpu_torch.vocoder.bigvgan import (
    BIGVGAN_22KHZ_80BAND, BIGVGAN_BASE_22KHZ_80BAND, BIGVGAN_V2_24KHZ_100BAND,
    BIGVGAN_V2_44KHZ_128BAND, SnakeAlias,
)

from _torch_port_util import rand

TOL = dict(atol=1e-5, rtol=1e-5)
F32 = np.float32
CONFIGS = {"22khz_80band": BIGVGAN_22KHZ_80BAND, "base_22khz_80band": BIGVGAN_BASE_22KHZ_80BAND,
           "v2_24khz_100band": BIGVGAN_V2_24KHZ_100BAND,
           "v2_44khz_128band": BIGVGAN_V2_44KHZ_128BAND}
GEOMETRIES = sorted({(name, t, c) for cfg_name, cfg in CONFIGS.items() for mel_t in (1, 32, 516)
                     for name, t, c, _ in chip_smoke.sandwich_geometries(cfg, mel_t)})
RAGGED_T = [1, 5, 7, 8, 9, 255, 256, 257, 2047]
DTYPES = [torch.bfloat16, torch.float32]


def channels_first_strides(b, t, c):
    return (c * t, 1, t)


# ---------------------------------------------------------------- the plan

def entry_accepts(plan, b, t, c) -> bool:
    """The C entry's check of a plan (``lm2a_snake_sandwich``), mirrored."""
    if plan.run != sw.RUN or not 1 <= plan.warps <= sw.MAX_WARPS or plan.blocks < 1:
        return False
    runs = b * c * -(-t // sw.RUN)
    if runs + 2 * sw.STORED >= 2 ** 31:
        return False
    tiles = -(-runs // sw.STORED)
    return (plan.blocks <= -(-tiles // plan.warps)
            and plan.tiles == -(-tiles // (plan.blocks * plan.warps)))


def check_plan(b, t, c, dtype, strides):
    plan = sw.sandwich_plan(b, t, c, dtype, strides)
    assert entry_accepts(plan, b, t, c), plan
    n = sw.sandwich_tiles(b, t, c)
    assert plan.blocks <= sw.SMS * sw.blocks_per_sm(plan.warps)  # one wave at most
    # the grid-stride walk: warp w takes tiles w, w + W, ...; every tile once,
    # no warp more than plan.tiles of them
    grid = plan.blocks * plan.warps
    per_warp = np.bincount(np.arange(n) % grid, minlength=grid)
    assert per_warp.max() == plan.tiles and per_warp.sum() == n
    # the tiles store every run once: lanes 1..30 of tile k hold runs 30k..30k+29
    runs = b * c * -(-t // sw.RUN)
    stored = (np.arange(n)[:, None] * sw.STORED + np.arange(sw.STORED)[None, :]).ravel()
    assert np.array_equal(np.sort(stored[stored < runs]), np.arange(runs))
    return plan


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name,t,c", GEOMETRIES)
def test_plan_at_every_vocoder_geometry(name, t, c, dtype):
    plan = check_plan(1, t, c, dtype, channels_first_strides(1, t, c))
    if t * c >= 1_000_000:  # the flagship's stages: a full wave of 4-warp blocks
        assert plan.warps == 4 and plan.blocks == sw.SMS * sw.blocks_per_sm(4)


@pytest.mark.parametrize("layout", ["channels_first", "channels_last"])
@pytest.mark.parametrize("c", [1, 3, 24, 768])
@pytest.mark.parametrize("t", RAGGED_T)
def test_plan_at_ragged_t(t, c, layout):
    b = 2
    strides = channels_first_strides(b, t, c) if layout == "channels_first" else (t * c, c, 1)
    check_plan(b, t, c, torch.bfloat16, strides)


def test_plan_refusals_the_card_tests_send():
    """Every plan the card test ``test_sandwich_refuses_a_plan_it_does_not_take``
    sends is one the entry refuses; the good one it starts from is not."""
    import dataclasses

    good = sw.sandwich_plan(1, 300, 24, torch.bfloat16, channels_first_strides(1, 300, 24))
    n = sw.sandwich_tiles(1, 300, 24)
    assert entry_accepts(good, 1, 300, 24)
    for bad in (dataclasses.replace(good, run=16), dataclasses.replace(good, run=4),
                dataclasses.replace(good, warps=0), dataclasses.replace(good, warps=17),
                dataclasses.replace(good, blocks=0),
                dataclasses.replace(good, blocks=-(-n // good.warps) + 1),
                dataclasses.replace(good, tiles=good.tiles + 1),
                dataclasses.replace(good, tiles=good.tiles - 1)):
        assert not entry_accepts(bad, 1, 300, 24), bad


def test_candidates_are_plans_the_entry_takes():
    for name, t, c in GEOMETRIES[::5]:
        for plan in sw.sandwich_candidates(1, t, c):
            assert entry_accepts(plan, 1, t, c), (name, plan)


# ---------------------------------------------------------------- the division

def fast_div(d: int):
    """The host's magic numbers for n // d (``fast_div`` in csrc/sandwich.cu)."""
    s = 0
    while (1 << s) < d:
        s += 1
    return ((1 << 32) * ((1 << s) - d)) // d + 1, s


def kernel_div(n: np.ndarray, m: int, s: int) -> np.ndarray:
    n = n.astype(np.uint64)
    return ((((n * np.uint64(m)) >> np.uint64(32)) + n) & np.uint64(0xFFFFFFFF)) >> np.uint64(s)


@pytest.mark.parametrize("name,t,c", GEOMETRIES[::3])
def test_fast_division_of_runs(name, t, c):
    """A run's row (run // runs per row) and a row's batch (row // C), as the
    kernel divides, over every run of a 16-row batch and at the 2^31 edge."""
    nr = -(-t // sw.RUN)
    for d, top in ((nr, 16 * c * nr), (c, 16 * c)):
        m, s = fast_div(d)
        n = np.concatenate([np.arange(min(top, 1 << 20)), np.arange(2 ** 31 - 4096, 2 ** 31)])
        np.testing.assert_array_equal(kernel_div(n, m, s), n // d)


# ---------------------------------------------------------------- the arithmetic

INV_2PI, TWO_PI_HI, TWO_PI_LO = F32(0.15915493667125702), F32(6.2831854820251465), F32(-1.7484555314695172e-07)
ROUND_MAGIC = F32(12582912.0)


def fma(a, b, c):
    """fp32 fused multiply-add: the product exact in float64, one rounding."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64) + np.asarray(c, np.float64)).astype(F32)


def snake_emulated(y, al, inv_b):
    """The kernel's snake: u = alpha y, k = rint(u / 2pi) by the 1.5 * 2^23
    trick, r = u - k 2pi by two FMAs on the hi/lo split, the sine of r
    (float64's in place of the MUFU), y + s^2 inv_b."""
    u = (al * y).astype(F32)
    k = (fma(u, INV_2PI, ROUND_MAGIC) - ROUND_MAGIC).astype(F32)
    r = fma(-k, TWO_PI_HI, u)
    r = fma(-k, TWO_PI_LO, r)
    s = np.sin(r.astype(np.float64)).astype(F32)
    return fma((s * s).astype(F32), inv_b, y), r


def shfl_up(v):  # lane i reads lane i - 1; lane 0 its own
    return np.concatenate([v[:, :1], v[:, :-1]], axis=1)


def shfl_down(v):  # lane i reads lane i + 1; lane 31 its own
    return np.concatenate([v[:, 1:], v[:, -1:]], axis=1)


def emulate_kernel(x, alpha, beta, logscale):
    """``csrc/sandwich.cu`` on (B, T, C) fp32 numpy inputs, every warp tile
    at once (a tile's values do not depend on which warp takes it); returns
    z and how many times each output was stored."""
    b_, t_, c_ = x.shape
    R = sw.RUN
    f = sw.kaiser_sinc_filter1d(0.25, 0.3, sw.TAPS).astype(F32)
    up, down = (2 * f).astype(F32), f
    nr = -(-t_ // R)
    runs = b_ * c_ * nr
    tiles = -(-runs // sw.STORED)
    lane = np.arange(32)[None, :]
    g = np.arange(tiles)[:, None] * sw.STORED - 1 + lane
    owner = (lane >= 1) & (lane <= sw.STORED) & (g < runs)
    gc = np.clip(g, 0, runs - 1)
    row = gc // nr
    t0 = (gc - row * nr) * R
    b, c = row // c_, row % c_
    first, last = t0 == 0, t0 + R >= t_
    # xv[..., i] = x[t0 - 3 + i]; the loads clamp at T - 1
    xv = np.zeros(g.shape + (R + 6,), F32)
    for j in range(R):
        xv[..., 3 + j] = x[b, np.minimum(t0 + j, t_ - 1), c]
    al, be = alpha[c].astype(F32), beta[c].astype(F32)
    if logscale:
        al, be = np.exp(al), np.exp(be)
    inv_b = (F32(1) / (be + F32(1e-9))).astype(F32)
    for k in range(3):
        xv[..., k] = shfl_up(xv[..., R + k])
        xv[..., R + 3 + k] = shfl_down(xv[..., 3 + k])
    xv[..., :3] = np.where(first[..., None], xv[..., 3:4], xv[..., :3])
    xv[..., R + 3:] = np.where(last[..., None], xv[..., R + 2:R + 3], xv[..., R + 3:])
    se = np.zeros(g.shape + (R,), F32)
    so = np.zeros_like(se)
    for j in range(R):
        ye, yo = (up[0] * xv[..., j]).astype(F32), (up[1] * xv[..., j + 1]).astype(F32)
        for q in range(1, 6):
            ye = fma(up[2 * q], xv[..., j + q], ye)
            yo = fma(up[2 * q + 1], xv[..., j + q + 1], yo)
        se[..., j] = snake_emulated(ye, al, inv_b)[0]
        so[..., j] = snake_emulated(yo, al, inv_b)[0]
    pos = t0[..., None] + np.arange(R)
    cv = np.where(last, so[..., R - 1], 0)
    for j in range(R):
        cv = np.where(last & (t0 + j == t_ - 1), so[..., j], cv)
    past = last[..., None] & (pos >= t_)
    se = np.where(past, cv[..., None], se)
    so = np.where(past, cv[..., None], so)
    sox = np.zeros(g.shape + (R + 5,), F32)  # s_odd at t0 - 3 + i
    sex = np.zeros_like(sox)                 # s_even at t0 - 2 + i
    sox[..., 3:3 + R], sex[..., 2:2 + R] = so, se
    for k in range(3):
        sox[..., k] = shfl_up(so[..., R - 3 + k])
        sex[..., R + 2 + k] = shfl_down(se[..., k])
    for k in range(2):
        sex[..., k] = shfl_up(se[..., R - 2 + k])
        sox[..., R + 3 + k] = shfl_down(so[..., k])
    sox[..., :3] = np.where(first[..., None], se[..., :1], sox[..., :3])
    sex[..., :2] = np.where(first[..., None], se[..., :1], sex[..., :2])
    sox[..., R + 3:] = np.where(last[..., None], cv[..., None], sox[..., R + 3:])
    sex[..., R + 2:] = np.where(last[..., None], cv[..., None], sex[..., R + 2:])
    z = np.zeros_like(x)
    stores = np.zeros(x.shape, np.int64)
    for j in range(R):
        acc = (down[0] * sox[..., j]).astype(F32)
        acc = fma(down[1], sex[..., j], acc)
        for q in range(1, 6):
            acc = fma(down[2 * q], sox[..., j + q], acc)
            acc = fma(down[2 * q + 1], sex[..., j + q], acc)
        keep = owner & (t0 + j < t_)
        z[b[keep], t0[keep] + j, c[keep]] = acc[keep]
        np.add.at(stores, (b[keep], t0[keep] + j, c[keep]), 1)
    return z, stores


@pytest.mark.parametrize("logscale", [False, True])
@pytest.mark.parametrize("t,c", [(1, 3), (2, 3), (3, 5), (7, 3), (8, 3), (9, 2), (16, 3), (37, 5),
                                 (239, 2), (240, 1), (241, 2), (255, 3), (256, 1), (257, 2),
                                 (481, 1), (2047, 1)])
def test_emulated_kernel_matches_plain(t, c, logscale):
    """Rows shorter than a run, ragged last runs, tiles that cross rows
    (2 x c rows of T), a row of exactly 8 tiles (T = 240): every output
    stored once, equal to the plain version within 1e-5."""
    rng = np.random.default_rng(t * 10 + c)
    x = rand(rng, 2, t, c)
    la, lb = rand(rng, c, scale=0.3), rand(rng, c, scale=0.3)
    a, b = (la, lb) if logscale else (np.exp(la), np.exp(lb))
    z, stores = emulate_kernel(x, a, b, logscale)
    assert (stores == 1).all()
    want = sw.snake_sandwich_plain(torch.tensor(x), torch.tensor(a), torch.tensor(b),
                                   logscale=logscale).numpy()
    np.testing.assert_allclose(z, want, **TOL)


@pytest.mark.parametrize("t,c", [(5, 24), (300, 16), (301, 8)])
def test_emulated_kernel_matches_pallas(t, c):
    """Against the JAX package's Pallas kernel (interpret mode) on the same
    numpy inputs, log-scale parameters raw into the emulation and
    exponentiated into the JAX kernel, as each package's module passes them."""
    rng = np.random.default_rng(t + c)
    x = rand(rng, 2, t, c)
    la, lb = rand(rng, c, scale=0.3), rand(rng, c, scale=0.3)
    z, stores = emulate_kernel(x, la, lb, logscale=True)
    assert (stores == 1).all()
    want = fused_snake_sandwich(jnp.asarray(x), jnp.exp(jnp.asarray(la)), jnp.exp(jnp.asarray(lb)),
                                interpret=True)
    np.testing.assert_allclose(z, np.asarray(want), **TOL)


@pytest.mark.parametrize("scale", [1.0, 30.0, 300.0, 1000.0])
def test_reduction_holds_at_large_arguments(scale):
    """The snake of the same y with the reduction by the 2pi hi/lo split,
    against the plain version's sine of the fp32 product in float64, at
    |alpha y| up to 1e3 (beta 1, so the error is the sine's): within 1e-5,
    and the reduced argument within [-pi, pi] but for what the fp32 rounding
    of 1/2pi moves the nearest k by (|u| 2pi |INV_2PI - 1/2pi|, ~3e-5 at
    1e3) and an ulp."""
    rng = np.random.default_rng(int(scale))
    y = rng.uniform(-1.0, 1.0, 1 << 16).astype(F32)
    al = F32(scale)
    got, r = snake_emulated(y, al, F32(1.0))
    slack = scale * 2 * math.pi * abs(float(INV_2PI) - 1 / (2 * math.pi)) + 2 ** -21
    assert np.abs(r).max() <= math.pi + slack
    want = sw.snake(torch.tensor(y), torch.tensor(al), torch.tensor(F32(1.0 - 1e-9))).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert np.abs(al * y).max() > 0.99 * scale


# ---------------------------------------------------------------- log scale and callers

@pytest.mark.parametrize("t", [1, 37, 300])
def test_logscale_matches_exponentiated_parameters(t):
    rng = np.random.default_rng(t)
    x = torch.tensor(rand(rng, 2, t, 6))
    la, lb = torch.tensor(rand(rng, 6, scale=0.3)), torch.tensor(rand(rng, 6, scale=0.3))
    got = sw.snake_sandwich(x, la, lb, logscale=True)
    assert torch.equal(got, sw.snake_sandwich(x, torch.exp(la), torch.exp(lb)))


@pytest.mark.parametrize("beta,logscale", [(True, True), (False, True), (True, False)])
def test_snake_alias_hands_raw_parameters_to_the_kernel(monkeypatch, beta, logscale):
    """``SnakeAlias`` passes its parameters as they are, with its log-scale
    flag, so nothing is exponentiated outside the kernel; the output is the
    module's function of the exponentiated parameters."""
    mod = SnakeAlias(5, beta=beta, logscale=logscale)
    with torch.no_grad():
        mod.alpha.copy_(torch.linspace(-0.3, 0.4, 5) + (0 if logscale else 1.2))
        if beta:
            mod.beta.copy_(torch.linspace(0.2, -0.1, 5) + (0 if logscale else 1.1))
    seen = []
    real = bigvgan.snake_sandwich

    def spy(x, a, b, logscale=False):
        seen.append((a, b, logscale))
        return real(x, a, b, logscale=logscale)

    monkeypatch.setattr(bigvgan, "snake_sandwich", spy)
    x = torch.tensor(rand(np.random.default_rng(1), 2, 5, 40))
    got = mod(x)
    (a, b, flag), = seen
    assert flag == logscale
    assert torch.equal(a, mod.alpha) and torch.equal(b, mod.beta if beta else mod.alpha)
    conv = torch.exp if logscale else (lambda v: v)
    bb = mod.beta if beta else mod.alpha
    want = sw.snake_sandwich_plain(x.transpose(1, 2), conv(mod.alpha), conv(bb)).transpose(1, 2)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), **TOL)


@pytest.mark.parametrize("t", [1, 5, 37, 300])
def test_activation1d_yardstick_is_the_same_function(t):
    """BigVGAN's replicate-pad / grouped transposed conv / snake / grouped
    conv form (``chip_smoke.activation1d``) computes the plain version's
    function: the chip run's yardstick times the same work."""
    rng = np.random.default_rng(t)
    x = torch.tensor(rand(rng, 2, 7, t))
    a = torch.exp(torch.tensor(rand(rng, 7, scale=0.3)))
    b = torch.exp(torch.tensor(rand(rng, 7, scale=0.3)))
    got = chip_smoke.activation1d(x, a, b)
    want = sw.snake_sandwich_plain(x.transpose(1, 2), a, b).transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
