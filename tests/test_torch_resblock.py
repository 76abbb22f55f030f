"""Port of the fused resblock chain (lm2a_tpu_torch/ops/resblock.py) against
the JAX package: the Pallas kernel in interpret mode, the split two-call
path, and the plain-XLA reference. fp32 on both sides; tolerance 1e-5
absolute + relative (float reassociation only)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lm2a_tpu.ops.pallas_resblock as prb
from lm2a_tpu.ops.pallas_resblock import fused_resblock_chain, resblock_chain_reference
from lm2a_tpu_torch.ops import resblock as port

from _torch_port_util import max_err, rand

TOL = dict(atol=1e-5, rtol=1e-5)


def _args(rng, b, t, cin, cout, has_skip):
    args = [
        rand(rng, b, t, cin),
        1 + rand(rng, cin, scale=0.1), rand(rng, cin, scale=0.1),
        rand(rng, 3, cin, cout, scale=0.1), rand(rng, cout, scale=0.1),
        rand(rng, b, cout, scale=0.2), rand(rng, b, cout, scale=0.2),
        1 + rand(rng, cout, scale=0.1), rand(rng, cout, scale=0.1),
        rand(rng, 3, cout, cout, scale=0.1), rand(rng, cout, scale=0.1),
    ]
    if has_skip:
        args += [rand(rng, cin, cout, scale=0.1), rand(rng, cout, scale=0.1)]
    else:
        args += [None, None]
    return args


def _port(args, groups, add_residual):
    x, g1s, g1b, w1, b1, fs, fh, g2s, g2b, w2, b2, sw, sb = args
    w = port.ResblockWeights.from_jax(g1s, g1b, w1, b1, g2s, g2b, w2, b2, sw, sb,
                                      groups1=groups, groups2=groups)
    out = port.fused_resblock_chain(torch.tensor(x), w, torch.tensor(fs),
                                    torch.tensor(fh), add_residual=add_residual)
    return [o.numpy() for o in out] if isinstance(out, tuple) else [out.numpy()]


def _jax(fn, args, groups, add_residual, **kw):
    out = fn(*[None if a is None else jnp.asarray(a) for a in args],
             groups1=groups, groups2=groups, add_residual=add_residual, **kw)
    return [np.asarray(o) for o in out] if isinstance(out, tuple) else [np.asarray(out)]


CASES = [(True, True), (True, False), (False, True), (False, False)]


@pytest.mark.parametrize("has_skip,add_residual", CASES)
def test_chain_matches_pallas_and_reference(has_skip, add_residual):
    rng = np.random.default_rng(1)
    cin, cout = (32, 16) if has_skip else (32, 32)
    args = _args(rng, 2, 20, cin, cout, has_skip)
    got = _port(args, 4, add_residual)
    for want in (_jax(fused_resblock_chain, args, 4, add_residual, interpret=True),
                 _jax(resblock_chain_reference, args, 4, add_residual)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("has_skip,add_residual", CASES[:3])
def test_chain_matches_split_path(has_skip, add_residual, monkeypatch):
    """The JAX split (_half1/_half2) path, forced by shrinking the VMEM
    budget to the larger half as tests/test_pallas_resblock.py does."""
    rng = np.random.default_rng(2)
    cin = 32
    cout = 16 if has_skip else cin
    args = _args(rng, 2, 24, cin, cout, has_skip)
    half1 = args[3].size * 4
    half2 = args[9].size * 4 + (args[11].size * 4 if has_skip else 0)
    monkeypatch.setattr(prb, "VMEM_WEIGHT_BUDGET", max(half1, half2))
    want = _jax(fused_resblock_chain, args, 4, add_residual, interpret=True)
    for g, w in zip(_port(args, 4, add_residual), want):
        np.testing.assert_allclose(g, w, **TOL)


def test_gn_stats_plain_matches_fast_variance():
    rng = np.random.default_rng(3)
    x = rand(rng, 2, 17, 32, scale=2.0) + 0.5
    mean, rstd = port.gn_stats_plain(torch.tensor(x), 8)
    xg = x.reshape(2, 17, 8, 4).astype(np.float64)
    m = xg.mean(axis=(1, 3))
    var = (xg * xg).mean(axis=(1, 3)) - m * m
    np.testing.assert_allclose(mean.numpy(), m, atol=1e-6)
    np.testing.assert_allclose(rstd.numpy(), 1 / np.sqrt(var + 1e-5), rtol=1e-5)


def test_bf16_chain_close_to_fp32():
    """bf16 weights/activations (the card's compute dtype) stay within bf16
    rounding of the fp32 chain: 3e-2 absolute on O(1) outputs."""
    rng = np.random.default_rng(4)
    args = _args(rng, 2, 20, 32, 32, False)
    x, g1s, g1b, w1, b1, fs, fh, g2s, g2b, w2, b2, _, _ = args
    outs = []
    for dt in (torch.float32, torch.bfloat16):
        w = port.ResblockWeights.from_jax(g1s, g1b, w1, b1, g2s, g2b, w2, b2,
                                          groups1=4, groups2=4, dtype=dt)
        outs.append(port.fused_resblock_chain(torch.tensor(x), w, torch.tensor(fs),
                                              torch.tensor(fh)).float().numpy())
    assert max_err(outs[0], outs[1]) < 3e-2


def test_wrappers_refuse_other_devices():
    x = torch.zeros((1, 4, 32), device="meta")
    with pytest.raises(ValueError):
        port.gn_stats(x, 8)
