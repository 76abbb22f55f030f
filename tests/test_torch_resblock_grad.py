"""The fused resblock training chain of the port against the JAX package.

- ``resblock_bwd_plain`` (the kernels' plain versions composed as the card
  composes the kernels) against JAX's ``_resblock_bwd_call`` with the Pallas
  kernel in interpret mode: all 11 (13 with a skip) gradients, fp32 and bf16;
- gradients through the port's autograd Function (fp32 master weights in
  Conv1d layouts) against ``jax.grad`` of ``fused_resblock_train``;
- ``resblock_train_fits`` against the JAX gate at the flagship geometries.

Tolerances, relative L2 per gradient: fp32 1e-5 (sums in another order);
bf16 1e-3 (the same bf16 operands; a handful can round to the other bf16
neighbour where the fp32 value feeding them differs in the last bit).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from lm2a_tpu.ops import pallas_resblock as prb
from lm2a_tpu_torch.core.config import ModelConfig
from lm2a_tpu_torch.ops import resblock_grad as rg

from _torch_port_util import one_torch_thread, rand, rel_l2  # noqa: F401

NAMES = ["dx", "dg1s", "dg1b", "dw1", "db1", "dsc", "dsh", "dg2s", "dg2b", "dw2", "db2",
         "dsw", "dsb"]
TOL = {"float32": 1e-5, "bfloat16": 1e-3}


def _inputs(rng, b, t, cin, cout, has_skip):
    return dict(
        x=rand(rng, b, t, cin), g1s=1 + rand(rng, cin, scale=0.1), g1b=rand(rng, cin, scale=0.1),
        w1=rand(rng, 3, cin, cout, scale=0.2), b1=rand(rng, cout, scale=0.1),
        sc=rand(rng, b, cout, scale=0.2), sh=rand(rng, b, cout, scale=0.2),
        g2s=1 + rand(rng, cout, scale=0.1), g2b=rand(rng, cout, scale=0.1),
        w2=rand(rng, 3, cout, cout, scale=0.2), b2=rand(rng, cout, scale=0.1),
        sw=rand(rng, cin, cout, scale=0.2) if has_skip else None,
        sb=rand(rng, cout, scale=0.1) if has_skip else None,
        gh=rand(rng, b, t, cout), gx=rand(rng, b, t, cout) if has_skip else None)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("has_skip", [False, True], ids=["no_skip", "skip"])
def test_backward_matches_jax_kernel(has_skip, dtype):
    rng = np.random.default_rng(1 + has_skip)
    b, t, cin = 2, 70, 32  # T off the 64-frame tile
    cout = 16 if has_skip else 32
    a = _inputs(rng, b, t, cin, cout, has_skip)
    jdt = jnp.dtype(dtype)
    J = lambda v: None if v is None else jnp.asarray(v)  # noqa: E731
    want = prb._resblock_bwd_call(
        J(a["x"]).astype(jdt), J(a["g1s"]), J(a["g1b"]), J(a["w1"]), J(a["b1"]), J(a["sc"]),
        J(a["sh"]), J(a["g2s"]), J(a["g2b"]), J(a["w2"]), J(a["sw"]), J(a["gh"]).astype(jdt),
        None if a["gx"] is None else J(a["gx"]).astype(jdt), groups1=4, groups2=4,
        interpret=True)
    tdt = getattr(torch, dtype)
    T = lambda v: None if v is None else torch.tensor(v)  # noqa: E731
    got = rg.resblock_bwd_plain(
        T(a["x"]).to(tdt), T(a["g1s"]), T(a["g1b"]), T(a["w1"]), T(a["b1"]), T(a["sc"]),
        T(a["sh"]), T(a["g2s"]), T(a["g2b"]), T(a["w2"]), T(a["sw"]), T(a["gh"]).to(tdt),
        None if a["gx"] is None else T(a["gx"]).to(tdt), groups1=4, groups2=4)
    assert len(got) == len(want) == (13 if has_skip else 11)
    for name, g, w in zip(NAMES, got, want):
        w = np.asarray(w.astype(jnp.float32))
        assert tuple(g.shape) == w.shape, name
        assert g.dtype == (tdt if name == "dx" else torch.float32), name
        assert rel_l2(g.float().numpy(), w) <= TOL[dtype], name


@pytest.mark.parametrize("has_skip", [False, True], ids=["no_skip", "skip"])
def test_autograd_matches_jax_grad(has_skip):
    """``fused_resblock_train`` under autograd (fp32 master weights, Conv1d
    layouts) against ``jax.grad`` of the JAX function, fp32."""
    rng = np.random.default_rng(3)
    b, t, cin = 2, 40, 32
    cout = 64 if has_skip else 32
    a = _inputs(rng, b, t, cin, cout, has_skip)
    r_h, r_x = rand(rng, b, t, cout), rand(rng, b, t, cout)
    keys = ["x", "g1s", "g1b", "w1", "b1", "sc", "sh", "g2s", "g2b", "w2", "b2"]
    keys += ["sw", "sb"] if has_skip else []

    def jloss(*args):
        out = prb.fused_resblock_train(*args, groups1=8, groups2=8)
        h, xs = out if has_skip else (out, None)
        val = jnp.sum(h * r_h)
        return val + jnp.sum(xs * r_x) if has_skip else val

    want = jax.grad(jloss, argnums=tuple(range(len(keys))))(*[jnp.asarray(a[k]) for k in keys])

    def conv(w):  # JAX (K, Cin, Cout) -> Conv1d (Cout, Cin, K)
        return torch.tensor(np.ascontiguousarray(np.asarray(w).transpose(2, 1, 0)))

    p = {k: torch.tensor(a[k]) for k in keys}
    p["w1"], p["w2"] = conv(a["w1"]), conv(a["w2"])
    if has_skip:
        p["sw"] = conv(a["sw"][None])
    for v in p.values():
        v.requires_grad_()
    out = rg.fused_resblock_train(*[p[k] for k in keys], groups1=8, groups2=8)
    h, xs = out if has_skip else (out, None)
    loss = (h * torch.tensor(r_h)).sum()
    if has_skip:
        loss = loss + (xs * torch.tensor(r_x)).sum()
    loss.backward()
    for k, w in zip(keys, want):
        g = p[k].grad
        if k in ("w1", "w2", "sw"):
            g = g.permute(2, 1, 0)
            w = w if k != "sw" else w[None]
        assert g.dtype == torch.float32, k
        assert rel_l2(g.numpy(), np.asarray(w)) <= TOL["float32"], k


def test_train_gate_matches_jax_at_flagship_geometries():
    geoms = {(t, cin, cout, skip) for _, t, cin, cout, skip, _ in
             chip_smoke.resblock_geometries(ModelConfig(), 516)}
    assert len(geoms) == 9
    for t, cin, cout, skip in geoms:
        for itemsize in (2, 4):
            assert (rg.resblock_train_fits(t, cin, cout, skip, itemsize)
                    == prb.resblock_train_fits(t, cin, cout, skip, itemsize))
    fused = [name for name, t, cin, cout, skip, _ in
             chip_smoke.resblock_geometries(ModelConfig(), 516)
             if rg.resblock_train_fits(t, cin, cout, skip, 2)]
    assert fused == ["down_0_block_0", "down_0_block_1", "down_1_block_0", "down_1_block_1",
                     "up_1_block_1", "up_2_block_0", "up_2_block_1"]


def test_gate_declines_and_wrappers_refuse_other_devices():
    x = torch.zeros((1, 516, 1024), dtype=torch.bfloat16)
    w = torch.zeros((1024, 1024, 3))
    v = torch.zeros(1024)
    assert rg.fused_resblock_train(x, v, v, w, v, v[None], v[None], v, v, w, v,
                                   groups1=8, groups2=8) is None
    meta = torch.zeros((1, 4, 64), device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="unsupported device"):
        rg.conv3_dgrad(meta, torch.zeros((64, 192), device="meta", dtype=torch.bfloat16))
