"""The attention core of the port (``ops/attention.py``) and the fused
attention route of its models, against the JAX package on the CPU.

- ``attention_core_plain`` (what ``attention_core`` runs for CPU tensors)
  against JAX ``attention_core`` (the Pallas kernels in interpret mode, as
  ``tests/test_pallas_attention.py`` runs them) and the plain XLA
  ``attention_core_reference``, at that file's shapes; against the streaming
  kernel ``_attention_pallas_streaming`` at a ragged long S; bf16 inputs
  against JAX's bf16 route; T = S = 1;
- the backward of the ``autograd.Function`` against autograd through the
  plain version;
- ``MultiheadAttention`` / ``CrossAttentionFusion`` with ``fused`` and a tiny
  ``UNet1DUltimate`` with ``fused_attention`` (with and without the CFG
  constant ``uncond_rows``) against the JAX modules with the same switches,
  the weights of a JAX init carried across; ``prepare`` keeps that route
  unfolded.

Tolerances: fp32 1e-5 absolute / 1e-4 relative where only the order of
float sums differs (the JAX tests' figure), 2e-5 against the streaming
kernel (its figure), 2e-4 on the tiny UNet (``test_unet_fused_equals_unfused``
in the JAX suite). bf16: 2^-7 relative (two bf16 ulps of the output) and
2^-8 absolute, because the kernel rounds ``exp(s - max)`` before normalising
and ``_attention_kernel`` after: each rounding errs by up to 2^-9 of a
summand ``p v`` (|v| < 4 here), which near-cancelling outputs feel as an
absolute error; both sides lie within those bounds of an fp64 softmax of
the same bf16 inputs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lm2a_tpu.models import attention as jatt
from lm2a_tpu.models.factory import build_denoiser as jax_build_denoiser
from lm2a_tpu.ops import pallas_attention as jpa
from lm2a_tpu_torch.models import attention
from lm2a_tpu_torch.models.factory import build_denoiser
from lm2a_tpu_torch.ops import attention as att

from _torch_port_util import TINY_CFG, load_jax_params, one_torch_thread, rand  # noqa: F401

KEY = jax.random.key(0)
TOL = dict(atol=1e-5, rtol=1e-4)
BF16_TOL = dict(atol=2.0 ** -8, rtol=2.0 ** -7)


def _qkv(seed, b, h, t, s, hd):
    rng = np.random.default_rng(seed)
    return rand(rng, b, h, t, hd), rand(rng, b, h, s, hd), rand(rng, b, h, s, hd)


def _plain(q, k, v, dtype=torch.float32):
    return att.attention_core_plain(*(torch.tensor(a).to(dtype) for a in (q, k, v)))


@pytest.mark.parametrize("b,h,t,s,hd", [
    (2, 4, 16, 16, 32),    # aligned
    (1, 8, 66, 66, 32),    # unaligned T
    (2, 2, 516, 516, 32),  # the clip's mel length
    (1, 4, 33, 33, 64),    # another head dim
    (1, 2, 20, 13, 32),    # keys shorter than queries
    # head dims off the powers of two: base 48's and 96's 6, 12, 24 and 48,
    # v1's 96 and 192 at its default widths
    (1, 8, 40, 37, 6),
    (1, 8, 40, 37, 12),
    (1, 8, 40, 37, 24),
    (1, 8, 40, 37, 48),
    (1, 2, 40, 37, 96),
    (1, 2, 40, 37, 192),
])
def test_plain_matches_jax_kernel_and_reference(b, h, t, s, hd):
    q, k, v = _qkv(b + h + t, b, h, t, s, hd)
    got = _plain(q, k, v).numpy()
    np.testing.assert_allclose(got, np.asarray(jpa.attention_core(q, k, v)), **TOL)
    np.testing.assert_allclose(got, np.asarray(jpa.attention_core_reference(q, k, v)), **TOL)
    # the wrapper on CPU tensors is the plain version
    wrapped = att.attention_core(*(torch.tensor(a) for a in (q, k, v)))
    np.testing.assert_array_equal(wrapped.numpy(), got)


def test_plain_matches_streaming_kernel():
    """Ragged T and S over several S tiles: padding and the key mask."""
    q, k, v = _qkv(7, 1, 2, 300, 1400, 16)
    want = jpa._attention_pallas_streaming(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           interpret=True, block_t=128, block_s=512)
    np.testing.assert_allclose(_plain(q, k, v).numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("t,s", [(40, 40), (24, 1100)])
def test_bf16_matches_jax_bf16_route(t, s):
    """bf16 q, k, v: JAX's _attention_kernel (S <= 1024) or _flash_kernel."""
    q, k, v = _qkv(t, 1, 2, t, s, 32)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    want = np.asarray(jpa.attention_core(*jb).astype(jnp.float32))
    got = _plain(q, k, v, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, **BF16_TOL)


def test_single_query_single_key():
    """T = S = 1, as the CFG constant calls it: the output is v."""
    q, k, v = _qkv(3, 1, 4, 1, 1, 16)
    got = _plain(q, k, v).numpy()
    np.testing.assert_allclose(got, v, atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(jpa.attention_core(q, k, v)), **TOL)


def test_backward_matches_autograd_through_plain():
    q, k, v = _qkv(4, 1, 2, 12, 9, 32)
    g = rand(np.random.default_rng(5), 1, 2, 12, 32)
    grads = []
    for fn in (att.attention_core, att.attention_core_plain):
        xs = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
        fn(*xs).backward(torch.tensor(g))
        grads.append([x.grad.numpy() for x in xs])
    for a, b in zip(*grads):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-5)
    # and JAX's custom VJP (recomputed through attention_core_reference)
    _, vjp = jax.vjp(jpa.attention_core, q, k, v)
    for a, b in zip(grads[0], vjp(g)):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)


def test_multihead_attention_fused():
    rng = np.random.default_rng(1)
    q, kv = rand(rng, 2, 18, 16), rand(rng, 2, 11, 16)
    params = jatt.MultiheadAttention(16, 4).init(KEY, q, kv, kv)["params"]
    want = jatt.MultiheadAttention(16, 4, fused=True).apply({"params": params}, q, kv, kv)
    m = load_jax_params(attention.MultiheadAttention(16, 4, fused=True), params)
    got = m(torch.tensor(q), torch.tensor(kv), torch.tensor(kv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cross_attention_fusion_fused_takes_the_unfolded_path():
    rng = np.random.default_rng(2)
    h, m_f, t_f = rand(rng, 2, 9, 16), rand(rng, 2, 9, 8), rand(rng, 2, 9, 8)
    params = jatt.CrossAttentionFusion(16, 8, 4).init(KEY, h, m_f, t_f)["params"]
    # JAX: folded and fused together take the unfolded, fused path
    want = jatt.CrossAttentionFusion(16, 8, 4, fused=True, folded=True).apply(
        {"params": params}, h, m_f, t_f)
    m = load_jax_params(attention.CrossAttentionFusion(16, 8, 4, fused=True), params)
    m.fold(torch.float32)
    m.folded["w_out"].zero_()  # the folded weights must not be read
    got = m(torch.tensor(h), torch.tensor(m_f), torch.tensor(t_f))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.fixture(scope="module")
def tiny_fused():
    mc = dataclasses.replace(TINY_CFG.model, fused_attention=True)
    rng = np.random.default_rng(3)
    t = 13
    x, m_f, t_f = (rand(rng, 1, t, mc.in_dim), rand(rng, 1, t, mc.cond_dim),
                   rand(rng, 1, t, mc.cond_dim))
    x2 = np.concatenate([x, x])
    m2 = np.concatenate([np.zeros_like(m_f), m_f])
    l2 = np.concatenate([np.zeros_like(t_f), t_f])
    ts = np.array([5, 5], np.int32)
    jm = jax_build_denoiser(mc)
    params = jax.jit(jm.init)(KEY, x2, ts, m2, l2)["params"]
    apply = jax.jit(jm.apply, static_argnames=("uncond_rows",))
    return mc, params, apply, (x2, ts, m2, l2)


@pytest.mark.parametrize("uncond_rows", [0, 1])
def test_tiny_unet_fused_route_matches_jax(tiny_fused, uncond_rows):
    mc, params, apply, (x2, ts, m2, l2) = tiny_fused
    want = np.asarray(apply({"params": params}, x2, ts, m2, l2, uncond_rows=uncond_rows))
    model = load_jax_params(build_denoiser(mc), params).prepare(torch.float32)
    got = model(torch.tensor(x2), torch.tensor(ts).long(), torch.tensor(m2), torch.tensor(l2),
                uncond_rows=uncond_rows)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=2e-4)


def test_prepare_leaves_the_fused_route_unfolded(tiny_fused):
    mc, params, _, _ = tiny_fused
    fused = load_jax_params(build_denoiser(mc), params).prepare(torch.float32)
    plain = load_jax_params(build_denoiser(TINY_CFG.model), params).prepare(torch.float32)
    for model, want_fused in ((fused, True), (plain, False)):
        sites = [b.cross_attn for b in model.resblocks() if b.use_attn]
        assert sites and all(c.fused == want_fused for c in sites)
        assert all((c.folded is None) == want_fused for c in sites)
