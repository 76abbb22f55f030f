"""Port modules against the JAX package with the weights of a JAX init:
embeddings, CondProjection, multi-head and cross attention (plain and
folded), the UNet helpers, the tiny UNet under CFG ``uncond_rows``, and the
samplers' grid and step. fp32 on both sides; each test states its tolerance
(1e-5 where only float reassociation separates the two)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lm2a_tpu.diffusion.gaussian import ddim_time_grid as jax_grid
from lm2a_tpu.diffusion import make_schedule as jax_make_schedule
from lm2a_tpu.diffusion.gaussian import guided_eps as jax_guided_eps
from lm2a_tpu.diffusion.gaussian import p_sample_step as jax_p_sample_step
from lm2a_tpu.models import attention as jatt
from lm2a_tpu.models import embedding as jemb
from lm2a_tpu.models import unet1d as junet
from lm2a_tpu.models.factory import build_denoiser as jax_build_denoiser
from lm2a_tpu_torch.core.config import DiffusionConfig
from lm2a_tpu_torch.diffusion import gaussian, schedule
from lm2a_tpu_torch.models import attention, embedding, unet1d
from lm2a_tpu_torch.models.factory import build_denoiser

from _torch_port_util import TINY_CFG, load_jax_params, rand

TOL = dict(atol=1e-5, rtol=1e-5)
KEY = jax.random.key(0)


def test_time_embedding():
    t = np.array([0, 3, 999], np.int32)
    np.testing.assert_allclose(
        embedding.sinusoidal_time_embed(torch.tensor(t), 16).numpy(),
        np.asarray(jemb.sinusoidal_time_embed(jnp.asarray(t), 16)), **TOL)
    jm = jemb.TimestepEmbedding(16)
    params = jm.init(KEY, jnp.asarray(t))["params"]
    m = load_jax_params(embedding.TimestepEmbedding(16), params)
    np.testing.assert_allclose(m(torch.tensor(t)).numpy(),
                               np.asarray(jm.apply({"params": params}, jnp.asarray(t))), **TOL)


def test_cond_projection():
    rng = np.random.default_rng(0)
    motion, lyrics = rand(rng, 2, 7, 234), rand(rng, 2, 7, 768)
    jm = jemb.CondProjection(out_dim=8)
    params = jm.init(KEY, motion, lyrics)["params"]
    m = load_jax_params(embedding.CondProjection(234, 768, 8), params)
    for g, w in zip(m(torch.tensor(motion), torch.tensor(lyrics)),
                    jm.apply({"params": params}, motion, lyrics)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_multihead_attention():
    rng = np.random.default_rng(1)
    q, kv = rand(rng, 2, 9, 16), rand(rng, 2, 5, 16)
    jm = jatt.MultiheadAttention(16, 4)
    params = jm.init(KEY, q, kv, kv)["params"]
    m = load_jax_params(attention.MultiheadAttention(16, 4), params)
    np.testing.assert_allclose(m(torch.tensor(q), torch.tensor(kv), torch.tensor(kv)).numpy(),
                               np.asarray(jm.apply({"params": params}, q, kv, kv)), **TOL)


@pytest.mark.parametrize("folded", [False, True])
def test_cross_attention_fusion(folded):
    rng = np.random.default_rng(2)
    h, m_f, t_f = rand(rng, 2, 9, 16), rand(rng, 2, 9, 8), rand(rng, 2, 9, 8)
    params = jatt.CrossAttentionFusion(16, 8, 4).init(KEY, h, m_f, t_f)["params"]
    want = jatt.CrossAttentionFusion(16, 8, 4, folded=folded).apply(
        {"params": params}, h, m_f, t_f)
    m = load_jax_params(attention.CrossAttentionFusion(16, 8, 4), params)
    if folded:
        m.fold(torch.float32)
    got = m(torch.tensor(h), torch.tensor(m_f), torch.tensor(t_f))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("t", [1, 5, 64])
def test_upsample_and_fix_time_len(t):
    rng = np.random.default_rng(t)
    x = rand(rng, 2, t, 3)
    np.testing.assert_allclose(
        unet1d.upsample_linear_2x_align_corners(torch.tensor(x)).numpy(),
        np.asarray(junet.upsample_linear_2x_align_corners(jnp.asarray(x))), **TOL)
    for target in (t - 1, t, t + 1):
        np.testing.assert_array_equal(unet1d._fix_time_len(torch.tensor(x), target).numpy(),
                                      np.asarray(junet._fix_time_len(jnp.asarray(x), target)))


def test_unet_cfg_uncond_rows_matches_fused_folded_jax():
    """Tiny UNet, 2 CFG rows (row 0 unconditional), against JAX with
    fused_resblock=True (Pallas interpret mode) and folded_attention=True.
    T=13 exercises the down-conv length change and _fix_time_len.
    Tolerance 1e-4 absolute: about 20 stacked layers in another order."""
    import dataclasses

    mc = TINY_CFG.model
    rng = np.random.default_rng(3)
    b, t = 1, 13
    x, m_f, t_f = rand(rng, b, t, mc.in_dim), rand(rng, b, t, mc.cond_dim), rand(rng, b, t, mc.cond_dim)
    x2 = np.concatenate([x, x])
    m2 = np.concatenate([np.zeros_like(m_f), m_f])
    l2 = np.concatenate([np.zeros_like(t_f), t_f])
    ts = np.array([5, 5], np.int32)
    jplain = jax_build_denoiser(mc)
    params = jax.jit(jplain.init)(KEY, x2, ts, m2, l2)["params"]
    jfused = jax_build_denoiser(dataclasses.replace(mc, fused_resblock=True, folded_attention=True))
    apply = jax.jit(jfused.apply, static_argnames=("uncond_rows",))
    want = np.asarray(apply({"params": params}, x2, ts, m2, l2, uncond_rows=b))
    model = load_jax_params(build_denoiser(TINY_CFG.model), params).prepare(torch.float32)
    got = model(torch.tensor(x2), torch.tensor(ts).long(), torch.tensor(m2), torch.tensor(l2),
                uncond_rows=b).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    # and without the constant fold: the same numbers
    plain = model(torch.tensor(x2), torch.tensor(ts).long(), torch.tensor(m2), torch.tensor(l2))
    np.testing.assert_allclose(plain.numpy(), got, atol=1e-5, rtol=0)


@pytest.mark.parametrize("steps", [8, 12, 25, 50, 100, 250])
def test_ddim_time_grid_is_jax_grid_exactly(steps):
    ts, ts_prev = gaussian.ddim_time_grid(1000, steps)
    jts, jprev = jax_grid(1000, steps)
    np.testing.assert_array_equal(ts, np.asarray(jts))
    np.testing.assert_array_equal(ts_prev, np.asarray(jprev))


def test_schedule_and_p_sample_step():
    cfg = DiffusionConfig()
    sch, jsch = schedule.make_schedule(cfg), jax_make_schedule(cfg)
    np.testing.assert_allclose(sch.betas.numpy(), np.asarray(jsch.betas), rtol=1e-6)
    np.testing.assert_allclose(sch.alpha_bars.numpy(), np.asarray(jsch.alpha_bars), rtol=1e-5)
    rng = np.random.default_rng(5)
    x, eps, noise = rand(rng, 3, 4, 2), rand(rng, 3, 4, 2), rand(rng, 3, 4, 2)
    t = np.array([0, 1, 999], np.int32)
    got = gaussian.p_sample_step(sch, torch.tensor(x), torch.tensor(t).long(),
                                 torch.tensor(eps), torch.tensor(noise))
    want = jax_p_sample_step(jsch, jnp.asarray(x), jnp.asarray(t), jnp.asarray(eps),
                             jnp.asarray(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=1e-5)


def test_guided_eps_clamps():
    rng = np.random.default_rng(6)
    x, m = rand(rng, 2, 3, 4), rand(rng, 2, 3, 4)

    def fn(xx, tt, mm, ll, **kw):  # conditional branch far from the unconditional one
        return xx * 3 + mm * 40 + ll

    def tfn(xx, tt, mm, ll, **kw):
        return fn(*(torch.as_tensor(np.asarray(a)) for a in (xx, tt, mm, ll)))

    t = np.zeros(2, np.int32)
    for w in (1.0, 2.1):
        got = gaussian.guided_eps(tfn, torch.tensor(x), torch.tensor(t), torch.tensor(m),
                                  torch.tensor(m), w)
        want = jax_guided_eps(fn, jnp.asarray(x), jnp.asarray(t), jnp.asarray(m),
                              jnp.asarray(m), w)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
