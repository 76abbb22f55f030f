"""Port of the snake sandwich and the BigVGAN generator against the JAX
package. fp32 on both sides.

- resamplers and the sandwich: 1e-5 absolute (float reassociation only);
- the small generator: 2e-4 absolute on a [-1, 1] waveform (many stacked
  convolutions in a different summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lm2a_tpu.vocoder import BigVGANGenerator as JaxGenerator
from lm2a_tpu.vocoder import SnakeAlias as JaxSnakeAlias
from lm2a_tpu.vocoder import VocoderConfig as JaxVocoderConfig
from lm2a_tpu.vocoder import downsample2x as jax_down
from lm2a_tpu.vocoder import kaiser_sinc_filter1d as jax_kaiser
from lm2a_tpu.vocoder import upsample2x as jax_up
from lm2a_tpu.vocoder.pallas_sandwich import fused_snake_sandwich
from lm2a_tpu_torch.convert import BIGVGAN_CONV_TRANSPOSE
from lm2a_tpu_torch.vocoder import filters, sandwich
from lm2a_tpu_torch.vocoder.bigvgan import BigVGANGenerator, VocoderConfig

from _torch_port_util import load_jax_params, rand

TOL = dict(atol=1e-5, rtol=1e-5)


def test_filter_taps_identical():
    np.testing.assert_array_equal(filters.kaiser_sinc_filter1d(0.25, 0.3, 12),
                                  jax_kaiser(0.25, 0.3, 12))


@pytest.mark.parametrize("t", [1, 5, 37])
def test_resamplers_match_jax(t):
    rng = np.random.default_rng(t)
    x = rand(rng, 2, t, 3)
    up = filters.upsample2x(torch.tensor(x)).numpy()
    np.testing.assert_allclose(up, np.asarray(jax_up(jnp.asarray(x))), **TOL)
    y = rand(rng, 2, 2 * t + 1, 3)  # odd length too
    np.testing.assert_allclose(filters.downsample2x(torch.tensor(y)).numpy(),
                               np.asarray(jax_down(jnp.asarray(y))), **TOL)


@pytest.mark.parametrize("t,c", [
    (300, 640),  # the Pallas grid uses 128-sample tiles at C=640: 3 tiles
    (301, 640),  # odd T, ragged last tile
    (5, 24),     # T below the 8-sample halo
])
def test_sandwich_matches_pallas_and_unfused(t, c):
    rng = np.random.default_rng(t + c)
    x = rand(rng, 2, t, c)
    alpha = np.exp(rand(rng, c, scale=0.3))
    beta = np.exp(rand(rng, c, scale=0.3))
    got = sandwich.snake_sandwich(torch.tensor(x), torch.tensor(alpha), torch.tensor(beta))
    fused = fused_snake_sandwich(jnp.asarray(x), jnp.asarray(alpha), jnp.asarray(beta),
                                 interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(fused), **TOL)
    mod = JaxSnakeAlias(c, beta=True, logscale=True)
    params = {"params": {"alpha": jnp.log(alpha), "beta": jnp.log(beta)}}
    unfused = mod.apply(params, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(unfused), atol=2e-5, rtol=2e-5)


def test_sandwich_reads_channels_first_views():
    """The vocoder hands the wrapper a (B, T, C) view of (B, C, T) memory;
    the output keeps that layout."""
    rng = np.random.default_rng(7)
    x = torch.tensor(rand(rng, 1, 6, 40)).transpose(1, 2)  # (1, 40, 6) view
    a = torch.ones(6)
    z = sandwich.snake_sandwich(x, a, a)
    assert z.stride() == x.stride()
    np.testing.assert_allclose(z.numpy(),
                               sandwich.snake_sandwich(x.contiguous(), a, a).numpy())


TINY = dict(upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
            upsample_initial_channel=32, resblock_kernel_sizes=(3, 5),
            resblock_dilation_sizes=((1, 2), (1, 2)))


@pytest.mark.parametrize("resblock_type,final", [("1", True), ("2", False)])
def test_generator_matches_jax(resblock_type, final):
    kw = dict(TINY, resblock_type=resblock_type, use_bias_at_final=final,
              use_tanh_at_final=final)
    jcfg, pcfg = JaxVocoderConfig(**kw), VocoderConfig(**kw)
    rng = np.random.default_rng(8)
    mel = rand(rng, 1, 12, 80)
    jgen = JaxGenerator(cfg=jcfg)  # the Pallas sandwich is held above
    params = jax.jit(jgen.init)(jax.random.key(3), jnp.asarray(mel))["params"]
    # non-trivial snake parameters so alpha/beta carry-over is exercised
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: v + 0.1 * jnp.sin(jnp.arange(v.size, dtype=v.dtype).reshape(v.shape))
        if p[-1].key in ("alpha", "beta") else v, params)
    want = np.asarray(jax.jit(jgen.apply)({"params": params}, jnp.asarray(mel)))
    gen = load_jax_params(BigVGANGenerator(pcfg), params, BIGVGAN_CONV_TRANSPOSE)
    got = gen(torch.tensor(mel)).numpy()
    assert got.shape == want.shape == (1, 12 * 8)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)
