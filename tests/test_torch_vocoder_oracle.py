"""The port's vocoder against the JAX package's second oracle,
``lm2a_tpu/vocoder/torch_oracle.py``: a BigVGAN generator with NVIDIA's
module and key layout (weight norm, ``ups.<i>.0``, ``resblocks.<k>``,
snake-beta activations), its 2x resamplers and snake sandwich built from
the documented math.

The oracle's own state dict goes through the port's ``convert_bigvgan`` into
``BigVGANGenerator`` (the NVIDIA loader's path), and the port's generator,
resamplers and snake sandwich (plain versions, on the CPU) are held to the
oracle at the tolerances of ``tests/test_vocoder_torch_parity.py``: 1e-4
relative and 1e-5 absolute on the resamplers, a mean absolute error under
1e-4 on the waveform of a 24-frame mel.
"""

import numpy as np
import torch

from lm2a_tpu.vocoder import VocoderConfig as JaxVocoderConfig
from lm2a_tpu.vocoder.torch_oracle import (
    TorchOracleGenerator, torch_down2x, torch_snake_alias, torch_up2x,
)
from lm2a_tpu_torch.vocoder.bigvgan import BigVGANGenerator, VocoderConfig
from lm2a_tpu_torch.vocoder.convert import convert_bigvgan
from lm2a_tpu_torch.vocoder.filters import downsample2x, upsample2x
from lm2a_tpu_torch.vocoder.sandwich import snake_sandwich_plain

from _torch_port_util import one_torch_thread  # noqa: F401

TINY = dict(upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4), upsample_initial_channel=16,
            resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),),
            activation="snakebeta", snake_logscale=True)
RESAMPLE_TOL = dict(rtol=1e-4, atol=1e-5)


def _x(seed):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=(2, 3, 40))
                            .astype(np.float32))


def _cl(f, x):
    """``f`` of the port (channels-last) on the oracle's (B, C, T) ``x``."""
    return f(x.transpose(1, 2)).transpose(1, 2)


def test_resamplers_match_the_oracle():
    x = _x(0)
    np.testing.assert_allclose(_cl(upsample2x, x).numpy(), torch_up2x(x).numpy(),
                               **RESAMPLE_TOL)
    np.testing.assert_allclose(_cl(downsample2x, x).numpy(), torch_down2x(x).numpy(),
                               **RESAMPLE_TOL)


def test_snake_sandwich_matches_the_oracle():
    x = _x(1)
    rng = np.random.default_rng(2)
    alpha, beta = (torch.from_numpy((0.1 * rng.normal(size=3)).astype(np.float32))
                   for _ in range(2))
    want = torch_snake_alias(x, alpha, beta, logscale=True)
    got = _cl(lambda y: snake_sandwich_plain(y, alpha, beta, logscale=True), x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **RESAMPLE_TOL)


def test_converted_generator_matches_the_oracle():
    torch.manual_seed(0)
    oracle = TorchOracleGenerator(JaxVocoderConfig(**TINY)).eval()
    mel = np.random.default_rng(2).normal(size=(1, 80, 24)).astype(np.float32)
    with torch.no_grad():
        want = oracle(torch.from_numpy(mel)).numpy()[:, 0, :]
    cfg = VocoderConfig(**TINY)
    gen = BigVGANGenerator(cfg)
    gen.load_state_dict(convert_bigvgan(oracle.state_dict(), cfg))
    with torch.no_grad():
        got = gen.eval()(torch.from_numpy(mel.transpose(0, 2, 1))).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).mean() < 1e-4
