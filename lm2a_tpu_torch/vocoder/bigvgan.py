"""BigVGAN generator in PyTorch: mel (B, T, num_mels) -> waveform (B, hop*T).

The port of ``lm2a_tpu/vocoder/bigvgan.py``: conv_pre (k7) -> N upsample
stages (transposed conv, rate r_i), each followed by |K| parallel AMP blocks
averaged together -> anti-aliased post activation -> conv_post (k7) -> tanh
(v1) or clamp (v2). Every activation is the anti-aliased SnakeBeta sandwich,
which runs as the fused CUDA kernel on the card (``vocoder/sandwich.py``).

Module attribute names follow the flax names (``resblock_0_1.act2_2.alpha``,
``up_3``, ...), so flax parameters carry over by a rule per leaf kind
(``lm2a_tpu_torch.convert``). Inside the generator activations stay
channels-first ``(B, C, T)``, the layout ``F.conv1d`` and the sandwich kernel
read along time; the public ``forward`` keeps the JAX layout.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn as nn

from lm2a_tpu_torch.vocoder.sandwich import snake_sandwich


@dataclass(frozen=True)
class VocoderConfig:
    num_mels: int = 80
    upsample_rates: Tuple[int, ...] = (4, 4, 2, 2, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (8, 8, 4, 4, 4, 4)
    upsample_initial_channel: int = 1536
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = (
        (1, 3, 5), (1, 3, 5), (1, 3, 5),
    )
    resblock_type: str = "1"  # '1' = AMPBlock1 (two convs/dilation), '2' = one
    activation: str = "snakebeta"  # 'snake' | 'snakebeta'
    snake_logscale: bool = True
    sample_rate: int = 22050
    # v2 checkpoints: bias-less conv_post and a clamp instead of tanh
    use_bias_at_final: bool = True
    use_tanh_at_final: bool = True

    @property
    def hop(self) -> int:
        h = 1
        for r in self.upsample_rates:
            h *= r
        return h


# nvidia/bigvgan_22khz_80band (the checkpoint the reference loads)
BIGVGAN_22KHZ_80BAND = VocoderConfig()
# nvidia/bigvgan_base_22khz_80band
BIGVGAN_BASE_22KHZ_80BAND = VocoderConfig(
    upsample_rates=(8, 8, 2, 2),
    upsample_kernel_sizes=(16, 16, 4, 4),
    upsample_initial_channel=512,
)
# nvidia/bigvgan_v2_24khz_100band_256x
BIGVGAN_V2_24KHZ_100BAND = VocoderConfig(
    num_mels=100,
    sample_rate=24000,
    use_bias_at_final=False,
    use_tanh_at_final=False,
)
# nvidia/bigvgan_v2_44khz_128band_512x
BIGVGAN_V2_44KHZ_128BAND = VocoderConfig(
    num_mels=128,
    sample_rate=44100,
    upsample_rates=(8, 4, 2, 2, 2, 2),
    upsample_kernel_sizes=(16, 8, 4, 4, 4, 4),
    use_bias_at_final=False,
    use_tanh_at_final=False,
)


class SnakeAlias(nn.Module):
    """Anti-aliased Snake/SnakeBeta on (B, C, T): up2x -> snake -> down2x."""

    def __init__(self, channels: int, beta: bool = True, logscale: bool = True):
        super().__init__()
        init = torch.zeros if logscale else torch.ones
        self.alpha = nn.Parameter(init(channels))
        self.beta = nn.Parameter(init(channels)) if beta else None
        self.logscale = logscale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        alpha = self.alpha.float()
        beta = self.beta.float() if self.beta is not None else alpha
        if self.logscale:
            alpha, beta = torch.exp(alpha), torch.exp(beta)
        return snake_sandwich(x.transpose(1, 2), alpha, beta).transpose(1, 2)


def _conv(cin, cout, kernel, dilation=1):
    return nn.Conv1d(cin, cout, kernel, dilation=dilation,
                     padding=(kernel * dilation - dilation) // 2)


class AMPBlock1(nn.Module):
    """Anti-aliased multi-periodicity residual block (BigVGAN resblock '1')."""

    def __init__(self, channels, kernel=3, dilations=(1, 3, 5), beta=True, logscale=True):
        super().__init__()
        self.n = len(dilations)
        for i, d in enumerate(dilations):
            self.add_module(f"act1_{i}", SnakeAlias(channels, beta, logscale))
            self.add_module(f"conv1_{i}", _conv(channels, channels, kernel, d))
            self.add_module(f"act2_{i}", SnakeAlias(channels, beta, logscale))
            self.add_module(f"conv2_{i}", _conv(channels, channels, kernel, 1))

    def forward(self, x):
        for i in range(self.n):
            xt = getattr(self, f"act1_{i}")(x)
            xt = getattr(self, f"conv1_{i}")(xt)
            xt = getattr(self, f"act2_{i}")(xt)
            xt = getattr(self, f"conv2_{i}")(xt)
            x = x + xt
        return x


class AMPBlock2(nn.Module):
    """Lighter residual block (BigVGAN resblock '2'): one conv per dilation."""

    def __init__(self, channels, kernel=3, dilations=(1, 3), beta=True, logscale=True):
        super().__init__()
        self.n = len(dilations)
        for i, d in enumerate(dilations):
            self.add_module(f"act_{i}", SnakeAlias(channels, beta, logscale))
            self.add_module(f"conv_{i}", _conv(channels, channels, kernel, d))

    def forward(self, x):
        for i in range(self.n):
            x = x + getattr(self, f"conv_{i}")(getattr(self, f"act_{i}")(x))
        return x


class BigVGANGenerator(nn.Module):
    """(B, T, num_mels) log-mel -> (B, hop*T) waveform in [-1, 1]."""

    def __init__(self, cfg: VocoderConfig = BIGVGAN_22KHZ_80BAND):
        super().__init__()
        self.cfg = cfg
        beta = cfg.activation == "snakebeta"
        ch = cfg.upsample_initial_channel
        self.conv_pre = nn.Conv1d(cfg.num_mels, ch, 7, padding=3)
        block_cls = AMPBlock1 if cfg.resblock_type == "1" else AMPBlock2
        for i, (r, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
            # flax padding k-1-(k-r)//2 on both sides == torch padding (k-r)//2
            self.add_module(f"up_{i}", nn.ConvTranspose1d(ch, ch // 2, k, stride=r,
                                                          padding=(k - r) // 2))
            ch //= 2
            for j, (rk, dil) in enumerate(zip(cfg.resblock_kernel_sizes,
                                              cfg.resblock_dilation_sizes)):
                self.add_module(f"resblock_{i}_{j}",
                                block_cls(ch, rk, tuple(dil), beta, cfg.snake_logscale))
        self.activation_post = SnakeAlias(ch, beta, cfg.snake_logscale)
        self.conv_post = nn.Conv1d(ch, 1, 7, padding=3, bias=cfg.use_bias_at_final)

    @property
    def dtype(self) -> torch.dtype:
        return self.conv_pre.weight.dtype

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        nk = len(c.resblock_kernel_sizes)
        x = self.conv_pre(mel.to(self.dtype).transpose(1, 2))
        for i in range(len(c.upsample_rates)):
            x = getattr(self, f"up_{i}")(x)
            acc = None
            for j in range(nk):
                y = getattr(self, f"resblock_{i}_{j}")(x)
                acc = y if acc is None else acc + y
            x = acc / nk
        x = self.activation_post(x)
        x = self.conv_post(x).float()
        x = torch.tanh(x) if c.use_tanh_at_final else torch.clamp(x, -1.0, 1.0)
        return x[:, 0, :]
