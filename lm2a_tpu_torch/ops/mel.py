"""Mel-spectrogram extraction (port of ``lm2a_tpu/ops/mel.py``).

The mel convention BigVGAN's ``get_mel_spectrogram`` gives (the JAX
package's): reflect-pad the waveform by ``(n_fft - hop) // 2`` a side, STFT
with a periodic Hann window and ``center=False``, magnitude
``sqrt(re^2 + im^2 + 1e-9)``, the Slaney mel filterbank (librosa's
``htk=False, norm='slaney'``), then ``log(clip(mel, 1e-5))``. The filterbank
and window are numpy, computed once per configuration; the STFT is
``torch.fft.rfft`` over the frames of one gather, on the waveform's device.
The JAX package computes these outside any Pallas kernel, as plain XLA ops,
so here they are plain PyTorch.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from lm2a_tpu_torch.core.config import MelConfig


def _hz_to_mel_slaney(f):
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = f >= min_log_hz
    return np.where(log_region,
                    min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mels)


def _mel_to_hz_slaney(m):
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = m * f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = m >= min_log_mel
    return np.where(log_region, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


def slaney_mel_filterbank(sample_rate: int, n_fft: int, num_mels: int, fmin: float = 0.0,
                          fmax: Optional[float] = None) -> np.ndarray:
    """Triangular Slaney-normalised mel filterbank, (num_mels, n_fft//2+1)
    float32: ``librosa.filters.mel`` with its defaults, computed in float64."""
    if fmax is None:
        fmax = sample_rate / 2.0
    n_freqs = n_fft // 2 + 1
    fftfreqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    mel_pts = np.linspace(_hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax), num_mels + 2)
    hz_pts = _mel_to_hz_slaney(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2: num_mels + 2] - hz_pts[:num_mels])  # Slaney energy norm
    weights *= enorm[:, None]
    return weights.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _cached_filterbank(sr, n_fft, num_mels, fmin, fmax):
    return slaney_mel_filterbank(sr, n_fft, num_mels, fmin, fmax)


def hann_window_periodic(win_size: int) -> np.ndarray:
    """Periodic Hann window (``torch.hann_window``'s default)."""
    n = np.arange(win_size, dtype=np.float64)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * n / win_size))).astype(np.float32)


def frame_count(num_samples: int, cfg: MelConfig) -> int:
    """STFT frames of a waveform of ``num_samples`` samples."""
    pad = (cfg.n_fft - cfg.hop_size) // 2
    return 1 + (num_samples + 2 * pad - cfg.n_fft) // cfg.hop_size


def stft_magnitude(wav: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """Magnitude STFT ``(..., frames, n_fft//2+1)`` of a waveform ``(..., T)``."""
    pad = (cfg.n_fft - cfg.hop_size) // 2
    lead = wav.shape[:-1]
    x = torch.nn.functional.pad(wav.reshape(-1, 1, wav.shape[-1]).float(), (pad, pad),
                                mode="reflect").reshape(*lead, -1)
    n_frames = 1 + (x.shape[-1] - cfg.n_fft) // cfg.hop_size
    window = hann_window_periodic(cfg.win_size)
    if cfg.win_size < cfg.n_fft:  # torch.stft centre-pads a short window
        lpad = (cfg.n_fft - cfg.win_size) // 2
        window = np.pad(window, (lpad, cfg.n_fft - cfg.win_size - lpad))
    idx = (torch.arange(n_frames, device=x.device)[:, None] * cfg.hop_size
           + torch.arange(cfg.n_fft, device=x.device)[None, :])
    frames = x[..., idx] * torch.as_tensor(window, device=x.device)  # (..., frames, n_fft)
    spec = torch.fft.rfft(frames, dim=-1)
    return torch.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-9)


def mel_spectrogram(wav: torch.Tensor, cfg: MelConfig = MelConfig()) -> torch.Tensor:
    """Log-mel spectrogram ``(..., frames, num_mels)``, channels-last (the npz
    schema's (80, T) is a transpose at the serialisation boundary)."""
    mag = stft_magnitude(wav, cfg)
    fb = torch.as_tensor(_cached_filterbank(cfg.sample_rate, cfg.n_fft, cfg.num_mels,
                                            float(cfg.fmin), cfg.fmax), device=mag.device)
    return torch.log(torch.clamp(mag @ fb.t(), min=1e-5))
