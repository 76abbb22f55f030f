"""MFCC audio embeddings in the librosa convention.

Every set-level wav metric in the reference (FAD, NDB, JS/KL, acoustic
similarity) embeds a file as the time-mean of 40 MFCCs computed by
``librosa.feature.mfcc`` with defaults (``reference/metrics/fad.py:
11-14`` and siblings). librosa is not a dependency of the package, so its default chain is
implemented here:

mel power spectrogram (n_fft 2048, hop 512, centered reflect pad, Hann,
power 2, 128 slaney mels to sr/2) -> power_to_db (ref=1, amin=1e-10,
top_db=80) -> orthonormal DCT-II over the mel axis -> first ``n_mfcc`` rows.

A copy of ``lm2a_tpu/eval/mfcc.py`` (numpy and scipy only) with the port's
imports, so the port imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np
from scipy.fft import dct

from lm2a_tpu_torch.ops.mel import slaney_mel_filterbank


def _stft_power(y: np.ndarray, n_fft: int = 2048, hop: int = 512) -> np.ndarray:
    """Centered magnitude^2 STFT, (1+n_fft/2, frames) — librosa layout."""
    y = np.asarray(y, dtype=np.float32)
    pad = n_fft // 2
    y = np.pad(y, (pad, pad), mode="reflect")
    n_frames = 1 + (len(y) - n_fft) // hop
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft))
    idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    frames = y[idx] * window
    spec = np.fft.rfft(frames, axis=-1)
    return (np.abs(spec) ** 2).T.astype(np.float64)


def power_to_db(s: np.ndarray, amin: float = 1e-10, top_db: float = 80.0):
    log_spec = 10.0 * np.log10(np.maximum(amin, s))
    if top_db is not None:
        log_spec = np.maximum(log_spec, log_spec.max() - top_db)
    return log_spec


def melspectrogram(
    y: np.ndarray, sr: int = 22050, n_fft: int = 2048, hop: int = 512,
    n_mels: int = 128,
) -> np.ndarray:
    power = _stft_power(y, n_fft=n_fft, hop=hop)
    fb = slaney_mel_filterbank(sr, n_fft, n_mels).astype(np.float64)
    return fb @ power


def mfcc(
    y: np.ndarray, sr: int = 22050, n_mfcc: int = 40, n_mels: int = 128
) -> np.ndarray:
    """(n_mfcc, frames) MFCC matrix (librosa default chain)."""
    s_db = power_to_db(melspectrogram(y, sr=sr, n_mels=n_mels))
    return dct(s_db, type=2, axis=0, norm="ortho")[:n_mfcc]


def mfcc_embedding(y: np.ndarray, sr: int = 22050, n_mfcc: int = 40) -> np.ndarray:
    """Time-mean MFCC vector — the embed_fn of the reference's wav metrics."""
    return mfcc(y, sr=sr, n_mfcc=n_mfcc).mean(axis=1)


def embed_file(path: str, sr: int = 22050, n_mfcc: int = 40) -> np.ndarray:
    from lm2a_tpu_torch.utils.audio import read_wav

    y, _ = read_wav(path, target_sr=sr)
    return mfcc_embedding(y, sr=sr, n_mfcc=n_mfcc)
