"""WAV output without external audio libraries (port of the writer in
``lm2a_tpu/utils/audio.py``)."""

from __future__ import annotations

import wave

import numpy as np


def write_wav(path: str, y: np.ndarray, sr: int) -> None:
    """Write mono float32 [-1, 1] as 16-bit PCM."""
    y = np.asarray(y, dtype=np.float32).reshape(-1)
    pcm = np.clip(y * 32767.0, -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
