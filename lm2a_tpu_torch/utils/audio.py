"""WAV read/write without external audio libraries (port of
``lm2a_tpu/utils/audio.py``): a minimal RIFF codec (PCM 8/16/24/32-bit and
IEEE float32/64, mono by channel averaging), optional polyphase resampling
(scipy) to a target rate, and a 16-bit PCM writer. numpy and scipy only,
the JAX package's code as it is.
"""

from __future__ import annotations

import struct
import wave
from typing import Optional, Tuple

import numpy as np


def _parse_riff(path: str) -> Tuple[np.ndarray, int]:
    """Minimal RIFF/WAVE parser supporting PCM (1) and IEEE float (3)."""
    with open(path, "rb") as f:
        riff, _size, wave_id = struct.unpack("<4sI4s", f.read(12))
        if riff != b"RIFF" or wave_id != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        fmt = None
        data = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            cid, csize = struct.unpack("<4sI", hdr)
            payload = f.read(csize + (csize & 1))
            if cid == b"fmt ":
                fmt = struct.unpack("<HHIIHH", payload[:16])
            elif cid == b"data":
                data = payload[:csize]
        if fmt is None or data is None:
            raise ValueError(f"{path}: missing fmt/data chunk")

    audio_fmt, channels, sr, _brate, _balign, bits = fmt
    if audio_fmt == 0xFFFE and len(data) >= 0:  # WAVE_FORMAT_EXTENSIBLE
        audio_fmt = 1  # assume PCM subformat
    if audio_fmt == 1:  # PCM
        if bits == 8:
            y = np.frombuffer(data, dtype=np.uint8).astype(np.float32)
            y = (y - 128.0) / 128.0
        elif bits == 16:
            y = np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 24:
            raw = np.frombuffer(data, dtype=np.uint8)
            raw = raw[: (len(raw) // 3) * 3].reshape(-1, 3)
            vals = (
                raw[:, 0].astype(np.int32)
                | (raw[:, 1].astype(np.int32) << 8)
                | (raw[:, 2].astype(np.int32) << 16)
            )
            vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
            y = vals.astype(np.float32) / float(1 << 23)
        elif bits == 32:
            y = np.frombuffer(data, dtype="<i4").astype(np.float32) / 2147483648.0
        else:
            raise ValueError(f"unsupported PCM bit depth {bits}")
    elif audio_fmt == 3:  # IEEE float
        dt = "<f4" if bits == 32 else "<f8"
        y = np.frombuffer(data, dtype=dt).astype(np.float32)
    else:
        raise ValueError(f"unsupported WAV format code {audio_fmt}")

    if channels > 1:
        y = y[: (len(y) // channels) * channels].reshape(-1, channels).mean(axis=1)
    return y.astype(np.float32), sr


def resample_poly(y: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    if orig_sr == target_sr:
        return y
    from math import gcd

    from scipy.signal import resample_poly as _rp

    g = gcd(orig_sr, target_sr)
    return _rp(y, target_sr // g, orig_sr // g).astype(np.float32)


def read_wav(path: str, target_sr: Optional[int] = None) -> Tuple[np.ndarray, int]:
    """Load a wav as mono float32 in [-1, 1], optionally resampled."""
    y, sr = _parse_riff(path)
    if target_sr is not None and sr != target_sr:
        y = resample_poly(y, sr, target_sr)
        sr = target_sr
    return y, sr


def write_wav(path: str, y: np.ndarray, sr: int) -> None:
    """Write mono float32 [-1, 1] as 16-bit PCM."""
    y = np.asarray(y, dtype=np.float32).reshape(-1)
    pcm = np.clip(y * 32767.0, -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
