"""On-disk npz sample schema.

Byte-compatible with the reference's 11-key shards written by
``reference/preprocess.py:274-287``:

    mel (80, T) f32, motion (T_m, 234) f32, lyrics (T_m, 768) f32,
    sr i, hop_length i, song_name bytes, time_start f32, time_end f32,
    lyric_text bytes, frame_start i32, frame_end i32

Canonical geometry for 6 s / 22.05 kHz / 30 fps clips:
mel (80, 516), motion (180, 234), lyrics (180, 768)
(``reference/sometest/testnpz.py:58-75``).
"""

from __future__ import annotations

from dataclasses import dataclass
import numpy as np

REQUIRED_KEYS = ("mel", "motion", "lyrics")
ALL_KEYS = REQUIRED_KEYS + (
    "sr",
    "hop_length",
    "song_name",
    "time_start",
    "time_end",
    "lyric_text",
    "frame_start",
    "frame_end",
)


@dataclass
class Sample:
    mel: np.ndarray  # (80, T)
    motion: np.ndarray  # (T_m, 234)
    lyrics: np.ndarray  # (T_m, 768)
    sr: int = 22050
    hop_length: int = 256
    song_name: str = ""
    time_start: float = 0.0
    time_end: float = 0.0
    lyric_text: str = ""
    frame_start: int = 0
    frame_end: int = 0


def _decode_bytes(v) -> str:
    if isinstance(v, bytes):
        return v.decode("utf-8", errors="replace")
    if isinstance(v, np.ndarray):
        try:
            return v.tobytes().decode("utf-8", errors="replace").rstrip("\x00")
        except Exception:
            return str(v)
    return str(v)


def normalize_mel_layout(mel: np.ndarray, num_mels: int = 80) -> np.ndarray:
    """Coerce mel to (num_mels, T), squeezing stray batch dims."""
    mel = np.asarray(mel)
    if mel.ndim == 3:
        mel = np.squeeze(mel, axis=0)
    if mel.shape[0] != num_mels and mel.shape[1] == num_mels:
        mel = mel.T
    return mel.astype(np.float32)


def load_sample(path: str) -> Sample:
    d = np.load(path, allow_pickle=True)
    return Sample(
        mel=normalize_mel_layout(d["mel"]),
        motion=np.asarray(d["motion"], dtype=np.float32),
        lyrics=np.asarray(d["lyrics"], dtype=np.float32),
        sr=int(d.get("sr", 22050)),
        hop_length=int(d.get("hop_length", 256)),
        song_name=_decode_bytes(d.get("song_name", b"")),
        time_start=float(d.get("time_start", 0.0)),
        time_end=float(d.get("time_end", 0.0)),
        lyric_text=_decode_bytes(d.get("lyric_text", b"")),
        frame_start=int(d.get("frame_start", 0)),
        frame_end=int(d.get("frame_end", 0)),
    )


def save_sample(path: str, s: Sample) -> None:
    np.savez_compressed(
        path,
        mel=s.mel.astype(np.float32),
        motion=s.motion.astype(np.float32),
        lyrics=s.lyrics.astype(np.float32),
        sr=s.sr,
        hop_length=s.hop_length,
        song_name=np.bytes_(s.song_name.encode("utf-8")),
        time_start=np.float32(s.time_start),
        time_end=np.float32(s.time_end),
        lyric_text=np.bytes_(s.lyric_text.encode("utf-8")),
        frame_start=np.int32(s.frame_start),
        frame_end=np.int32(s.frame_end),
    )
