"""Dataset builder: raw songs -> normalized npz shards (port of
``lm2a_tpu/data/preprocess.py``).

Pipeline parity with ``reference/preprocess.py:207-385``:

walk ``root/<year>/<song>/{sliced.json, smplfull.json, audio.wav}``; for each
"m:ss" slice key: extract the 6 s log-mel (BigVGAN convention), derive
per-frame SMPL motion (poses+Th+Rh = 78-d, hold-last/zero fill), smooth +
velocity/acceleration -> (T, 234), embed the lyric slice (768-d, tiled to
mel_T), and write ``sample_%08d.npz`` with the 11-key schema. A second pass
z-scores the motion dimensions with the dataset-wide mean/std and rewrites
every shard; ``motion_stats.npz`` and ``sample_info_list.json`` are emitted.

Rewrites of the reference's hot loops, as in the JAX package:
- each song's wav is decoded ONCE and all its full-length slices are mel-ed
  as one batched ``ops.mel.mel_spectrogram`` call on ``device`` (the JAX
  package makes one jitted call per song; the reference re-loads the full
  wav per slice, ``preprocess.py:41-60``). The mel is plain ``torch.fft``:
  the JAX package computes it outside any Pallas kernel;
- smoothing/vel/acc are vectorized convolutions (``ops.motion``) instead of
  per-frame/per-dim Python loops;
- the Welford row loop becomes mergeable chunk moments (``ops.moments``),
  algebraically identical (ddof=1).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from lm2a_tpu_torch.core.config import MelConfig
from lm2a_tpu_torch.core.device import DeviceLike, resolve_device
from lm2a_tpu_torch.data.lyrics import (
    LyricsEmbedder, get_lyrics_embedder, tile_lyrics_embedding,
)
from lm2a_tpu_torch.data.schema import Sample, load_sample, save_sample
from lm2a_tpu_torch.ops.mel import mel_spectrogram
from lm2a_tpu_torch.ops.moments import RunningMoments
from lm2a_tpu_torch.ops.motion import motion_features
from lm2a_tpu_torch.utils.audio import read_wav

POSE_DIM, TH_DIM, RH_DIM = 72, 3, 3


def parse_time_key(key: str) -> Optional[float]:
    """'m:ss' or plain float seconds -> seconds; None when unparseable."""
    try:
        if ":" in key:
            minutes, seconds = key.split(":")
            return float(minutes) * 60.0 + float(seconds)
        return float(key)
    except (ValueError, AttributeError):
        return None


def find_lyric_for_time(sliced: Dict[str, str], start_seconds: float) -> Optional[str]:
    """Key matching within 1e-3 s, else nearest (preprocess.py:158-199)."""
    best_key, best_dist = None, float("inf")
    for k in sliced:
        t = parse_time_key(k)
        t = 0.0 if t is None else t
        d = abs(t - start_seconds)
        if d < 1e-3:
            return sliced[k]
        if d < best_dist:
            best_dist, best_key = d, k
    return sliced[best_key] if best_key is not None else None


def extract_motion_track(
    smplfull: Dict, start_frame: int, total_frames: int
) -> np.ndarray:
    """(total_frames, 78) raw pose track with hold-last / zero fill."""
    keys = list(smplfull.keys())
    key_width = len(keys[0]) if keys else 6
    frames: List[np.ndarray] = []
    for i in range(total_frames):
        k = str(start_frame + i).zfill(key_width)
        if k in smplfull:
            ann = smplfull[k]["annots"][0]
            poses = np.asarray(ann.get("poses", [[]])[0], dtype=np.float32)
            th = np.asarray(ann.get("Th", [[0, 0, 0]])[0], dtype=np.float32)
            rh = np.asarray(ann.get("Rh", [[0, 0, 0]])[0], dtype=np.float32)
            frames.append(np.concatenate([poses, th, rh]).astype(np.float32))
        elif frames:
            frames.append(frames[-1].copy())
        else:
            frames.append(np.zeros(POSE_DIM + TH_DIM + RH_DIM, dtype=np.float32))
    return np.stack(frames, axis=0)


def _mel(segments: np.ndarray, mel_cfg: MelConfig, device) -> np.ndarray:
    """(..., L) waveform segments -> (..., mel_T, 80) float32, one call on
    ``device``."""
    wav = torch.from_numpy(np.ascontiguousarray(segments, dtype=np.float32)).to(device)
    with torch.no_grad():
        return mel_spectrogram(wav, mel_cfg).cpu().numpy()


def _load_json(path: str) -> Optional[dict]:
    for enc in ("utf-8", None):
        try:
            with open(path, "r", encoding=enc) as f:
                return json.load(f)
        except Exception:
            continue
    return None


def make_dataset(
    root_in: str,
    out_dir: str,
    sequence_seconds: float = 6.0,
    fps: int = 30,
    sr: int = 22050,
    mel_cfg: Optional[MelConfig] = None,
    lyrics_backend: str = "auto",
    embedder: Optional[LyricsEmbedder] = None,
    lyrics_model_path: Optional[str] = None,
    device: DeviceLike = None,
) -> int:
    """Build the shard directory; returns the number of samples written.
    The mels (and a RoBERTa embedder) run on ``device`` (None: the card)."""
    device = resolve_device(device)
    mel_cfg = mel_cfg or MelConfig(sample_rate=sr)
    embedder = embedder or get_lyrics_embedder(lyrics_backend, lyrics_model_path, device)
    os.makedirs(out_dir, exist_ok=True)

    moments = RunningMoments()
    sample_list: List[dict] = []
    count = 0
    seg_len = int(sequence_seconds * sr)

    years = sorted(
        os.path.join(root_in, d)
        for d in os.listdir(root_in)
        if os.path.isdir(os.path.join(root_in, d))
    )
    for year in years:
        for song in sorted(os.listdir(year)):
            song_path = os.path.join(year, song)
            if not os.path.isdir(song_path):
                continue
            sliced_path = os.path.join(song_path, "sliced.json")
            smpl_path = os.path.join(song_path, "smplfull.json")
            audio_path = os.path.join(song_path, "audio.wav")
            if not all(map(os.path.exists, (sliced_path, smpl_path, audio_path))):
                print(f"skip {song_path}: missing files")
                continue
            sliced = _load_json(sliced_path)
            smplfull = _load_json(smpl_path)
            if sliced is None or smplfull is None:
                print(f"skip {song_path}: unreadable json")
                continue

            try:
                wav, _ = read_wav(audio_path, target_sr=sr)
            except Exception as e:
                print(f"skip {song_path}: wav read failed: {e}")
                continue

            # collect valid slices, then mel the full-length ones in ONE batch
            slices: List[Tuple[str, float, np.ndarray]] = []
            for k in list(sliced.keys()):
                start_seconds = parse_time_key(k)
                if start_seconds is None:
                    print(f"skip slice {k}: unparseable time key")
                    continue
                a = int(start_seconds * sr)
                seg = wav[a : a + seg_len]
                if seg.size == 0:
                    print(f"skip slice {k}: audio empty")
                    continue
                slices.append((k, start_seconds, seg))

            full = [s for s in slices if s[2].size == seg_len]
            rest = [s for s in slices if s[2].size != seg_len]
            mels: Dict[str, np.ndarray] = {}
            if full:
                batch = np.stack([s[2] for s in full])
                mel_batch = _mel(batch, mel_cfg, device)  # (N, T, 80)
                for (k, _, _), m in zip(full, mel_batch):
                    mels[k] = np.ascontiguousarray(m.T)  # (80, T) npz layout
            for k, _, seg in rest:
                m = _mel(seg, mel_cfg, device)
                mels[k] = np.ascontiguousarray(m.T)

            for k, start_seconds, _seg in slices:
                mel = mels[k]
                mel_t = mel.shape[1]
                start_frame = int(round(start_seconds * fps))
                total_frames = int(sequence_seconds * fps)
                raw = extract_motion_track(smplfull, start_frame, total_frames)
                motion = motion_features(raw, fps=fps, sigma=1.0)  # (T, 234)

                lyric_text = find_lyric_for_time(sliced, start_seconds) or ""
                if lyric_text:
                    lyrics_emb = tile_lyrics_embedding(embedder.embed(lyric_text), mel_t)
                else:
                    lyrics_emb = np.zeros((mel_t, 768), dtype=np.float32)

                out_name = f"sample_{count:08d}.npz"
                save_sample(
                    os.path.join(out_dir, out_name),
                    Sample(
                        mel=mel,
                        motion=motion,
                        lyrics=lyrics_emb,
                        sr=sr,
                        hop_length=mel_cfg.hop_size,
                        song_name=os.path.basename(song_path),
                        time_start=start_seconds,
                        time_end=start_seconds + sequence_seconds,
                        lyric_text=lyric_text,
                        frame_start=start_frame,
                        frame_end=start_frame + total_frames,
                    ),
                )
                sample_list.append(
                    {
                        "npz_name": out_name,
                        "song_name": os.path.basename(song_path),
                        "time_start": round(float(start_seconds), 2),
                        "time_end": round(float(start_seconds + sequence_seconds), 2),
                        "lyric_text": lyric_text,
                        "frame_start": int(start_frame),
                        "frame_end": int(start_frame + total_frames),
                        "mel_shape": list(mel.shape),
                        "lyrics_emb_shape": list(lyrics_emb.shape),
                        "motion_shape": list(motion.shape),
                    }
                )
                moments.update(motion)
                count += 1

    if count == 0:
        return 0

    mean = moments.mean.astype(np.float32)
    std = moments.std().astype(np.float32)
    np.savez_compressed(
        os.path.join(out_dir, "motion_stats.npz"), mean=mean, std=std
    )

    # pass 2: z-score motion in-place (divide-by-zero guarded)
    std_safe = np.where(std == 0, 1.0, std)
    normalize_motion_shards(out_dir, mean, std_safe)

    with open(os.path.join(out_dir, "sample_info_list.json"), "w", encoding="utf-8") as f:
        json.dump(sample_list, f, ensure_ascii=False, indent=2)
    return count


def normalize_motion_shards(out_dir: str, mean: np.ndarray, std: np.ndarray) -> None:
    for name in sorted(os.listdir(out_dir)):
        if not name.endswith(".npz") or name == "motion_stats.npz":
            continue
        path = os.path.join(out_dir, name)
        try:
            s = load_sample(path)
            s.motion = ((s.motion - mean) / std).astype(np.float32)
            save_sample(path, s)
        except Exception as e:
            print(f"warning: normalize failed for {path}: {e}")
