"""Long-form generation: whole-song mels beyond the 6 s clip (port of
``lm2a_tpu/inference/longform.py``).

Two protocols:

- ``generate_long``: the song's motion and per-window lyrics are cut into
  clip-sized overlapping windows, all windows are sampled in batched chains
  (``batch_size`` windows per chain, seed ``seed + i`` for the chain that
  starts at window ``i``), and the overlaps are cross-faded in mel space;
- ``generate_single_pass``: one chain over the whole sequence, with the
  fused attention route (the CUDA attention kernel on the card) taken above
  ``FUSED_ATTENTION_MIN_T`` frames by ``with_streaming_attention``. Memory
  is linear in T (the kernel never holds (T, S) scores); compute is
  quadratic.

Both run their chains through ``inference.sample``'s chain cache: on the
card each geometry's step is a CUDA graph, replayed step after step.

``window_conditions`` and ``crossfade_stitch`` are numpy copies of the JAX
functions.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from lm2a_tpu_torch.inference.sample import LoadedModels, generate_mel, generate_mel_batch
from lm2a_tpu_torch.ops import attention
from lm2a_tpu_torch.ops.resample import linear_resample


def window_conditions(
    motion: np.ndarray,  # (T_motion, 234) full-song motion features
    lyrics_per_window: List[np.ndarray],  # one (768,) or (T, 768) per window
    num_windows: int,
    window_motion_frames: int,
    hop_motion_frames: int,
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Slice a full-song motion track into overlapping windows."""
    out = []
    for w in range(num_windows):
        a = w * hop_motion_frames
        seg = motion[a: a + window_motion_frames]
        if seg.shape[0] < window_motion_frames:  # pad tail by holding last
            pad = np.repeat(seg[-1:], window_motion_frames - seg.shape[0], axis=0)
            seg = np.concatenate([seg, pad], axis=0)
        lyr = lyrics_per_window[min(w, len(lyrics_per_window) - 1)]
        if lyr.ndim == 1:
            lyr = np.tile(lyr[None], (window_motion_frames, 1))
        out.append((seg.astype(np.float32), lyr.astype(np.float32)))
    return out


def crossfade_stitch(
    windows: np.ndarray,  # (W, 80, T_w) generated mels
    hop_frames: int,
) -> np.ndarray:
    """Linearly cross-fade overlapping windows into one (80, total_T) mel."""
    w, c, t_w = windows.shape
    overlap = t_w - hop_frames
    total = hop_frames * (w - 1) + t_w
    out = np.zeros((c, total), dtype=np.float64)
    weight = np.zeros(total, dtype=np.float64)

    env = np.ones(t_w)
    if overlap > 0:
        ramp = np.linspace(0.0, 1.0, overlap + 2)[1:-1]
        env[:overlap] = ramp
        env[-overlap:] = ramp[::-1]

    for i in range(w):
        a = i * hop_frames
        e = env.copy()
        if i == 0 and overlap > 0:
            e[:overlap] = 1.0  # no fade-in on the first window
        if i == w - 1 and overlap > 0:
            e[-overlap:] = 1.0  # no fade-out on the last
        out[:, a: a + t_w] += windows[i] * e
        weight[a: a + t_w] += e
    return (out / np.maximum(weight, 1e-8)).astype(np.float32)


def generate_long(
    models: LoadedModels,
    motion: np.ndarray,  # (T_motion, 234) full-song normalized motion feats
    lyrics_windows: List[np.ndarray],  # lyric embedding per window
    total_seconds: float,
    window_seconds: float = 6.0,
    overlap_seconds: float = 1.0,
    fps: int = 30,
    sr: int = 22050,
    hop_size: int = 256,
    steps: Optional[int] = None,
    guidance_weight: Optional[float] = None,
    method: Optional[str] = None,
    seed: int = 0,
    batch_size: int = 8,
    ddim_steps: Optional[int] = None,
) -> np.ndarray:
    """Generate a (80, ~total_seconds*sr/hop) mel via overlapped windows."""
    if overlap_seconds >= window_seconds:
        raise ValueError("overlap must be smaller than the window")
    mel_fps = sr / hop_size
    t_w = int(round(window_seconds * mel_fps))
    hop_w = int(round((window_seconds - overlap_seconds) * mel_fps))
    total_t = int(round(total_seconds * mel_fps))
    num_windows = max(1, int(np.ceil((total_t - t_w) / hop_w)) + 1)

    win_motion = int(round(window_seconds * fps))
    hop_motion = int(round((window_seconds - overlap_seconds) * fps))
    conds = window_conditions(motion, lyrics_windows, num_windows, win_motion, hop_motion)

    mels = []
    for i in range(0, num_windows, batch_size):
        chunk = conds[i: i + batch_size]
        gen, _, _ = generate_mel_batch(
            models, [m for m, _ in chunk], [l for _, l in chunk], t_w,
            steps=steps, guidance_weight=guidance_weight, method=method,
            seed=seed + i, ddim_steps=ddim_steps,
        )
        mels.append(gen)
    windows = np.concatenate(mels, axis=0)  # (W, 80, t_w)
    stitched = crossfade_stitch(windows, hop_w)
    if stitched.shape[1] > total_t:
        stitched = stitched[:, :total_t]
    if stitched.shape[1] != total_t:
        return linear_resample(stitched, total_t, time_axis=1)
    return stitched


def with_streaming_attention(models: LoadedModels, mel_t: int) -> LoadedModels:
    """``models`` itself at or below ``FUSED_ATTENTION_MIN_T`` frames; above
    it a copy whose denoiser takes the fused attention route.

    Cross-attention here has S == T, so at long T the plain core holds
    (B, h, T, T) fp32 scores per site; the kernel keeps them on chip. The
    copy's denoiser shares every weight tensor with ``models.denoiser``
    (``UNet1DUltimate.with_fused_attention``), the caller's ``models`` is
    left as it is, and the distilled metadata is kept: losing it would send
    method and guidance resolution back to DDPM at 2.1. Its sampler cache is
    fresh (its chains run another route, so other graphs), as in the JAX
    package."""
    if mel_t <= attention.FUSED_ATTENTION_MIN_T:
        return models
    cfg = dataclasses.replace(models.cfg, model=dataclasses.replace(
        models.cfg.model, fused_attention=True))
    return dataclasses.replace(models, cfg=cfg,
                               denoiser=models.denoiser.with_fused_attention())


def generate_single_pass(
    models: LoadedModels,
    motion: np.ndarray,  # (T_motion, 234) full-song normalized motion feats
    lyrics: np.ndarray,  # (T_l, 768) full-song lyric embedding track
    total_seconds: float,
    sr: int = 22050,
    hop_size: int = 256,
    steps: Optional[int] = None,
    guidance_weight: Optional[float] = None,
    method: Optional[str] = None,
    seed: int = 0,
    ddim_steps: Optional[int] = None,
) -> np.ndarray:
    """Whole-song (80, T) mel in one attention window (no stitching seams)."""
    mel_t = int(round(total_seconds * sr / hop_size))
    m = with_streaming_attention(models, mel_t)
    gen, *_ = generate_mel(m, motion, lyrics, mel_t, steps=steps,
                           guidance_weight=guidance_weight, method=method, seed=seed,
                           ddim_steps=ddim_steps)
    return gen[0]
