"""Mel-to-waveform driving: one generator, npz files in, wav files out.

The port of ``lm2a_tpu/vocoder/vocode.py``. ``weights_path`` is an NVIDIA
BigVGAN generator checkpoint (``vocoder/convert.py``); without one the
generator is initialised from a seeded ``torch.Generator`` ("smoke" mode:
shapes and the pipeline, not audio quality).
"""

from __future__ import annotations

import os
import sys
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from lm2a_tpu_torch.core.device import DeviceLike, dtype_from_str, resolve_device
from lm2a_tpu_torch.data.schema import normalize_mel_layout
from lm2a_tpu_torch.models.factory import random_init_
from lm2a_tpu_torch.utils.audio import write_wav
from lm2a_tpu_torch.vocoder.bigvgan import BIGVGAN_22KHZ_80BAND, BigVGANGenerator, VocoderConfig
from lm2a_tpu_torch.vocoder.convert import load_bigvgan_torch


def cast_convs_(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Convolutions to the compute dtype; snake parameters stay fp32."""
    for m in model.modules():
        if isinstance(m, (nn.Conv1d, nn.ConvTranspose1d)):
            m.to(dtype)
    return model


class Vocoder:
    def __init__(
        self,
        weights_path: Optional[str] = None,
        cfg: VocoderConfig = BIGVGAN_22KHZ_80BAND,
        compute_dtype="bfloat16",
        device: DeviceLike = None,
        seed: int = 0,
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = BigVGANGenerator(cfg)
        if weights_path:
            self.model.load_state_dict(load_bigvgan_torch(weights_path, cfg))
        else:
            # stderr: stdout may carry a protocol stream
            print("vocoder: no weights file given; using random init "
                  "(smoke mode)", file=sys.stderr)
            random_init_(self.model, seed)
        self.model.eval().requires_grad_(False)
        cast_convs_(self.model.to(self.device), dtype_from_str(compute_dtype))

    @torch.no_grad()
    def mel_to_wav(self, mel: np.ndarray) -> np.ndarray:
        """mel (80, T) or (B, 80, T) npz layout -> waveform (B, hop*T)."""
        mel = np.asarray(mel, dtype=np.float32)
        if mel.ndim == 2:
            mel = mel[None]
        x = torch.as_tensor(mel.transpose(0, 2, 1).copy(), device=self.device)
        return self.model(x).cpu().numpy()


def npz_to_wav(npz_path: str, out_path: str, vocoder: Vocoder) -> Tuple[str, int]:
    d = np.load(npz_path, allow_pickle=True)
    mel = normalize_mel_layout(d["mel"])
    sr = int(d.get("sr", vocoder.cfg.sample_rate))
    wav = vocoder.mel_to_wav(mel)[0]
    write_wav(out_path, wav, sr)
    return out_path, sr


def batch_npz_to_wav(npz_dir: str, vocoder: Vocoder, suffix: str = ".wav"):
    """Vocode every npz in a folder, wav written next to each npz."""
    ok, failed = 0, 0
    for name in sorted(os.listdir(npz_dir)):
        if not name.endswith(".npz") or name == "motion_stats.npz":
            continue
        src = os.path.join(npz_dir, name)
        dst = os.path.join(npz_dir, os.path.splitext(name)[0] + suffix)
        try:
            npz_to_wav(src, dst, vocoder)
            ok += 1
        except Exception as e:
            print(f"vocode failed for {src}: {e}")
            failed += 1
    print(f"vocoded {ok} files, {failed} failures")
    return ok, failed
