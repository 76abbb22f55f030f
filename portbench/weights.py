"""Seeds, weights and inputs made from ``--seed``.

``Seeds`` splits the run's seed (any whole number) into the streams a run
draws from. ``make_weights`` fills a parameter spec (``reference.unet.spec``
form: name -> (shape, kind)) from one normal draw on the device, scaled by
kind: weights N(0, 1/fan_in), biases N(0, 0.02^2), norm scales 1 + N(0,
0.1^2), norm shifts and the vocoder's log-scale snake parameters N(0,
0.1^2). The same seed gives the same tensors, so the reference can make
them again after the program has run.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

STREAMS = ("unet", "cond", "vocoder", "data", "program", "order", "noise", "check")


class Seeds:
    def __init__(self, seed: int):
        state = np.random.SeedSequence(int(seed)).generate_state(len(STREAMS), dtype=np.uint64)
        self.by_name = {k: int(v) for k, v in zip(STREAMS, state)}

    def __getitem__(self, name: str) -> int:
        """A 63-bit seed of stream ``name``."""
        return self.by_name[name] >> 1

    def small(self, name: str) -> int:
        """A 31-bit seed (the program's training seed is shifted up by 32 bits)."""
        return self.by_name[name] >> 33

    def rng(self, name: str) -> np.random.Generator:
        return np.random.default_rng(self.by_name[name])


def _fan_in(shape: tuple, kind: str) -> int:
    if kind == "w_linear":
        return shape[1]
    if kind == "w_conv":
        return shape[1] * shape[2]
    return shape[0] * shape[2]  # w_conv_transpose: (Cin, Cout, K)


@torch.no_grad()
def make_weights(spec: Dict[str, tuple], seed: int, device) -> Dict[str, torch.Tensor]:
    """fp32 tensors for every entry of ``spec``: views of one buffer."""
    sizes = [math.prod(shape) for shape, _ in spec.values()]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    out = {}
    for (name, (shape, kind)), part in zip(spec.items(), flat.split(sizes)):
        v = part.view(shape)
        if kind.startswith("w_"):
            v.mul_(1.0 / math.sqrt(_fan_in(shape, kind)))
        elif kind == "bias":
            v.mul_(0.02)
        elif kind == "norm_weight":
            v.mul_(0.1).add_(1.0)
        else:  # norm_bias, snake
            v.mul_(0.1)
        out[name] = v
    return out


def make_pack(n: int, t: int, m: dict, seed: int, device, mel_mean: float,
              mel_std: float) -> Dict[str, torch.Tensor]:
    """A packed training split on the device: (N, T, .) fp32 mel, motion and
    lyrics, conditions at the mel's frames, as ``cli pack`` lays them out."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def draw(width):
        return torch.randn((n, t, width), generator=gen, device=device, dtype=torch.float32)

    mel = draw(m["in_dim"]).mul_(mel_std).add_(mel_mean)
    return {"mel": mel, "motion": draw(m["motion_dim"]), "lyrics": draw(m["text_dim"])}


def make_clips(n: int, frames: int, m: dict, rng: np.random.Generator):
    """``n`` request conditions on the host: motion (frames, 234) and lyrics
    (frames, 768) at 30 fps, float32."""
    return [(rng.standard_normal((frames, m["motion_dim"]), dtype=np.float32),
             rng.standard_normal((frames, m["text_dim"]), dtype=np.float32)) for _ in range(n)]


def sync(device) -> None:
    """Wait for the device (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
