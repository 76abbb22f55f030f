"""Load reference PyTorch checkpoints into the port's modules (the
counterpart of ``lm2a_tpu/utils/torch_convert.py``).

A reference checkpoint is a ``torch.save`` dict with keys ``unet`` /
``ema_unet`` / ``cond_proj`` / ``ema_cond_proj`` (state dicts) and
``dataset_mean`` / ``dataset_std`` / ``timesteps`` / ``guidance_weight``
(and ``step`` / ``epoch``); EMA weights are preferred when present. The port
is PyTorch with the same layouts as the reference modules (Linear
``(out, in)``, Conv1d ``(Cout, Cin, K)``, GroupNorm ``weight``/``bias``), so
the carry-over is a rename of state-dict keys plus one split: the packed
``nn.MultiheadAttention.in_proj_weight`` ``(3E, E)`` (and ``in_proj_bias``)
becomes the q/k/v projections.
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

import torch

# reference module prefix -> the port's (flax) names, first match wins
_RENAMES = [
    (re.compile(r"^time_embedding\.time_mlp\.1\."), "time_embedding.proj."),
    (re.compile(r"^downs\.(\d+)\.blocks\.(\d+)\."), r"down_\1_block_\2."),
    (re.compile(r"^downs\.(\d+)\.down\.conv\."), r"down_\1_downsample."),
    (re.compile(r"^mid\.blocks\.(\d+)\."), r"mid_block_\1."),
    (re.compile(r"^ups\.(\d+)\.up\.conv\."), r"up_\1_upsample."),
    (re.compile(r"^ups\.(\d+)\.blocks\.(\d+)\."), r"up_\1_block_\2."),
    (re.compile(r"^out_proj\.0\."), "out_gn."),
    (re.compile(r"^out_proj\.2\."), "out_proj."),
]
_FILM = re.compile(r"\.film\.net\.1\.")
_IN_PROJ = re.compile(r"^(.*)\.in_proj_(weight|bias)$")

META_KEYS = ("dataset_mean", "dataset_std", "step", "epoch", "timesteps",
             "guidance_weight")


def convert_unet_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Reference ``UNet1D_ultimate.state_dict()`` -> the port's
    ``UNet1DUltimate`` state dict. Keys no rule maps are passed through;
    ``load_state_dict`` then names whatever does not fit."""
    out = {}
    for key, t in sd.items():
        t = t.detach().float().cpu()
        for pat, repl in _RENAMES:
            if pat.match(key):
                key = pat.sub(repl, key, count=1)
                break
        key = _FILM.sub(".film.to_scale_shift.", key)
        m = _IN_PROJ.match(key)
        if m:
            for name, part in zip(("q_proj", "k_proj", "v_proj"), t.chunk(3, dim=0)):
                out[f"{m.group(1)}.{name}.{m.group(2)}"] = part.contiguous()
        else:
            out[key] = t
    return out


def load_torch_checkpoint(path: str, prefer_ema: bool = True) -> Tuple[dict, dict, dict]:
    """Read a reference ``torch.save`` checkpoint: ``(unet state dict,
    cond_proj state dict, meta)`` in the port's names, EMA preferred; ``meta``
    holds those of ``META_KEYS`` the file has."""
    ck = torch.load(path, map_location="cpu", weights_only=False)
    unet_key = "ema_unet" if prefer_ema and "ema_unet" in ck else "unet"
    proj_key = "ema_cond_proj" if prefer_ema and "ema_cond_proj" in ck else "cond_proj"
    meta = {k: ck[k] for k in META_KEYS if k in ck}
    # CondProjection's names already agree
    proj = {k: t.detach().float().cpu() for k, t in ck[proj_key].items()}
    return convert_unet_state_dict(ck[unet_key]), proj, meta
