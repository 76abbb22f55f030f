"""NVIDIA BigVGAN generator checkpoints -> the port's ``BigVGANGenerator``
(the counterpart of ``lm2a_tpu/vocoder/convert.py``).

Accepts generator state dicts with weight-norm factors (``weight_g`` /
``weight_v``, as published) or already folded (``weight``). Weight norm is
folded as ``w = g * v / max(||v||, 1e-12)`` with the norm over every dim but
0 (torch's default ``dim=0``). The port's modules are PyTorch ``Conv1d`` /
``ConvTranspose1d`` in NVIDIA's layouts, so weights carry over unchanged;
only the names differ:

    conv_pre / conv_post                     -> conv_pre / conv_post
    ups.<i>.0                                -> up_<i>
    resblocks.<i*K+j>.convs1.<m> / convs2.<m> -> resblock_<i>_<j>.conv1_<m> / conv2_<m>
    resblocks.<..>.activations.<2m|2m+1>.act -> resblock_<i>_<j>.act1_<m> / act2_<m>
    resblocks.<..>.convs.<m>, activations.<m>.act (type '2') -> conv_<m>, act_<m>
    activation_post.act                      -> activation_post

v2 checkpoints have no ``conv_post.bias`` (``use_bias_at_final=False``).
"""

from __future__ import annotations

from typing import Dict

import torch

from lm2a_tpu_torch.vocoder.bigvgan import VocoderConfig


def _fold_weight_norm(sd: Dict[str, torch.Tensor], prefix: str) -> torch.Tensor:
    if f"{prefix}.weight" in sd:
        return sd[f"{prefix}.weight"]
    g, v = sd[f"{prefix}.weight_g"], sd[f"{prefix}.weight_v"]
    norm = v.pow(2).sum(dim=tuple(range(1, v.dim())), keepdim=True).sqrt()
    return g * v / torch.clamp(norm, min=1e-12)


def convert_bigvgan(sd: Dict[str, torch.Tensor], cfg: VocoderConfig) -> Dict[str, torch.Tensor]:
    """NVIDIA BigVGAN generator state dict -> the port's state dict."""
    sd = {k: torch.as_tensor(v).detach().float().cpu() for k, v in sd.items()}
    beta = cfg.activation == "snakebeta"
    out: Dict[str, torch.Tensor] = {}

    def conv(src, dst, bias=True):
        out[f"{dst}.weight"] = _fold_weight_norm(sd, src)
        if bias:
            out[f"{dst}.bias"] = sd[f"{src}.bias"]

    def snake(src, dst):
        out[f"{dst}.alpha"] = sd[f"{src}.alpha"].reshape(-1)
        if beta:
            out[f"{dst}.beta"] = sd[f"{src}.beta"].reshape(-1)

    conv("conv_pre", "conv_pre")
    conv("conv_post", "conv_post", bias=cfg.use_bias_at_final)
    snake("activation_post.act", "activation_post")
    nk = len(cfg.resblock_kernel_sizes)
    for i in range(len(cfg.upsample_rates)):
        conv(f"ups.{i}.0", f"up_{i}")
        for j in range(nk):
            rb, blk = f"resblocks.{i * nk + j}", f"resblock_{i}_{j}"
            for m in range(len(cfg.resblock_dilation_sizes[j])):
                if cfg.resblock_type == "1":
                    conv(f"{rb}.convs1.{m}", f"{blk}.conv1_{m}")
                    conv(f"{rb}.convs2.{m}", f"{blk}.conv2_{m}")
                    snake(f"{rb}.activations.{2 * m}.act", f"{blk}.act1_{m}")
                    snake(f"{rb}.activations.{2 * m + 1}.act", f"{blk}.act2_{m}")
                else:  # resblock '2': convs named 'convs', one activation each
                    conv(f"{rb}.convs.{m}", f"{blk}.conv_{m}")
                    snake(f"{rb}.activations.{m}.act", f"{blk}.act_{m}")
    return out


def load_bigvgan_torch(path: str, cfg: VocoderConfig) -> Dict[str, torch.Tensor]:
    """Read an NVIDIA BigVGAN ``bigvgan_*.pt`` / ``g_*`` checkpoint file; the
    generator's state dict may sit under ``generator``."""
    ck = torch.load(path, map_location="cpu", weights_only=False)
    return convert_bigvgan(ck.get("generator", ck), cfg)
