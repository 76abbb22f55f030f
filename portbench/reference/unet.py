"""Both LM2A denoisers and the condition projection, written out plainly.

Source: Bokway/LM2A-lyrics-and-motion-to-audio-with-diffusion-model,
``models/unet1d.py`` (``UNet1D``, the v1 baseline) and the production
``UNet1D_ultimate`` that ``train.py:77-86`` builds. Activations are
channels-last (B, T, C). ``spec(model)`` lists every parameter with its shape
and kind; ``denoise(p, model, ...)`` is the forward over a flat parameter
dict. ``generator`` (training) draws the dropout masks in forward order;
None is the eval form.

The ultimate block: GN-SiLU-conv3 -> FiLM (scale, shift from SiLU(t_emb)) ->
GN-SiLU-conv3 -> dropout -> cross-attention (last block of each down stage,
every mid block, first block of each up stage) + a 1x1 skip where the
width changes. Down: conv k4 s2 p1. Up: linear 2x (align corners) -> conv3
-> pad or cut to the skip's length -> concatenated with the skip. Head:
GN-SiLU-1x1. The v1 block: GN(8)-SiLU-conv3 + Linear(t_emb) ->
GN(8)-SiLU-conv3 -> cross-attention + x; up by a transposed conv k4 s2 p1.
Cross-attention: the mel attends over each condition projected to its
width (Q = mel, K = V = condition), the two results joined by a Linear(2C,
C). GroupNorm: float32 statistics, biased variance, eps 1e-5.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .precision import EXACT, Precision

Spec = Dict[str, Tuple[tuple, str]]
GN_EPS = 1e-5
GROUPS = 8


def _linear(spec: Spec, name: str, cin: int, cout: int) -> None:
    spec[f"{name}.weight"] = ((cout, cin), "w_linear")
    spec[f"{name}.bias"] = ((cout,), "bias")


def _conv(spec: Spec, name: str, cin: int, cout: int, k: int) -> None:
    spec[f"{name}.weight"] = ((cout, cin, k), "w_conv")
    spec[f"{name}.bias"] = ((cout,), "bias")


def _norm(spec: Spec, name: str, c: int) -> None:
    spec[f"{name}.weight"] = ((c,), "norm_weight")
    spec[f"{name}.bias"] = ((c,), "norm_bias")


def _cross_attention(spec: Spec, name: str, c: int, cond: int) -> None:
    _linear(spec, f"{name}.motion_kv_proj", cond, c)
    _linear(spec, f"{name}.text_kv_proj", cond, c)
    for branch in ("attn_motion", "attn_text"):
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _linear(spec, f"{name}.{branch}.{proj}", c, c)
    _linear(spec, f"{name}.fuse_proj", 2 * c, c)


def dims(m: dict):
    return [m["base_dim"] * k for k in m["dim_mults"]]


def ultimate_blocks(m: dict):
    """(name, cin, cout, attends) of every ultimate resblock in forward order."""
    out, prev, ds = [], m["base_dim"], dims(m)
    nrb = m["num_res_blocks"]
    for i, d in enumerate(ds):
        for b in range(nrb):
            out.append((f"down_{i}_block_{b}", prev, d, b == nrb - 1))
            prev = d
    for b in range(m["mid_blocks"]):
        out.append((f"mid_block_{b}", prev, prev, True))
    for i, d in enumerate(reversed(ds)):
        for b in range(nrb):
            out.append((f"up_{i}_block_{b}", 2 * d if b == 0 else d, d, b == 0))
    return out


def spec(m: dict) -> Spec:
    """Every parameter of the denoiser ``m`` (a model configuration dict)."""
    s: Spec = {}
    _linear(s, "time_embedding.proj", m["time_emb_dim"], m["time_emb_dim"])
    ds = dims(m)
    if m["arch"] == "ultimate":
        _conv(s, "in_proj", m["in_dim"], m["base_dim"], 1)
        for name, cin, cout, attends in ultimate_blocks(m):
            _norm(s, f"{name}.gn1", cin)
            _conv(s, f"{name}.conv1", cin, cout, 3)
            _linear(s, f"{name}.film.to_scale_shift", m["time_emb_dim"], 2 * cout)
            _norm(s, f"{name}.gn2", cout)
            _conv(s, f"{name}.conv2", cout, cout, 3)
            if attends:
                _cross_attention(s, f"{name}.cross_attn", cout, m["cond_dim"])
            if cin != cout:
                _conv(s, f"{name}.skip", cin, cout, 1)
        for i, d in enumerate(ds):
            _conv(s, f"down_{i}_downsample", d, d, 4)
        prev = ds[-1]
        for i, d in enumerate(reversed(ds)):
            _conv(s, f"up_{i}_upsample", prev, d, 3)
            prev = d
        _norm(s, "out_gn", prev)
        _conv(s, "out_proj", prev, m["in_dim"], 1)
        return s
    if m["arch"] != "v1":
        raise ValueError(f"unknown arch {m['arch']!r}")
    _conv(s, "input_proj", m["in_dim"], m["base_dim"], 1)
    for name, c in v1_blocks(m):
        _norm(s, f"{name}.norm1", c)
        _conv(s, f"{name}.conv1", c, c, 3)
        _linear(s, f"{name}.time_proj", m["time_emb_dim"], c)
        _norm(s, f"{name}.norm2", c)
        _conv(s, f"{name}.conv2", c, c, 3)
        _cross_attention(s, f"{name}.cross_attn", c, m["cond_dim"])
    prev, skips = m["base_dim"], []
    for i, d in enumerate(ds):
        _conv(s, f"down_{i}_downsample", prev, d, 4)
        skips.append(prev)
        prev = d
    for i, (d, sc) in enumerate(zip(reversed(ds), reversed(skips))):
        s[f"up_{i}_upconv.weight"] = ((prev, d, 4), "w_conv_transpose")
        s[f"up_{i}_upconv.bias"] = ((d,), "bias")
        prev = d + sc
    _conv(s, "out_proj", prev, m["in_dim"], 1)
    return s


def v1_blocks(m: dict):
    """(name, channels) of every v1 block in forward order."""
    ds, prev, out, skips = dims(m), m["base_dim"], [], []
    for i, d in enumerate(ds):
        out.append((f"down_{i}_res", prev))
        skips.append(prev)
        prev = d
    out.append(("mid_res", prev))
    for i, d in enumerate(reversed(ds)):
        prev = d + skips.pop()
        out.append((f"up_{i}_res", prev))
    return out


def cond_spec(m: dict) -> Spec:
    s: Spec = {}
    _linear(s, "motion_proj", m["motion_dim"], m["cond_dim"])
    _linear(s, "text_proj", m["text_dim"], m["cond_dim"])
    return s


# ---------------------------------------------------------------- operations

def linear(p, name: str, x, q: Precision):
    return F.linear(q(x), q(p[f"{name}.weight"]), p[f"{name}.bias"])


def conv(p, name: str, x, q: Precision, stride: int = 1, padding: int = 0):
    """A Conv1d on channels-last (B, T, C)."""
    y = F.conv1d(q(x).transpose(1, 2), q(p[f"{name}.weight"]), p[f"{name}.bias"],
                 stride=stride, padding=padding)
    return y.transpose(1, 2)


def conv_transpose(p, name: str, x, q: Precision, stride: int, padding: int):
    y = F.conv_transpose1d(q(x).transpose(1, 2), q(p[f"{name}.weight"]), p[f"{name}.bias"],
                           stride=stride, padding=padding)
    return y.transpose(1, 2)


def group_norm(p, name: str, x, groups: int = GROUPS):
    b, t, c = x.shape
    xg = x.reshape(b, t, groups, c // groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = ((xg - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    y = ((xg - mean) / torch.sqrt(var + GN_EPS)).reshape(b, t, c)
    return y * p[f"{name}.weight"] + p[f"{name}.bias"]


def time_embedding(p, t, dim: int, q: Precision):
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                      * (-math.log(10000.0) / (half - 1)))
    args = t.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    return F.silu(linear(p, "time_embedding.proj", emb, q))


def attention(p, name: str, x, kv, heads: int, q: Precision):
    """Multi-head attention of x (B, T, C) over kv (B, S, C)."""
    b, t, c = x.shape
    hd = c // heads
    qh = linear(p, f"{name}.q_proj", x, q).reshape(b, t, heads, hd)
    kh = linear(p, f"{name}.k_proj", kv, q).reshape(b, -1, heads, hd)
    vh = linear(p, f"{name}.v_proj", kv, q).reshape(b, -1, heads, hd)
    scores = torch.einsum("bqhd,bkhd->bhqk", q(qh), q(kh)) / math.sqrt(hd)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", q(probs), q(vh)).reshape(b, t, c)
    return linear(p, f"{name}.out_proj", out, q)


def cross_attention(p, name: str, h, motion_f, text_f, heads: int, q: Precision):
    mkv = linear(p, f"{name}.motion_kv_proj", motion_f, q)
    tkv = linear(p, f"{name}.text_kv_proj", text_f, q)
    a_m = attention(p, f"{name}.attn_motion", h, mkv, heads, q)
    a_t = attention(p, f"{name}.attn_text", h, tkv, heads, q)
    return linear(p, f"{name}.fuse_proj", torch.cat([a_m, a_t], dim=-1), q)


def dropout(h, rate: float, generator: Optional[torch.Generator]):
    """Keep with probability 1 - rate, scaled by its inverse; the mask is one
    uniform draw of h's shape from ``generator``."""
    if generator is None or rate == 0.0:
        return h
    keep = 1.0 - rate
    mask = torch.rand(h.shape, generator=generator, device=h.device) < keep
    return torch.where(mask, h / keep, torch.zeros_like(h))


def upsample_2x(x):
    """Linear interpolation to twice the length, align corners."""
    t = x.shape[1]
    pos = torch.arange(2 * t, dtype=torch.float32, device=x.device) * ((t - 1) / (2 * t - 1))
    lo = torch.clamp(torch.floor(pos).long(), 0, t - 1)
    hi = torch.clamp(lo + 1, 0, t - 1)
    frac = (pos - lo.float())[None, :, None]
    return x[:, lo] * (1.0 - frac) + x[:, hi] * frac


def fit_length(h, t: int):
    if h.shape[1] < t:
        return F.pad(h, (0, 0, 0, t - h.shape[1]))
    return h[:, :t]


# ---------------------------------------------------------------- the denoisers

def _ultimate_block(p, name, cin, cout, attends, x, t_emb, motion_f, text_f, m, generator, q):
    h = conv(p, f"{name}.conv1", F.silu(group_norm(p, f"{name}.gn1", x)), q, padding=1)
    scale, shift = linear(p, f"{name}.film.to_scale_shift", F.silu(t_emb), q).chunk(2, dim=-1)
    h = h * (1.0 + scale[:, None, :]) + shift[:, None, :]
    h = conv(p, f"{name}.conv2", F.silu(group_norm(p, f"{name}.gn2", h)), q, padding=1)
    h = dropout(h, m["dropout"], generator)
    if attends:
        h = cross_attention(p, f"{name}.cross_attn", h, motion_f, text_f, m["attn_heads"], q)
    if cin != cout:
        x = conv(p, f"{name}.skip", x, q)
    return x + h


def _ultimate(p, m, x, t, motion_f, text_f, generator, q):
    t_emb = time_embedding(p, t, m["time_emb_dim"], q)
    blocks = iter(ultimate_blocks(m))

    def block(h):
        return _ultimate_block(p, *next(blocks), h, t_emb, motion_f, text_f, m, generator, q)

    h = conv(p, "in_proj", x, q)
    skips = []
    for i in range(len(dims(m))):
        for _ in range(m["num_res_blocks"]):
            h = block(h)
        skips.append(h)
        h = conv(p, f"down_{i}_downsample", h, q, stride=2, padding=1)
    for _ in range(m["mid_blocks"]):
        h = block(h)
    for i in range(len(dims(m))):
        skip = skips.pop()
        h = fit_length(conv(p, f"up_{i}_upsample", upsample_2x(h), q, padding=1), skip.shape[1])
        h = torch.cat([h, skip], dim=-1)
        for _ in range(m["num_res_blocks"]):
            h = block(h)
    return conv(p, "out_proj", F.silu(group_norm(p, "out_gn", h)), q)


def _v1_block(p, name, x, t_emb, motion_f, text_f, m, q):
    h = conv(p, f"{name}.conv1", F.silu(group_norm(p, f"{name}.norm1", x)), q, padding=1)
    h = h + linear(p, f"{name}.time_proj", t_emb, q)[:, None, :]
    h = conv(p, f"{name}.conv2", F.silu(group_norm(p, f"{name}.norm2", h)), q, padding=1)
    return x + cross_attention(p, f"{name}.cross_attn", h, motion_f, text_f, m["attn_heads"], q)


def _v1(p, m, x, t, motion_f, text_f, q):
    t_emb = time_embedding(p, t, m["time_emb_dim"], q)
    h = conv(p, "input_proj", x, q)
    skips = []
    for i in range(len(dims(m))):
        h = _v1_block(p, f"down_{i}_res", h, t_emb, motion_f, text_f, m, q)
        skips.append(h)
        h = conv(p, f"down_{i}_downsample", h, q, stride=2, padding=1)
    h = _v1_block(p, "mid_res", h, t_emb, motion_f, text_f, m, q)
    for i in range(len(dims(m))):
        h = conv_transpose(p, f"up_{i}_upconv", h, q, stride=2, padding=1)
        skip = skips.pop()
        h = torch.cat([fit_length(h, skip.shape[1]), skip], dim=-1)
        h = _v1_block(p, f"up_{i}_res", h, t_emb, motion_f, text_f, m, q)
    return conv(p, "out_proj", h, q)


def denoise(p: Dict[str, torch.Tensor], m: dict, x, t, motion_f, text_f,
            generator: Optional[torch.Generator] = None, q: Precision = EXACT):
    """Predicted noise for x (B, T, in_dim) at timesteps t (B,)."""
    if m["arch"] == "ultimate":
        return _ultimate(p, m, x, t, motion_f, text_f, generator, q)
    return _v1(p, m, x, t, motion_f, text_f, q)


def project_conditions(p: Dict[str, torch.Tensor], motion, lyrics, q: Precision = EXACT):
    """Motion (B, T, 234) and lyrics (B, T, 768) to the conditioning width."""
    return linear(p, "motion_proj", motion, q), linear(p, "text_proj", lyrics, q)
