"""Cross-attention condition fusion (port of ``lm2a_tpu/models/attention.py``).

Mel hidden states attend separately over projected motion and lyric features
(Q = mel, K/V = condition); the two outputs are concatenated and fused back
to the mel width. ``MultiheadAttention`` has torch ``nn.MultiheadAttention``
semantics with explicit q/k/v/out Linear layers (flax names).

``CrossAttentionFusion.fold`` is the serving rewrite of the JAX ``folded``
path (same parameters, same math up to float reassociation): one merged
``C -> 2C`` Q projection, both branches' cores in one batched product, and
the per-branch out_proj + concat + fuse_proj collapsed into one matmul whose
weight products are computed once, in fp32, when the models are loaded.

``fused=True`` (``ModelConfig.fused_attention``) routes every attention core
through ``ops.attention.attention_core``, the CUDA kernel on the card (the
port of the JAX package's Pallas attention kernels), and, as in the JAX
package, keeps the unfolded form: ``fold`` is skipped on that route.
Without it the core is plain matmul + fp32 softmax.

Passing ``dtype`` to ``forward`` is the training form: the fp32 parameters
are cast to ``dtype`` at each use, nothing is folded, and the fused route's
core is differentiable (``attention_core``'s backward is its plain version).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from lm2a_tpu_torch.models.embedding import dense
from lm2a_tpu_torch.ops.attention import attention_core


def _inv_scale(hd: int, like: torch.Tensor) -> torch.Tensor:
    # sqrt(hd) in the activation dtype, as jnp.sqrt(asarray(hd, q.dtype))
    return torch.sqrt(torch.tensor(float(hd), dtype=like.dtype, device=like.device))


class MultiheadAttention(nn.Module):
    """Batched multi-head attention over (B, T, E) with (B, S, E) keys.
    ``fused`` runs the core through ``attention_core``."""

    def __init__(self, embed_dim: int, num_heads: int, fused: bool = False):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} not divisible by heads {num_heads}")
        self.embed_dim, self.num_heads, self.fused = embed_dim, num_heads, fused
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def _proj(self, lin, x, dtype):
        if dtype is None:
            return lin(x.to(lin.weight.dtype))
        return dense(lin, x, dtype)

    def forward(self, query, key, value, dtype=None):
        e, h = self.embed_dim, self.num_heads
        hd = e // h
        q = self._proj(self.q_proj, query, dtype)
        k = self._proj(self.k_proj, key, dtype)
        v = self._proj(self.v_proj, value, dtype)
        q = q.reshape(q.shape[:-1] + (h, hd))
        k = k.reshape(k.shape[:-1] + (h, hd))
        v = v.reshape(v.shape[:-1] + (h, hd))
        if self.fused:  # (B, H, T, hd) views in and out: no transposes copy
            out = attention_core(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2)).transpose(1, 2)
        else:
            scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / _inv_scale(hd, q)
            probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
            out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        return self._proj(self.out_proj, out.reshape(out.shape[0], -1, e), dtype)


class CrossAttentionFusion(nn.Module):
    """Fuse mel hidden states (B, T, C) with motion and lyric conditions
    (B, S, cond_dim): each branch projects its condition to C, cross-attends,
    and the concatenated results are fused by a Linear(2C -> C)."""

    def __init__(self, mel_dim: int, cond_dim: int = 128, num_heads: int = 4,
                 fused: bool = False):
        super().__init__()
        self.mel_dim, self.num_heads = mel_dim, num_heads
        self.motion_kv_proj = nn.Linear(cond_dim, mel_dim)
        self.text_kv_proj = nn.Linear(cond_dim, mel_dim)
        self.attn_motion = MultiheadAttention(mel_dim, num_heads, fused)
        self.attn_text = MultiheadAttention(mel_dim, num_heads, fused)
        self.fuse_proj = nn.Linear(2 * mel_dim, mel_dim)
        self.folded = None  # dict of folded weights once fold() ran

    @property
    def fused(self) -> bool:
        return self.attn_motion.fused

    def set_fused(self, fused: bool) -> None:
        """Select the attention route; the fused one runs unfolded."""
        self.attn_motion.fused = self.attn_text.fused = fused
        if fused:
            self.folded = None

    @torch.no_grad()
    def fold(self, dtype: torch.dtype) -> None:
        """Precompute the folded weights from the (fp32) parameters; call
        before the module's own weights are cast to ``dtype``."""
        e = self.mel_dim
        am, at = self.attn_motion, self.attn_text
        wf = self.fuse_proj.weight.float().t()  # (2e, e), flax layout
        w = torch.cat([am.out_proj.weight.float().t() @ wf[:e],
                       at.out_proj.weight.float().t() @ wf[e:]], dim=0)
        bias = (am.out_proj.bias.float() @ wf[:e] + at.out_proj.bias.float() @ wf[e:]
                + self.fuse_proj.bias.float())
        self.folded = {
            "wq": torch.cat([am.q_proj.weight, at.q_proj.weight], dim=0).to(dtype),
            "bq": torch.cat([am.q_proj.bias, at.q_proj.bias]).to(dtype),
            "w_out": w.t().contiguous().to(dtype),  # (e, 2e)
            "b_out": bias.to(dtype),
        }

    def _forward_folded(self, mel_hidden, motion_f, text_f):
        f = self.folded
        dt = f["wq"].dtype
        e, h = self.mel_dim, self.num_heads
        hd = e // h
        b, t = mel_hidden.shape[:2]
        q = F.linear(mel_hidden.to(dt), f["wq"], f["bq"]).reshape(b, t, 2, h, hd)
        ks, vs = [], []
        for kv_proj, attn, cond in ((self.motion_kv_proj, self.attn_motion, motion_f),
                                    (self.text_kv_proj, self.attn_text, text_f)):
            kv = kv_proj(cond.to(dt))
            ks.append(attn.k_proj(kv))
            vs.append(attn.v_proj(kv))
        s = ks[0].shape[1]
        k = torch.stack(ks, dim=2).reshape(b, s, 2, h, hd)
        v = torch.stack(vs, dim=2).reshape(b, s, 2, h, hd)
        scores = torch.einsum("bqnhd,bknhd->bnhqk", q, k) / _inv_scale(hd, q)
        probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
        core = torch.einsum("bnhqk,bknhd->bqnhd", probs, v).reshape(b, t, 2 * e)
        return F.linear(core, f["w_out"], f["b_out"])

    def forward(self, mel_hidden, motion_f, text_f, dtype=None):
        if dtype is not None:  # training form
            motion_kv = dense(self.motion_kv_proj, motion_f, dtype)
            text_kv = dense(self.text_kv_proj, text_f, dtype)
            a_m = self.attn_motion(mel_hidden, motion_kv, motion_kv, dtype)
            a_t = self.attn_text(mel_hidden, text_kv, text_kv, dtype)
            return dense(self.fuse_proj, torch.cat([a_m, a_t], dim=-1), dtype)
        if self.folded is not None and not self.fused:
            return self._forward_folded(mel_hidden, motion_f, text_f)
        dt = self.motion_kv_proj.weight.dtype
        motion_kv = self.motion_kv_proj(motion_f.to(dt))
        text_kv = self.text_kv_proj(text_f.to(dt))
        a_m = self.attn_motion(mel_hidden, motion_kv, motion_kv)
        a_t = self.attn_text(mel_hidden, text_kv, text_kv)
        return self.fuse_proj(torch.cat([a_m, a_t], dim=-1))
