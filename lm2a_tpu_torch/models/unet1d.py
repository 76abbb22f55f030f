"""The 1-D UNet denoisers, channels-last (B, T, C) (port of
``lm2a_tpu/models/unet1d.py``): ``UNet1DUltimate``, the production denoiser,
and ``UNet1D``, the v1 baseline (``ModelConfig.arch='v1'``; see its class).
Both share one interface (``Denoiser``): the serving form after
``prepare(dtype)``, ``refresh``, ``with_fused_attention``, the serving
forward with ``uncond_rows``, ``forward_train``, and ``run``, the traversal
both forwards (and tensor parallelism's split forwards) drive through a
block, a conv and a head callback, so no call site reads the architecture.

FiLM timestep modulation, sparse cross-attention (last block of each down
stage, every mid block, first block of each up stage), stride-2 conv
downsampling, align-corners linear upsampling + conv3, GroupNorm + SiLU +
1x1 output head. Module attribute names follow the flax names
(``down_0_block_0.conv1``, ``mid_block_2.cross_attn.attn_motion.q_proj``).

Every residual block runs its conv chain through
``ops.resblock.fused_resblock_chain`` — the CUDA kernels on the card, their
plain versions on the CPU — with the semantics of the JAX serving path
(``fused_resblock=True``): FiLM vectors in the compute dtype outside the
chain, attention blocks getting ``h`` (and ``xs`` when a skip exists) and
adding ``xs`` after attention.

``prepare(dtype)`` readies a loaded model for serving: kernel-layout chain
weights and folded attention weights from the fp32 parameters, then the
remaining Linear/Conv weights cast to the compute dtype (GroupNorm stays
fp32, as flax computes it). With ``fused_attention`` every attention core,
the CFG constant's at T=S=1 included, runs through the attention kernel's
wrapper and nothing is folded, as in the JAX package.

``forward_train`` is the training form, beside the serving form: the fp32
parameters stay the master copy and are cast to the compute dtype at each
use; GroupNorm keeps fp32 statistics; Dropout sits on ``h`` after conv2 and
before attention and draws from an explicit generator; attention is never
folded. Block routing follows the JAX package's: with
``fused_resblock_grad`` a block whose geometry passes
``ops.resblock_grad.resblock_train_fits`` runs the fused train chain (the
forward kernels and the CUDA backward); every other block runs plain,
differentiable PyTorch.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from lm2a_tpu_torch.core import draws
from lm2a_tpu_torch.models.attention import CrossAttentionFusion
from lm2a_tpu_torch.models.embedding import TimestepEmbedding, dense
from lm2a_tpu_torch.ops.resblock import (
    GN_EPS, ResblockWeights, fused_resblock_chain, gn_stats, gn_stats_plain,
)
from lm2a_tpu_torch.ops.resblock_grad import fused_resblock_train


def default_num_groups(channels: int) -> int:
    """Largest of (8, 4, 2, 1) dividing ``channels``."""
    for g in (8, 4, 2, 1):
        if channels % g == 0:
            return g
    return 1


class GroupNorm(nn.GroupNorm):
    """GroupNorm over channels-last (B, T, C): fp32 statistics with fast
    variance, eps 1e-5 (torch's default, kept by the JAX package), output in
    the input dtype. Where no gradient flows to the input (serving: the
    UNet's ``out_gn``), the statistics come from the ``gn_stats`` kernel's
    wrapper; under autograd from its plain version, which autograd can
    differentiate."""

    def __init__(self, channels: int, groups: Optional[int] = None, kernel: bool = True):
        super().__init__(groups or default_num_groups(channels), channels, eps=GN_EPS)
        self.kernel = kernel  # False: always the plain statistics (v1, as in JAX: no kernel)

    def forward(self, x):
        b, t, c = x.shape
        g = self.num_groups
        if not self.kernel or (torch.is_grad_enabled() and x.requires_grad):
            mean, rstd = gn_stats_plain(x, g, self.eps)
        else:
            mean, rstd = gn_stats(x.contiguous(), g, self.eps)
        y = (x.float().reshape(b, t, g, c // g) - mean[:, None, :, None]) * rstd[:, None, :, None]
        return (y.reshape(b, t, c) * self.weight.float() + self.bias.float()).to(x.dtype)


def conv_cl(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """A Conv1d applied to a channels-last (B, T, C) tensor."""
    dt = conv.weight.dtype
    if conv.kernel_size == (1,) and conv.stride == (1,):
        return F.linear(x.to(dt), conv.weight[:, :, 0], conv.bias)
    return conv(x.to(dt).transpose(1, 2)).transpose(1, 2).contiguous()


def conv_train(conv: nn.Module, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A Conv1d (or ConvTranspose1d) on a channels-last tensor in ``dtype``,
    its fp32 weight and bias cast differentiably (flax ``nn.Conv(dtype=...)``)."""
    w, b = conv.weight.to(dtype), conv.bias.to(dtype)
    x = x.to(dtype)
    if isinstance(conv, nn.ConvTranspose1d):
        return F.conv_transpose1d(x.transpose(1, 2), w, b, stride=conv.stride,
                                  padding=conv.padding).transpose(1, 2)
    if conv.kernel_size == (1,) and conv.stride == (1,):
        return F.linear(x, w[:, :, 0], b)
    return F.conv1d(x.transpose(1, 2), w, b, stride=conv.stride,
                    padding=conv.padding).transpose(1, 2)


def dropout(h: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability ``1 - rate`` and scale by
    its inverse; ``generator=None`` is the deterministic (eval) form, a
    ``core.draws.RowShard`` draws the mask at the global batch shape."""
    if rate == 0.0 or generator is None:
        return h
    keep = 1.0 - rate
    mask = draws.rand(h.shape, generator, h.device) < keep
    return torch.where(mask, h / keep, torch.zeros_like(h))


def upsample_linear_2x_align_corners(x: torch.Tensor) -> torch.Tensor:
    """(B, T, C) -> (B, 2T, C) linear interpolation with align_corners=True:
    output sample i sits at input position ``i (T-1) / (2T-1)``; the lerp
    fraction is rounded to the activation dtype, as in the JAX package."""
    t = x.shape[1]
    out_t = 2 * t
    pos = torch.arange(out_t, dtype=torch.float32, device=x.device) * ((t - 1) / (out_t - 1))
    lo = torch.clamp(torch.floor(pos).long(), 0, t - 1)
    hi = torch.clamp(lo + 1, 0, t - 1)
    frac = (pos - lo.float()).to(x.dtype)[None, :, None]
    return x[:, lo, :] * (1.0 - frac) + x[:, hi, :] * frac


def _fix_time_len(h: torch.Tensor, target_t: int) -> torch.Tensor:
    """Zero-pad or truncate the time axis to ``target_t``."""
    t = h.shape[1]
    if t == target_t:
        return h
    if t < target_t:
        return F.pad(h, (0, 0, 0, target_t - t))
    return h[:, :target_t, :]


class FiLM(nn.Module):
    """SiLU -> Linear(2C): per-channel (scale, shift), each (B, C)."""

    def __init__(self, time_emb_dim: int, out_channels: int):
        super().__init__()
        self.to_scale_shift = nn.Linear(time_emb_dim, 2 * out_channels)

    def forward(self, t_emb):
        stats = self.to_scale_shift(F.silu(t_emb.to(self.to_scale_shift.weight.dtype)))
        return stats.chunk(2, dim=-1)

    def forward_train(self, t_emb, dtype):
        return dense(self.to_scale_shift, F.silu(t_emb.to(dtype)), dtype).chunk(2, dim=-1)


class Denoiser(nn.Module):
    """What every call site reads of a denoiser: ``prepare`` (the serving
    form), ``refresh``, ``with_fused_attention``, ``forward`` (serving, with
    ``uncond_rows``) and ``forward_train``. A subclass sets
    ``fused_attention`` and adds its kernel-layout weights through
    ``_prepare_kernels`` / ``_refresh_kernels``."""

    fused_attention: bool = False
    fused_resblock_grad: bool = False

    def run(self, x, block, conv, head):
        """The traversal every form of the forward shares, from the input
        to the output: ``conv(module, h)`` for the input projection and each
        conv between blocks, ``block(module, h)`` for each residual block,
        ``head(module, a)`` for the final 1x1 conv on what it reads (the last
        block's output, through ``out_gn`` and SiLU where the architecture
        has them). Returns ``head``'s output."""
        raise NotImplementedError

    def forward(self, x, t, motion_f=None, text_f=None, uncond_rows: int = 0):
        t_emb = self.time_embedding(t)
        return self.run(x, lambda blk, h: blk(h, t_emb, motion_f, text_f, uncond_rows),
                        conv_cl, conv_cl).float()

    def forward_train(self, x, t, motion_f=None, text_f=None, *, dtype: torch.dtype,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Training form on the fp32 parameters, compute in ``dtype``;
        ``generator`` draws the dropout masks (None: deterministic, the
        eval step). Output fp32."""
        t_emb = self.time_embedding.forward_train(t, dtype)
        fused = self.fused_resblock_grad

        def conv(module, h):
            return conv_train(module, h, dtype)

        return self.run(x, lambda blk, h: blk.forward_train(h, t_emb, motion_f, text_f, dtype,
                                                            generator, fused),
                        conv, conv).float()

    def attention_modules(self):
        return [m for m in self.modules() if isinstance(m, CrossAttentionFusion)]

    def _prepare_kernels(self, dtype: torch.dtype) -> None:
        """Kernel-layout weights from the fp32 parameters (none by default)."""

    def _refresh_kernels(self, src: "Denoiser") -> None:
        """``_prepare_kernels`` again from ``src``, in place (none by default)."""

    @torch.no_grad()
    def prepare(self, dtype: torch.dtype) -> "Denoiser":
        """Serving form: kernel-layout and (off the fused route) folded
        attention weights from the fp32 parameters, then Linear/Conv weights
        cast to ``dtype``."""
        self._prepare_kernels(dtype)
        if not self.fused_attention:
            for a in self.attention_modules():
                a.fold(dtype)
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv1d, nn.ConvTranspose1d)):
                m.to(dtype)
        return self

    @torch.no_grad()
    def refresh(self, src: "Denoiser") -> "Denoiser":
        """Make this prepared model ``src.prepare(dtype)`` again, in place:
        ``src`` is the same architecture with fp32 parameters. Every tensor
        the serving forward reads is written with one ``copy_`` into its own
        storage, so a captured graph that reads them sees the new values."""
        for d, s in zip(self.parameters(), src.parameters(), strict=True):
            d.copy_(s)
        self._refresh_kernels(src)
        for d, s in zip(self.attention_modules(), src.attention_modules(), strict=True):
            if d.folded is not None:
                for k, t in s.folded_weights(d.folded["wq"].dtype).items():
                    d.folded[k].copy_(t)
        return self

    def with_fused_attention(self) -> "Denoiser":
        """This model on the fused attention route: a copy of the module tree
        whose parameters, buffers and kernel-layout weights are this model's
        own tensors (no second copy of the weights); this model is left as
        it is."""

        def tree(m: nn.Module) -> nn.Module:
            new = copy.copy(m)
            new._parameters = dict(m._parameters)
            new._buffers = dict(m._buffers)
            new._modules = {k: tree(c) for k, c in m._modules.items()}
            return new

        new = tree(self)
        new.fused_attention = True
        for m in new.attention_modules():
            m.set_fused(True)
        return new


def attend_uncond(attn: CrossAttentionFusion, h, motion_f, text_f, uncond_rows: int):
    """Cross-attention where the first ``uncond_rows`` rows are CFG-
    unconditional (identically zero conditions): their output is a
    per-channel constant, computed once at (1, 1) shapes and broadcast."""
    if not uncond_rows:
        return attn(h, motion_f, text_f)
    bu, t_len, c = uncond_rows, h.shape[1], h.shape[2]
    const = attn(h.new_zeros((1, 1, c)), motion_f.new_zeros((1, 1, motion_f.shape[-1])),
                 text_f.new_zeros((1, 1, text_f.shape[-1])))
    h_cond = attn(h[bu:], motion_f[bu:], text_f[bu:])
    return torch.cat([const.expand(bu, t_len, c), h_cond], dim=0)


class ResBlockUltimate(nn.Module):
    """GN-SiLU-conv3 -> FiLM -> GN-SiLU-conv3 -> [cross-attn] + skip.

    ``uncond_rows`` marks the first N batch rows as CFG-unconditional
    (identically zero conditions): their cross-attention output is a
    per-channel constant, computed once at (1, 1) shapes and broadcast."""

    def __init__(self, in_channels: int, out_channels: int, time_emb_dim: int,
                 cond_dim: int = 128, use_attn: bool = False, num_heads: int = 4,
                 fused_attention: bool = False, dropout: float = 0.1):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.use_attn = use_attn
        self.dropout = dropout
        self.gn1 = GroupNorm(in_channels)
        self.conv1 = nn.Conv1d(in_channels, out_channels, 3, padding=1)
        self.film = FiLM(time_emb_dim, out_channels)
        self.gn2 = GroupNorm(out_channels)
        self.conv2 = nn.Conv1d(out_channels, out_channels, 3, padding=1)
        if use_attn:
            self.cross_attn = CrossAttentionFusion(out_channels, cond_dim, num_heads,
                                                   fused_attention)
        if in_channels != out_channels:
            self.skip = nn.Conv1d(in_channels, out_channels, 1)
        self.chain: Optional[ResblockWeights] = None

    @torch.no_grad()
    def chain_weights(self, dtype: Optional[torch.dtype] = None) -> ResblockWeights:
        """Kernel-layout weights: convs ``(Cout, 3*Cin)`` in ``dtype``, norm
        parameters and biases fp32 (read from the current parameters)."""
        dtype = dtype or self.conv1.weight.dtype

        def conv(c):
            co, ci, k = c.weight.shape
            return c.weight.permute(0, 2, 1).reshape(co, k * ci).to(dtype).contiguous()

        def vec(p):  # a copy: prepare() casts the module's own parameters later
            return p.detach().float().clone()

        skip = getattr(self, "skip", None)
        return ResblockWeights(
            vec(self.gn1.weight), vec(self.gn1.bias), conv(self.conv1), vec(self.conv1.bias),
            vec(self.gn2.weight), vec(self.gn2.bias), conv(self.conv2), vec(self.conv2.bias),
            skip.weight[:, :, 0].to(dtype, copy=True) if skip is not None else None,
            vec(skip.bias) if skip is not None else None,
            self.gn1.num_groups, self.gn2.num_groups,
        )

    def forward(self, x, t_emb, motion_f=None, text_f=None, uncond_rows: int = 0):
        p = self.chain if self.chain is not None else self.chain_weights()
        scale, shift = self.film(t_emb)
        out = fused_resblock_chain(x, p, scale, shift, add_residual=not self.use_attn)
        if not self.use_attn:
            return out  # residual added in the kernel's epilogue
        h, xs = out if p.skip_w is not None else (out, x.to(p.conv1_w.dtype))
        if motion_f is not None and text_f is not None:
            h = attend_uncond(self.cross_attn, h, motion_f, text_f, uncond_rows)
        return xs + h

    def fused_train(self, x, scale, shift, dtype: torch.dtype, shard=None,
                    n: Optional[int] = None, tp=None):
        """The block's fused train chain (``fused_resblock_train``) on ``x``
        at ``dtype``: ``(h, xs)``, the chain's output and the residual (the
        skip's output, or ``x`` at ``dtype``), or None where the training
        gate refuses the geometry. With ``shard``: ``x`` is the shard's rows
        of a length-``n`` sequence, and the gate reads ``n``. With ``tp``:
        the chain split over the model axis of tensor parallelism (the
        parameters this rank's shards, FiLM its channels)."""
        skip = getattr(self, "skip", None)
        res = fused_resblock_train(
            x.to(dtype), self.gn1.weight, self.gn1.bias, self.conv1.weight, self.conv1.bias,
            scale, shift, self.gn2.weight, self.gn2.bias, self.conv2.weight, self.conv2.bias,
            skip.weight if skip is not None else None, skip.bias if skip is not None else None,
            groups1=self.gn1.num_groups, groups2=self.gn2.num_groups, shard=shard, n=n, tp=tp)
        if res is None:
            return None
        return res if skip is not None else (res, x.to(dtype))

    def forward_train(self, x, t_emb, motion_f, text_f, dtype: torch.dtype,
                      generator: Optional[torch.Generator], fused_grad: bool):
        """Training form (see the module docstring); ``generator=None``
        disables dropout."""
        scale, shift = self.film.forward_train(t_emb, dtype)
        skip = getattr(self, "skip", None)
        attend = self.use_attn and motion_f is not None and text_f is not None
        if fused_grad:
            res = self.fused_train(x, scale, shift, dtype)
            if res is not None:  # the geometry passes the fused-backward gate
                h, xs = res
                h = dropout(h, self.dropout, generator)
                if attend:
                    h = self.cross_attn(h, motion_f, text_f, dtype=dtype)
                return xs + h
        h = conv_train(self.conv1, F.silu(self.gn1(x)), dtype)
        h = h * (1.0 + scale[:, None, :]) + shift[:, None, :]
        h = conv_train(self.conv2, F.silu(self.gn2(h)), dtype)
        h = dropout(h, self.dropout, generator)
        if attend:
            h = self.cross_attn(h, motion_f, text_f, dtype=dtype)
        if skip is not None:
            x = conv_train(skip, x, dtype)
        return x + h


class UNet1DUltimate(Denoiser):
    """Epsilon-prediction UNet over (B, T, in_dim) mels; output fp32."""

    def __init__(self, in_dim: int = 80, base_dim: int = 256,
                 dim_mults: Tuple[int, ...] = (1, 2, 4), cond_dim: int = 128,
                 time_emb_dim: int = 256, num_res_blocks: int = 2, mid_blocks: int = 3,
                 attn_heads: int = 8, fused_attention: bool = False, dropout: float = 0.1,
                 fused_resblock_grad: bool = False):
        super().__init__()
        self.num_res_blocks, self.mid_blocks = num_res_blocks, mid_blocks
        self.fused_attention = fused_attention
        self.fused_resblock_grad = fused_resblock_grad
        self.dims = [base_dim * m for m in dim_mults]
        self.time_embedding = TimestepEmbedding(time_emb_dim)
        self.in_proj = nn.Conv1d(in_dim, base_dim, 1)

        def block(cin, cout, use_attn):
            return ResBlockUltimate(cin, cout, time_emb_dim, cond_dim, use_attn, attn_heads,
                                    fused_attention, dropout)

        prev = base_dim
        for i, dim in enumerate(self.dims):
            for b in range(num_res_blocks):
                self.add_module(f"down_{i}_block_{b}",
                                block(prev, dim, b == num_res_blocks - 1))
                prev = dim
            self.add_module(f"down_{i}_downsample", nn.Conv1d(dim, dim, 4, stride=2, padding=1))
        for b in range(mid_blocks):
            self.add_module(f"mid_block_{b}", block(prev, prev, True))
        for i, dim in enumerate(reversed(self.dims)):
            self.add_module(f"up_{i}_upsample", nn.Conv1d(prev, dim, 3, padding=1))
            for b in range(num_res_blocks):
                # the first block takes the upsampled h concatenated with the skip
                self.add_module(f"up_{i}_block_{b}", block(2 * dim if b == 0 else dim, dim, b == 0))
            prev = dim
        self.out_gn = GroupNorm(prev)
        self.out_proj = nn.Conv1d(prev, in_dim, 1)

    def resblocks(self):
        return [m for m in self.modules() if isinstance(m, ResBlockUltimate)]

    def _prepare_kernels(self, dtype: torch.dtype) -> None:
        for blk in self.resblocks():
            blk.chain = blk.chain_weights(dtype)

    def _refresh_kernels(self, src: "UNet1DUltimate") -> None:
        for d, s in zip(self.resblocks(), src.resblocks(), strict=True):
            fresh = s.chain_weights(d.chain.conv1_w.dtype)
            for f in dataclasses.fields(fresh):
                t = getattr(fresh, f.name)
                if isinstance(t, torch.Tensor):
                    getattr(d.chain, f.name).copy_(t)

    def walk(self, h, block, conv, up=None):
        """The path from the input projection's output to the last up block,
        shared by every form of the forward: ``block(module, h)`` for each
        res block, ``conv(module, h)`` for the downsampling convs and the
        conv after each 2x upsampling; ``up(module, h, skip)``, where given,
        replaces the upsampling, its conv and ``_fix_time_len``. The skip's
        channels are joined after."""
        skips = []
        for i in range(len(self.dims)):
            for b in range(self.num_res_blocks):
                h = block(getattr(self, f"down_{i}_block_{b}"), h)
            skips.append(h)
            h = conv(getattr(self, f"down_{i}_downsample"), h)
        for b in range(self.mid_blocks):
            h = block(getattr(self, f"mid_block_{b}"), h)
        for i in range(len(self.dims)):
            skip, conv_up = skips.pop(), getattr(self, f"up_{i}_upsample")
            if up is None:
                h = _fix_time_len(conv(conv_up, upsample_linear_2x_align_corners(h)),
                                  skip.shape[1])
            else:
                h = up(conv_up, h, skip)
            h = torch.cat([h, skip], dim=-1)
            for b in range(self.num_res_blocks):
                h = block(getattr(self, f"up_{i}_block_{b}"), h)
        return h

    def run(self, x, block, conv, head):
        h = self.walk(conv(self.in_proj, x), block, conv)
        return head(self.out_proj, F.silu(self.out_gn(h)))


class ResBlockV1(nn.Module):
    """v1 block: GN(8)-SiLU-conv3 + time_proj(t_emb) -> GN(8)-SiLU-conv3 ->
    cross-attention (every block) + x. GroupNorm and convolutions are plain
    PyTorch, as the JAX package runs them through XLA (no Pallas kernel); the
    attention core takes the kernel on the fused route."""

    def __init__(self, channels: int, time_emb_dim: int, cond_dim: int = 128,
                 num_heads: int = 4, fused_attention: bool = False):
        super().__init__()
        self.channels = channels
        self.norm1 = GroupNorm(channels, groups=8, kernel=False)
        self.conv1 = nn.Conv1d(channels, channels, 3, padding=1)
        self.time_proj = nn.Linear(time_emb_dim, channels)
        self.norm2 = GroupNorm(channels, groups=8, kernel=False)
        self.conv2 = nn.Conv1d(channels, channels, 3, padding=1)
        self.cross_attn = CrossAttentionFusion(channels, cond_dim, num_heads, fused_attention)

    def forward(self, x, t_emb, motion_f, text_f, uncond_rows: int = 0):
        h = conv_cl(self.conv1, F.silu(self.norm1(x)))
        h = h + self.time_proj(t_emb.to(self.time_proj.weight.dtype))[:, None, :]
        h = conv_cl(self.conv2, F.silu(self.norm2(h)))
        return x + attend_uncond(self.cross_attn, h, motion_f, text_f, uncond_rows)

    def forward_train(self, x, t_emb, motion_f, text_f, dtype: torch.dtype,
                      generator: Optional[torch.Generator] = None, fused_grad: bool = False):
        """Training form (no dropout, no fused chain: ``generator`` and
        ``fused_grad`` are unused)."""
        h = conv_train(self.conv1, F.silu(self.norm1(x)), dtype)
        h = h + dense(self.time_proj, t_emb, dtype)[:, None, :]
        h = conv_train(self.conv2, F.silu(self.norm2(h)), dtype)
        return x.to(dtype) + self.cross_attn(h, motion_f, text_f, dtype=dtype)


class UNet1D(Denoiser):
    """The v1 baseline UNet (port of ``UNet1D`` in
    ``lm2a_tpu/models/unet1d.py``; ``ModelConfig.arch='v1'``): additive
    timestep projection, cross-attention in every block, stride-2 conv
    downsampling, transposed-conv upsampling (k4, s2, p1: flax's padding
    (2, 2)) concatenated with the skip, asymmetric up-path widths, a 1x1
    output head; no dropout. ``fused_resblock_grad`` has no effect here, as
    in the JAX factory. Output fp32."""

    def __init__(self, in_dim: int = 80, base_dim: int = 128,
                 dim_mults: Tuple[int, ...] = (1, 2, 4), cond_dim: int = 128,
                 time_emb_dim: int = 256, attn_heads: int = 4, fused_attention: bool = False):
        super().__init__()
        self.fused_attention = fused_attention
        self.dims = [base_dim * m for m in dim_mults]
        self.time_embedding = TimestepEmbedding(time_emb_dim)
        self.input_proj = nn.Conv1d(in_dim, base_dim, 1)

        def block(c):
            return ResBlockV1(c, time_emb_dim, cond_dim, attn_heads, fused_attention)

        prev, skip_channels = base_dim, []
        for i, dim in enumerate(self.dims):
            self.add_module(f"down_{i}_res", block(prev))
            skip_channels.append(prev)
            self.add_module(f"down_{i}_downsample", nn.Conv1d(prev, dim, 4, stride=2, padding=1))
            prev = dim
        self.mid_res = block(prev)
        for i, (dim, skip_ch) in enumerate(zip(reversed(self.dims), reversed(skip_channels))):
            self.add_module(f"up_{i}_upconv", nn.ConvTranspose1d(prev, dim, 4, stride=2,
                                                                 padding=1))
            self.add_module(f"up_{i}_res", block(dim + skip_ch))
            prev = dim + skip_ch
        self.out_proj = nn.Conv1d(prev, in_dim, 1)

    def run(self, x, block, conv, head):
        h = conv(self.input_proj, x)
        skips = []
        for i in range(len(self.dims)):
            h = block(getattr(self, f"down_{i}_res"), h)
            skips.append(h)
            h = conv(getattr(self, f"down_{i}_downsample"), h)
        h = block(self.mid_res, h)
        for i in range(len(self.dims)):
            h = conv(getattr(self, f"up_{i}_upconv"), h)
            skip = skips.pop()
            h = torch.cat([_fix_time_len(h, skip.shape[1]), skip], dim=-1)
            h = block(getattr(self, f"up_{i}_res"), h)
        return head(self.out_proj, h)
