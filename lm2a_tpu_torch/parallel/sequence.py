"""Sequence-parallel sampling: the mel time axis sharded over the mesh's
model axis (port of ``lm2a_tpu/parallel/sequence.py``).

The JAX package constrains the ``(B, T, C)`` activations to ``P(None,
'model', None)`` and lets GSPMD insert the halo exchanges and gathers. The
port writes them out: each rank of the model axis holds rows ``[lo, hi)``
of every time axis (the ceiling split of its length, so 129 frames go 65/64
over two ranks), and runs the serving forward of ``UNet1DUltimate`` on its
rows through the same kernels as an unsharded forward:

- GroupNorm statistics span all of T: ``gn_stats``'s sums form gives each
  shard's per (row, group) sum and sum of squares, one all-reduce adds them
  over the model axis, and ``gn_finish`` makes mean and rstd as the kernel
  does; ``conv3_fused`` then normalises with them.
- The k=3 convolutions read one row past each end of the shard. The conv's
  zero padding lies in activation space (after GroupNorm and SiLU), so a
  shard at a global edge passes no halo row (the kernel pads), and an inner
  one passes its neighbours' raw rows, which the kernel normalises with the
  global statistics; the rows computed for the halos are dropped. A 1x1 skip
  and the residual read the same extended rows.
- The stride-2 downsampling conv (k=4, pad 1) and the align-corners linear
  upsampling read global positions: every stage's shard bounds come from
  its global length, each rank fetches the input rows its outputs read
  (``halo_exchange`` with per-rank counts), and the upsampling's positions
  ``i (T-1) / (2T-1)`` are computed at global indices, so the values are
  the unsharded ones.
- Cross-attention keeps its queries local; the conditions (sharded along S
  like the mel) are all-gathered once a chain, so every rank's attention
  reads all keys and values through the unchanged attention path.

``make_sp_train_step`` trains with batch rows over the data axis and T over
the model axis: the training form of the same forward. With
``fused_resblock_grad``, every block that the training gate routes at the
sequence's global length (the shape the JAX kernel sees under GSPMD, so the
blocks the unsharded step routes) runs the fused train chain on its shard
(``ops.resblock_grad.chain_forward_sharded`` and
``chain_backward_sharded``, through the kernels on the card): the
statistics from the all-reduced sums as above, the convs' inputs with halo
rows; in the backward each conv's output gradient is exchanged one row
forward, so a shard gets the whole gradient of its own activation rows
(the halo forms of ``conv3_dgrad`` and ``conv3_wgrad``), and GroupNorm's
backward reads the group totals all-reduced over the model axis (the
totals form of ``gn_bwd``); that autograd node does its own collectives.
The other blocks, and every block without ``fused_resblock_grad``, run the
library route, differentiated through collectives that autograd knows
(``core.distributed``: a halo's backward sends each received row's gradient
back to the rank it came from, which adds it to that row; the GroupNorm
sums' all-reduce and the conditions' gather have all-reduces as backward).
The steps run eagerly, on the card or the CPU: gloo's collectives cannot be
captured in a CUDA graph.

``make_sequence_sharded_sampler(apply_fn, schedule, mesh, ...)`` returns
``run(generator, shape, motion_f, text_f, x_init=None, noise_seq=None)``:
one DDPM or DDIM chain whose steps run eagerly (their collectives cannot be
captured in a CUDA graph under gloo), whose draws are made at the global
shape and sliced (``core.draws.RowShard`` along T), and whose result is
gathered: every rank returns the whole ``(B, T, C)`` sample.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from lm2a_tpu_torch.core import distributed
from lm2a_tpu_torch.core import draws as row_draws
from lm2a_tpu_torch.core.draws import RowShard
from lm2a_tpu_torch.core.mesh import DATA_AXIS, MODEL_AXIS, Mesh
from lm2a_tpu_torch.diffusion.gaussian import SamplerChain, ddim_sample, ddpm_sample
from lm2a_tpu_torch.diffusion.schedule import Schedule
from lm2a_tpu_torch.models.unet1d import attend_uncond, conv_cl, conv_train, dropout
from lm2a_tpu_torch.ops.resblock import conv3_fused, gn_finish, gn_sums


def shard_bounds(n: int, parts: int, i: int) -> Tuple[int, int]:
    """Rows ``[lo, hi)`` of a length-``n`` axis that shard ``i`` of ``parts``
    holds: the ceiling split (the first shards take the extra rows)."""
    return -(-n * i // parts), -(-n * (i + 1) // parts)


@dataclass
class SeqShard:
    """This rank's place on the model axis of ``mesh``: ``index`` of
    ``parts`` shards, the axis's process group (None for one shard)."""

    mesh: Mesh

    def __post_init__(self):
        self.group = self.mesh.group(MODEL_AXIS)
        self.parts = self.mesh.shape[MODEL_AXIS]
        self.index = self.mesh.axis_index(MODEL_AXIS)

    def bounds(self, n: int, i: Optional[int] = None) -> Tuple[int, int]:
        return shard_bounds(n, self.parts, self.index if i is None else i)

    def rows(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This shard's rows of a whole tensor."""
        lo, hi = self.bounds(x.shape[dim])
        return x.narrow(dim, lo, hi - lo)

    @staticmethod
    def _grad(x: torch.Tensor) -> bool:
        """Whether ``x`` takes part in a backward (the collectives then
        take their autograd forms)."""
        return torch.is_grad_enabled() and x.requires_grad

    def window(self, x: torch.Tensor, n: int, need) -> torch.Tensor:
        """Global rows ``need(i) = [a, b)`` of a length-``n`` axis that
        shard ``i`` reads, this shard's from its local rows ``x``: rows of
        the neighbours fetched by one halo exchange, rows outside ``[0, n)``
        zero. ``need`` is evaluated for every shard (each sends what its
        neighbours ask)."""
        wants = [need(i) for i in range(self.parts)]
        bounds = [self.bounds(n, i) for i in range(self.parts)]
        left = [max(0, lo - max(a, 0)) for (a, _), (lo, _) in zip(wants, bounds)]
        right = [max(0, min(b, n) - hi) for (_, b), (_, hi) in zip(wants, bounds)]
        exchange = (distributed.halo_exchange_grad if self._grad(x)
                    else distributed.halo_exchange)
        from_left, from_right = exchange(x, self.group, left, right)
        (a, b), (lo, hi) = wants[self.index], bounds[self.index]
        parts = [from_left, x[:, max(a, lo) - lo:min(b, hi) - lo], from_right]
        out = torch.cat([p for p in parts if p is not None], dim=1)
        pad = (max(0, -a), max(0, b - n))
        if any(pad):
            out = F.pad(out, (0, 0) + pad)
        return out

    def halo(self, x: torch.Tensor, n: int) -> Tuple[torch.Tensor, int]:
        """``x`` with one neighbour row at each inner end (none at a global
        edge, where the conv pads) and the offset of ``x``'s first row in it."""
        lo, hi = self.bounds(n)
        ext = self.window(x, n, lambda i: (lambda b: (max(b[0] - 1, 0),
                                                      min(b[1] + 1, n)))(self.bounds(n, i)))
        return ext.contiguous(), int(lo > 0)

    def stats(self, x: torch.Tensor, groups: int, n: int):
        """GroupNorm mean and rstd over all ``n`` rows of a sharded tensor."""
        s, ss = gn_sums(x.contiguous(), groups)
        sums = self.all_reduce(torch.stack([s, ss]))
        return gn_finish(sums[0], sums[1], n * (x.shape[-1] // groups))

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the model axis, in place."""
        return distributed.all_reduce(t, self.group)

    def gather(self, x: torch.Tensor, n: int) -> torch.Tensor:
        """The whole length-``n`` axis from every shard's rows."""
        sizes = [hi - lo for lo, hi in (self.bounds(n, i) for i in range(self.parts))]
        if self._grad(x):
            return distributed.all_gather_grad(x, self.group, sizes)
        return distributed.all_gather(x.contiguous(), self.group, sizes)

    def group_norm(self, gn, x: torch.Tensor, n: int) -> torch.Tensor:
        """``GroupNorm.forward`` (its plain, differentiable statistics) over
        all ``n`` rows: each shard's sums added over the model axis."""
        b, tl, c = x.shape
        g = gn.num_groups
        xf = x.float().reshape(b, tl, g, c // g)
        sums = distributed.all_reduce_grad(
            torch.stack([xf.sum(dim=(1, 3)), (xf * xf).sum(dim=(1, 3))]), self.group)
        cnt = float(n * (c // g))
        mean = sums[0] / cnt
        rstd = torch.rsqrt(sums[1] / cnt - mean * mean + gn.eps)
        y = (xf - mean[:, None, :, None]) * rstd[:, None, :, None]
        return (y.reshape(b, tl, c) * gn.weight.float() + gn.bias.float()).to(x.dtype)

    def conv3_train(self, conv, a: torch.Tensor, n: int, dtype) -> torch.Tensor:
        """A k=3, pad-1 conv (``conv_train``) of this shard's rows of a
        length-``n`` activation: the neighbours' rows of it (their own
        GroupNorm and SiLU, with the same statistics), zeros at a global
        edge."""
        w = self.window(a, n, lambda i: (lambda b: (b[0] - 1, b[1] + 1))(self.bounds(n, i)))
        return F.conv1d(w.to(dtype).transpose(1, 2), conv.weight.to(dtype),
                        conv.bias.to(dtype)).transpose(1, 2)


def _block(blk, shard: SeqShard, x, n: int, t_emb, motion_f, text_f, uncond_rows: int):
    """``ResBlockUltimate.forward`` on this shard's rows of a length-``n``
    axis (see the module docstring)."""
    p = blk.chain
    scale, shift = blk.film(t_emb)
    add_residual = not blk.use_attn
    cdt = p.conv1_w.dtype
    x = x.to(cdt).contiguous()
    tl = x.shape[1]
    film = (scale.float().contiguous(), shift.float().contiguous())
    xe, a = shard.halo(x, n)
    mean1, rstd1 = shard.stats(x, p.groups1, n)
    f = conv3_fused(xe, mean1, rstd1, p.gn1_scale, p.gn1_bias, p.conv1_w, p.conv1_b,
                    film=film, out_dtype=torch.float32)[:, a:a + tl].contiguous()
    mean2, rstd2 = shard.stats(f, p.groups2, n)
    fe, _ = shard.halo(f, n)
    kw = dict(out_dtype=cdt)
    if p.skip_w is not None:
        kw.update(skip=(xe, p.skip_w, p.skip_b), split_skip=not add_residual)
    elif add_residual:
        kw.update(residual=xe)
    out = conv3_fused(fe, mean2, rstd2, p.gn2_scale, p.gn2_bias, p.conv2_w, p.conv2_b, **kw)
    if add_residual:
        return out[:, a:a + tl]
    h, xs = out if p.skip_w is not None else (out, xe)
    h, xs = h[:, a:a + tl], xs[:, a:a + tl]
    if motion_f is not None and text_f is not None:
        h = attend_uncond(blk.cross_attn, h, motion_f, text_f, uncond_rows)
    return xs + h


def _weights(conv, dtype):
    """A conv's weight and bias in ``dtype`` (the training form casts the
    fp32 parameters at each use), or as they are (the serving form)."""
    if dtype is None:
        return conv.weight, conv.bias
    return conv.weight.to(dtype), conv.bias.to(dtype)


def _downsample(conv, shard: SeqShard, h, n: int, dtype=None):
    """The k=4, stride-2, pad-1 conv: output ``j`` reads rows ``2j-1 .. 2j+2``."""
    m = (n + 2 - 4) // 2 + 1
    w, b = _weights(conv, dtype)

    def need(i):
        lo, hi = shard.bounds(m, i)
        return 2 * lo - 1, 2 * hi + 1

    win = shard.window(h.to(w.dtype), n, need)
    out = F.conv1d(win.transpose(1, 2), w, b, stride=2)
    return out.transpose(1, 2).contiguous(), m


def _up_rows(n_low: int, k0: int, k1: int):
    """Rows ``[k0, k1)`` of the align-corners 2x upsampling of ``n_low`` rows:
    their fp32 positions (at global indices, as the unsharded upsampling
    computes them) and the low rows they read."""
    m = 2 * n_low
    pos = torch.arange(k0, k1, dtype=torch.float32) * ((n_low - 1) / (m - 1))
    lo = torch.clamp(torch.floor(pos).long(), 0, n_low - 1)
    return pos, lo, torch.clamp(lo + 1, 0, n_low - 1)


def _upsample_conv(conv, shard: SeqShard, h, n_low: int, n_out: int, dtype=None):
    """``upsample_linear_2x_align_corners``, the k=3 conv and ``_fix_time_len``
    to ``n_out`` rows, on this shard's rows of the ``n_out`` axis."""
    m = 2 * n_low
    cw, cb = _weights(conv, dtype)

    def span(i):  # upsampled rows [k0, k1) whose conv outputs shard i keeps
        lo, hi = shard.bounds(n_out, i)
        return max(lo - 1, 0), min(hi + 1, m)

    def need(i):
        k0, k1 = span(i)
        if k1 <= k0:  # every row of the shard lies in the zero padding past m
            return shard.bounds(n_low, i)
        _, lo, hi = _up_rows(n_low, k0, k1)
        return int(lo[0]), int(hi[-1]) + 1

    lo, hi = shard.bounds(n_out)
    k0, k1 = span(shard.index)
    w = shard.window(h, n_low, need)
    b, _, c = h.shape
    if k1 <= k0:  # the window still joins its shard's exchange above
        return w.new_zeros((b, hi - lo, cw.shape[0]), dtype=cw.dtype) + 0.0 * w.sum().to(cw.dtype)
    pos, rl, rh = _up_rows(n_low, k0, k1)
    a = need(shard.index)[0]
    pos, rl, rh = pos.to(h.device), rl.to(h.device) - a, rh.to(h.device) - a
    frac = (pos - (rl + a).float()).to(h.dtype)[None, :, None]
    u = w[:, rl, :] * (1.0 - frac) + w[:, rh, :] * frac
    u = F.pad(u, (0, 0, int(lo == 0), int(min(hi, m) + 1 > m)))
    out = F.conv1d(u.to(cw.dtype).transpose(1, 2), cw, cb)
    out = out.transpose(1, 2)[:, :max(0, min(hi, m) - lo)]
    if out.shape[1] < hi - lo:  # rows past m: _fix_time_len's zero padding
        out = F.pad(out, (0, 0, 0, hi - lo - out.shape[1]))
    return out.contiguous()


def _walk(unet, shard: SeqShard, h, n: int, block, dtype=None):
    """``UNet1DUltimate.walk`` on this shard's rows of a length-``n`` mel:
    ``block(module, h, n)`` at each block's global length. Returns the last
    up block's rows and their length (``n`` again)."""
    ns = [n]  # the current global length on top, the skips' lengths below

    def down(conv, h):
        h, m = _downsample(conv, shard, h, ns[-1], dtype)
        ns.append(m)
        return h

    def up(conv, h, skip):
        m = ns.pop()
        return _upsample_conv(conv, shard, h, m, ns[-1], dtype)

    return unet.walk(h, lambda blk, h: block(blk, h, ns[-1]), down, up), ns[-1]


def sequence_sharded_forward(unet, shard: SeqShard, x, t, motion_f=None, text_f=None,
                             n: Optional[int] = None, uncond_rows: int = 0) -> torch.Tensor:
    """``UNet1DUltimate.forward`` (the prepared serving form) on this shard's
    rows ``x`` of a length-``n`` mel; ``motion_f`` and ``text_f`` whole
    (every key and value). Returns this shard's rows of the fp32 output."""
    dt = unet.in_proj.weight.dtype
    t_emb = unet.time_embedding(t)
    h = conv_cl(unet.in_proj, x.to(dt))
    h, n = _walk(unet, shard, h, n, lambda blk, h, n: _block(blk, shard, h, n, t_emb, motion_f,
                                                             text_f, uncond_rows))
    gn = unet.out_gn
    bsz, tl, c = h.shape
    g = gn.num_groups
    mean, rstd = shard.stats(h, g, n)
    y = (h.float().reshape(bsz, tl, g, c // g) - mean[:, None, :, None]) * rstd[:, None, :, None]
    y = (y.reshape(bsz, tl, c) * gn.weight.float() + gn.bias.float()).to(h.dtype)
    return conv_cl(unet.out_proj, F.silu(y)).float()


def _stage_generator(generator, shard: SeqShard, n: int):
    """The dropout masks' generator at a stage of ``n`` frames: drawn at the
    stage's global length, this shard's frames kept."""
    if generator is None:
        return None
    rows = slice(*shard.bounds(n))
    if isinstance(generator, RowShard):
        return generator.cut(1, rows, n)
    return RowShard(generator, rows, n, dim=1)


def _block_train(blk, shard: SeqShard, x, n: int, t_emb, motion_f, text_f, dtype, generator,
                 fused: bool):
    """``ResBlockUltimate.forward_train`` on this shard's rows: the fused
    train chain on the shard where ``fused`` and the gate pass at the global
    length ``n``, else the library route."""
    scale, shift = blk.film.forward_train(t_emb, dtype)
    skip = getattr(blk, "skip", None)
    res = blk.fused_train(x, scale, shift, dtype, shard=shard, n=n) if fused else None
    if res is not None:
        h, xs = res
    else:
        h = shard.conv3_train(blk.conv1, F.silu(shard.group_norm(blk.gn1, x, n)), n, dtype)
        h = h * (1.0 + scale[:, None, :]) + shift[:, None, :]
        h = shard.conv3_train(blk.conv2, F.silu(shard.group_norm(blk.gn2, h, n)), n, dtype)
        xs = conv_train(skip, x, dtype) if skip is not None else x
    h = dropout(h, blk.dropout, _stage_generator(generator, shard, n))
    if blk.use_attn and motion_f is not None and text_f is not None:
        h = blk.cross_attn(h, motion_f, text_f, dtype=dtype)
    return xs + h


def sequence_sharded_forward_train(unet, shard: SeqShard, x, t, motion_f, text_f, n: int, *,
                                   dtype: torch.dtype, generator=None) -> torch.Tensor:
    """``UNet1DUltimate.forward_train`` on this shard's rows ``x`` of a
    length-``n`` mel (each block as ``_block_train`` routes it),
    differentiable through the collectives; ``motion_f`` and ``text_f``
    whole. fp32 out."""
    t_emb = unet.time_embedding.forward_train(t, dtype)
    h = conv_train(unet.in_proj, x, dtype)
    h, n = _walk(unet, shard, h, n,
                 lambda blk, h, n: _block_train(blk, shard, h, n, t_emb, motion_f, text_f, dtype,
                                                generator, unet.fused_resblock_grad), dtype)
    h = F.silu(shard.group_norm(unet.out_gn, h, n))
    return conv_train(unet.out_proj, h, dtype).float()


def make_sp_train_step(schedule: Schedule, cfg, optimizer=None, mesh: Optional[Mesh] = None,
                       dataset_mean: float = 0.0, dataset_std: float = 1.0):
    """Sequence-sharded training step: batch rows over ``data``, time over
    ``model``; ``make_train_step``'s math (the CFG drop, the diffusion loss,
    clip + Adan + EMA) with replicated state. Returns ``step(state, batch,
    generator=None, draws=None) -> loss`` over this rank's rows of the global
    batch, whole in T (each rank keeps its frames); the gradients and the
    loss are summed over the model axis and averaged over the data axis in
    one all-reduce of ``state.grads``. Draws are made (or injected,
    ``Draws``) at the global shape. Eager, on the batch's device (see the
    module docstring)."""
    from lm2a_tpu_torch.core.device import dtype_from_str
    from lm2a_tpu_torch.diffusion.gaussian import q_sample
    from lm2a_tpu_torch.ops.adan import N_SCALARS
    from lm2a_tpu_torch.training.train_step import make_optimizer

    opt = optimizer or make_optimizer(cfg)
    shard = SeqShard(mesh)
    n_data = mesh.shape[DATA_AXIS]
    everyone = None
    if distributed.process_count() > 1 and mesh.size > 1:
        import torch.distributed as dist

        everyone = dist.group.WORLD
    dt = dtype_from_str(cfg.train.compute_dtype)
    p_drop = cfg.train.cond_drop_prob

    def step(state, batch, generator=None, draws=None) -> torch.Tensor:
        b, n = batch["mel"].shape[:2]
        rows = distributed.local_batch_slice(mesh, b * n_data)
        lo, hi = shard.bounds(n)
        gen = generator
        if isinstance(gen, torch.Generator) and n_data > 1:
            gen = RowShard(gen, rows, b * n_data)
        params = state.params()
        torch._foreach_zero_([p.grad for p in params.values()])
        dev = batch["mel"].device
        motion_f, text_f = state.cond_proj.forward_train(batch["motion"][:, lo:hi],
                                                         batch["lyrics"][:, lo:hi], dt)
        if p_drop > 0.0:
            if draws is not None and draws.keep is not None:
                keep = draws.keep[rows].to(dev, motion_f.dtype)
            else:
                keep = (~(row_draws.rand((b, 1, 1), gen, dev) < p_drop)).to(motion_f.dtype)
            motion_f, text_f = motion_f * keep, text_f * keep
        s = batch["motion"].shape[1]
        motion_f, text_f = shard.gather(motion_f, s), shard.gather(text_f, s)
        x0 = (batch["mel"][:, lo:hi] - dataset_mean) / dataset_std
        if draws is not None:
            t = draws.t[rows].to(dev)
            noise = draws.noise[rows][:, lo:hi].to(dev)
        else:
            t = row_draws.randint(schedule.timesteps, (b,), gen, dev)
            cut = (gen.cut(1, slice(lo, hi), n) if isinstance(gen, RowShard)
                   else RowShard(gen, slice(lo, hi), n, dim=1))
            noise = row_draws.randn(x0.shape, cut, dev, x0.dtype)
        x_t = q_sample(schedule, x0, t, noise)
        pred = sequence_sharded_forward_train(state.unet, shard, x_t, t, motion_f, text_f, n,
                                              dtype=dt, generator=gen)
        local = ((noise - pred.float()) ** 2).sum() / float(b * n * noise.shape[-1])
        local.backward()
        state.grads[-1:].copy_(local.detach().view(1))
        if everyone is not None:
            distributed.all_reduce(state.grads, everyone)
        state.grads.mul_(1.0 / n_data)
        loss = state.grads[-1].clone()
        scal = opt.stage_scalars(state.opt.step, torch.empty(N_SCALARS, dtype=torch.float32,
                                                             device=dev))
        opt.apply(params, {k: p.grad for k, p in params.items()}, state.ema, state.opt, scal)
        state.step += 1
        state.opt.step += 1
        return loss

    return step


def make_sequence_sharded_sampler(apply_fn, schedule: Schedule, mesh: Mesh,
                                  guidance_weight: float = 1.0, method: str = "ddpm",
                                  **kwargs):
    """A sampler whose (B, T, C) activations are sharded along T over the
    mesh's model axis; ``apply_fn`` is the prepared ``UNet1DUltimate``.
    Returns ``run(generator, shape, motion_f=None, text_f=None,
    x_init=None, noise_seq=None)`` (see the module docstring); ``kwargs``
    go to ``ddim_sample``/``ddpm_sample`` (``num_steps``, ``uncond_fast``,
    ...)."""
    if method not in ("ddpm", "ddim"):
        raise ValueError(f"unknown method {method!r}; use 'ddpm' or 'ddim'")
    shard = SeqShard(mesh)

    @torch.no_grad()
    def run(generator: Optional[torch.Generator], shape, motion_f=None, text_f=None,
            x_init: Optional[torch.Tensor] = None, noise_seq: Optional[torch.Tensor] = None):
        b, n, c = shape
        lo, hi = shard.bounds(n)
        if shard.parts > 1 and hi - lo < 2 ** len(apply_fn.dims):
            raise ValueError(f"sequence parallelism: {n} frames over {shard.parts} shards "
                             f"leave {hi - lo} a shard; the deepest stage needs 2")
        conds = (None, None)
        if motion_f is not None and text_f is not None:
            # each shard's rows of the conditions, all-gathered once a chain
            s = motion_f.shape[1]
            both = shard.gather(torch.cat([shard.rows(motion_f), shard.rows(text_f)], -1), s)
            conds = both.split([motion_f.shape[-1], text_f.shape[-1]], dim=-1)

        def model_fn(x, t, m, l, uncond_rows: int = 0):
            return sequence_sharded_forward(apply_fn, shard, x, t, m, l, n, uncond_rows)

        gen = None if generator is None else RowShard(generator, slice(lo, hi), n, dim=1)
        local = (b, hi - lo, c)
        extra = {}
        if method == "ddim":
            extra.update(num_steps=kwargs.get("num_steps", 50), eta=kwargs.get("eta", 0.0),
                         x0_clip=kwargs.get("x0_clip", 2.0))
        chain = SamplerChain(schedule, local, method, generator=gen, eager=True, **extra)
        xi = None if x_init is None else shard.rows(x_init)
        common = dict(guidance_weight=guidance_weight, x_init=xi, chain=chain,
                      uncond_fast=kwargs.get("uncond_fast", False))
        if method == "ddim":
            x = ddim_sample(model_fn, schedule, local, *conds, **extra, **common)
        else:
            ns = None if noise_seq is None else shard.rows(noise_seq, dim=2)
            x = ddpm_sample(model_fn, schedule, local, *conds, noise_seq=ns, **common)
        return shard.gather(x, n)

    run.mesh = mesh
    run.shard = shard
    return run
