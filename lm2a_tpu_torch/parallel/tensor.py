"""Tensor parallelism: the training state sharded over the mesh's model
axis, and the UNet's compute split over it (port of
``lm2a_tpu/parallel/tensor.py``).

One rule decides the state of both packages: ``_leaf_spec`` is the JAX
package's, read on the JAX names and layouts of the port's leaves
(``jax_leaf``: the ``convert.py`` table, conv kernels ``(K, Cin, Cout)``,
dense ``(in, out)``). Kernels are sharded on their output features
(column-parallel), those of ``conv2`` and ``out_proj`` on their input
features (row-parallel), and 1-D biases and scales on their only axis
where divisible; the rest is replicated. Each rank holds 1/TP of every
eligible parameter, EMA leaf and Adan moment (``prev_grad`` included).

The compute is split where GSPMD splits the JAX package's: each rank runs
its share of every column/row pair, and one all-reduce joins the pair
(Megatron's f and g, ``core.distributed.tp_copy`` and ``tp_reduce``):

- a resblock of ``UNet1DUltimate``: conv 1 on its shard of the output
  channels (FiLM, GroupNorm 2 and their parameters on the same channels),
  conv 2 on its shard of the input channels, its fp32 partial sums
  all-reduced (``conv3_fused``'s partial form in the serving chain and in
  the fused train chain, ``ops.resblock_grad.chain_forward_tp``; the
  library route on the same shards); the 1x1 skip column-parallel, its
  output all-gathered where attention keeps it apart;
- FiLM: ``to_scale_shift`` column-parallel on its 2C outputs, which do not
  line up with conv 1's channels, so its (B, 2C) output is all-gathered and
  each rank takes its channels of the scale and the shift;
- a ``ResBlockV1`` of the v1 UNet: conv 1, ``time_proj`` (its C outputs
  line up with conv 1's: no collective) and GroupNorm 2 on the rank's
  channels, conv 2 (plain PyTorch, as the JAX package runs v1's convs
  through XLA) on its input channels, the fp32 partial sums all-reduced
  and the bias added once;
- an attention branch: ``q/k/v_proj`` column-parallel (a rank's heads),
  the core on the rank's heads, ``out_proj`` row-parallel; both branches'
  partial sums (or, folded for serving, the rank's out·fuse product) in one
  all-reduce; the biases added once after it;
- the UNet's final 1x1 conv (named ``out_proj``, so row-parallel): the
  rank's input channels of ``silu(out_gn(h))``, its partial sum all-reduced.

Those weights are never whole on a rank. The other sharded leaves (GroupNorm
1, ``fuse_proj``, the condition and time projections, the down and
upsampling convs, ``out_gn``, the condition projection) are all-gathered
into a working copy within the step (one flat all-gather) and feed
replicated compute; a block whose width, or an attention site whose heads,
do not divide over the model axis runs replicated on gathered weights, as
GSPMD replicates a leaf that does not divide. ``split_leaves`` lists each
rank's split and gathered leaves. Both architectures run through one walk
(``Denoiser.run``), each block type's split forms from one table
(``_BLOCKS``).

``make_tp_train_step``'s gradients come from the split backward: the split
leaves' gradients are their shards, the gathered leaves' the whole
(every rank computes it), of which a rank keeps its piece. The clip's norm
is the whole gradient's: the sharded leaves' sums of squares all-reduced
over the model axis, each replicated leaf added once. ``make_tp_sampler``
prepares a serving model from the rank's shards once a call and runs the
chain eagerly (gloo's collectives cannot be captured in a CUDA graph);
every rank returns the whole sample.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Set, Tuple

import torch
import torch.nn.functional as F

from lm2a_tpu_torch.convert import UNET_CONV_TRANSPOSE
from lm2a_tpu_torch.core import distributed
from lm2a_tpu_torch.core.draws import RowShard
from lm2a_tpu_torch.core.mesh import DATA_AXIS, MODEL_AXIS, Mesh
from lm2a_tpu_torch.models.attention import CrossAttentionFusion
from lm2a_tpu_torch.models.embedding import dense
from lm2a_tpu_torch.models.unet1d import (
    ResBlockUltimate, ResBlockV1, attend_uncond, conv_cl, conv_train, dropout,
)
from lm2a_tpu_torch.ops.adan import N_SCALARS
from lm2a_tpu_torch.ops.resblock import conv3_fused, gn_stats, gn_stats_plain, gn_sums_plain
from lm2a_tpu_torch.ops.resblock_grad import KERNELS, tp_cols, tp_group_stats
from lm2a_tpu_torch.training.adan import AdanState, STATE_KEYS
from lm2a_tpu_torch.training.train_step import TrainState, data_group, loss_fn

# Modules whose INPUT features arrive sharded from a column-parallel
# producer (the JAX package's rule): conv1 -> FiLM/GN -> conv2, and the
# q/k/v projections -> attention -> out_proj. Their biases stay replicated.
ROW_PARALLEL_MODULES = frozenset({"conv2", "out_proj"})


def _leaf_spec(path: Sequence[str], shape: Sequence[int], tp: int) -> Tuple:
    """The partition of one leaf by its JAX path names and JAX layout shape:
    a tuple naming ``MODEL_AXIS`` at the sharded dimension (None elsewhere),
    or ``()`` for a replicated leaf (the JAX package's ``PartitionSpec``)."""
    name = path[-1] if path else None
    module = path[-2] if len(path) > 1 else None
    if not shape:
        return ()
    row = module in ROW_PARALLEL_MODULES
    if name == "kernel" and len(shape) >= 2:
        if row and shape[-2] % tp == 0:
            return (None,) * (len(shape) - 2) + (MODEL_AXIS, None)
        if not row and shape[-1] % tp == 0:
            return (None,) * (len(shape) - 1) + (MODEL_AXIS,)
        return ()
    if len(shape) == 1 and shape[0] % tp == 0 and name in ("bias", "scale") and not row:
        return (MODEL_AXIS,)
    return ()


def jax_leaf(name: str, shape: Sequence[int]):
    """A port leaf (``"<tree>/<module path>.<weight|bias>"``) as the JAX
    package names and lays it out: ``(path, jax shape, torch dim of each
    jax dim)``."""
    tree, rest = name.split("/", 1)
    module, leaf = rest.rsplit(".", 1) if "." in rest else ("", rest)
    mods = tuple(module.split(".")) if module else ()
    nd = len(shape)
    dims = tuple(range(nd))
    if leaf == "weight" and nd == 2:  # Dense (in, out) <- Linear (out, in)
        leaf, dims = "kernel", (1, 0)
    elif leaf == "weight" and nd == 3 and UNET_CONV_TRANSPOSE(module):
        leaf, dims = "kernel", (2, 0, 1)  # (K, Cin, Cout) <- (Cin, Cout, K)
    elif leaf == "weight" and nd == 3:
        leaf, dims = "kernel", (2, 1, 0)  # (K, Cin, Cout) <- (Cout, Cin, K)
    elif leaf == "weight":
        leaf = "scale"
    return (tree, *mods, leaf), tuple(shape[d] for d in dims), dims


def tp_shardings(tree: Dict[str, torch.Tensor], mesh: Mesh) -> Dict[str, Optional[int]]:
    """The torch dimension each leaf of ``tree`` is sharded on over the
    model axis, None for a replicated leaf."""
    tp = mesh.shape[MODEL_AXIS]
    out = {}
    for name, t in tree.items():
        path, jshape, dims = jax_leaf(name, tuple(t.shape))
        spec = _leaf_spec(path, jshape, tp) if tp > 1 else ()
        out[name] = dims[spec.index(MODEL_AXIS)] if MODEL_AXIS in spec else None
    return out


def state_shardings_tp(state: TrainState, mesh: Mesh) -> Dict[str, Dict[str, Optional[int]]]:
    """The shardings of a TrainState: parameters, EMA and every Adan moment
    by the leaf rule (moments mirror their parameters), the step counters
    replicated."""
    dims = tp_shardings(state.params(), mesh)
    return {"params": dims, "ema": dict(dims), **{k: dict(dims) for k in STATE_KEYS}}


def _piece(t: torch.Tensor, dim: Optional[int], index: int, parts: int) -> torch.Tensor:
    if dim is None:
        return t
    n = t.shape[dim] // parts
    return t.narrow(dim, index * n, n)


# ---------------------------------------------------------------- the split plan

# a split block's leaves (module path inside the block -> the leaf names)
_BLOCK_SPLIT = ("conv1.weight", "conv1.bias", "gn2.weight", "gn2.bias", "conv2.weight",
                "skip.weight", "skip.bias", "film.to_scale_shift.weight",
                "film.to_scale_shift.bias")
_V1_SPLIT = ("conv1.weight", "conv1.bias", "time_proj.weight", "time_proj.bias",
             "norm2.weight", "norm2.bias", "conv2.weight")
_ATTN_SPLIT = tuple(f"{br}.{m}.{leaf}" for br in ("attn_motion", "attn_text")
                    for m in ("q_proj", "k_proj", "v_proj") for leaf in ("weight", "bias")) + (
    "attn_motion.out_proj.weight", "attn_text.out_proj.weight")


def _ultimate_leaves(blk: ResBlockUltimate, parts: int) -> Tuple[str, ...]:
    if blk.out_channels % parts:
        return ()
    return tuple(k for k in _BLOCK_SPLIT if k.split(".")[0] != "skip" or hasattr(blk, "skip"))


def _v1_leaves(blk: ResBlockV1, parts: int) -> Tuple[str, ...]:
    return () if blk.channels % parts else _V1_SPLIT


def split_modules(unet, parts: int) -> Dict[str, Tuple[str, ...]]:
    """The modules of ``unet`` whose compute splits over ``parts`` ranks of
    the model axis, by name, each with its split leaves: every residual
    block whose width divides (``ResBlockUltimate``: conv 1/2, GroupNorm 2,
    the skip, FiLM; ``ResBlockV1``: conv 1/2, ``time_proj``, GroupNorm 2),
    every attention site whose width and heads divide (q/k/v_proj,
    out_proj), and the final ``out_proj`` where its input channels divide.
    None for one rank."""
    if parts == 1:
        return {}
    out = {}
    for name, m in unet.named_modules():
        leaves = _BLOCKS[type(m)].leaves(m, parts) if type(m) in _BLOCKS else ()
        if leaves:
            out[name] = leaves
        elif (isinstance(m, CrossAttentionFusion) and m.mel_dim % parts == 0
              and m.num_heads % parts == 0):
            out[name] = _ATTN_SPLIT
    if unet.out_proj.in_channels % parts == 0:
        out["out_proj"] = ("weight",)
    return out


def split_leaves(unet, dims: Dict[str, Optional[int]], parts: int, prefix: str = "unet/"):
    """``(split, gathered)``: the names (``prefix`` + parameter name) of the
    leaves a rank keeps as its shards through the compute, and of the
    sharded leaves it gathers whole within a step. A split leaf is sharded
    by the rule on the dimension its compute splits (checked)."""
    split = set()
    for mod, leaves in split_modules(unet, parts).items():
        for leaf in leaves:
            name = f"{prefix}{mod}.{leaf}" if mod else f"{prefix}{leaf}"
            if name not in dims:
                raise KeyError(f"tensor parallelism: no leaf {name}")
            row = f"{mod}.{leaf}".split(".")[-2] in ROW_PARALLEL_MODULES
            if dims[name] != (1 if row else 0):
                raise ValueError(f"tensor parallelism: {name} is sharded on {dims[name]}, its "
                                 f"compute splits on {1 if row else 0}")
            split.add(name)
    gathered = {k for k, d in dims.items() if d is not None and k not in split}
    return split, gathered


@dataclass
class ModelShard:
    """This rank's place on the model axis of ``mesh`` and the modules whose
    compute it splits (``split``: module objects' ids)."""

    mesh: Mesh
    split: Set[int] = field(default_factory=set)

    def __post_init__(self):
        self.group = self.mesh.group(MODEL_AXIS)
        self.parts = self.mesh.shape[MODEL_AXIS]
        self.index = self.mesh.axis_index(MODEL_AXIS)

    @classmethod
    def of(cls, mesh: Mesh, unet) -> "ModelShard":
        names = split_modules(unet, mesh.shape[MODEL_AXIS])
        mods = dict(unet.named_modules())
        return cls(mesh, {id(mods[n]) for n in names})

    def is_split(self, module) -> bool:
        return id(module) in self.split

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the model axis, in place (outside autograd)."""
        return distributed.all_reduce(t, self.group)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' ``x`` along the last dimension, outside autograd."""
        return distributed.tp_gather(x, self.group)

    def copy(self, x: torch.Tensor) -> torch.Tensor:  # f
        return distributed.tp_copy(x, self.group)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:  # g
        return distributed.tp_reduce(x, self.group)

    def group_norm(self, gn, x: torch.Tensor) -> torch.Tensor:
        """``GroupNorm.forward`` (plain, differentiable) on this rank's
        channels ``x`` with its shard of the affine: the rank's own groups,
        or where groups straddle ranks every channel's group's statistics
        from sums added over the model axis. Those sums feed every rank's
        own channels, so their gradient is summed over the axis
        (``all_reduce_grad``)."""
        b, t, cs = x.shape
        g = gn.num_groups
        xf = x.float()
        if g % self.parts == 0:
            gl = g // self.parts
            mean, rstd = gn_stats_plain(xf, gl, gn.eps)
            y = (xf.reshape(b, t, gl, cs // gl) - mean[:, None, :, None]) * rstd[:, None, :, None]
        else:
            cg = cs * self.parts // g
            lo, _ = tp_cols(cs * self.parts, self)
            idx = torch.arange(lo, lo + cs, device=x.device) // cg
            s, ss = gn_sums_plain(xf, cs)
            sums = torch.zeros((2, b, g), dtype=torch.float32, device=x.device)
            sums = distributed.all_reduce_grad(sums.index_add(2, idx, torch.stack([s, ss])),
                                               self.group)
            n = float(t * cg)
            mean = sums[0] / n
            rstd = torch.rsqrt(sums[1] / n - mean * mean + gn.eps)
            y = (xf - mean[:, None, idx]) * rstd[:, None, idx]
        return (y.reshape(b, t, cs) * gn.weight.float() + gn.bias.float()).to(x.dtype)


def _film(film, tp: ModelShard, t_emb, dtype, cols):
    """A split block's FiLM: ``to_scale_shift`` on the rank's shard of its
    2C outputs, the (B, 2C) whole all-gathered (its gradient the rank's
    piece), then the rank's ``cols`` of the scale and of the shift (their
    gradients from every rank: f)."""
    lin = film.to_scale_shift
    if dtype is None:
        stats = lin(F.silu(t_emb.to(lin.weight.dtype)))
    else:
        stats = dense(lin, F.silu(t_emb.to(dtype)), dtype)
    scale, shift = tp.copy(distributed.tp_gather(stats, tp.group)).chunk(2, dim=-1)
    lo, hi = cols
    return scale[:, lo:hi], shift[:, lo:hi]


def _join(tp: ModelShard, parts, dtype):
    """g over a list of partial sums: one all-reduce of them all (fp32),
    each back in ``dtype``."""
    if len(parts) == 1:
        return [tp.reduce(parts[0].float()).to(dtype)]
    flat = tp.reduce(torch.cat([p.float().reshape(-1) for p in parts]))
    return [v.view(p.shape).to(dtype) for v, p in zip(flat.split([p.numel() for p in parts]),
                                                      parts)]


def _folded(attn: CrossAttentionFusion, dtype) -> bool:
    return dtype is None and attn.folded is not None and not attn.fused


def _attention_partial(attn: CrossAttentionFusion, tp: ModelShard, h, motion_f, text_f,
                       dtype):
    """A split site's partial sum: the folded form's (B, T, C) out·fuse
    product of the rank's heads (serving), or both branches' (B, T, 2C)
    ``out_proj`` products of the rank's heads, no bias."""
    if _folded(attn, dtype):
        return attn._forward_folded(h, motion_f, text_f, partial=True)
    dt = dtype or attn.motion_kv_proj.weight.dtype

    def proj(lin, x):
        return lin(x.to(lin.weight.dtype)) if dtype is None else dense(lin, x, dtype)

    kv_m, kv_t = proj(attn.motion_kv_proj, motion_f), proj(attn.text_kv_proj, text_f)
    t, s = h.shape[1], kv_m.shape[1]
    q, kv_m, kv_t = tp.copy(torch.cat([h.to(dt), kv_m, kv_t], 1)).split([t, s, s], 1)
    out = []
    for mha, kv in ((attn.attn_motion, kv_m), (attn.attn_text, kv_t)):
        core = mha.core(proj(mha.q_proj, q), proj(mha.k_proj, kv), proj(mha.v_proj, kv))
        out.append(F.linear(core, mha.out_proj.weight.to(dt)))
    return torch.cat(out, -1)


def _attention_join(attn: CrossAttentionFusion, joined, dtype):
    """The site's output from its joined partial sums: the folded bias, or
    ``out_proj``'s biases and ``fuse_proj``."""
    if _folded(attn, dtype):
        return (joined.float() + attn.folded["b_out"].float()).to(joined.dtype)
    e = attn.mel_dim
    am = joined[..., :e] + attn.attn_motion.out_proj.bias.to(joined.dtype)
    at = joined[..., e:] + attn.attn_text.out_proj.bias.to(joined.dtype)
    both = torch.cat([am, at], -1)
    if dtype is None:
        return attn.fuse_proj(both.to(attn.fuse_proj.weight.dtype))
    return dense(attn.fuse_proj, both, dtype)


def attend(attn: CrossAttentionFusion, tp: ModelShard, h, motion_f, text_f, dtype=None,
           uncond_rows: int = 0):
    """``CrossAttentionFusion.forward`` (``dtype``: the training form) with
    ``uncond_rows`` as ``attend_uncond``: split over the model axis where the
    site is, one all-reduce of its partial sums; replicated elsewhere."""
    if not tp.is_split(attn):
        if dtype is not None:
            return attn(h, motion_f, text_f, dtype=dtype)
        return attend_uncond(attn, h, motion_f, text_f, uncond_rows)
    dt = dtype or h.dtype
    if not uncond_rows:
        joined, = _join(tp, [_attention_partial(attn, tp, h, motion_f, text_f, dtype)], dt)
        return _attention_join(attn, joined, dtype)
    bu, t, c = uncond_rows, h.shape[1], h.shape[2]
    const = _attention_partial(attn, tp, h.new_zeros((1, 1, c)),
                               motion_f.new_zeros((1, 1, motion_f.shape[-1])),
                               text_f.new_zeros((1, 1, text_f.shape[-1])), dtype)
    cond = _attention_partial(attn, tp, h[bu:], motion_f[bu:], text_f[bu:], dtype)
    const, cond = (_attention_join(attn, j, dtype) for j in _join(tp, [const, cond], dt))
    return torch.cat([const.expand(bu, t, c), cond], dim=0)


def _out_proj(conv, tp: ModelShard, a, dtype=None):
    """The final 1x1 conv ``conv`` (the UNet's ``out_proj``), row-parallel
    where split: the rank's input channels of ``a`` (their gradient from
    every rank: f), the partial sum all-reduced, the bias added once."""
    if not tp.is_split(conv):
        return conv_cl(conv, a) if dtype is None else conv_train(conv, a, dtype)
    lo, hi = tp_cols(a.shape[-1], tp)
    dt = dtype or conv.weight.dtype
    part = F.linear(tp.copy(a)[..., lo:hi].to(dt), conv.weight[:, :, 0].to(dt))
    joined, = _join(tp, [part], torch.float32)
    return (joined + conv.bias.float()).to(dt)


def _block(blk, tp: ModelShard, x, t_emb, motion_f, text_f, uncond_rows: int):
    """``ResBlockUltimate.forward`` (the prepared serving chain) split over
    the model axis: conv 1 on the rank's ``conv1`` shard, conv 2 through
    ``conv3_fused``'s partial form, one all-reduce of the block output
    (or of ``h``, the skip's columns all-gathered, before attention)."""
    if not tp.is_split(blk):
        return blk(x, t_emb, motion_f, text_f, uncond_rows)
    p = blk.chain
    cdt = p.conv1_w.dtype
    cols = tp_cols(blk.out_channels, tp)
    scale, shift = _film(blk.film, tp, t_emb, None, cols)
    x = x.to(cdt).contiguous()
    film = (scale.float().contiguous(), shift.float().contiguous())
    mean1, rstd1 = gn_stats(x, p.groups1)
    f = conv3_fused(x, mean1, rstd1, p.gn1_scale, p.gn1_bias, p.conv1_w, p.conv1_b, film=film,
                    out_dtype=torch.float32)

    mean2, rstd2 = tp_group_stats(KERNELS, tp, f, p.groups2)
    kw = dict(out_dtype=torch.float32, part=cols)
    if p.skip_w is not None:
        kw.update(skip=(x, p.skip_w, p.skip_b), split_skip=blk.use_attn)
    elif not blk.use_attn:
        kw.update(residual=x)
    out = conv3_fused(f, mean2, rstd2, p.gn2_scale, p.gn2_bias, p.conv2_w, p.conv2_b, **kw)
    if not blk.use_attn:
        return tp.all_reduce(out).to(cdt)
    h, xs = out if p.skip_w is not None else (out, None)
    h = tp.all_reduce(h).to(cdt)
    xs = tp.gather(xs) if xs is not None else x
    if motion_f is not None and text_f is not None:
        h = attend(blk.cross_attn, tp, h, motion_f, text_f, uncond_rows=uncond_rows)
    return xs + h


def _conv2_part(conv2, tp: ModelShard, a, dtype):
    """A split block's row-parallel conv 2 on the rank's input channels of
    ``a`` (plain PyTorch): the fp32 partial sums all-reduced (g), the bias
    added once, in ``dtype``."""
    w = conv2.weight.to(dtype)
    part = F.conv1d(a.to(dtype).transpose(1, 2), w, padding=1).transpose(1, 2)
    joined, = _join(tp, [part], torch.float32)
    return (joined + conv2.bias.to(dtype).float()).to(dtype)


def _block_v1(blk, tp: ModelShard, x, t_emb, motion_f, text_f, uncond_rows: int):
    """``ResBlockV1.forward`` (the prepared serving form) split over the
    model axis: conv 1 and ``time_proj`` on the rank's shards of the same
    channels, GroupNorm 2 on them, conv 2 row-parallel, then the site
    (``attend``: split where it is)."""
    if not tp.is_split(blk):
        return blk(x, t_emb, motion_f, text_f, uncond_rows)
    h = conv_cl(blk.conv1, F.silu(blk.norm1(x)))
    h = h + blk.time_proj(t_emb.to(blk.time_proj.weight.dtype))[:, None, :]
    h = _conv2_part(blk.conv2, tp, F.silu(tp.group_norm(blk.norm2, h)), blk.conv2.weight.dtype)
    return x + attend(blk.cross_attn, tp, h, motion_f, text_f, uncond_rows=uncond_rows)


def _block_v1_train(blk, tp: ModelShard, x, t_emb, t_split, motion_f, text_f, dtype,
                    generator, fused: bool):
    """``ResBlockV1.forward_train`` split over the model axis: conv 1's input
    through f, ``time_proj`` reading the time embedding through the
    forward's one f (``t_split``), conv 2's partial sum through g."""
    if not tp.is_split(blk):
        return blk.forward_train(x, t_emb, motion_f, text_f, dtype, generator, fused)
    h = conv_train(blk.conv1, tp.copy(F.silu(blk.norm1(x))), dtype)
    h = h + dense(blk.time_proj, t_split, dtype)[:, None, :]
    h = _conv2_part(blk.conv2, tp, F.silu(tp.group_norm(blk.norm2, h)), dtype)
    return x.to(dtype) + attend(blk.cross_attn, tp, h, motion_f, text_f, dtype)


def _block_train(blk, tp: ModelShard, x, t_emb, t_split, motion_f, text_f, dtype, generator,
                 fused: bool):
    """``ResBlockUltimate.forward_train`` split over the model axis: the
    fused train chain on the shards (``chain_forward_tp``) where ``fused``
    and the gate pass, else the library route on them (conv 1's and the
    skip's input through f, conv 2's partial sum through g)."""
    if not tp.is_split(blk):
        return blk.forward_train(x, t_emb, motion_f, text_f, dtype, generator, fused)
    cols = tp_cols(blk.out_channels, tp)
    scale, shift = _film(blk.film, tp, t_split, dtype, cols)
    skip = getattr(blk, "skip", None)
    res = blk.fused_train(x, scale, shift, dtype, tp=tp) if fused else None
    if res is not None:
        h, xs = res
    else:
        h = conv_train(blk.conv1, tp.copy(F.silu(blk.gn1(x))), dtype)
        h = h * (1.0 + scale[:, None, :]) + shift[:, None, :]
        h = _conv2_part(blk.conv2, tp, F.silu(tp.group_norm(blk.gn2, h)), dtype)
        xs = (distributed.tp_gather(conv_train(skip, tp.copy(x), dtype), tp.group)
              if skip is not None else x)
    h = dropout(h, blk.dropout, generator)
    if blk.use_attn and motion_f is not None and text_f is not None:
        h = attend(blk.cross_attn, tp, h, motion_f, text_f, dtype)
    return xs + h


class _SplitForms(NamedTuple):
    """A block type's split leaves (none where its width does not divide)
    and its serving and training forms split over the model axis."""

    leaves: Callable
    serve: Callable
    train: Callable


_BLOCKS = {ResBlockUltimate: _SplitForms(_ultimate_leaves, _block, _block_train),
           ResBlockV1: _SplitForms(_v1_leaves, _block_v1, _block_v1_train)}


def tensor_sharded_forward(unet, tp: ModelShard, x, t, motion_f=None, text_f=None,
                           uncond_rows: int = 0) -> torch.Tensor:
    """``Denoiser.forward`` (the prepared serving form, its parameters this
    rank's: ``make_tp_sampler``) with its compute split over the model
    axis. Every rank returns the whole fp32 output."""
    t_emb = unet.time_embedding(t)

    def block(blk, h):
        return _BLOCKS[type(blk)].serve(blk, tp, h, t_emb, motion_f, text_f, uncond_rows)

    return unet.run(x, block, conv_cl, lambda conv, a: _out_proj(conv, tp, a)).float()


def tensor_sharded_forward_train(unet, tp: ModelShard, x, t, motion_f=None, text_f=None, *,
                                 dtype: torch.dtype,
                                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """``Denoiser.forward_train`` with its compute split over the model axis
    (the split leaves are this rank's shards, the gathered leaves whole),
    differentiable through the collectives; every rank computes the same
    fp32 output. The split blocks read the time embedding through one f."""
    t_emb = unet.time_embedding.forward_train(t, dtype)
    t_split = tp.copy(t_emb)

    def block(blk, h):
        return _BLOCKS[type(blk)].train(blk, tp, h, t_emb, t_split, motion_f, text_f, dtype,
                                        generator, unet.fused_resblock_grad)

    def conv(module, h):
        return conv_train(module, h, dtype)

    return unet.run(x, block, conv, lambda m, a: _out_proj(m, tp, a, dtype)).float()


# ---------------------------------------------------------------- the state


@dataclass
class TPState:
    """A TrainState whose ``ema`` and ``opt`` hold this rank's shards, with
    ``params`` the parameter shards and ``dims`` each leaf's sharded
    dimension. The modules' split parameters are their shards (``split``),
    the gathered ones a working copy a step gathers (empty between steps);
    ``tp`` the model axis and the split modules."""

    state: TrainState
    params: Dict[str, torch.Tensor]
    dims: Dict[str, Optional[int]]
    mesh: Mesh
    grads: Dict[str, torch.Tensor]  # this rank's shards of the step's gradient
    split: Set[str] = field(default_factory=set)
    gathered: Set[str] = field(default_factory=set)
    tp: Optional[ModelShard] = None
    views: Dict[str, torch.Tensor] = field(default_factory=dict)  # the backward's gradients

    @property
    def index(self) -> int:
        return self.mesh.axis_index(MODEL_AXIS)

    @property
    def parts(self) -> int:
        return self.mesh.shape[MODEL_AXIS]

    def state_bytes(self) -> int:
        """Bytes this rank holds of parameters, EMA and Adan state."""
        trees = [self.params, self.state.ema] + [getattr(self.state.opt, k) for k in STATE_KEYS]
        return sum(t.numel() * t.element_size() for tree in trees for t in tree.values())


def shard_state_tp(state: TrainState, mesh: Mesh):
    """``state`` sharded by the TP rule: this rank keeps its shard of every
    parameter, EMA leaf and Adan moment (copies; the full EMA and moments
    are dropped). The split parameters become their shards, the gathered
    ones are freed until a step gathers them, and the flat gradient buffer
    is made anew at the sizes the step's backward gives (shards for the
    split leaves, whole for the others). Returns ``(TPState, shardings)``.
    The input state is consumed."""
    shardings = state_shardings_tp(state, mesh)
    dims = shardings["params"]
    r, tp = mesh.axis_index(MODEL_AXIS), mesh.shape[MODEL_AXIS]

    def shard(tree):
        return {k: _piece(t, dims[k], r, tp).contiguous().clone() if dims[k] is not None else t
                for k, t in tree.items()}

    named = state.params()
    params = {k: _piece(p.detach(), dims[k], r, tp).contiguous().clone()
              if dims[k] is not None else p.detach() for k, p in named.items()}
    state.ema = shard(state.ema)
    o = state.opt
    state.opt = AdanState(o.step, *(shard(getattr(o, k)) for k in STATE_KEYS), chained=o.chained)
    split, gathered = split_leaves(state.unet, dims, tp)
    for k, p in named.items():  # the split leaves' compute reads their shards
        p.grad = None
        if k in split:
            p.data = params[k]
    sizes = [p.numel() for p in named.values()]
    state.grads = torch.zeros(sum(sizes) + 1, dtype=torch.float32, device=state.grads.device)
    views = dict(zip(named, state.grads.split(sizes + [1])))
    grads = {}
    for k, p in named.items():
        if k in gathered:
            grads[k] = torch.zeros_like(params[k])
        else:
            p.grad = views[k].view_as(p)
            grads[k] = p.grad
    tps = TPState(state, params, dims, mesh, grads, split, gathered,
                  ModelShard.of(mesh, state.unet), views)
    release_params(tps)
    return tps, shardings


def gather_whole(shards: Dict[str, torch.Tensor], dims: Dict[str, Optional[int]],
                 mesh: Mesh) -> Dict[str, torch.Tensor]:
    """Every sharded leaf of ``shards`` whole again: one flat all-gather of
    this rank's shards over the model axis, each leaf's pieces put back
    along its dimension (ranks in axis order). Every rank passes its leaves
    in the same order."""
    sharded = [k for k in shards if dims[k] is not None]
    if not sharded:
        return {}
    parts = mesh.shape[MODEL_AXIS]
    flat = torch.cat([shards[k].reshape(-1) for k in sharded])
    full = distributed.all_gather(flat[None, :], mesh.group(MODEL_AXIS)).view(parts, -1)
    out, off = {}, 0
    for k in sharded:
        s = shards[k]
        pieces = full[:, off:off + s.numel()].reshape((parts,) + tuple(s.shape))
        out[k] = torch.cat(list(pieces.unbind(0)), dim=dims[k])
        off += s.numel()
    return out


def gather_params(tps: TPState) -> None:
    """The working copy of the gathered leaves: their shards all-gathered
    over the model axis into the modules' parameters, each with its whole
    gradient buffer (the split leaves stay their shards)."""
    named = tps.state.params()
    for k, whole in gather_whole({k: v for k, v in tps.params.items() if k in tps.gathered},
                                 tps.dims, tps.mesh).items():
        named[k].data = whole
        named[k].grad = tps.views[k].view_as(whole)


def release_params(tps: TPState) -> None:
    """Free the gathered leaves' working copy."""
    for k, p in tps.state.params().items():
        if k in tps.gathered:
            p.grad = None
            p.data = p.data.new_empty(0)


def _tp_norm(tps: TPState, group):
    """The clip's norm of the whole gradient from this rank's shards: the
    sharded leaves' sums of squares added over the model axis, each
    replicated leaf once."""

    def sq(ts):
        return (torch.stack(torch._foreach_norm(ts)).square().sum() if ts
                else torch.zeros((), device=tps.state.grads.device))

    sharded = sq([g for k, g in tps.grads.items() if tps.dims[k] is not None])
    whole = distributed.all_reduce(sharded.view(1), group)[0]
    return torch.sqrt(whole + sq([g for k, g in tps.grads.items() if tps.dims[k] is None]))


def make_tp_train_step(schedule, cfg, optimizer, mesh: Mesh, state_template: TrainState,
                       dataset_mean: float = 0.0, dataset_std: float = 1.0):
    """Data-parallel batch and tensor-parallel state and compute in one step.
    Returns ``(train_step, state_shardings)``: ``train_step(tps, batch,
    generator=None, draws=None) -> loss`` over this rank's rows of the global
    batch (ranks of a model line take the same rows and the same draws),
    ``tps`` from ``shard_state_tp``; ``train_step.norm`` is the last step's
    clip norm. See the module docstring."""
    shardings = state_shardings_tp(state_template, mesh)
    group = data_group(mesh)
    opt = copy.copy(optimizer)

    def train_step(tps: TPState, batch, generator=None, draws=None) -> torch.Tensor:
        st = tps.state
        gather_params(tps)
        params = st.params()
        torch._foreach_zero_([p.grad for p in params.values()])

        def norm(_shards):
            train_step.norm = _tp_norm(tps, tps.tp.group)
            return train_step.norm

        opt.norm_fn = norm
        if group is not None and isinstance(generator, torch.Generator):
            b = batch["mel"].shape[0]
            n = b * mesh.shape[DATA_AXIS]
            generator = RowShard(generator, distributed.local_batch_slice(mesh, n), n)
        forward = None
        if tps.split:
            def forward(x, t, m, l, *, dtype, generator):
                return tensor_sharded_forward_train(st.unet, tps.tp, x, t, m, l, dtype=dtype,
                                                    generator=generator)
        loss = loss_fn(st, schedule, batch, cfg, dataset_mean=dataset_mean,
                       dataset_std=dataset_std, train=True, generator=generator, draws=draws,
                       forward=forward)
        loss.backward()
        if group is not None:
            st.grads[-1:].copy_(loss.detach().float().view(1))
            distributed.all_reduce(st.grads, group, mean=True)
            loss = st.grads[-1].clone()
        with torch.no_grad():
            for k in tps.gathered:
                tps.grads[k].copy_(_piece(params[k].grad, tps.dims[k], tps.index, tps.parts))
        scal = opt.stage_scalars(st.opt.step, torch.empty(N_SCALARS, dtype=torch.float32,
                                                          device=loss.device))
        opt.apply(tps.params, tps.grads, st.ema, st.opt, scal)
        release_params(tps)
        st.step += 1
        st.opt.step += 1
        return loss.detach()

    train_step.norm = None
    return train_step, shardings


def make_tp_sampler(apply_fn, schedule, mesh: Mesh, params_template: Dict[str, torch.Tensor],
                    guidance_weight: float = 1.0, method: str = "ddpm", **kwargs):
    """A sampling chain of a denoiser whose parameters stay sharded over the
    model axis. ``apply_fn`` is an fp32 denoiser (its architecture is the
    template, its weights unused); ``params_template`` its named parameters.
    Returns ``run(params, generator, shape, motion_f=None, text_f=None,
    x_init=None, noise_seq=None)`` with ``params`` this rank's shards (e.g.
    the ``"unet/..."`` leaves of a TPState's EMA, prefix dropped): the
    gathered leaves all-gathered and a serving model prepared from the
    rank's leaves once a call, then the chain, eager, its forwards split
    over the model axis (``tensor_sharded_forward``). ``kwargs`` go to the
    sampler (``num_steps``, ``uncond_fast``, ``eta``, ``x0_clip``) but
    ``dtype``, the serving dtype."""
    from lm2a_tpu_torch.diffusion.gaussian import SamplerChain, ddim_sample, ddpm_sample

    if method not in ("ddpm", "ddim"):
        raise ValueError(f"unknown method {method!r}; use 'ddpm' or 'ddim'")
    sample = {"ddpm": ddpm_sample, "ddim": ddim_sample}[method]
    dims = tp_shardings({f"unet/{k}": v for k, v in params_template.items()}, mesh)
    dims = {k.split("/", 1)[1]: d for k, d in dims.items()}
    split, gathered = split_leaves(apply_fn, dims, mesh.shape[MODEL_AXIS], prefix="")
    kwargs = dict(kwargs)
    dtype = kwargs.pop("dtype", torch.bfloat16)
    # the rank's fp32 leaves (shards where split) and the serving model made from them
    holder = copy.deepcopy(apply_fn)
    r, parts = mesh.axis_index(MODEL_AXIS), mesh.shape[MODEL_AXIS]
    for k, p in holder.named_parameters():
        p.data = (torch.zeros_like(_piece(p.data, dims[k], r, parts)) if k in split
                  else torch.zeros_like(p.data))
    serving = copy.deepcopy(holder).prepare(dtype)
    tp = ModelShard.of(mesh, serving)
    extra = {k: kwargs.pop(k) for k in ("num_steps", "eta", "x0_clip") if k in kwargs}
    if method == "ddim":
        extra.setdefault("num_steps", 50)

    @torch.no_grad()
    def run(params: Dict[str, torch.Tensor], generator, shape, motion_f=None, text_f=None,
            **kw):
        whole = gather_whole({k: params[k] for k in dims if k in gathered}, dims, mesh)
        for k, p in holder.named_parameters():
            p.copy_(whole.get(k, params[k]))
        serving.refresh(holder)

        def model_fn(x, t, m, l, uncond_rows: int = 0):
            if tp.split:
                return tensor_sharded_forward(serving, tp, x, t, m, l, uncond_rows)
            return serving(x, t, m, l, uncond_rows)

        chain = SamplerChain(schedule, shape, method, generator=generator, eager=True, **extra)
        return sample(model_fn, schedule, shape, motion_f, text_f,
                      guidance_weight=guidance_weight, generator=generator, chain=chain,
                      **extra, **kwargs, **kw)

    run.shardings = dims
    run.split, run.gathered = split, gathered
    run.serving, run.tp = serving, tp  # the prepared model a call refreshes, its model axis
    return run
