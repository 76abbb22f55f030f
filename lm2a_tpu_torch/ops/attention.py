"""Fused attention core: the CUDA kernel's wrapper and plain version.

``softmax(q k^T / sqrt(hd)) v`` over ``(B, H, T, hd)`` queries and
``(B, H, S, hd)`` keys and values, the port of ``attention_core`` in
``lm2a_tpu/ops/pallas_attention.py``. The JAX package has two TPU kernels
for it, ``_attention_kernel`` (S <= ``STREAMING_S_THRESHOLD``, all of S in
one block) and ``_flash_kernel`` (online softmax over S tiles); one CUDA
kernel (``csrc/attention.cu``) covers both.

Numerics, kept by the kernel and ``attention_core_plain`` alike: scores in
fp32 divided by sqrt(hd) in fp32, ``p = exp(s - max)`` in fp32 and rounded to
the input dtype for the P.V product, the denominator summed over the
unrounded ``p``, the output divided once and rounded to the input dtype.
``_attention_kernel`` normalises before rounding ``p``; the two differ by
about one bf16 ulp of ``p``.

``attention_core`` launches the kernel for CUDA tensors (bf16, any head dim
from 1 to ``MAX_HEAD_DIM``) with the launch plan of ``attention_plan`` (the
head's tile channels, keys per tile, ring stages, the split of the key
tiles over a thread-block cluster) and
runs the plain version for CPU tensors. Its backward
recomputes through the plain version, as the JAX custom VJP recomputes
through ``attention_core_reference``. The inputs may be strided views: the
kernel reads them through their strides, and the output comes back as a
``(B, H, T, hd)`` view of a ``(B, T, H, hd)`` tensor, so a caller holding
channels-last projections needs no transposes.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
import torch

from lm2a_tpu_torch.ops import _build
from lm2a_tpu_torch.ops.resblock import SMEM_MAX, SPLIT_MAX, WAVE_BLOCKS

# The JAX package's switch from _attention_kernel to _flash_kernel (S above
# it streams). One CUDA kernel covers both; chip_smoke.py uses it to say
# which TPU kernel a geometry replaces.
STREAMING_S_THRESHOLD = 1024
# Long-form generation takes the fused route above this many mel frames,
# as the JAX package does (its break-even on the TPU, kept for parity).
FUSED_ATTENTION_MIN_T = 12288
# every head dim from 1 to MAX_HEAD_DIM: a head is read into Q and K tiles of
# `head_tile(hd, h)` channels (TILE_CHANNELS), V and O in parts of at most
# 128 channels. A head dim off the 8-channel unit (a row offset h*hd*2 bytes
# off the tensor maps' 16-byte unit) is read through windows over each
# row's H*hd channels: its heads must lie side by side (head stride hd).
MAX_HEAD_DIM = 256
TILE_CHANNELS = (16, 32, 64, 128, 192, 256)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_build.declare("attention", "lm2a_attention",
               [_P] * 4 + [_I] * 5 + [_L] * 12 + [_I] * 5 + [_P])

# csrc/attention.cu: 128 query rows per block (two consumer warpgroups of
# 64 and a producer warpgroup), key tiles of BN keys in a ring of 3 to
# MAX_STAGES stages, one block per SM (setmaxnreg gives the consumers 232
# registers a thread), a split over at most MAX_SPLIT blocks of a cluster.
# The ring takes as many stages as fit, up to the number of key tiles (at
# least 3).
BM, MAX_STAGES, MIN_STAGES, MAX_SPLIT = 128, 8, 3, 8
KEY_TILES = (64, 128)  # keys per tile; above 128 tile channels only 64 (registers)
_ALIGN = 1024  # slack for aligning the swizzled tiles to 1024 bytes

# The plan picks the candidate of least modeled time: a block costs
# BLOCK_US[hdq] plus TILE_US[(hdq, bn)] per key tile it runs, plus, when the
# key tiles are split over a cluster, COMBINE_US + COMBINE_US_PER_HD * hdq
# (the ranks' fp32 O through distributed shared memory); a grid runs in
# waves of WAVE_BLOCKS[split] blocks (ops/resblock.py: one block per SM;
# clusters fit in one GPC). hdq is the head's tile channels. The constants
# were fitted to the device times of scripts/torch_attention_plan_sweep.py on
# an H100 (PERF.md) at the flagship's 32, 64 and 128 (16 takes 32's), and
# 192 and 256 (two blocks a head, each with a 128-channel part of V) to the
# least-squares fit of its ``--set wide`` run.
BLOCK_US = {16: 3.8, 32: 3.8, 64: 3.9, 128: 6.0, 192: 4.05, 256: 4.24}
COMBINE_US, COMBINE_US_PER_HD = 0.6, 0.025
TILE_US = {(16, 64): 0.69, (16, 128): 1.06, (32, 64): 0.69, (32, 128): 1.06,
           (64, 64): 0.8, (64, 128): 1.23, (128, 64): 0.99, (128, 128): 1.51,
           (192, 64): 1.29, (256, 64): 1.47}


def head_tile(hd: int, h: int):
    """(tile channels, window) of head dim ``hd`` with ``h`` heads: a head
    dim off the 8-channel unit is read through windows that start at the
    8-channel unit holding the head's first channel, (h*hd) % 8 channels
    before it; the tile rounds hd plus the largest such offset up to 16, 32,
    64 or a multiple of 64 (the csrc's ``tile_channels``)."""
    window = hd % 8 != 0
    need = hd + (max((i * hd) % 8 for i in range(min(h, 8))) if window else 0)
    hdq = 16 if need <= 16 else 32 if need <= 32 else -(-need // 64) * 64
    return hdq, window


@dataclass(frozen=True)
class AttentionPlan:
    """Launch of one ``attention_core``: Q and K tiles of ``hdq`` channels,
    V and O in ``vparts`` parts (a block each), ``BM`` query rows per block,
    key tiles of ``bn`` keys (``tiles`` of them), a ring of ``stages`` K/V
    stages, the key tiles split over ``split`` blocks of a thread-block
    cluster (combined in rank order); grid ``(split * mtiles, H * vparts,
    B)``; ``smem`` dynamic shared bytes."""

    hdq: int
    vparts: int
    bn: int
    stages: int
    split: int
    mtiles: int
    tiles: int
    smem: int

    @property
    def rows(self) -> int:
        return BM

    def blocks(self, b: int, h: int) -> int:
        return self.split * self.mtiles * h * self.vparts * b


def v_channels(hdq: int) -> int:
    """Channels of a V tile row and of a block's O: at most 128."""
    return min(hdq, 128)


def attention_smem(hdq: int, bn: int, stages: int) -> int:
    """Dynamic shared bytes: the Q tile, the K/V ring and (reusing the
    ring) the split's fp32 combine buffer of (m, l, O) per row."""
    hdv = v_channels(hdq)
    ring = stages * bn * (hdq + hdv) * 2
    # the split's combine: O, m and l of each rank's part of this block's
    # rows, then each row's weights over the ranks and their sum
    rows = BM + MAX_SPLIT
    combine = rows * (hdv + 4) * 4 + 2 * rows * 4 + (BM // 2) * (MAX_SPLIT + 1) * 4
    return _ALIGN + BM * hdq * 2 + max(ring, combine)


def attention_candidates(b: int, h: int, t: int, s: int, hd: int):
    """Every launch of the kernel for this call that fits the card, as
    (modeled microseconds, AttentionPlan), in a fixed order."""
    hdq, _ = head_tile(hd, h)
    vparts = -(-hdq // v_channels(hdq))
    mtiles = -(-t // BM)
    out = []
    for bn in KEY_TILES:
        if hdq > 128 and bn > 64:
            continue
        tiles = -(-s // bn)
        stages = MIN_STAGES
        while (stages < min(MAX_STAGES, max(tiles, MIN_STAGES))
               and attention_smem(hdq, bn, stages + 1) <= SMEM_MAX):
            stages += 1
        smem = attention_smem(hdq, bn, stages)
        if smem > SMEM_MAX:
            continue
        for split in range(1, min(SPLIT_MAX, tiles) + 1):
            plan = AttentionPlan(hdq, vparts, bn, stages, split, mtiles, tiles, smem)
            per_block = BLOCK_US[hdq] + -(-tiles // split) * TILE_US[(hdq, bn)]
            if split > 1:
                per_block += COMBINE_US + COMBINE_US_PER_HD * v_channels(hdq)
            waves = -(-plan.blocks(b, h) // WAVE_BLOCKS[split])
            out.append((waves * per_block, plan))
    return out


@functools.lru_cache(maxsize=None)
def attention_plan(b: int, h: int, t: int, s: int, hd: int) -> AttentionPlan:
    """Key tile, ring stages, split and shared memory of the attention
    kernel (pure; the wrapper passes it to the kernel): the candidate of
    least modeled time, the first of equals."""
    return min(attention_candidates(b, h, t, s, hd), key=lambda c: c[0])[1]


def attention_core_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch, on any device; (B, H, T, hd) out."""
    hd = q.shape[-1]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    # in place: at long form the (B, H, T, S) fp32 scores are gigabytes. The
    # max is a constant shift (softmax does not depend on it), so it is
    # detached and the gradient stays exact.
    s.div_(torch.full((), float(hd), dtype=torch.float32, device=q.device).sqrt())
    s.sub_(s.detach().amax(dim=-1, keepdim=True)).exp_()
    denom = s.sum(dim=-1, keepdim=True)
    out = torch.matmul(s.to(v.dtype).float(), v.float()) / denom
    return out.to(q.dtype)


def _check(q, k, v):
    b, h, t, hd = q.shape
    s = k.shape[2]

    def need(cond, msg):
        if not cond:
            raise ValueError(f"attention_core: {msg}")

    need(q.dtype == k.dtype == v.dtype == torch.bfloat16,
         f"the CUDA kernel takes bf16 q, k, v, got {q.dtype}, {k.dtype}, {v.dtype}")
    need(1 <= hd <= MAX_HEAD_DIM, f"head dim {hd} outside 1..{MAX_HEAD_DIM}")
    need(tuple(k.shape) == tuple(v.shape) == (b, h, s, hd),
         f"k, v must be (B, H, S, hd) = ({b}, {h}, S, {hd}), got {tuple(k.shape)}, "
         f"{tuple(v.shape)}")
    need(t >= 1 and s >= 1, f"empty T or S ({t}, {s})")
    need(head_tile(hd, h)[0] in TILE_CHANNELS,
         f"head dim {hd} at its window offset needs more than {MAX_HEAD_DIM} tile channels")
    for x, name in ((q, "q"), (k, "k"), (v, "v")):
        st = x.stride()
        need(x.device == q.device, f"{name} on {x.device}, q on {q.device}")
        if hd % 8:  # windows over each row's channels: the heads side by side
            need(st[3] == 1 and st[1] == hd and st[0] % 8 == st[2] % 8 == x.data_ptr() % 16 == 0,
                 f"{name} at head dim {hd} needs its heads side by side (head stride {hd}) "
                 f"and 16-byte aligned rows, strides {st}, H {h}")
        else:
            need(st[3] == 1 and st[0] % 8 == st[1] % 8 == st[2] % 8 == x.data_ptr() % 16 == 0,
                 f"{name} needs hd contiguous and 16-byte aligned rows, strides {st}")


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    if q.device.type == "cpu":
        return attention_core_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"attention_core: unsupported device {q.device}")
    _check(q, k, v)
    b, h, t, hd = q.shape
    s = k.shape[2]
    plan = attention_plan(b, h, t, s, hd)
    out = torch.empty((b, t, h, hd), device=q.device, dtype=q.dtype).transpose(1, 2)
    _build.launch("attention", "lm2a_attention", "attention",
                  _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
                  b, h, t, s, hd, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                  *out.stride()[:3], plan.hdq, plan.bn, plan.stages, plan.split, plan.smem,
                  _build.stream_ptr(q.device))
    return out


class _AttentionCore(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return _forward(q, k, v)

    @staticmethod
    def backward(ctx, grad):
        with torch.enable_grad():
            inputs = [x.detach().requires_grad_() for x in ctx.saved_tensors]
            out = attention_core_plain(*inputs)
        return torch.autograd.grad(out, inputs, grad)


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Fused attention over (B, H, T, hd) q and (B, H, S, hd) k, v."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _AttentionCore.apply(q, k, v)
    return _forward(q, k, v)  # serving: no autograd node to build
