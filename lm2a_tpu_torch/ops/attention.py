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

``attention_core`` launches the kernel for CUDA tensors (bf16, hd in
``HEAD_DIMS``) with the launch plan of ``attention_plan`` (keys per tile,
ring stages, the split of the key tiles over a thread-block cluster) and
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
# head dims 2 and 4 (C/8 at the narrow base-16 and base-32 models' C = 16 and
# 32) are read through virtual heads of 8 channels: the heads must lie side
# by side (head stride hd, a channels-last projection's view), H*hd a
# multiple of 8
HEAD_DIMS = (2, 4, 8, 16, 32, 64, 128)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_build.declare("attention", "lm2a_attention",
               [_P] * 4 + [_I] * 5 + [_L] * 12 + [_I] * 4 + [_P])

# csrc/attention.cu: 128 query rows per block (two consumer warpgroups of
# 64 and a producer warpgroup), key tiles of BN keys in a ring of 3 to
# MAX_STAGES stages, one block per SM (setmaxnreg gives the consumers 232
# registers a thread), a split over at most MAX_SPLIT blocks of a cluster.
# The ring takes as many stages as fit, up to the number of key tiles (at
# least 3).
BM, MAX_STAGES, MIN_STAGES, MAX_SPLIT = 128, 8, 3, 8
KEY_TILES = (64, 128)  # keys per tile
_ALIGN = 1024  # slack for aligning the swizzled tiles to 1024 bytes

# The plan picks the candidate of least modeled time: a block costs
# BLOCK_US[hd] plus TILE_US[(hd, bn)] per key tile it runs, plus, when the
# key tiles are split over a cluster, COMBINE_US + COMBINE_US_PER_HD * hd
# (the ranks' fp32 O through distributed shared memory); a grid runs in
# waves of WAVE_BLOCKS[split] blocks (ops/resblock.py: one block per SM;
# clusters fit in one GPC). The constants were fitted to the device times of
# scripts/torch_attention_plan_sweep.py on an H100 (PERF.md); hd 2 to 16,
# off the flagship's path, take hd 32's.
BLOCK_US = {2: 3.8, 4: 3.8, 8: 3.8, 16: 3.8, 32: 3.8, 64: 3.9, 128: 6.0}
COMBINE_US, COMBINE_US_PER_HD = 0.6, 0.025
TILE_US = {(2, 64): 0.69, (2, 128): 1.06, (4, 64): 0.69, (4, 128): 1.06,
           (8, 64): 0.69, (8, 128): 1.06, (16, 64): 0.69, (16, 128): 1.06,
           (32, 64): 0.69, (32, 128): 1.06, (64, 64): 0.8, (64, 128): 1.23,
           (128, 64): 0.99, (128, 128): 1.51}


@dataclass(frozen=True)
class AttentionPlan:
    """Launch of one ``attention_core``: ``BM`` query rows per block, key
    tiles of ``bn`` keys (``tiles`` of them), a ring of ``stages`` K/V
    stages, the key tiles split over ``split`` blocks of a thread-block
    cluster (combined in rank order); grid ``(split * mtiles, H, B)``;
    ``smem`` dynamic shared bytes."""

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
        return self.split * self.mtiles * h * b


def attention_smem(hd: int, bn: int, stages: int) -> int:
    """Dynamic shared bytes: the Q tile, the K/V ring and (reusing the
    ring) the split's fp32 combine buffer of (m, l, O) per row."""
    hdp = max(hd, 16)  # the contraction, padded to the k16 step
    ring = stages * 2 * bn * hdp * 2
    # the split's combine: O, m and l of each rank's part of this block's
    # rows, then each row's weights over the ranks and their sum
    rows = BM + MAX_SPLIT
    combine = rows * (hdp + 4) * 4 + 2 * rows * 4 + (BM // 2) * (MAX_SPLIT + 1) * 4
    return _ALIGN + BM * hdp * 2 + max(ring, combine)


def attention_candidates(b: int, h: int, t: int, s: int, hd: int):
    """Every launch of the kernel for this call that fits the card, as
    (modeled microseconds, AttentionPlan), in a fixed order."""
    mtiles = -(-t // BM)
    out = []
    for bn in KEY_TILES:
        tiles = -(-s // bn)
        stages = MIN_STAGES
        while (stages < min(MAX_STAGES, max(tiles, MIN_STAGES))
               and attention_smem(hd, bn, stages + 1) <= SMEM_MAX):
            stages += 1
        smem = attention_smem(hd, bn, stages)
        if smem > SMEM_MAX:
            continue
        for split in range(1, min(SPLIT_MAX, tiles) + 1):
            plan = AttentionPlan(bn, stages, split, mtiles, tiles, smem)
            per_block = BLOCK_US[hd] + -(-tiles // split) * TILE_US[(hd, bn)]
            if split > 1:
                per_block += COMBINE_US + COMBINE_US_PER_HD * hd
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
    need(hd in HEAD_DIMS, f"head dim {hd} not in {HEAD_DIMS}")
    need(tuple(k.shape) == tuple(v.shape) == (b, h, s, hd),
         f"k, v must be (B, H, S, hd) = ({b}, {h}, S, {hd}), got {tuple(k.shape)}, "
         f"{tuple(v.shape)}")
    need(t >= 1 and s >= 1, f"empty T or S ({t}, {s})")
    for x, name in ((q, "q"), (k, "k"), (v, "v")):
        st = x.stride()
        need(x.device == q.device, f"{name} on {x.device}, q on {q.device}")
        if hd < 8:  # virtual heads of 8 channels: the heads side by side
            need(st[3] == 1 and st[1] == hd and (h * hd) % 8 == 0
                 and st[0] % 8 == st[2] % 8 == x.data_ptr() % 16 == 0,
                 f"{name} at head dim {hd} needs its heads side by side (head stride {hd}), "
                 f"H*hd a multiple of 8 and 16-byte aligned rows, strides {st}, H {h}")
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
                  *out.stride()[:3], plan.bn, plan.stages, plan.split, plan.smem,
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
