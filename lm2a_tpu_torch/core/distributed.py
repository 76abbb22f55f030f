"""Multi-process execution and the port's collectives (port of
``lm2a_tpu/core/distributed.py``).

``init_distributed`` joins a ``torch.distributed`` process group: the
explicit arguments win, then ``LM2A_COORDINATOR`` / ``LM2A_NUM_PROCESSES``
/ ``LM2A_PROCESS_ID``; with neither it returns False and the run is one
process. The backend follows the devices: NCCL where each rank of a host
has a card of its own (``cuda:<local rank>``), gloo on the CPU and where
ranks share a card (NCCL refuses two ranks on one device). A failed init
raises; nothing retries on another backend.

Every process loads the seed-identical global batch and keeps the rows its
place on the mesh owns (``local_batch_slice``); the state starts replicated
from rank 0 (``put_replicated``). With one process every helper is the
single-process no-op.

Every collective of the port goes through ``all_reduce``, ``all_gather``,
``halo_exchange`` (the counterpart of XLA's collective-permute) and
``broadcast``, which count each call and its bytes into ``COUNTS`` under
the JAX package's HLO names (``parallel/audit.py`` reads them). A gather
is an all-reduce into a zero-filled buffer under every backend. Gloo takes
CUDA tensors only for broadcast and all-reduce, so under gloo a gather's
buffer and a halo exchange's rows go through the host; under NCCL the halo
rows are sent and received on the card. Tensor parallelism's f and g
(``tp_copy``, ``tp_reduce``) and ``tp_gather`` are autograd forms of the
same all-reduce and all-gather, counted as such.
"""

from __future__ import annotations

import datetime
import os
from collections import Counter
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from lm2a_tpu_torch.core.mesh import DATA_AXIS, Mesh, make_mesh

_ENV_COORD = "LM2A_COORDINATOR"
_ENV_NPROC = "LM2A_NUM_PROCESSES"
_ENV_PID = "LM2A_PROCESS_ID"
# ranks a host runs (torchrun's names); by default every rank on one host
_ENV_LOCAL_WORLD = "LOCAL_WORLD_SIZE"
_ENV_LOCAL_RANK = "LOCAL_RANK"
TIMEOUT_S = 600

# op name (the JAX package's HLO opcode) -> calls, and "<op>:bytes" -> bytes
COUNTS: Counter = Counter()
_info: Dict[str, object] = {}


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def choose_backend(device: str, local_world: int, cards: int) -> str:
    """NCCL where every local rank has a card of its own, else gloo (the
    CPU, or ranks sharing a card)."""
    if torch.device(device).type != "cuda":
        return "gloo"
    return "nccl" if cards >= local_world else "gloo"


def init_distributed(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, device: str = "cuda") -> bool:
    """Join the process group before any other distributed use. Returns
    True when one was joined, False for the single-process no-op (no
    coordinator configured anywhere). ``coordinator`` is ``host:port`` (TCP)
    or a full init URL (``file://...``)."""
    coordinator = coordinator or os.environ.get(_ENV_COORD)
    if num_processes is None and os.environ.get(_ENV_NPROC):
        num_processes = int(os.environ[_ENV_NPROC])
    if process_id is None and os.environ.get(_ENV_PID):
        process_id = int(os.environ[_ENV_PID])
    if coordinator is None and num_processes is None:
        return False
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError("a multi-process run needs a coordinator, num_processes and "
                         f"process_id (got {coordinator!r}, {num_processes}, {process_id})")
    import torch.distributed as dist

    local_world = int(os.environ.get(_ENV_LOCAL_WORLD, num_processes))
    local_rank = int(os.environ.get(_ENV_LOCAL_RANK, process_id % local_world))
    dev = torch.device(device)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if dev.type == "cuda" and cards == 0:
        raise RuntimeError("init_distributed: --device cuda, but no CUDA device is visible")
    backend = choose_backend(device, local_world, cards)
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(dev)
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=url, world_size=num_processes,
                            rank=process_id, timeout=datetime.timedelta(seconds=TIMEOUT_S),
                            **kw)
    _info.update(backend=backend, device=dev, local_world=local_world, local_rank=local_rank)
    return True


def backend() -> Optional[str]:
    """The process group's backend, None without one."""
    return _dist().get_backend() if _dist() else None


def rank_device() -> torch.device:
    """This rank's device as ``init_distributed`` chose it (the CPU without
    a process group)."""
    return _info.get("device", torch.device("cpu"))


def process_index() -> int:
    return _dist().get_rank() if _dist() else 0


def process_count() -> int:
    return _dist().get_world_size() if _dist() else 1


def describe() -> str:
    """``process i/n: backend, device`` (the JAX CLI's process line)."""
    return (f"process {process_index()}/{process_count()}: backend {backend()} on "
            f"{rank_device()} ({_info.get('local_world', 1)} ranks on this host)")


def is_primary() -> bool:
    """True on the process that owns logging and checkpoint writes."""
    return process_index() == 0


def barrier(name: str = "lm2a") -> None:
    """Block until every process reaches this point (no-op single-process)."""
    dist = _dist()
    if dist and dist.get_world_size() > 1:
        dist.barrier()  # under NCCL on the card init_distributed bound (device_id)


def make_hybrid_mesh(model: int = 1, device=None) -> Mesh:
    """(data, model) mesh over every process's rank, the model axis inside
    one host (ranks of a host are consecutive). Single process: ``make_mesh``."""
    if process_count() == 1:
        return make_mesh(model=model, device=device)
    per_granule = int(_info.get("local_world", process_count()))
    if per_granule % model != 0:
        raise ValueError(
            f"model={model} must divide the per-granule device count "
            f"{per_granule}: the model axis cannot cross DCN (halo "
            "exchanges / TP reductions are latency-sensitive)"
        )
    return make_mesh(model=model, device=device)


def local_batch_slice(mesh: Mesh, global_batch_size: int) -> slice:
    """The contiguous row range of a data-sharded global batch that THIS
    process's cells of the mesh own, derived from the mesh's layout (not
    assumed from the rank): cells along the model axis repeat a slice, and
    the distinct slices must tile one range."""
    parts = mesh.shape[DATA_AXIS]
    rows = sorted({(global_batch_size * int(d) // parts, global_batch_size * (int(d) + 1) // parts)
                   for d, _ in np.argwhere(mesh.devices == mesh.rank)})
    lo, run = rows[0][0], rows[0][0]
    for low, high in rows:
        if low != run:
            raise ValueError(
                f"process {mesh.rank} owns non-contiguous batch rows {rows}; "
                "use make_hybrid_mesh() so each process's rows are contiguous"
            )
        run = high
    return slice(lo, run)


def put_global_batch(mesh: Mesh, local_batch):
    """This process's rows (``local_batch_slice``) on its device."""
    return {k: torch.as_tensor(np.asarray(v)).to(mesh.device) for k, v in local_batch.items()}


def put_replicated(mesh: Mesh, tensors: Sequence[torch.Tensor]) -> None:
    """Make every rank's ``tensors`` rank 0's, in place, so a seeded or
    resumed state cannot drift between ranks (no-op single-process)."""
    if process_count() > 1:
        broadcast_many(list(tensors), src=0, group=_dist().group.WORLD)


# ---------------------------------------------------------------- collectives

def _record(op: str, nbytes: int) -> None:
    COUNTS[op] += 1
    COUNTS[op + ":bytes"] += int(nbytes)


def _gloo_cuda(t: torch.Tensor, group) -> bool:
    dist = _dist()
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _group_size(group) -> int:
    """Ranks of ``group``; None (a mesh line of one rank) is 1: the layer
    takes the world only as ``dist.group.WORLD``."""
    return 1 if group is None else _dist().get_world_size(group)


def all_reduce(t: torch.Tensor, group=None, mean: bool = False) -> torch.Tensor:
    """Sum (or mean) of ``t`` over ``group``'s ranks, in place; returns ``t``.
    A group of one rank moves nothing."""
    n = _group_size(group)
    if n == 1:
        return t
    _record("all-reduce", t.numel() * t.element_size())
    _dist().all_reduce(t, group=group)
    if mean:
        t.mul_(1.0 / n)
    return t


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """``t``'s storage as bytes (gloo adds and moves any dtype as uint8)."""
    return t.view(torch.uint8)


def all_gather(t: torch.Tensor, group, sizes: Optional[List[int]] = None) -> torch.Tensor:
    """The ranks' ``t`` concatenated along dim 1 in group order ((B, n_i, .)
    pieces; ``sizes`` the n_i where they differ, else all ``t.shape[1]``).
    Each rank's bytes go into a zero-filled buffer (on the host under gloo
    with CUDA tensors) that one all-reduce adds up as uint8: every byte has
    one nonzero addend, so the sum is the copy. One path for every backend
    and for uneven pieces."""
    n = _group_size(group)
    if n == 1:
        return t
    dist = _dist()
    me = dist.get_group_rank(group, dist.get_rank())
    sizes = list(sizes) if sizes is not None else [t.shape[1]] * n
    offs = np.concatenate([[0], np.cumsum(sizes)]).astype(int)
    out_shape = (t.shape[0], int(offs[-1])) + tuple(t.shape[2:])
    _record("all-gather", int(np.prod(out_shape)) * t.element_size())
    host = _gloo_cuda(t, group)  # gloo adds CUDA bytes through the host: do it here
    out = torch.zeros(out_shape, dtype=t.dtype, device="cpu" if host else t.device)
    out[:, offs[me]:offs[me + 1]] = t.cpu() if host else t
    dist.all_reduce(_bytes(out), group=group)
    return out.to(t.device)


def _p2p(group, sends, recvs, host: bool) -> None:
    """Point-to-point sends ``(tensor, group rank)`` and receives into
    ``(buffer, group rank)``, as bytes, through the host under gloo with
    CUDA tensors (the buffers are then host tensors)."""
    dist = _dist()
    ranks = dist.get_process_group_ranks(group)
    ops = [dist.P2POp(dist.isend, _bytes(t.contiguous().cpu() if host else t.contiguous()),
                      ranks[peer], group) for t, peer in sends]
    ops += [dist.P2POp(dist.irecv, _bytes(buf), ranks[peer], group) for buf, peer in recvs]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


def _counts(counts, n: int) -> List[int]:
    return [counts] * n if isinstance(counts, int) else list(counts)


def halo_exchange(x: torch.Tensor, group, left, right):
    """Rows of dim 1 from the neighbours along ``group``'s line: the last
    ``left`` rows of the rank before and the first ``right`` rows of the rank
    after (None at either end of the line, or where the count is 0). The
    counts are ints, the same on every rank, or sequences giving every
    rank's (each rank sends what its neighbours ask). Returns
    ``(from_left, from_right)``."""
    n = _group_size(group)
    if n == 1:
        return None, None
    dist = _dist()
    me = dist.get_group_rank(group, dist.get_rank())
    left, right = _counts(left, n), _counts(right, n)
    host = _gloo_cuda(x, group)

    def buffer(count: int) -> torch.Tensor:
        return torch.empty((x.shape[0], count) + tuple(x.shape[2:]), dtype=x.dtype,
                           device="cpu" if host else x.device)

    # each pair of neighbours trades: a rank sends its first rows to the
    # rank before and its last rows to the rank after
    sends, recv = [], {}
    if me > 0 and right[me - 1]:
        _halo_check(right[me - 1] <= x.shape[1], me - 1, right[me - 1], x.shape[1])
        sends.append((x[:, :right[me - 1]], me - 1))
    if me < n - 1 and left[me + 1]:
        _halo_check(left[me + 1] <= x.shape[1], me + 1, left[me + 1], x.shape[1])
        sends.append((x[:, x.shape[1] - left[me + 1]:], me + 1))
    if me > 0 and left[me]:
        recv["left"] = (buffer(left[me]), me - 1)
    if me < n - 1 and right[me]:
        recv["right"] = (buffer(right[me]), me + 1)
    _p2p(group, sends, list(recv.values()), host)
    got = {k: v.to(x.device) for k, (v, _) in recv.items()}
    _record("collective-permute", sum(v.numel() * v.element_size() for v in got.values()))
    return got.get("left"), got.get("right")


def halo_return(x_shape, from_left: Optional[torch.Tensor], from_right: Optional[torch.Tensor],
                group, left, right, like: torch.Tensor) -> torch.Tensor:
    """The backward of ``halo_exchange``: the gradients of the rows a rank
    received go back to the rank that sent them and are added where those
    rows came from. Returns the gradient of ``x`` (shape ``x_shape``) that
    the neighbours' rows carried."""
    n = _group_size(group)
    gx = torch.zeros(x_shape, dtype=like.dtype, device=like.device)
    if n == 1:
        return gx
    dist = _dist()
    me = dist.get_group_rank(group, dist.get_rank())
    left, right = _counts(left, n), _counts(right, n)
    host = _gloo_cuda(like, group)
    tail = tuple(x_shape[2:])

    def buffer(count: int) -> torch.Tensor:
        return torch.empty((x_shape[0], count) + tail, dtype=like.dtype,
                           device="cpu" if host else like.device)

    sends, recv = [], {}
    if from_left is not None and from_left.shape[1]:
        sends.append((from_left, me - 1))
    if from_right is not None and from_right.shape[1]:
        sends.append((from_right, me + 1))
    if me < n - 1 and left[me + 1]:  # the gradient of my last rows, from the rank after
        recv["last"] = (buffer(left[me + 1]), me + 1)
    if me > 0 and right[me - 1]:  # of my first rows, from the rank before
        recv["first"] = (buffer(right[me - 1]), me - 1)
    _p2p(group, sends, list(recv.values()), host)
    if "last" in recv:
        g = recv["last"][0].to(like.device)
        gx[:, x_shape[1] - g.shape[1]:] += g
    if "first" in recv:
        g = recv["first"][0].to(like.device)
        gx[:, :g.shape[1]] += g
    _record("collective-permute", sum(v.numel() * v.element_size() for v, _ in recv.values()))
    return gx


def _halo_check(ok: bool, rank: int, rows: int, have: int) -> None:
    if not ok:
        raise ValueError(f"halo_exchange: rank {rank} asks for {rows} rows of a shard of "
                         f"{have}: a shard must hold its neighbours' halos")


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, left, right):
        ctx.group, ctx.left, ctx.right, ctx.shape = group, left, right, tuple(x.shape)
        fl, fr = halo_exchange(x, group, left, right)
        empty = x.new_zeros((x.shape[0], 0) + tuple(x.shape[2:]))
        return (empty if fl is None else fl), (empty if fr is None else fr)

    @staticmethod
    def backward(ctx, gl, gr):
        return halo_return(ctx.shape, gl, gr, ctx.group, ctx.left, ctx.right, gl), None, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, sizes):
        ctx.group, ctx.sizes = group, sizes
        return all_gather(x.contiguous(), group, sizes)

    @staticmethod
    def backward(ctx, g):
        dist = _dist()
        me = dist.get_group_rank(ctx.group, dist.get_rank())
        lo = int(sum(ctx.sizes[:me]))
        g = all_reduce(g.contiguous().clone(), ctx.group)
        return g[:, lo:lo + ctx.sizes[me]].contiguous(), None, None


def all_reduce_grad(x: torch.Tensor, group) -> torch.Tensor:
    """``all_reduce`` (a sum) that autograd differentiates: the gradient of
    the sum, itself summed over the group."""
    return x if _group_size(group) == 1 else _AllReduce.apply(x, group)


def halo_exchange_grad(x: torch.Tensor, group, left, right):
    """``halo_exchange`` that autograd differentiates (``halo_return`` is
    its backward), zero-row tensors where it gives None: a caller keeps
    both in its graph, so every rank runs the backward its neighbours wait
    on."""
    if _group_size(group) == 1:
        return None, None
    return _Exchange.apply(x, group, left, right)


def all_gather_grad(x: torch.Tensor, group, sizes: List[int]) -> torch.Tensor:
    """``all_gather`` (dim 1) that autograd differentiates: each rank's
    slice of the gradient, summed over the group."""
    return x if _group_size(group) == 1 else _Gather.apply(x, group, list(sizes))


# ---------------------------------------------------------------- tensor parallelism
# Megatron's pair for the model axis of tensor parallelism, where every rank
# of a model line computes the same loss (the sequence-parallel forms above
# sum their backward over the group, which would multiply TP's gradients by
# the group's size): ``tp_copy`` (f) goes where a replicated tensor enters a
# split computation, ``tp_reduce`` (g) where a split computation's partial
# sums leave it; ``tp_gather`` makes a sharded tensor whole for a replicated
# computation.


class _TPCopy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _TPReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _TPGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        n = _group_size(group)
        dist = _dist()
        ctx.me, ctx.width = dist.get_group_rank(group, dist.get_rank()), x.shape[-1]
        whole = all_gather(x.movedim(-1, 1).contiguous(), group, [x.shape[-1]] * n)
        return whole.movedim(1, -1).contiguous()

    @staticmethod
    def backward(ctx, g):
        lo = ctx.me * ctx.width
        return g[..., lo:lo + ctx.width].contiguous(), None


def tp_copy(x: torch.Tensor, group) -> torch.Tensor:
    """f: ``x`` as it is; its gradient all-reduced over ``group`` (the
    split computation after it gives each rank a part of the gradient)."""
    return x if _group_size(group) == 1 else _TPCopy.apply(x, group)


def tp_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """g: the sum of the ranks' partial ``x`` (a new tensor); its gradient
    passes as it is (every rank holds the whole gradient of the sum)."""
    return x if _group_size(group) == 1 else _TPReduce.apply(x, group)


def tp_gather(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``x`` concatenated along the last dimension in group order
    (equal pieces); the gradient of the whole is every rank's, so each
    keeps its own piece of it."""
    return x if _group_size(group) == 1 else _TPGather.apply(x, group)


def broadcast(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every rank of ``group``, in place."""
    if _group_size(group) == 1:
        return t
    _record("broadcast", t.numel() * t.element_size())
    _dist().broadcast(t, src=src, group=group)
    return t


BUCKET_BYTES = 256 << 20


@torch.no_grad()
def broadcast_many(tensors: List[torch.Tensor], src: int = 0, group=None) -> None:
    """``broadcast`` of many tensors in flat buckets of one dtype and device
    (at most ``BUCKET_BYTES`` each, a larger tensor alone)."""
    run: List[torch.Tensor] = []

    def flush():
        if not run:
            return
        if len(run) == 1:
            broadcast(run[0], src, group)
        else:
            flat = torch.cat([t.reshape(-1) for t in run])
            broadcast(flat, src, group)
            torch._foreach_copy_(run, [v.view_as(t) for v, t in
                                       zip(flat.split([t.numel() for t in run]), run)])
        run.clear()

    size = 0
    for t in tensors:
        if run and (t.dtype != run[0].dtype or t.device != run[0].device
                    or size + t.numel() * t.element_size() > BUCKET_BYTES):
            flush()
            size = 0
        run.append(t)
        size += t.numel() * t.element_size()
    flush()
