"""CUDA graphs of the port's hot steps: the counterpart of the JAX package's
``jit`` compile-and-cache.

``GraphedStep(fn, device=..., generators=..., pool=...)`` holds one step
function whose inputs and outputs are static buffers (tensors that stay
where they are between calls). On the card its first call runs ``fn``
eagerly on a side stream (the warm-up ``torch.cuda.graphs`` asks for, and
that call's real work), then captures ``fn`` into a CUDA graph; every later
call replays the graph. Callers copy fresh inputs into the static buffers
before a call (``stage``) and copy results out after it. ``fn`` must have no
host-side effects: a replay runs none of its Python.

- Randomness: each ``torch.Generator`` the step draws from is registered
  with the graph, so a replay draws, from the generator's seed and offset
  at that moment, what an eager call draws, and advances it as far.
  Callers seed it between calls as the eager path does.
- Launch accounting: the capture's kernel launches are recorded against
  the graph (``ops._build.recording``) and added to ``ops._build.LAUNCHES``
  at each replay; the first call's eager launches count themselves. The
  counts equal those of running every call eagerly.
- Tracing: while the spans of ``utils.profiling`` are on, each replay runs
  in the span ``graph.replay``, with timing events on the current stream
  just before and after it; a warm-up or capture records nothing.
- A failed capture or replay raises, and a step whose capture failed keeps
  raising: nothing falls back to the eager loop on the card.
- ``CAPTURE_LOCK`` is held from the first call's warm-up to the end of its
  capture; a thread that launches CUDA work beside the main thread (the
  batch prefetcher) takes it, so none of its calls lands inside a capture.
- Inside ``eager_on_card()`` steps run eagerly on the card too: what the
  card's comparisons of replays against eager runs use. No entry point
  enters it. A step made with ``eager=True`` always runs eagerly: a step
  of a multi-process run, whose collectives a graph cannot capture (gloo).

On the CPU a ``GraphedStep`` calls ``fn``: the plain route, as every kernel
wrapper takes for a CPU tensor.
"""

from __future__ import annotations

import threading
import time
from collections import Counter
from contextlib import contextmanager
from typing import Callable, Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from lm2a_tpu_torch.ops import _build
from lm2a_tpu_torch.utils import profiling

CAPTURE_LOCK = threading.RLock()
captures = 0  # CUDA graphs captured in this process (a cached geometry adds none)
_side_streams: Dict[torch.device, "torch.cuda.Stream"] = {}
_eager = False


@contextmanager
def eager_on_card() -> Iterator[None]:
    """Run every ``GraphedStep`` eagerly inside the block, on the card too."""
    global _eager
    prev, _eager = _eager, True
    try:
        yield
    finally:
        _eager = prev


def side_stream(device: torch.device) -> "torch.cuda.Stream":
    """The one stream every warm-up and capture on ``device`` runs on (graphs
    sharing a memory pool must be captured on the same stream)."""
    s = _side_streams.get(device)
    if s is None:
        s = _side_streams[device] = torch.cuda.Stream(device)
    return s


def new_pool(device: torch.device):
    """A memory pool handle for graphs to share on the card, None on the CPU."""
    return torch.cuda.graph_pool_handle() if torch.device(device).type == "cuda" else None


def stage(dst: torch.Tensor, src) -> torch.Tensor:
    """Copy ``src`` (numpy, a host tensor, or a tensor on ``dst``'s device)
    into the static buffer ``dst`` without a host sync: host data goes
    through pinned memory by a non-blocking copy on the current stream."""
    if not isinstance(src, torch.Tensor):
        src = torch.from_numpy(np.ascontiguousarray(src))
    if dst.device.type == "cuda" and src.device.type == "cpu":
        return dst.copy_(src.pin_memory(), non_blocking=True)
    return dst.copy_(src)


class GraphedStep:
    """One step function, replayed from a CUDA graph on the card (see the
    module docstring). ``capture_seconds`` and ``capture_bytes`` (the device
    memory the capture reserved) are set after the capture."""

    def __init__(self, fn: Callable[[], None], *, device, generators: Sequence = (),
                 pool=None, eager: bool = False):
        self.fn = fn
        self.eager = eager
        self.device = torch.device(device)
        self.generators = tuple(g for g in generators if g is not None)
        self.pool = pool
        self.graph: Optional["torch.cuda.CUDAGraph"] = None
        self.launches: Counter = Counter()
        self.capture_seconds: Optional[float] = None
        self.capture_bytes: Optional[int] = None
        self.replays = 0
        self._error: Optional[BaseException] = None

    def __call__(self) -> None:
        if self.device.type != "cuda" or _eager or self.eager:
            self.fn()
            return
        if self._error is not None:
            raise RuntimeError("this step's CUDA graph capture failed earlier; it does not "
                               "run eagerly instead") from self._error
        if self.graph is None:
            self._warm_up_and_capture()
            return
        with profiling.span("graph.replay", device=self.device):
            self.graph.replay()
        _build.count(self.launches)
        self.replays += 1

    def _warm_up_and_capture(self) -> None:
        global captures
        dev = self.device
        side = side_stream(dev)
        cur = torch.cuda.current_stream(dev)
        graph = torch.cuda.CUDAGraph()
        register = getattr(graph, "register_generator_state", None)
        if self.generators and register is None:
            raise RuntimeError(f"torch {torch.__version__} cannot register a generator with a "
                               "CUDA graph (CUDAGraph.register_generator_state)")
        with CAPTURE_LOCK:
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                self.fn()  # the warm-up is this call's work; its launches count themselves
            cur.wait_stream(side)
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(dev)
            t0 = time.perf_counter()
            for g in self.generators:
                register(g)
            record: Counter = Counter()
            try:
                with _build.recording(record), torch.cuda.graph(graph, pool=self.pool,
                                                                  stream=side):
                    self.fn()
            except BaseException as e:
                self._error = e
                raise
            self.capture_seconds = time.perf_counter() - t0
            self.capture_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.graph, self.launches = graph, record
        captures += 1
