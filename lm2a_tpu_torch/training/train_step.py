"""Train and eval steps (port of ``lm2a_tpu/training/train_step.py``).

One optimization step is the reference's hot loop: condition projection,
one shared Bernoulli mask dropping BOTH conditions for classifier-free
guidance, the diffusion loss on the training form of the denoiser, the
backward, then clip + Adan + EMA. bf16 compute on fp32 master parameters.

Randomness comes from a ``torch.Generator`` in a fixed order: the CFG keep
mask, the timesteps, the noise, then the dropout masks block by block. The
kernel route and the plain route draw the same numbers in the same order,
so one generator state gives both the same step. The tests inject the JAX
package's draws instead (``Draws``).

Gradients accumulate into ``.grad`` buffers that are allocated once and
zeroed each step, so the optimizer kernel's table of pointers is built once.
They are views of one flat buffer (``TrainState.grads``) whose last slot
takes the step's loss: under data parallelism (``mesh`` with a data axis
longer than one) one all-reduce of that buffer, between the backward and
the optimizer, averages the gradients and the loss over the data axis, as
the JAX step's psum does. Each rank then draws its step's randomness at the
global batch shape and keeps its rows (``core/draws.py``), so N ranks take
one rank's step over the same global batch. Such a step runs eagerly on the
card: gloo's collectives cannot be captured in a CUDA graph.

The compiled steps (the JAX package's jitted ``make_multistep_train_step``,
``make_device_data_multistep`` and ``make_device_data_eval``, and
``make_multistep_eval`` for streamed validation, which the JAX package jits
as ``make_eval_step``) are what ``training/loop.py`` calls. Each runs
through a ``StepRunner``, cached per state and batch geometry: one step's
device work (``make_update_step``'s math, or the eval loss) over rows of a
static data buffer, its batch gathered with ``index_select`` from a (K, B)
row table, its Adan scalars read from a (K, 8) table
(``Adan.stage_scalars``) and its loss written into a (K,) buffer at the
step counter.
K steps a call are K replays of one captured step on the card (the first
call's first step is the capture's warm-up), K eager calls on the CPU, the
generator seeded before each from ``(seed, offset)`` as ``step_generator``
does. A (K, B) table from a device-resident pack is the ``device_data``
form; the streaming forms copy their batches into the buffer first.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from lm2a_tpu_torch.core.config import LM2AConfig
from lm2a_tpu_torch.core.device import DeviceLike, dtype_from_str, resolve_device
from lm2a_tpu_torch.core import distributed as collectives
from lm2a_tpu_torch.core import draws as row_draws
from lm2a_tpu_torch.core.graphs import GraphedStep, stage
from lm2a_tpu_torch.core.mesh import DATA_AXIS
from lm2a_tpu_torch.diffusion.gaussian import diffusion_loss
from lm2a_tpu_torch.diffusion.schedule import Schedule
from lm2a_tpu_torch.models.embedding import CondProjection
from lm2a_tpu_torch.models.factory import build_cond_projection, build_denoiser, random_init_
from lm2a_tpu_torch.models.unet1d import Denoiser
from lm2a_tpu_torch.ops.adan import N_SCALARS
from lm2a_tpu_torch.training.adan import Adan, AdanState, make_lr_schedule

TREES = ("unet", "cond_proj")


@dataclass
class TrainState:
    """Step counter, the two parameter trees (fp32 modules), the EMA of
    every parameter and the Adan state, keyed ``"<tree>/<parameter name>"``."""

    step: int
    unet: Denoiser
    cond_proj: CondProjection
    ema: Dict[str, torch.Tensor]
    opt: AdanState
    grads: Optional[torch.Tensor] = None  # the flat gradient buffer, then the loss

    def params(self) -> Dict[str, torch.Tensor]:
        return {f"{tree}/{n}": p for tree in TREES
                for n, p in getattr(self, tree).named_parameters()}


class Draws(NamedTuple):
    """Injected randomness of one loss: timesteps (B,), noise like the mel,
    CFG keep mask (B, 1, 1) or None."""

    t: torch.Tensor
    noise: torch.Tensor
    keep: Optional[torch.Tensor] = None


def make_optimizer(cfg: LM2AConfig,
                   lr_schedule: Optional[Callable[[int], np.float32]] = None) -> Adan:
    """The Adan of ``cfg.train``; ``lr_schedule`` replaces its step decay
    (``cli distill``'s cosine rate). ``fused_opt=False`` gives the chained
    form (clip, then Adan; the JAX package's ``optax.chain`` state layout),
    which ``opt_backend='pallas'`` refuses, as the JAX package does."""
    tc = cfg.train
    return Adan(lr_schedule or make_lr_schedule(tc.lr, tc.lr_decay_steps, tc.lr_decay_factors),
                weight_decay=tc.weight_decay, grad_clip=tc.grad_clip or 0.0,
                ema_decay=tc.ema_decay,
                state_dtype=None if tc.opt_dtype in ("", "float32") else dtype_from_str(tc.opt_dtype),
                backend=tc.opt_backend, fused=bool(tc.fused_opt))


def init_train_state(cfg: LM2AConfig, seed: int, device: DeviceLike = None,
                     optimizer: Optional[Adan] = None) -> TrainState:
    """Seeded fp32 parameters (``random_init_``), EMA = parameters, zero
    Adan state, and a zeroed ``.grad`` buffer on every parameter (views of
    ``state.grads``), on CUDA unless ``device="cpu"``."""
    dev = resolve_device(device)
    unet = random_init_(build_denoiser(cfg.model), seed).to(dev)
    proj = random_init_(build_cond_projection(cfg.model), seed + 1).to(dev)
    unet.train()
    proj.train()
    state = TrainState(0, unet, proj, {}, AdanState(0))
    params = state.params()
    sizes = [p.numel() for p in params.values()]
    state.grads = torch.zeros(sum(sizes) + 1, dtype=torch.float32, device=dev)
    for p, g in zip(params.values(), state.grads.split(sizes + [1])):
        p.grad = g.view_as(p)
    state.ema = {k: p.detach().clone() for k, p in params.items()}
    state.opt = (optimizer or make_optimizer(cfg)).init(params)
    return state


def loss_fn(state: TrainState, schedule: Schedule, batch, cfg: LM2AConfig, *,
            dataset_mean: float, dataset_std: float, train: bool,
            generator: Optional[torch.Generator] = None,
            draws: Optional[Draws] = None, forward: Optional[Callable] = None) -> torch.Tensor:
    """The diffusion loss of one batch (dict of (B, T, .) tensors ``mel``,
    ``motion``, ``lyrics``). ``train`` adds the CFG condition drop and
    dropout; the eval form has neither. ``forward`` replaces the
    denoiser's ``forward_train`` (the tensor-parallel step's split form)."""
    dt = dtype_from_str(cfg.train.compute_dtype)
    motion_f, text_f = state.cond_proj.forward_train(batch["motion"], batch["lyrics"], dt)
    p = cfg.train.cond_drop_prob
    if train and p > 0.0:
        b = motion_f.shape[0]
        if draws is not None and draws.keep is not None:
            keep = draws.keep.to(motion_f.device, motion_f.dtype)
        else:  # one shared mask zeroes both conditions
            drop = row_draws.rand((b, 1, 1), generator, motion_f.device) < p
            keep = (~drop).to(motion_f.dtype)
        motion_f = motion_f * keep
        text_f = text_f * keep

    def model_fn(x, t, m, l):
        return (forward or state.unet.forward_train)(x, t, m, l, dtype=dt,
                                                     generator=generator if train else None)

    return diffusion_loss(model_fn, schedule, batch["mel"], motion_f, text_f,
                          dataset_mean=dataset_mean, dataset_std=dataset_std,
                          t=None if draws is None else draws.t.to(batch["mel"].device),
                          noise=None if draws is None else draws.noise.to(batch["mel"].device),
                          generator=generator)


def step_seed(seed: int, step: int) -> int:
    """The seed of one step's (or validation batch's) generator in a run."""
    return ((seed + 1) << 32) + step


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of one step (or validation batch) of a run."""
    return torch.Generator(device=device).manual_seed(step_seed(seed, step))


def data_group(mesh):
    """The process group of the mesh's data axis, None without one (a mesh
    of one data rank, or no mesh)."""
    return None if mesh is None else mesh.group(DATA_AXIS)


def make_update_step(loss_builder: Callable, optimizer: Adan, mesh=None):
    """The grad -> optimizer -> EMA update. ``loss_builder(state, batch,
    **kw) -> scalar loss``; returns ``one_step(state, batch, **kw) -> loss``
    (detached), updating ``state`` in place. ``one_step.device_step(state,
    batch, scal, **kw)`` is its device work with the step's Adan scalars
    staged in ``scal``: no host state changes, what a CUDA graph captures;
    ``one_step`` stages the scalars, runs it and counts the step. Under a
    ``mesh`` with a data axis, the gradients and the loss are averaged over
    it in one all-reduce of ``state.grads`` before the update."""
    group = data_group(mesh)

    def device_step(state: TrainState, batch, scal: torch.Tensor, **kw) -> torch.Tensor:
        params = state.params()
        grads = [p.grad for p in params.values()]
        torch._foreach_zero_(grads)
        loss = loss_builder(state, batch, **kw)
        loss.backward()
        if group is not None:
            state.grads[-1:].copy_(loss.detach().float().view(1))
            collectives.all_reduce(state.grads, group, mean=True)
            loss = state.grads[-1].clone()
        optimizer.apply(params, {k: p.grad for k, p in params.items()}, state.ema, state.opt,
                        scal)
        return loss.detach()

    def one_step(state: TrainState, batch, **kw) -> torch.Tensor:
        scal = optimizer.stage_scalars(state.opt.step, torch.empty(
            N_SCALARS, dtype=torch.float32, device=next(state.unet.parameters()).device))
        loss = device_step(state, batch, scal, **kw)
        state.step += 1
        state.opt.step += 1
        return loss

    one_step.device_step = device_step
    one_step.optimizer = optimizer
    return one_step


def make_train_step(schedule: Schedule, cfg: LM2AConfig, optimizer: Optional[Adan] = None,
                    dataset_mean: float = 0.0, dataset_std: float = 1.0, mesh=None):
    """``train_step(state, batch, generator=None, draws=None) -> loss``; under
    a ``mesh`` with a data axis, this rank's rows of a data-parallel step."""

    def loss_builder(state, batch, generator=None, draws=None):
        return loss_fn(state, schedule, batch, cfg, dataset_mean=dataset_mean,
                       dataset_std=dataset_std, train=True, generator=generator, draws=draws)

    return make_update_step(loss_builder, optimizer or make_optimizer(cfg), mesh)


def make_eval_step(schedule: Schedule, cfg: LM2AConfig, dataset_mean: float = 0.0,
                   dataset_std: float = 1.0, mesh=None):
    """Validation loss on the current parameters: no condition drop, no
    dropout. ``eval_step(state, batch, generator=None, draws=None)``; under
    a ``mesh`` with a data axis, averaged over it."""
    group = data_group(mesh)

    @torch.no_grad()
    def eval_step(state: TrainState, batch, generator=None, draws=None) -> torch.Tensor:
        loss = loss_fn(state, schedule, batch, cfg, dataset_mean=dataset_mean,
                       dataset_std=dataset_std, train=False, generator=generator,
                       draws=draws)
        return collectives.all_reduce(loss.float().view(1), group, mean=True)[0]

    eval_step.mesh = mesh
    return eval_step


class StepRunner:
    """K train (or eval) steps a call over rows of ``data``, on the card as
    replays of one captured step (see the module docstring).

    ``step`` is a ``make_update_step`` step (train) or the loss function
    ``loss(state, batch, generator=...)`` (eval, ``train=False``); ``data``
    the (N, T, .) tensors the rows index: a device-resident pack, or None
    for a buffer of ``k_max * batch_size`` rows made at the first ``load``.
    ``shard`` (this rank's rows, the global rows) makes the step draw at the
    global batch shape (a data-parallel step); a run of several processes
    steps eagerly.
    """

    def __init__(self, step: Callable, state: TrainState, data: Optional[Dict[str, torch.Tensor]],
                 batch_size: int, k_max: int, *, train: bool = True, device=None,
                 shard: Optional[Tuple[slice, int]] = None):
        dev = (torch.device(device) if device is not None
               else next(state.unet.parameters()).device)
        self.step, self.state, self.train = step, state, train
        self.batch_size, self.k_max, self.device = batch_size, k_max, dev
        self.idx = idx = torch.zeros((k_max, batch_size), dtype=torch.long, device=dev)
        self.scal = scal = torch.zeros((k_max, N_SCALARS), dtype=torch.float32, device=dev)
        self.k = k = torch.zeros((1,), dtype=torch.long, device=dev)
        self.losses = losses = torch.zeros((k_max,), dtype=torch.float32, device=dev)
        self.generator = gen = torch.Generator(device=dev)
        draw = gen if shard is None else row_draws.RowShard(gen, *shard)
        self.data = data = {} if data is None else dict(data)

        def device_step() -> None:  # closes over the buffers, not the runner: no cycle
            rows = idx.index_select(0, k).view(-1)
            batch = {key: v.index_select(0, rows) for key, v in data.items()}
            if train:
                loss = step.device_step(state, batch, scal.index_select(0, k).view(-1),
                                        generator=draw)
            else:
                with torch.no_grad():
                    loss = step(state, batch, generator=draw)
            losses.index_copy_(0, k, loss.float().view(1))
            k.add_(1)

        self.graphed = GraphedStep(device_step, device=dev, generators=(gen,),
                                   eager=collectives.process_count() > 1)

    def load(self, batches: Dict[str, torch.Tensor]) -> np.ndarray:
        """Copy ``batches`` ((K, B, T, .) or (B, T, .) tensors) into the
        buffer's first rows; returns their (K, B) row table."""
        flat = {key: v.reshape((-1,) + tuple(v.shape[-2:])) for key, v in batches.items()}
        if not self.data:  # the buffer, made at the first load
            self.data.update({key: torch.zeros((self.k_max * self.batch_size,)
                                               + tuple(v.shape[1:]),
                                               dtype=torch.float32, device=self.device)
                              for key, v in flat.items()})
        rows = flat["mel"].shape[0]
        for key, v in flat.items():
            buf = self.data[key]
            if v.shape[0] != rows or rows > buf.shape[0] or v.shape[1:] != buf.shape[1:]:
                raise ValueError(f"StepRunner.load: {key} {tuple(v.shape)} does not fit the "
                                 f"buffer {tuple(buf.shape)}")
            stage(buf[:rows], v)
        return np.arange(rows).reshape(-1, self.batch_size)

    def run(self, idx, seed: int, offsets: Sequence[int]) -> torch.Tensor:
        """``len(offsets)`` steps, step j over rows ``idx[j]`` with the
        generator of ``(seed, offsets[j])``; returns their (K,) losses. A
        train runner counts the steps on its state."""
        k = len(offsets)
        if not 0 < k <= self.k_max or tuple(np.shape(idx)) != (k, self.batch_size):
            raise ValueError(f"StepRunner.run: rows {tuple(np.shape(idx))} for {k} steps "
                             f"(at most {self.k_max} of {self.batch_size})")
        stage(self.idx[:k], idx if isinstance(idx, torch.Tensor) else np.asarray(idx, np.int64))
        if self.train:
            self.step.optimizer.stage_scalars(self.state.opt.step, self.scal[:k])
        self.k.zero_()
        for off in offsets:
            self.generator.manual_seed(step_seed(seed, int(off)))
            self.graphed()
        if self.train:
            self.state.step += k
            self.state.opt.step += k
        return self.losses[:k].clone()


def _runner_for(cache: dict, key, make: Callable[[], StepRunner], k: int) -> StepRunner:
    """The cached runner for ``key`` (one per state and data), made anew when
    a call asks for more steps than its tables hold."""
    r = cache.get(key)
    if r is None or r.k_max < k:
        r = cache[key] = make()
    return r


def _shard(mesh, b: int) -> Optional[Tuple[slice, int]]:
    """(this rank's rows, the global rows) of a data-parallel step over local
    batches of ``b`` rows; None without a data axis."""
    if data_group(mesh) is None:
        return None
    n = b * mesh.shape[DATA_AXIS]
    return collectives.local_batch_slice(mesh, n), n


def _streaming(step: Callable, train: bool, mesh=None):
    """``fn(state, batches, seed, offsets) -> (K,) losses`` over stacked
    batches (dict of (K, B, T, .) tensors) copied into a runner's buffer;
    under a data-parallel ``mesh`` B is this rank's rows."""
    cache: dict = {}

    def fn(state: TrainState, batches, seed: int, offsets) -> torch.Tensor:
        k, b = batches["mel"].shape[:2]
        shapes = tuple((key, tuple(v.shape[2:])) for key, v in batches.items())
        r = _runner_for(cache, (id(state), b, shapes),
                        lambda: StepRunner(step, state, None, b, k, train=train,
                                           shard=_shard(mesh, b)), k)
        return r.run(r.load(batches), seed, offsets)

    return fn


def _resident(step: Callable, train: bool):
    """``fn(state, data, idx, seed, offsets) -> (K,) losses`` gathering each
    step's batch from the device-resident ``data`` at the rows ``idx[k]``."""
    cache: dict = {}

    def fn(state: TrainState, data, idx, seed: int, offsets) -> torch.Tensor:
        k, b = np.shape(idx)
        key = (id(state), b, tuple((n, v.data_ptr(), tuple(v.shape)) for n, v in data.items()))
        r = _runner_for(cache, key, lambda: StepRunner(step, state, data, b, k, train=train), k)
        return r.run(idx, seed, offsets)

    return fn


def make_multistep_train_step(schedule: Schedule, cfg: LM2AConfig,
                              optimizer: Optional[Adan] = None, dataset_mean: float = 0.0,
                              dataset_std: float = 1.0, mesh=None):
    """``multi(state, batches, seed, offsets) -> losses (K,)``: K optimizer
    steps over stacked batches (dict of (K, B, T, .) tensors), step k
    drawing from ``step_generator(seed, offsets[k])``; each step is
    ``make_train_step``'s math. ``cli train`` runs every streamed step
    through it, K = 1 included; under a data-parallel ``mesh`` (K = 1) B
    is this rank's rows of the global batch."""
    return _streaming(make_train_step(schedule, cfg, optimizer, dataset_mean, dataset_std,
                                      mesh), train=True, mesh=mesh)


def make_device_data_multistep(schedule: Schedule, cfg: LM2AConfig,
                               optimizer: Optional[Adan] = None, dataset_mean: float = 0.0,
                               dataset_std: float = 1.0):
    """``multi(state, data, idx, seed, offsets) -> losses (K,)``: K fused
    optimizer steps gathering their batches from a device-resident dataset
    (``data``: the packed (N, T, .) tensors, ``data.dataset.upload_dataset``),
    ``idx`` the (K, B) row indices, the only per-call input; the same math
    as ``make_multistep_train_step``."""
    return _resident(make_train_step(schedule, cfg, optimizer, dataset_mean, dataset_std),
                     train=True)


def make_multistep_eval(schedule: Schedule, cfg: LM2AConfig, dataset_mean: float = 0.0,
                        dataset_std: float = 1.0, mesh=None):
    """``fn(state, batches, seed, offsets) -> (K,) losses``: validation over
    stacked batches, each scored with ``make_eval_step``'s math from
    ``step_generator(seed, offsets[k])``; the streaming counterpart of
    ``make_device_data_eval`` (the JAX package jits ``make_eval_step``).
    Under a data-parallel ``mesh`` the losses are averaged over it."""
    return _streaming(make_eval_step(schedule, cfg, dataset_mean, dataset_std, mesh),
                      train=False, mesh=mesh)


def make_device_data_eval(schedule: Schedule, cfg: LM2AConfig, dataset_mean: float = 0.0,
                          dataset_std: float = 1.0):
    """``fn(state, data, idx, seed, offsets) -> (K,) losses``: validation
    batches gathered from a device-resident split, each scored with
    ``make_eval_step``'s math from ``step_generator(seed, offsets[k])``."""
    return _resident(make_eval_step(schedule, cfg, dataset_mean, dataset_std), train=False)
