"""Tensor parallelism: the training state physically sharded over the mesh's
model axis (port of ``lm2a_tpu/parallel/tensor.py``).

One rule decides both packages: ``_leaf_spec`` is the JAX package's, read
on the JAX names and layouts of the port's leaves (``jax_leaf``: the
``convert.py`` table, conv kernels ``(K, Cin, Cout)``, dense ``(in, out)``).
Kernels are sharded on their output features (column-parallel), those of
``conv2`` and ``out_proj`` on their input features (row-parallel), and
1-D biases and scales on their only axis where divisible; the rest is
replicated. Each rank holds 1/TP of every eligible parameter, EMA leaf and
Adan moment (``prev_grad`` included): at TP=4 the flagship's optimizer
state drops to a quarter a rank.

The state is sharded, the compute replicated: a step all-gathers the
parameter shards (one flat all-gather over the model axis) into the working
copy the modules read, runs the replicated step's forward and backward
through the same kernels on every rank of a model line, averages the
gradients over the data axis, then updates this rank's shards with the
Adan+EMA kernel. Every rank then holds the whole gradient, so the clip's
norm is the replicated step's (``global_norm`` of the whole gradient, the
same bits, no collective) and the update is the replicated update's shard.
The working copy is freed after the update. Splitting the compute itself
(column-parallel outputs, the row-parallel ``conv2`` and ``out_proj``
reduced) is not ported.

``make_tp_sampler`` gathers the denoiser's shards into a serving model
once a call and runs the usual chain on it.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch

from lm2a_tpu_torch.convert import UNET_CONV_TRANSPOSE
from lm2a_tpu_torch.core import distributed
from lm2a_tpu_torch.core.draws import RowShard
from lm2a_tpu_torch.core.mesh import DATA_AXIS, MODEL_AXIS, Mesh
from lm2a_tpu_torch.ops.adan import N_SCALARS, global_norm
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


@dataclass
class TPState:
    """A TrainState whose ``ema`` and ``opt`` hold this rank's shards, with
    ``params`` the parameter shards and ``dims`` each leaf's sharded
    dimension; the modules' parameters are the working copy a step gathers
    (empty between steps for sharded leaves)."""

    state: TrainState
    params: Dict[str, torch.Tensor]
    dims: Dict[str, Optional[int]]
    mesh: Mesh
    grads: Dict[str, torch.Tensor]  # contiguous shards of the step's gradient

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
    are dropped, the modules' sharded parameters freed until a step gathers
    them). Returns ``(TPState, shardings)``. The input state is consumed."""
    shardings = state_shardings_tp(state, mesh)
    dims = shardings["params"]
    r, tp = mesh.axis_index(MODEL_AXIS), mesh.shape[MODEL_AXIS]

    def shard(tree):
        return {k: _piece(t, dims[k], r, tp).contiguous().clone() if dims[k] is not None else t
                for k, t in tree.items()}

    params = {k: _piece(p.detach(), dims[k], r, tp).contiguous().clone()
              if dims[k] is not None else p.detach() for k, p in state.params().items()}
    state.ema = shard(state.ema)
    o = state.opt
    state.opt = AdanState(o.step, *(shard(getattr(o, k)) for k in STATE_KEYS), chained=o.chained)
    grads = {k: torch.empty_like(v) for k, v in params.items()}
    tps = TPState(state, params, dims, mesh, grads)
    release_params(tps)
    return tps, shardings


def gather_whole(shards: Dict[str, torch.Tensor], dims: Dict[str, Optional[int]],
                 mesh: Mesh) -> Dict[str, torch.Tensor]:
    """Every sharded leaf of ``shards`` whole again: one flat all-gather of
    this rank's shards over the model axis, each leaf's pieces put back
    along its dimension (ranks in axis order)."""
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
    """The working copy: every sharded parameter all-gathered over the model
    axis into the module's parameter."""
    named = tps.state.params()
    for k, whole in gather_whole(tps.params, tps.dims, tps.mesh).items():
        named[k].data = whole


def release_params(tps: TPState) -> None:
    """Free the working copy of the sharded parameters (the replicated ones
    are the shards themselves)."""
    for k, p in tps.state.params().items():
        p.data = tps.params[k] if tps.dims[k] is None else p.data.new_empty(0)


def make_tp_train_step(schedule, cfg, optimizer, mesh: Mesh, state_template: TrainState,
                       dataset_mean: float = 0.0, dataset_std: float = 1.0):
    """Data-parallel batch and tensor-parallel state in one step. Returns
    ``(train_step, state_shardings)``: ``train_step(tps, batch,
    generator=None, draws=None) -> loss`` over this rank's rows of the
    global batch (ranks of a model line take the same rows), ``tps`` from
    ``shard_state_tp``. See the module docstring."""
    shardings = state_shardings_tp(state_template, mesh)
    group = data_group(mesh)
    opt = copy.copy(optimizer)

    def train_step(tps: TPState, batch, generator=None, draws=None) -> torch.Tensor:
        st = tps.state
        gather_params(tps)
        params = st.params()
        whole = [p.grad for p in params.values()]
        opt.norm_fn = lambda _shards: global_norm(whole)  # the clip's norm: the whole gradient's
        torch._foreach_zero_(whole)
        if group is not None and isinstance(generator, torch.Generator):
            b = batch["mel"].shape[0]
            n = b * mesh.shape[DATA_AXIS]
            generator = RowShard(generator, distributed.local_batch_slice(mesh, n), n)
        loss = loss_fn(st, schedule, batch, cfg, dataset_mean=dataset_mean,
                       dataset_std=dataset_std, train=True, generator=generator, draws=draws)
        loss.backward()
        if group is not None:
            st.grads[-1:].copy_(loss.detach().float().view(1))
            distributed.all_reduce(st.grads, group, mean=True)
            loss = st.grads[-1].clone()
        with torch.no_grad():
            for k, p in params.items():
                tps.grads[k].copy_(_piece(p.grad, tps.dims[k], tps.index, tps.parts))
        scal = opt.stage_scalars(st.opt.step, torch.empty(N_SCALARS, dtype=torch.float32,
                                                          device=loss.device))
        opt.apply(tps.params, tps.grads, st.ema, st.opt, scal)
        release_params(tps)
        st.step += 1
        st.opt.step += 1
        return loss.detach()

    return train_step, shardings


def make_tp_sampler(apply_fn, schedule, mesh: Mesh, params_template: Dict[str, torch.Tensor],
                    guidance_weight: float = 1.0, method: str = "ddpm", **kwargs):
    """A sampling chain of a denoiser whose parameters stay sharded over the
    model axis between calls. ``apply_fn`` is an fp32 denoiser (its
    parameters are the template the shards fill); ``params_template`` its
    named parameters. Returns ``run(params, generator, shape, motion_f=None,
    text_f=None, x_init=None, noise_seq=None)`` with ``params`` this rank's
    shards (e.g. the ``"unet/..."`` leaves of a TPState's EMA, prefix
    dropped): gathered into the serving form once a call, then the usual
    chain (``kwargs`` go to the sampler: ``num_steps``, ``uncond_fast``,
    ``dtype``)."""
    from lm2a_tpu_torch.diffusion.gaussian import ddim_sample, ddpm_sample

    sample = {"ddpm": ddpm_sample, "ddim": ddim_sample}[method]
    dims = tp_shardings({f"unet/{k}": v for k, v in params_template.items()}, mesh)
    dims = {k.split("/", 1)[1]: d for k, d in dims.items()}
    kwargs = dict(kwargs)
    dtype = kwargs.pop("dtype", torch.bfloat16)
    serving = copy.deepcopy(apply_fn).prepare(dtype)

    @torch.no_grad()
    def run(params: Dict[str, torch.Tensor], generator, shape, motion_f=None, text_f=None,
            **kw):
        whole = gather_whole({k: params[k] for k in dims}, dims, mesh)
        for k, p in apply_fn.named_parameters():
            p.copy_(whole.get(k, params[k]))
        serving.refresh(apply_fn)
        return sample(serving, schedule, shape, motion_f, text_f,
                      guidance_weight=guidance_weight, generator=generator, **kwargs, **kw)

    run.shardings = dims
    return run
