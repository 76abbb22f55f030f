"""Full training-state checkpoints in the JAX package's layout (port of
``lm2a_tpu/training/checkpoint.py``), so either package resumes the other's.

    <dir>/ckpt_step_<n>/state.npz   flat TrainState, keys = jax.tree_util.keystr
    <dir>/ckpt_step_<n>.meta.json   step, epoch, dataset stats, config

Keys: ``.step``, ``.params['unet'][...]['kernel']`` (and ``'cond_proj'``),
``.ema_params[...]``, ``.opt_state.step`` and
``.opt_state.{m,v,n,prev_grad}[...]`` (``.opt_state[1].step`` and
``.opt_state[1].{m,...}[...]`` for the chained ``fused_opt=False`` form,
whose clip state holds no leaf), each leaf in the flax layout (Dense
kernel ``(in, out)``, Conv kernel ``(K, Cin, Cout)``, ConvTranspose kernel
``(K, Cin, Cout)`` flipped along K (the v1 UNet's ``up_<i>_upconv``),
GroupNorm ``scale``);
bf16 optimizer state stored as its uint16 bit pattern. ``save_checkpoint``
fetches the state to the host on the caller's thread and can write the
archive on a background thread (``CheckpointWriter``); the tmp-dir + rename
protocol never exposes a partial checkpoint.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from lm2a_tpu_torch.checkpoint import STATE_FILE, checkpoint_path, load_metadata
from lm2a_tpu_torch.convert import UNET_CONV_TRANSPOSE
from lm2a_tpu_torch.core.config import LM2AConfig, config_to_dict
from lm2a_tpu_torch.training.adan import STATE_KEYS
from lm2a_tpu_torch.training.train_step import TrainState

_STEP_RE = re.compile(r"^ckpt_step_(\d+)$")

__all__ = ["CheckpointWriter", "checkpoint_path", "latest_checkpoint", "list_checkpoints",
           "load_ema", "load_metadata", "load_state_arrays", "restore_checkpoint",
           "save_checkpoint", "state_arrays"]


def flax_path(name: str, ndim: int) -> Tuple[str, ...]:
    """``"unet/down_0_block_0.conv1.weight"`` -> ``('unet', 'down_0_block_0',
    'conv1', 'kernel')``: a >=2-D weight is a kernel, a 1-D one a GroupNorm
    scale."""
    tree, rest = name.split("/", 1)
    *mods, leaf = rest.split(".")
    if leaf == "weight":
        leaf = "kernel" if ndim >= 2 else "scale"
    return (tree, *mods, leaf)


def keystr(collection: str, path: Tuple[str, ...]) -> str:
    return f".{collection}" + "".join(f"['{p}']" for p in path)


def _transposed(name: str) -> bool:
    """Whether the state leaf ``name`` is a ConvTranspose1d weight."""
    return UNET_CONV_TRANSPOSE(name.rsplit(".", 1)[0]) is not None


def to_flax_layout(t: torch.Tensor, name: str = "") -> torch.Tensor:
    """Linear (out, in) -> (in, out); Conv1d (Cout, Cin, K) -> (K, Cin, Cout);
    ConvTranspose1d (Cin, Cout, K) -> (K, Cin, Cout) flipped along K."""
    if t.ndim == 2:
        return t.t()
    if t.ndim == 3:
        return t.permute(2, 0, 1).flip(0) if _transposed(name) else t.permute(2, 1, 0)
    return t


def from_flax_layout(a: torch.Tensor, name: str = "") -> torch.Tensor:
    if a.ndim == 2:
        return a.t()
    if a.ndim == 3:
        return a.flip(0).permute(1, 2, 0) if _transposed(name) else a.permute(2, 1, 0)
    return a


def _to_numpy(t: torch.Tensor, name: str) -> np.ndarray:
    # always a copy: the arrays outlive the step (an async write reads them later)
    t = to_flax_layout(t.detach(), name).to("cpu", memory_format=torch.contiguous_format,
                                            copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _opt_key(state: TrainState) -> str:
    """The Adan state's collection: ``opt_state``, or index 1 of the chain."""
    return "opt_state[1]" if state.opt.chained else "opt_state"


def _trees(state: TrainState) -> Dict[str, Dict[str, torch.Tensor]]:
    params = state.params()
    trees = {"params": params, "ema_params": state.ema}
    for k in STATE_KEYS:
        trees[f"{_opt_key(state)}.{k}"] = getattr(state.opt, k)
    return trees


def state_arrays(state: TrainState) -> Dict[str, np.ndarray]:
    """The whole state as host arrays under the JAX package's keys."""
    arrays = {".step": np.asarray(state.step, np.int32),
              f".{_opt_key(state)}.step": np.asarray(state.opt.step, np.int32)}
    for coll, tree in _trees(state).items():
        for name, t in tree.items():
            arrays[keystr(coll, flax_path(name, t.ndim))] = _to_numpy(t, name)
    return arrays


def list_checkpoints(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for name in os.listdir(ckpt_dir)
                  if (m := _STEP_RE.match(name)) and os.path.isdir(os.path.join(ckpt_dir, name)))


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    steps = list_checkpoints(ckpt_dir)
    return checkpoint_path(ckpt_dir, steps[-1]) if steps else None


def _write(path: str, arrays: Dict[str, np.ndarray], meta: dict, ckpt_dir: str,
           keep_last: int) -> None:
    tmp = path + ".tmp-write"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, STATE_FILE), **arrays)
    shutil.rmtree(path, ignore_errors=True)
    os.rename(tmp, path)
    with open(path + ".meta.json", "w") as f:
        json.dump(meta, f, indent=2)
    if keep_last and keep_last > 0:
        for old_step in list_checkpoints(ckpt_dir)[:-keep_last]:
            old = checkpoint_path(ckpt_dir, old_step)
            shutil.rmtree(old, ignore_errors=True)
            try:
                os.remove(old + ".meta.json")
            except FileNotFoundError:
                pass


class CheckpointWriter:
    """Writes checkpoints on one background thread: ``save`` returns once
    the state is on the host, ``wait`` joins the write in flight (``save``
    calls it first, so writes never overlap)."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def submit(self, fn) -> None:
        self.wait()

        def run():
            try:
                fn()
            except BaseException as e:  # raised to the caller by wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()


def save_checkpoint(ckpt_dir: str, state: TrainState, cfg: LM2AConfig, *, epoch: int = 0,
                    dataset_mean: float = 0.0, dataset_std: float = 1.0,
                    extra: Optional[dict] = None, keep_last: int = 0,
                    writer: Optional[CheckpointWriter] = None) -> str:
    """Save the full state; ``keep_last > 0`` prunes all but the newest N.
    With ``writer`` the archive is written on its thread. Returns the path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    if writer is not None:
        writer.wait()
    arrays = state_arrays(state)
    path = checkpoint_path(ckpt_dir, state.step)
    meta = {"step": state.step, "epoch": epoch, "dataset_mean": float(dataset_mean),
            "dataset_std": float(dataset_std), "config": config_to_dict(cfg)}
    meta.update(extra or {})
    if writer is None:
        _write(path, arrays, meta, ckpt_dir, keep_last)
    else:
        writer.submit(lambda: _write(path, arrays, meta, ckpt_dir, keep_last))
    return path


def _load_into(dst: torch.Tensor, a: np.ndarray, key: str, name: str) -> None:
    a = np.asarray(a)
    if a.dtype.kind not in "biufc" and a.dtype.itemsize == 2:  # an in-memory bfloat16 array
        a = a.view(np.uint16)
    if a.dtype == np.uint16:
        if dst.dtype != torch.bfloat16:
            raise ValueError(f"checkpoint leaf {key} is bf16, the state wants {dst.dtype}")
        src = torch.from_numpy(np.require(a, requirements="W").view(np.int16)).view(torch.bfloat16)
    else:
        src = torch.from_numpy(np.require(a, requirements="W"))
        if src.dtype != dst.dtype:
            raise ValueError(f"checkpoint leaf {key} is {src.dtype}, the state wants {dst.dtype}")
    src = from_flax_layout(src, name)
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"checkpoint leaf {key} has shape {tuple(a.shape)}, the state "
                         f"expects {tuple(to_flax_layout(dst, name).shape)}")
    dst.copy_(src)


@torch.no_grad()
def load_state_arrays(state: TrainState, arrays: Mapping[str, np.ndarray]) -> None:
    """Copy host arrays under the JAX package's keys into ``state`` (its
    structure, dtypes and device), in place."""
    for coll, tree in _trees(state).items():
        for name, t in tree.items():
            key = keystr(coll, flax_path(name, t.ndim))
            if key not in arrays:
                raise KeyError(f"no leaf {key}")
            _load_into(t, arrays[key], key, name)
    state.step = int(arrays[".step"])
    state.opt.step = int(arrays[f".{_opt_key(state)}.step"])


@torch.no_grad()
def load_ema(path: str, state: TrainState) -> Dict[str, torch.Tensor]:
    """A checkpoint's EMA weights as new tensors keyed, shaped and placed
    like ``state.ema``; ``state`` is left as it is."""
    ema = {k: torch.empty_like(e) for k, e in state.ema.items()}
    with np.load(os.path.join(os.path.abspath(path), STATE_FILE)) as z:
        for name, t in ema.items():
            key = keystr("ema_params", flax_path(name, t.ndim))
            if key not in z.files:
                raise KeyError(f"{path}: no leaf {key}")
            _load_into(t, z[key], key, name)
    return ema


def restore_checkpoint(path: str, state: TrainState) -> dict:
    """Load a checkpoint into ``state`` in place; returns the metadata."""
    path = os.path.abspath(path)
    with np.load(os.path.join(path, STATE_FILE)) as z:
        load_state_arrays(state, z)
    return load_metadata(path) if os.path.exists(path + ".meta.json") else {}
