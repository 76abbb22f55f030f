"""Dataset reading and batching (port of ``lm2a_tpu/data/dataset.py``).

1. :class:`MelNpzDataset` reads one npz clip at a time and aligns it to the
   mel time axis: mel transposed to (T, 80), motion and lyrics linearly
   interpolated ('interp') or repeat-padded to T.
2. :func:`pack_dataset` / :class:`PackedDataset`: a one-time pack of a split
   into memory-mapped ``.npy`` arrays; a batch is one numpy fancy index per
   array (the JAX package's ``use_native=False`` path; its C++ gatherer is
   not used here).

:class:`BatchIterator` yields stacked numpy batches, shuffled with
``default_rng(seed + epoch)`` and dropping the remainder, so both packages
see the same batches in the same order. :func:`superbatch_iterator` and
:class:`SuperbatchStream` are the fused K-step mode's source: ``("multi",
(K, B, T, .))`` groups then ``("single", (B, T, .))`` tail batches, in the
JAX package's row order, the stream gathering groups ahead across epochs on
a thread of its own. :func:`device_prefetch` stages the next batches onto
the card from a background thread; :func:`upload_dataset` puts a packed
split on the device once (the ``device_data`` form).
"""

from __future__ import annotations

import json
import os
import queue
import threading
import zipfile
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from lm2a_tpu_torch.core.graphs import CAPTURE_LOCK
from lm2a_tpu_torch.data.schema import load_sample, normalize_mel_layout
from lm2a_tpu_torch.ops.moments import RunningMoments
from lm2a_tpu_torch.ops.resample import match_len

_EXCLUDE = {"motion_stats.npz"}
KEYS = ("mel", "motion", "lyrics")
PACK_META = "pack_meta.json"


def list_npz(npz_dir: str) -> List[str]:
    files = sorted(
        f for f in os.listdir(npz_dir) if f.endswith(".npz") and f not in _EXCLUDE
    )
    return [os.path.join(npz_dir, f) for f in files]


class MelNpzDataset:
    """Aligned per-sample access over a directory of npz clips."""

    def __init__(self, npz_dir: str, align_mode: str = "interp"):
        self.npz_dir = npz_dir
        self.files = list_npz(npz_dir)
        self.align_mode = align_mode

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int) -> Dict:
        s = load_sample(self.files[idx])
        mel = normalize_mel_layout(s.mel)
        t = mel.shape[1]
        return {
            "mel": np.ascontiguousarray(mel.T).astype(np.float32),  # (T, 80)
            "motion": match_len(s.motion, t, mode=self.align_mode).astype(np.float32),
            "lyrics": match_len(s.lyrics, t, mode=self.align_mode).astype(np.float32),
            "sr": s.sr,
            "hop_length": s.hop_length,
            "path": self.files[idx],
        }


def pack_dataset(npz_dir: str, out_dir: str, align_mode: str = "interp") -> str:
    """Pack a split into ``mel.npy (N,T,80)``, ``motion.npy (N,T,234)``,
    ``lyrics.npy (N,T,768)`` and ``pack_meta.json`` with the file list."""
    ds = MelNpzDataset(npz_dir, align_mode=align_mode)
    if len(ds) == 0:
        raise ValueError(f"no npz files in {npz_dir}")
    os.makedirs(out_dir, exist_ok=True)
    first = ds[0]
    n = len(ds)
    arrays = {
        key: np.lib.format.open_memmap(os.path.join(out_dir, f"{key}.npy"), mode="w+",
                                       dtype=np.float32, shape=(n,) + first[key].shape)
        for key in KEYS
    }
    for i in range(n):
        item = first if i == 0 else ds[i]
        for key in KEYS:
            arrays[key][i] = item[key]
    for a in arrays.values():
        a.flush()
    meta = {
        "num_samples": n,
        "files": [os.path.basename(f) for f in ds.files],
        "sr": int(first["sr"]),
        "hop_length": int(first["hop_length"]),
        "align_mode": align_mode,
    }
    with open(os.path.join(out_dir, PACK_META), "w") as f:
        json.dump(meta, f)
    return out_dir


class PackedDataset:
    """Memory-mapped packed split; a batch is one fancy index per array."""

    def __init__(self, pack_dir: str):
        self.pack_dir = pack_dir
        with open(os.path.join(pack_dir, PACK_META)) as f:
            self.meta = json.load(f)
        for key in KEYS:
            setattr(self, key, np.load(os.path.join(pack_dir, f"{key}.npy"), mmap_mode="r"))

    def __len__(self) -> int:
        return self.mel.shape[0]

    def gather(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        return {key: np.asarray(getattr(self, key)[idx]) for key in KEYS}


def open_dataset(path: str, align_mode: str = "interp"):
    """A packed directory (it has ``pack_meta.json``) or a directory of npz clips."""
    if os.path.exists(os.path.join(path, PACK_META)):
        return PackedDataset(path)
    return MelNpzDataset(path, align_mode=align_mode)


def _gather(dataset, idx: np.ndarray) -> Dict[str, np.ndarray]:
    if isinstance(dataset, PackedDataset):
        return dataset.gather(idx)
    items = [dataset[int(i)] for i in idx]
    return {k: np.stack([it[k] for it in items]) for k in KEYS}


class BatchIterator:
    """Seeded, shuffled, drop-remainder batches of static shape over a
    :class:`PackedDataset` or a :class:`MelNpzDataset`."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0

    def __len__(self) -> int:
        return len(self.dataset) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        self.epoch += 1
        bs = self.batch_size
        for start in range(0, n - bs + 1, bs):
            yield _gather(self.dataset, order[start:start + bs])


def _epoch_order(n: int, shuffle: bool, seed: int) -> np.ndarray:
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    return order


def _multi(flat: Dict[str, np.ndarray], k: int, bs: int) -> Dict[str, np.ndarray]:
    return {key: v.reshape((k, bs) + v.shape[1:]) for key, v in flat.items()}


def superbatch_indices(n: int, batch_size: int, k: int, shuffle: bool = True,
                       seed: int = 0) -> Iterator[tuple]:
    """The rows of one epoch of the fused K-step mode over ``n`` rows:
    ``("multi", (K, B) rows)`` for each full group of K batches of the
    ``default_rng(seed)`` order, then ``("single", (1, B) rows)`` for each
    tail batch that does not fill a group; the order of
    :func:`superbatch_iterator`, and the rows ``--device_data`` gathers on
    the device."""
    order = _epoch_order(n, shuffle, seed)
    group = batch_size * k
    n_groups = n // group
    for g in range(n_groups):
        yield "multi", order[g * group:(g + 1) * group].reshape(k, batch_size)
    for start in range(n_groups * group, n - batch_size + 1, batch_size):
        yield "single", order[start:start + batch_size][None]


def superbatch_iterator(dataset, batch_size: int, k: int, shuffle: bool = True,
                        seed: int = 0) -> Iterator[tuple]:
    """One epoch of the fused K-step mode: ``("multi", {key: (K, B, T, .)})``
    for each full group of K batches (one K*B-row gather, the rows of K
    consecutive batches of the ``default_rng(seed)`` order), then
    ``("single", {key: (B, T, .)})`` for the tail batches that do not fill a
    group; the JAX package's stream."""
    for tag, rows in superbatch_indices(len(dataset), batch_size, k, shuffle, seed):
        flat = _gather(dataset, rows.reshape(-1))
        yield tag, (_multi(flat, k, batch_size) if tag == "multi" else flat)


class SuperbatchStream:
    """The fused K-step mode's stream across epochs: the batches of
    :func:`superbatch_iterator` with seed ``base_seed + epoch``, while a
    thread of its own gathers up to ``depth`` groups ahead, across epoch
    boundaries (the first groups of epoch e+1 are gathered while epoch e's
    tail, validation and checkpoints run). Epochs are consumed in order; an
    early stop retires the stream with :meth:`drain`."""

    def __init__(self, dataset, batch_size: int, k: int, base_seed: int = 0,
                 shuffle: bool = True, total_epochs: Optional[int] = None,
                 start_epoch: int = 0, depth: int = 2):
        self.ds, self.bs, self.k = dataset, batch_size, k
        self.base_seed, self.shuffle = base_seed, shuffle
        self.n_groups = len(dataset) // (batch_size * k)
        self._next_epoch = start_epoch
        self._queue: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._thread = None
        if self.n_groups and (total_epochs is None or start_epoch < total_epochs):
            self._thread = threading.Thread(target=self._gather_ahead,
                                            args=(start_epoch, total_epochs), daemon=True)
            self._thread.start()

    def _rows(self, epoch: int) -> Iterator[tuple]:
        return superbatch_indices(len(self.ds), self.bs, self.k, self.shuffle,
                                  self.base_seed + epoch)

    def _gather_ahead(self, epoch: int, total_epochs: Optional[int]) -> None:
        while total_epochs is None or epoch < total_epochs:
            for tag, rows in self._rows(epoch):
                if tag != "multi":
                    break
                try:
                    item = (epoch, _multi(_gather(self.ds, rows.reshape(-1)), self.k, self.bs))
                except BaseException as e:  # raised in the consumer
                    item = (epoch, e)
                while not self._stop.is_set():
                    try:
                        self._queue.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set() or isinstance(item[1], BaseException):
                    return
            epoch += 1

    def epoch(self, epoch: int) -> Iterator[tuple]:
        """Epoch ``epoch``'s ("multi"/"single", batch) stream."""
        if epoch != self._next_epoch:
            raise ValueError(f"epochs must be consumed in order: expected "
                             f"{self._next_epoch}, got {epoch}")
        self._next_epoch = epoch + 1
        for _ in range(self.n_groups):
            e, item = self._queue.get()
            if isinstance(item, BaseException):
                raise item
            if e != epoch:
                raise RuntimeError(f"superbatch stream gathered epoch {e} for epoch {epoch}")
            yield "multi", item
        for tag, rows in self._rows(epoch):
            if tag == "single":
                yield tag, _gather(self.ds, rows[0])

    def drain(self) -> None:
        """Retire the stream: stop gathering ahead and drop what is queued."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=60.0)
            self._thread = None
        while not self._queue.empty():
            self._queue.get_nowait()


def upload_dataset(ds, device) -> Dict[str, torch.Tensor]:
    """A packed dataset's ``mel``/``motion``/``lyrics`` arrays on ``device``, once."""
    return {k: torch.from_numpy(np.array(getattr(ds, k), dtype=np.float32)).to(device)
            for k in KEYS}


def device_prefetch(iterator, device, depth: int = 2, tagged: bool = False):
    """Yield the batches of ``iterator`` as dicts of tensors on ``device``
    (``tagged``: ``(tag, batch)`` items, the tag passed through).

    A background thread stages up to ``depth`` batches ahead: on a card it
    copies each batch from pinned host memory with ``non_blocking`` copies
    on a side stream and records an event, holding ``CAPTURE_LOCK`` (so
    none of these calls lands inside a CUDA graph capture); the consumer's
    stream waits on that event before the batch is used. An exception in
    the producer is raised in the consumer. Abandoning the generator stops
    the producer.
    """
    device = torch.device(device)
    cuda = device.type == "cuda"
    copy_stream = torch.cuda.Stream(device) if cuda else None
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    done = object()

    def stage(item):
        tag, batch = item if tagged else (None, item)
        if not cuda:
            out = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
            return tag, out, None
        with CAPTURE_LOCK, torch.cuda.stream(copy_stream):
            out = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                   .to(device, non_blocking=True) for k, v in batch.items()}
            ev = torch.cuda.Event()
            ev.record(copy_stream)
        return tag, out, ev

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        it = iter(iterator)
        try:
            for batch in it:
                if stop.is_set() or not put(stage(batch)):
                    return
            put(done)
        except BaseException as e:  # surfaced in the consumer
            put(e)
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, BaseException):
                raise item
            tag, batch, ev = item
            if ev is not None:
                cur = torch.cuda.current_stream(device)
                cur.wait_event(ev)
                for v in batch.values():
                    v.record_stream(cur)
            yield (tag, batch) if tagged else batch
    finally:
        stop.set()
        t.join(timeout=60.0)


def compute_dataset_stats(npz_dir: str, cap_files: Optional[int] = None):
    """Global mel mean and population std over a split, streamed clip by clip."""
    files = list_npz(npz_dir)
    if cap_files is not None:
        files = files[:cap_files]
    rm = RunningMoments()
    for path in files:
        try:
            d = np.load(path, allow_pickle=True)
            mel = normalize_mel_layout(d["mel"])
        except (OSError, KeyError, ValueError, zipfile.BadZipFile):
            continue
        rm.update(mel.reshape(-1, 1))
    if rm.count == 0:
        raise RuntimeError(f"no mel data found in {npz_dir}")
    return float(rm.mean[0]), float(np.sqrt(rm.m2[0] / rm.count))
