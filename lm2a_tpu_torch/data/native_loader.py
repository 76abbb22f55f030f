"""ctypes bindings for the native batch gatherer (port of
``lm2a_tpu/data/native_loader.py``, the same C ABI over the same source,
``native/lm2a_loader.cc``).

The source is compiled with ``g++`` on first use into the port's build
directory (``build/lm2a_tpu_torch/``, beside the CUDA libraries), named by a
hash of the source and flags, so an unchanged source is built once. The
library shipped beside the source is never read or written. When the
toolchain or the build fails, ``native_available()`` is False and
``build_error()`` says why; ``PackedDataset`` then prints the reason and
gathers with numpy.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from lm2a_tpu_torch.ops._build import BUILD_DIR

SRC = Path(__file__).resolve().parents[2] / "native" / "lm2a_loader.cc"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]
KEYS = ("mel", "motion", "lyrics")
_BUILD_LOCK = threading.Lock()
_lib_handle = None
_build_error: Optional[str] = None


def lib_path() -> Path:
    """Where the gatherer's library is built: keyed by the source and flags."""
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"liblm2a_loader-{h.hexdigest()[:16]}.so"


def _build() -> Path:
    out = lib_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    r = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SRC)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"g++ failed (rc {r.returncode}): {r.stderr.strip()}")
    os.replace(tmp, out)
    return out


def _load() -> Optional[ctypes.CDLL]:
    global _lib_handle, _build_error
    if _lib_handle is not None or _build_error is not None:
        return _lib_handle
    with _BUILD_LOCK:
        if _lib_handle is not None or _build_error is not None:
            return _lib_handle
        try:
            lib = ctypes.CDLL(str(_build()))
        except Exception as e:  # no g++, a failed build or load: the reason is kept
            _build_error = f"{type(e).__name__}: {e}"
            return None
        lib.lm2a_loader_open.restype = ctypes.c_void_p
        lib.lm2a_loader_open.argtypes = [ctypes.c_char_p] * 3
        lib.lm2a_loader_rows.restype = ctypes.c_int64
        lib.lm2a_loader_rows.argtypes = [ctypes.c_void_p]
        lib.lm2a_loader_row_elems.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
        ptr_f = ctypes.POINTER(ctypes.c_float)
        ptr_i = ctypes.POINTER(ctypes.c_int64)
        for fn in ("lm2a_loader_gather", "lm2a_loader_submit"):
            f = getattr(lib, fn)
            f.restype = ctypes.c_int
            f.argtypes = [ctypes.c_void_p, ptr_i, ctypes.c_int64, ptr_f, ptr_f, ptr_f]
        lib.lm2a_loader_wait.restype = ctypes.c_int
        lib.lm2a_loader_wait.argtypes = [ctypes.c_void_p]
        lib.lm2a_loader_close.argtypes = [ctypes.c_void_p]
        _lib_handle = lib
        return lib


def native_available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the gatherer is unavailable (None when it built and loaded)."""
    _load()
    return _build_error


class NativeGather:
    """Batch gatherer over a packed split directory (mel/motion/lyrics.npy).

    ``gather(idx)`` is synchronous; ``submit(idx)`` + ``wait()`` overlap
    batch assembly with computation. Up to 4 requests may be queued
    (FIFO); ``wait()`` returns the oldest submitted batch, so readahead
    can cross epoch boundaries.
    """

    def __init__(self, pack_dir: str):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native loader unavailable: {_build_error}")
        self._lib = lib
        paths = [os.path.join(pack_dir, f"{k}.npy").encode() for k in KEYS]
        self._h = lib.lm2a_loader_open(*paths)
        if not self._h:
            raise RuntimeError(f"failed to open packed arrays in {pack_dir}")
        self.rows = int(lib.lm2a_loader_rows(self._h))
        # trailing shapes from the .npy headers
        self.shapes = {k: tuple(np.load(os.path.join(pack_dir, f"{k}.npy"), mmap_mode="r")
                                .shape[1:]) for k in KEYS}
        self._pending = collections.deque()

    @property
    def pending(self) -> int:
        """Number of submitted-but-not-waited requests."""
        return len(self._pending)

    def _alloc(self, n: int) -> Dict[str, np.ndarray]:
        return {k: np.empty((n,) + self.shapes[k], dtype=np.float32) for k in KEYS}

    @staticmethod
    def _ptrs(out: Dict[str, np.ndarray]):
        ptr_f = ctypes.POINTER(ctypes.c_float)
        return [out[k].ctypes.data_as(ptr_f) for k in KEYS]

    def gather(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        idx = np.ascontiguousarray(idx, dtype=np.int64)
        out = self._alloc(len(idx))
        rc = self._lib.lm2a_loader_gather(
            self._h, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(idx),
            *self._ptrs(out))
        if rc != 0:
            raise IndexError(f"native gather failed (rc={rc})")
        return out

    def submit(self, idx: np.ndarray) -> None:
        idx = np.ascontiguousarray(idx, dtype=np.int64)
        out = self._alloc(len(idx))
        rc = self._lib.lm2a_loader_submit(
            self._h, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(idx),
            *self._ptrs(out))
        if rc != 0:
            raise RuntimeError(f"native submit failed (rc={rc})")
        self._pending.append((idx, out))  # keep buffers alive for the worker

    def wait(self) -> Dict[str, np.ndarray]:
        """Return the OLDEST submitted batch (FIFO), blocking until its
        gather has fully completed."""
        if not self._pending:
            raise RuntimeError("no submitted request")
        rc = self._lib.lm2a_loader_wait(self._h)
        _, out = self._pending.popleft()
        if rc != 0:
            raise IndexError(f"native gather failed (rc={rc})")
        return out

    def close(self) -> None:
        if self._h:
            while self._pending:
                self._lib.lm2a_loader_wait(self._h)
                self._pending.popleft()
            self._lib.lm2a_loader_close(self._h)
            self._h = None

    def __del__(self):  # noqa: D105
        try:
            self.close()
        except Exception:
            pass
