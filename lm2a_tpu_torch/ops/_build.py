"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` (plain C interface, no PyTorch headers) compiles to
its own shared library under ``build/lm2a_tpu_torch/`` at the repository
root, named by a hash of its sources and flags, so an unchanged source is
built once. ``build_all`` starts one ``nvcc`` per source at the same time
and waits for all of them. Nothing is built or loaded at import time: the
first kernel launch (or an explicit ``build_all``) does it.

``launch`` is the single place a kernel is launched from Python: it calls
the C entry, raises if the returned ``cudaError_t`` is not 0, and adds one
to the kernel's count in ``LAUNCHES``. Under a CUDA graph capture
(``recording``) the launch is recorded against that graph instead: a
capture runs nothing, and a replay makes no Python call, so the graph adds
its record to ``LAUNCHES`` at every replay (``count``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from collections import Counter
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, Iterator, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "lm2a_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
]

# kernel name -> launches since the last reset_launches()
LAUNCHES: Counter = Counter()
# the record of the graph being captured (launch() counts into it), or None;
# module-wide, not per thread, because autograd runs a captured backward on
# its own thread
_recording: Optional[Counter] = None

_libs: Dict[str, ctypes.CDLL] = {}
_argtypes: Dict[tuple, list] = {}
build_seconds: float = 0.0
build_log: Dict[str, str] = {}


def reset_launches() -> None:
    LAUNCHES.clear()


@contextmanager
def recording(into: Counter) -> Iterator[Counter]:
    """Count the launches made inside the block into ``into`` (a capture's
    record), not into ``LAUNCHES``."""
    global _recording
    prev, _recording = _recording, into
    try:
        yield into
    finally:
        _recording = prev


def count(launches: Counter) -> None:
    """Add a captured graph's record to ``LAUNCHES``: one replay's launches."""
    LAUNCHES.update(launches)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the lm2a_tpu_torch kernels")


def _sources() -> Dict[str, Path]:
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def _lib_path(name: str, src: Path) -> Path:
    h = hashlib.sha256()
    for p in [src] + sorted(CSRC.glob("*.cuh")):
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> float:
    """Compile every source that has no up-to-date library; returns seconds."""
    global build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name, src in _sources().items():
        out = _lib_path(name, src)
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        build_log[name] = log
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (rc {proc.returncode}) ---\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    build_seconds = time.perf_counter() - t0
    return build_seconds


def library(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        src = _sources()[name]
        path = _lib_path(name, src)
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        for (lib_name, fn_name), argtypes in _argtypes.items():
            if lib_name == name:
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        _libs[name] = lib
    return lib


def declare(lib_name: str, fn_name: str, argtypes: list) -> None:
    """Record a C entry's argument types; applied when the library loads.
    Pointers and the stream are ``c_void_p`` so ctypes never truncates them."""
    _argtypes[(lib_name, fn_name)] = argtypes


# negative codes: refusals of the host side of a C entry, before any launch
HOST_REFUSALS = {
    -1: "cuTensorMapEncodeTiled refused a tensor map of these strides",
    -2: "the kernel's registers at launch cannot fund its setmaxnreg budgets",
    -3: "the kernel does not take this launch plan",
}


def launch(lib_name: str, fn_name: str, kernel: str, *args) -> None:
    """Call C entry ``fn_name`` and count the launch under ``kernel``."""
    fn = getattr(library(lib_name), fn_name)
    err = fn(*args)
    if err != 0:
        why = HOST_REFUSALS.get(err, f"cudaError_t {err}")
        raise RuntimeError(f"CUDA kernel {kernel} ({fn_name}) failed: {why}")
    (LAUNCHES if _recording is None else _recording)[kernel] += 1


def ptr(t) -> ctypes.c_void_p:
    """Device pointer of a tensor (or NULL for None) as a ctypes argument."""
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
