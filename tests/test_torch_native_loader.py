"""The port's native batch gatherer (``data/native_loader.py``) and its
paths in ``data/dataset.py``, on the CPU.

- ``NativeGather`` gives the rows of the numpy gather and of the JAX
  package's gatherer, for ``gather`` and for queued ``submit``/``wait``
  (FIFO across several requests);
- ``BatchIterator``, ``superbatch_iterator`` and ``SuperbatchStream`` give the
  same batches, bit for bit, on the native and the numpy gatherer, and the
  JAX package's batches; they gather through ``PackedDataset.gather``, so
  the stream's prefetch thread runs the native gather; an abandoned epoch
  leaves the next one's batches intact;
- the library is built under ``build/lm2a_tpu_torch/``, keyed by the source;
  the library shipped beside the source keeps its bytes and mtime.
"""

import hashlib
import os

import numpy as np
import pytest

from lm2a_tpu.data import dataset as jds
from lm2a_tpu.data import native_loader as jnl
from lm2a_tpu_torch.data import dataset as ds
from lm2a_tpu_torch.data import native_loader as nl
from lm2a_tpu_torch.ops._build import BUILD_DIR

from _torch_port_util import one_torch_thread  # noqa: F401

SHIPPED = nl.SRC.parent / "liblm2a_loader.so"
N, T = 23, 12


def _shipped_state():
    if not SHIPPED.exists():
        return None
    return hashlib.sha256(SHIPPED.read_bytes()).hexdigest(), os.stat(SHIPPED).st_mtime_ns


SHIPPED_BEFORE = _shipped_state()  # at import, before any build of this file's


@pytest.fixture(scope="module")
def pack(tmp_path_factory):
    """A packed split of N rows of small, seeded arrays."""
    d = tmp_path_factory.mktemp("pack")
    rng = np.random.default_rng(0)
    for key, width in (("mel", 80), ("motion", 234), ("lyrics", 768)):
        np.save(d / f"{key}.npy", rng.standard_normal((N, T, width)).astype(np.float32))
    (d / ds.PACK_META).write_text('{"num_samples": %d}' % N)
    return str(d)


def test_the_library_builds_under_the_port_build_dir(pack):
    assert nl.native_available(), nl.build_error()
    path = nl.lib_path()
    assert path.exists() and path.parent == BUILD_DIR
    assert path.name.startswith("liblm2a_loader-") and path.suffix == ".so"
    assert nl.build_error() is None
    assert _shipped_state() == SHIPPED_BEFORE  # never rebuilt in place


def _numpy_rows(pack, idx):
    return {k: np.load(os.path.join(pack, f"{k}.npy"))[idx] for k in ds.KEYS}


def _same(a, b):
    assert set(a) == set(b) == set(ds.KEYS)
    for k in ds.KEYS:
        assert a[k].dtype == b[k].dtype == np.float32
        np.testing.assert_array_equal(a[k], b[k])


def _jax_gatherer(pack):
    """The JAX package's native gatherer where it would not rebuild its
    library in place, else its numpy gather."""
    lib = jnl._LIB
    if os.path.exists(lib) and os.path.getmtime(lib) >= os.path.getmtime(jnl._SRC):
        return jnl.NativeGather(pack).gather
    return jds.PackedDataset(pack, use_native=False).gather


@pytest.mark.parametrize("idx", [[0], [5, 5, 1], list(range(N))[::-1], [22, 0, 11, 3, 7]])
def test_gather_matches_numpy_and_jax(pack, idx):
    g = nl.NativeGather(pack)
    idx = np.asarray(idx)
    got = g.gather(idx)
    _same(got, _numpy_rows(pack, idx))
    _same(got, _jax_gatherer(pack)(idx))
    g.close()


def test_submit_wait_is_fifo(pack):
    g = nl.NativeGather(pack)
    reqs = [np.array([1, 2]), np.array([20, 0, 4]), np.array([7]), np.array([3, 3])]
    for r in reqs:
        g.submit(r)
    assert g.pending == 4
    for r in reqs:
        _same(g.wait(), _numpy_rows(pack, r))
    assert g.pending == 0
    with pytest.raises(RuntimeError, match="no submitted request"):
        g.wait()
    with pytest.raises(IndexError):
        g.gather(np.array([N]))
    g.close()


def test_packed_dataset_names_its_gatherer(pack):
    assert ds.PackedDataset(pack).gatherer == "native"
    assert ds.PackedDataset(pack, use_native=False).gatherer == "numpy"
    _same(ds.PackedDataset(pack).gather(np.array([4, 9])),
          ds.PackedDataset(pack, use_native=False).gather(np.array([4, 9])))


def test_gatherer_falls_back_with_the_reason(pack, monkeypatch, capsys):
    monkeypatch.setattr(nl, "_lib_handle", None)
    monkeypatch.setattr(nl, "_build_error", "RuntimeError: g++ failed (rc 1)")
    d = ds.PackedDataset(pack)
    assert d.gatherer == "numpy"
    assert "g++ failed" in capsys.readouterr().out


@pytest.mark.parametrize("bs,seed", [(4, 0), (5, 3), (23, 1)])
def test_batch_iterator_same_batches(pack, bs, seed):
    native, plain = ds.PackedDataset(pack), ds.PackedDataset(pack, use_native=False)
    jax_it = jds.BatchIterator(jds.PackedDataset(pack, use_native=False), bs, seed=seed)
    its = [ds.BatchIterator(native, bs, seed=seed), ds.BatchIterator(plain, bs, seed=seed)]
    for _ in range(2):  # two epochs: seed + epoch
        batches = [list(it) for it in its] + [list(jax_it)]
        assert len(batches[0]) == N // bs
        for a, b, c in zip(*batches):
            _same(a, b)
            _same(a, c)
    assert native.native.pending == 0


def test_abandoned_epoch_leaves_no_stale_batch(pack):
    d = ds.PackedDataset(pack)
    it = ds.BatchIterator(d, 4, seed=2)
    gen = iter(it)
    next(gen)
    gen.close()
    assert d.native.pending == 0  # the iterators queue nothing in the FIFO
    want = list(ds.BatchIterator(ds.PackedDataset(pack, use_native=False), 4, seed=2))
    it.epoch = 0
    for a, b in zip(it, want):
        _same(a, b)


def _count_native_gathers(d):
    """Count the dataset's native gathers (from any thread)."""
    calls, gather = [0], d.native.gather

    def counted(idx):
        calls[0] += 1
        return gather(idx)

    d.native.gather = counted
    return calls


def _tagged_equal(xs, ys):
    assert [t for t, _ in xs] == [t for t, _ in ys]
    for (_, a), (_, b) in zip(xs, ys):
        _same(a, b)


@pytest.mark.parametrize("bs,k", [(2, 2), (3, 4), (4, 3)])
def test_superbatches_same_on_both_gatherers(pack, bs, k):
    native, plain = ds.PackedDataset(pack), ds.PackedDataset(pack, use_native=False)
    got = list(ds.superbatch_iterator(native, bs, k, seed=5))
    want = list(ds.superbatch_iterator(plain, bs, k, seed=5))
    _tagged_equal(got, want)
    _tagged_equal(got, list(jds.superbatch_iterator(jds.PackedDataset(pack, use_native=False),
                                                    bs, k, seed=5)))
    assert got[0][1]["mel"].shape == (k, bs, T, 80)
    assert native.native.pending == 0


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_superbatch_stream_same_on_both_gatherers(pack, depth):
    native, plain = ds.PackedDataset(pack), ds.PackedDataset(pack, use_native=False)
    calls = _count_native_gathers(native)
    streams = [ds.SuperbatchStream(d, 2, 3, base_seed=7, total_epochs=3, depth=depth)
               for d in (native, plain)]
    for e in range(3):
        got, want = (list(s.epoch(e)) for s in streams)
        _tagged_equal(got, want)
        _tagged_equal(got, list(jds.superbatch_iterator(
            jds.PackedDataset(pack, use_native=False), 2, 3, seed=7 + e)))
    assert calls[0] == 3 * len(list(ds.superbatch_indices(N, 2, 3, True, 7)))
    assert native.native.pending == 0
    for s in streams:
        s.drain()


def test_superbatch_stream_drains_on_early_stop(pack):
    d = ds.PackedDataset(pack)
    calls = _count_native_gathers(d)
    s = ds.SuperbatchStream(d, 2, 2, base_seed=1, total_epochs=None, depth=3)
    next(iter(s.epoch(0)))
    thread = s._thread
    s.drain()
    assert not thread.is_alive()
    assert s._queue.empty()
    assert calls[0] >= 1  # the prefetch thread gathered natively
    assert d.native.pending == 0
