"""The port's training data pipeline against the JAX package's, exactly:
per-clip alignment (both ``align_mode``s), the pack files, gathers,
``BatchIterator``'s seeded order and drop-remainder, ``compute_dataset_stats``
and ``RunningMoments``; and ``device_prefetch`` on the CPU (same batches,
producer errors surfaced, an abandoned consumer stops the producer)."""

import json
import threading

import numpy as np
import pytest
import torch

from lm2a_tpu.data import dataset as jds
from lm2a_tpu.ops.moments import RunningMoments as JaxMoments
from lm2a_tpu_torch.cli import pack as cli_pack
from lm2a_tpu_torch.data import dataset as pds
from lm2a_tpu_torch.data.schema import Sample, save_sample
from lm2a_tpu_torch.ops.moments import RunningMoments

from _torch_port_util import one_torch_thread  # noqa: F401

N_CLIPS, MEL_T, MOTION_T = 7, 20, 9


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    d = tmp_path_factory.mktemp("clips")
    rng = np.random.default_rng(0)
    for i in range(N_CLIPS):
        save_sample(str(d / f"clip_{i:02d}.npz"), Sample(
            mel=(rng.standard_normal((80, MEL_T)) - 5).astype(np.float32),
            motion=rng.standard_normal((MOTION_T, 234)).astype(np.float32),
            lyrics=rng.standard_normal((MOTION_T, 768)).astype(np.float32)))
    return str(d)


@pytest.mark.parametrize("align_mode", ["interp", "repeat"])
def test_clips_align_as_in_jax(clips, align_mode):
    port, ref = pds.MelNpzDataset(clips, align_mode), jds.MelNpzDataset(clips, align_mode)
    assert len(port) == len(ref) == N_CLIPS and port.files == ref.files
    for i in range(N_CLIPS):
        a, b = port[i], ref[i]
        for k in pds.KEYS:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        assert a["mel"].shape == (MEL_T, 80) and a["motion"].shape == (MEL_T, 234)


def test_pack_files_and_gathers_match_jax(clips, tmp_path):
    assert pds.PACK_META == jds.PACK_META
    cli_pack.main(["--npz_dir", clips, "--out_dir", str(tmp_path / "port")])
    jds.pack_dataset(clips, str(tmp_path / "jax"))
    with open(tmp_path / "port" / pds.PACK_META) as f, open(tmp_path / "jax" / pds.PACK_META) as g:
        assert json.load(f) == json.load(g)
    for k in pds.KEYS:
        assert np.array_equal(np.load(tmp_path / "port" / f"{k}.npy"),
                              np.load(tmp_path / "jax" / f"{k}.npy"))
    port = pds.open_dataset(str(tmp_path / "port"))
    ref = jds.PackedDataset(str(tmp_path / "jax"), use_native=False)
    assert isinstance(port, pds.PackedDataset) and len(port) == len(ref) == N_CLIPS
    idx = np.array([4, 0, 6])
    for k, v in port.gather(idx).items():
        assert np.array_equal(v, ref.gather(idx)[k])


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "npz"])
def test_batch_order_matches_jax(clips, tmp_path, packed):
    if packed:
        pds.pack_dataset(clips, str(tmp_path / "p"))
        port = pds.PackedDataset(str(tmp_path / "p"))
        ref = jds.PackedDataset(str(tmp_path / "p"), use_native=False)
    else:
        port, ref = pds.MelNpzDataset(clips), jds.MelNpzDataset(clips)
    for seed in (0, 3):
        pit, rit = pds.BatchIterator(port, 3, seed=seed), jds.BatchIterator(ref, 3, seed=seed)
        assert len(pit) == len(rit) == N_CLIPS // 3
        for _ in range(2):  # two epochs: seed + epoch
            pb, rb = list(pit), list(rit)
            assert len(pb) == len(rb) == 2  # the remainder is dropped
            for a, b in zip(pb, rb):
                for k in pds.KEYS:
                    assert np.array_equal(a[k], b[k]), k
    unshuffled = list(pds.BatchIterator(port, 2, shuffle=False))
    assert np.array_equal(unshuffled[0]["mel"], np.stack([port_item(port, i) for i in (0, 1)]))


def port_item(ds, i):
    return ds.gather(np.array([i]))["mel"][0] if isinstance(ds, pds.PackedDataset) else ds[i]["mel"]


def test_dataset_stats_and_moments_match_jax(clips):
    assert pds.compute_dataset_stats(clips) == jds.compute_dataset_stats(clips)
    assert pds.compute_dataset_stats(clips, cap_files=3) == jds.compute_dataset_stats(clips, 3)
    rng = np.random.default_rng(1)
    port, ref = RunningMoments(), JaxMoments()
    for n in (5, 1, 17):
        rows = rng.standard_normal((n, 4))
        port.update(rows)
        ref.update(rows)
    assert port.count == ref.count
    np.testing.assert_array_equal(port.mean, ref.mean)
    np.testing.assert_array_equal(port.std(), ref.std())


def test_device_prefetch_on_the_cpu():
    batches = [{"mel": np.full((2, 3), i, np.float32)} for i in range(5)]
    got = list(pds.device_prefetch(iter(batches), "cpu"))
    assert [int(b["mel"][0, 0]) for b in got] == list(range(5))
    assert all(isinstance(b["mel"], torch.Tensor) for b in got)

    def broken():
        yield batches[0]
        raise OSError("disk gone")

    with pytest.raises(OSError, match="disk gone"):
        list(pds.device_prefetch(broken(), "cpu"))

    def endless():
        i = 0
        while True:
            yield {"mel": np.zeros(1, np.float32) + i}
            i += 1

    before = threading.active_count()
    gen = pds.device_prefetch(endless(), "cpu")
    next(gen)
    gen.close()  # an abandoned consumer retires the producer
    assert threading.active_count() == before
