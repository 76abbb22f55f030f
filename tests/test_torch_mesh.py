"""The port's mesh and multi-process layer (``core/mesh.py``,
``core/distributed.py``) in one process and its refusals, mirroring
``tests/test_multihost.py::TestSingleProcessDegenerate`` of the JAX
package; and ``cli train``'s four multi-process flags.

- One process (no group): the whole batch is this process's, the helpers
  are no-ops, ``make_hybrid_mesh`` is ``make_mesh``; cells of one rank along
  the model axis repeat its rows.
- ``init_distributed``: the explicit arguments win over ``LM2A_*``, which
  win over nothing (False); a coordinator without the world's size and rank
  is refused; the backend is NCCL only where every rank of a host has a
  card of its own.
- The JAX package's ``ValueError``s: a model axis that does not divide the
  devices, a mesh whose shape is not the device count, a model axis wider
  than a host's ranks, a process whose rows are not contiguous.
- ``cli train`` takes ``--coordinator``, ``--num_processes``,
  ``--process_id`` and ``--model_parallel`` (one gloo process on the CPU
  trains); two processes refuse ``--steps_per_call 2`` and
  ``--device_data`` with the JAX loop's message.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from lm2a_tpu_torch.core import distributed
from lm2a_tpu_torch.core.mesh import (
    DATA_AXIS, MODEL_AXIS, Mesh, batch_sharding, make_mesh, replicated, shard_batch,
)

from _torch_port_util import one_torch_thread  # noqa: F401
from _torch_ranks import REPO
from test_torch_dp import TINY, pack  # noqa: F401


class TestSingleProcessDegenerate:
    def test_local_batch_slice_is_full_range(self):
        assert distributed.local_batch_slice(make_mesh(), 16) == slice(0, 16)

    def test_local_batch_slice_model_axis_repeats_rows(self):
        # one process holding every cell of a (4, 2) mesh, as the JAX test's
        mesh = Mesh(np.zeros((4, 2), dtype=int), rank=0)
        assert distributed.local_batch_slice(mesh, 8) == slice(0, 8)
        # a rank's model line repeats its data row's slice
        mesh = Mesh(np.arange(8).reshape(4, 2), rank=5)
        assert distributed.local_batch_slice(mesh, 8) == slice(4, 6)
        assert batch_sharding(mesh).rows(8) == slice(4, 6)
        assert replicated(mesh).rows(8) == slice(0, 8)

    def test_put_global_batch_matches_the_host_arrays(self):
        mesh = make_mesh()
        batch = {"mel": np.random.default_rng(0).normal(size=(8, 4, 3)).astype(np.float32)}
        out = distributed.put_global_batch(mesh, batch)
        np.testing.assert_array_equal(out["mel"].numpy(), batch["mel"])
        assert batch_sharding(mesh).spec == (DATA_AXIS,)
        np.testing.assert_array_equal(shard_batch(mesh, batch)["mel"].numpy(), batch["mel"])

    def test_hybrid_mesh_single_process_is_make_mesh(self):
        m = distributed.make_hybrid_mesh()
        assert m.axis_names == (DATA_AXIS, MODEL_AXIS) and m.devices.shape == (1, 1)
        assert m.shape == make_mesh().shape == {DATA_AXIS: 1, MODEL_AXIS: 1}

    def test_collectives_and_barrier_are_no_ops(self):
        t = torch.arange(4.0)
        assert distributed.all_reduce(t, None) is t
        assert distributed.all_gather(t[None], None).shape == (1, 4)
        assert distributed.halo_exchange(t[None], None, 1, 1) == (None, None)
        distributed.barrier("x")
        distributed.put_replicated(make_mesh(), [t])
        assert distributed.is_primary() and distributed.process_count() == 1


@pytest.fixture
def fake_init(monkeypatch):
    seen = {}

    def init(backend, init_method=None, world_size=None, rank=None, timeout=None, **kw):
        seen.update(backend=backend, url=init_method, world=world_size, rank=rank, **kw)

    import torch.distributed as dist

    monkeypatch.setattr(dist, "init_process_group", init)
    monkeypatch.setattr(distributed, "_info", {})
    for k in ("LM2A_COORDINATOR", "LM2A_NUM_PROCESSES", "LM2A_PROCESS_ID",
              "LOCAL_WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    return seen


def test_init_distributed_precedence(fake_init, monkeypatch):
    assert distributed.init_distributed(device="cpu") is False and not fake_init
    monkeypatch.setenv("LM2A_COORDINATOR", "10.0.0.1:9")
    monkeypatch.setenv("LM2A_NUM_PROCESSES", "4")
    monkeypatch.setenv("LM2A_PROCESS_ID", "3")
    assert distributed.init_distributed(device="cpu")
    assert fake_init == dict(backend="gloo", url="tcp://10.0.0.1:9", world=4, rank=3)
    assert distributed.init_distributed("127.0.0.1:7", 2, 1, device="cpu")
    assert fake_init == dict(backend="gloo", url="tcp://127.0.0.1:7", world=2, rank=1)
    assert distributed.init_distributed("file:///tmp/x", device="cpu")
    assert fake_init["url"] == "file:///tmp/x" and fake_init["world"] == 4


def test_init_distributed_refuses_a_partial_world(fake_init):
    with pytest.raises(ValueError, match="needs a coordinator, num_processes and process_id"):
        distributed.init_distributed("127.0.0.1:7", device="cpu")


def test_backend_rule():
    assert distributed.choose_backend("cpu", 2, 0) == "gloo"
    assert distributed.choose_backend("cuda", 2, 1) == "gloo"  # two ranks share one card
    assert distributed.choose_backend("cuda", 1, 1) == "nccl"
    assert distributed.choose_backend("cuda", 4, 4) == "nccl"


def test_mesh_errors(monkeypatch):
    with pytest.raises(ValueError, match="3 devices not divisible by model=2"):
        make_mesh(world=3, model=2)
    with pytest.raises(ValueError, match=r"mesh 3x2 != 4 devices"):
        make_mesh(world=4, data=3, model=2)
    monkeypatch.setattr(distributed, "process_count", lambda: 4)
    monkeypatch.setattr(distributed, "_info", {"local_world": 2})
    with pytest.raises(ValueError, match="model=4 must divide the per-granule device count 2"):
        distributed.make_hybrid_mesh(model=4)


def test_local_batch_slice_refuses_non_contiguous_rows():
    mesh = Mesh(np.array([[0], [1], [0]]), rank=0)
    with pytest.raises(ValueError, match="non-contiguous batch rows"):
        distributed.local_batch_slice(mesh, 6)


def test_cli_train_takes_the_multi_process_flags(pack, tmp_path, capsys):  # noqa: F811
    from lm2a_tpu_torch.cli import train as cli_train

    cli_train.main(["--npz_dir", pack, "--save_dir", str(tmp_path / "run"), *TINY,
                    "--epochs", "1", "--coordinator", "file://" + str(tmp_path / "rdv"),
                    "--num_processes", "1", "--process_id", "0", "--model_parallel", "1"])
    out = capsys.readouterr().out
    assert "process 0/1: backend gloo on cpu" in out and "training done: step=2" in out
    assert os.path.isdir(tmp_path / "run" / "ckpt_step_2")
    assert distributed.process_count() == 1  # the group is gone again


@pytest.mark.parametrize("flags", [["--steps_per_call", "2"],
                                   ["--steps_per_call", "2", "--device_data"]])
def test_two_processes_refuse_the_single_process_modes(pack, tmp_path, flags):  # noqa: F811
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "lm2a_tpu_torch.cli", "train", *TINY, "--npz_dir", pack,
           "--save_dir", str(tmp_path / "run"), *flags, "--coordinator",
           "file://" + str(tmp_path / "rdv"), "--num_processes", "2"]
    procs = [subprocess.Popen(cmd + ["--process_id", str(r)], env=env, cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode != 0
        assert "steps_per_call>1 / --device_data are single-process modes" in out, out[-2000:]
