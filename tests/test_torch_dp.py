"""Data parallelism of the port (``core/distributed.py``, the data-parallel
train step of ``training/train_step.py``, ``cli train`` across processes)
against one rank and against the JAX package, on the CPU over gloo.

- Two ranks of four rows each take the JAX package's
  ``make_train_step(mesh=make_mesh())`` step (eight virtual devices of one
  row) over the same global batch of eight, the JAX draws injected at the
  global shape and each rank taking its rows: loss, gradients (Adan's
  ``prev_grad``), parameters and EMA after each of two steps, within
  ``test_torch_train.py``'s tolerances; and the port's one-rank step, the
  same. Both ranks end with the same state, bit for bit; the step's census
  is one all-reduce of the flat gradient buffer and the loss.
- With randomness from the step generator (dropout 0.1 and the CFG drop on),
  two ranks take one rank's steps: each draws at the global shape and keeps
  its rows. The eval step's loss is averaged over the ranks.
- ``cli train`` as two processes (``--coordinator file://... --num_processes
  2 --process_id i``) logs the one-process run's losses, and only rank 0
  writes checkpoints; ``--resume`` continues both alike. fp32 compute, so
  the runs differ by the order of sums alone (``TOL_LOSS``; in bf16 a GEMM
  over one row and over two round differently, which the JAX package's
  two-process test bounds at 2e-4).
"""

import csv
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lm2a_tpu.core.config import DiffusionConfig, LM2AConfig, ModelConfig, TrainConfig
from lm2a_tpu.core.config import config_to_dict as jax_config_to_dict
from lm2a_tpu.core.mesh import make_mesh as jax_make_mesh
from lm2a_tpu.diffusion import make_schedule as jax_make_schedule
from lm2a_tpu.models.factory import build_cond_projection as jax_bcp
from lm2a_tpu.models.factory import build_denoiser as jax_bd
from lm2a_tpu.training import init_train_state as jax_init_train_state
from lm2a_tpu.training.train_step import make_train_step as jax_make_train_step
from lm2a_tpu_torch.core.config import config_from_dict, config_to_dict
from lm2a_tpu_torch.diffusion.schedule import make_schedule
from lm2a_tpu_torch.training.checkpoint import state_arrays
from lm2a_tpu_torch.training.train_step import (
    init_train_state, make_eval_step, make_train_step, step_generator,
)

from _torch_port_util import jax_state_arrays, one_torch_thread, port_train_state, rand  # noqa: F401
from _torch_ranks import REPO, spawn
from test_torch_train import MEAN, STD, TOL_LOSS, assert_state_close, jax_draws

B, T, STEPS = 8, 32, 2
STATE = "state|"


def _cfg(dropout: float) -> LM2AConfig:
    return LM2AConfig(
        model=ModelConfig(base_dim=32, dim_mults=(1, 2), cond_dim=16, time_emb_dim=32,
                          num_res_blocks=1, mid_blocks=1, attn_heads=2, dropout=dropout),
        diffusion=DiffusionConfig(timesteps=50),
        train=TrainConfig(batch_size=B, compute_dtype="float32", opt_backend="xla"),
    )


def _batch(i):
    rng = np.random.default_rng(40 + i)
    return {"mel": MEAN + STD * rand(rng, B, T, 80), "motion": rand(rng, B, T, 234),
            "lyrics": rand(rng, B, T, 768)}


def _state_at(out, i):
    pre = f"{STATE}{i}|"
    return {k[len(pre):]: v for k, v in out.items() if k.startswith(pre)}


@pytest.fixture(scope="module")
def jax_run():
    """Two JAX data-parallel steps over eight virtual devices, the states
    before and after each, and the draws of each step."""
    cfg = _cfg(0.0)
    den, cp = jax_bd(cfg.model, "float32"), jax_bcp(cfg.model, "float32")
    state, tx = jax_init_train_state(den, cp, cfg, jax.random.key(0), seq_len=T)
    mesh = jax_make_mesh()
    assert mesh.devices.size == 8
    step = jax_make_train_step(den, cp, jax_make_schedule(cfg.diffusion), cfg, tx, mesh=mesh,
                               dataset_mean=MEAN, dataset_std=STD)
    states, losses, draws = [jax_state_arrays(state)], [], []
    jstate = jax.tree.map(jnp.copy, state)
    for i in range(STEPS):
        key = jax.random.key(200 + i)
        jb = {k: jnp.asarray(v) for k, v in _batch(i).items()}
        jstate, loss = step(jstate, jb, key)
        states.append(jax_state_arrays(jstate))
        losses.append(float(loss))
        draws.append(jax_draws(key, jb["mel"], cfg.train.cond_drop_prob,
                               cfg.diffusion.timesteps, train=True))
    return dict(cfg=cfg, states=states, losses=losses, draws=draws,
                port_cfg=config_from_dict(jax_config_to_dict(cfg)), jax_state=state)


def _payload(port_cfg, state0, mode, draws=()):
    arrays = {f"{k}_{i}": v for i in range(STEPS) for k, v in _batch(i).items()}
    for i, d in enumerate(draws):
        arrays.update({f"t_{i}": d.t.numpy(), f"noise_{i}": d.noise.numpy()})
        if d.keep is not None:
            arrays[f"keep_{i}"] = d.keep.numpy()
    arrays.update({STATE + k: v for k, v in state0.items()})
    arrays["meta"] = dict(cfg=config_to_dict(port_cfg), batch=B, steps=STEPS, mode=mode,
                          seed=5, mean=MEAN, std=STD)
    return arrays


def test_dp_step_matches_one_rank_and_jax(jax_run, tmp_path):
    cfg = jax_run["port_cfg"]
    outs = spawn("dp_step", 2, tmp_path, _payload(cfg, jax_run["states"][0], "draws",
                                                   jax_run["draws"]))
    assert [o["rows"] for o in outs] == [[0, 4], [4, 8]]
    # one rank of the port over the whole batch, the same draws
    one = port_train_state(cfg, jax_run["jax_state"])
    step = make_train_step(make_schedule(cfg.diffusion), cfg, dataset_mean=MEAN,
                           dataset_std=STD)
    for i in range(STEPS):
        before = state_arrays(one)
        loss = step(one, {k: torch.tensor(v) for k, v in _batch(i).items()},
                    draws=jax_run["draws"][i])
        got = _state_at(outs[0], i)
        assert float(outs[0][f"loss_{i}"]) == pytest.approx(jax_run["losses"][i], rel=TOL_LOSS)
        assert float(outs[0][f"loss_{i}"]) == pytest.approx(float(loss), rel=TOL_LOSS)
        got0 = _state_at(outs[0], i - 1) if i else jax_run["states"][0]
        assert_state_close(got, jax_run["states"][i + 1], got0, jax_run["states"][i],
                           warm=i > 0)
        assert_state_close(got, state_arrays(one), got0, before, warm=i > 0)
        for k, v in got.items():  # the ranks hold one state
            assert np.array_equal(v, _state_at(outs[1], i)[k]), k
    n_params = sum(p.numel() for p in one.params().values())
    for o in outs:
        assert o["census"] == {"collectives": {"all-reduce": 1}, "total": 1,
                               "bytes": (n_params + 1) * 4}


def test_dp_generator_draws_match_one_rank(tmp_path):
    """Dropout and the CFG drop from the step generator: two ranks drawing
    at the global shape take one rank's steps."""
    cfg = _cfg(0.1)
    port_cfg = config_from_dict(jax_config_to_dict(cfg))
    one = init_train_state(port_cfg, 0, "cpu")
    state0 = state_arrays(one)
    outs = spawn("dp_step", 2, tmp_path, _payload(port_cfg, state0, "generator"))
    schedule = make_schedule(port_cfg.diffusion)
    step = make_train_step(schedule, port_cfg, dataset_mean=MEAN, dataset_std=STD)
    for i in range(STEPS):
        before = state_arrays(one)
        loss = step(one, {k: torch.tensor(v) for k, v in _batch(i).items()},
                    generator=step_generator(5, i, "cpu"))
        for o in outs:
            assert float(o[f"loss_{i}"]) == pytest.approx(float(loss), rel=TOL_LOSS)
        got0 = _state_at(outs[0], i - 1) if i else state0
        assert_state_close(_state_at(outs[0], i), state_arrays(one), got0, before, warm=i > 0)
    ev = make_eval_step(schedule, port_cfg, MEAN, STD)(
        one, {k: torch.tensor(v) for k, v in _batch(0).items()},
        generator=step_generator(5, 99, "cpu"))
    for o in outs:
        assert float(o["eval"]) == pytest.approx(float(ev), rel=TOL_LOSS)


# ---------------------------------------------------------------- cli train

TINY = ["--batch_size", "2", "--base_dim", "16", "--dim_mults", "1,2", "--cond_dim", "16",
        "--time_emb_dim", "32", "--num_res_blocks", "1", "--mid_blocks", "1",
        "--attn_heads", "2", "--timesteps", "50", "--log_interval", "1", "--no_tensorboard",
        "--device", "cpu", "--fused_resblock_grad", "--opt_backend", "pallas", "--seed", "3",
        "--save_interval", "2", "--compute_dtype", "float32"]


def _cli(args, world, url=None, timeout=120):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "lm2a_tpu_torch.cli", "train", *TINY, *args]
    if world > 1:
        procs = [subprocess.Popen(cmd + ["--coordinator", url, "--num_processes", str(world),
                                         "--process_id", str(r)], env=env, cwd=REPO,
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(world)]
    else:
        procs = [subprocess.Popen(cmd, env=env, cwd=REPO, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return outs


def _losses(save_dir):
    with open(os.path.join(save_dir, "train_log.csv")) as f:
        rows = list(csv.reader(f))
    return {int(r[1]): float(r[2]) for r in rows[1:] if r[4] == ""}


@pytest.fixture(scope="module")
def pack(tmp_path_factory):
    import chip_smoke

    d = tmp_path_factory.mktemp("dp_data")
    chip_smoke.write_clips(str(d / "clips"), 4, seed=4, mel_t=T, motion_t=6)
    subprocess.run([sys.executable, "-m", "lm2a_tpu_torch.cli", "pack", "--npz_dir",
                    str(d / "clips"), "--out_dir", str(d / "pack")], check=True, cwd=REPO,
                   env=dict(os.environ, PYTHONPATH=REPO), capture_output=True)
    return str(d / "pack")


def test_two_process_cli_train_matches_one_process(pack, tmp_path):
    one, two = str(tmp_path / "one"), str(tmp_path / "two")
    _cli(["--npz_dir", pack, "--save_dir", one, "--epochs", "2"], 1)
    url = "file://" + str(tmp_path / "rendezvous")
    outs = _cli(["--npz_dir", pack, "--save_dir", two, "--epochs", "2"], 2, url)
    assert "process 0/2: backend gloo on cpu" in outs[0]
    assert "process 1/2: backend gloo on cpu" in outs[1]
    assert "saved checkpoint:" in outs[0] and "saved checkpoint:" not in outs[1]
    want, got = _losses(one), _losses(two)
    assert sorted(got) == sorted(want) == [0, 1, 2, 3]
    for s, w in want.items():
        assert got[s] == pytest.approx(w, rel=TOL_LOSS), s
    assert sorted(os.listdir(two)) == sorted(os.listdir(one))
    # both ranks resume from rank 0's checkpoint and go on alike
    _cli(["--npz_dir", pack, "--save_dir", one, "--epochs", "3", "--resume"], 1)
    outs = _cli(["--npz_dir", pack, "--save_dir", two, "--epochs", "3", "--resume"], 2,
                url + "2")
    assert all("resumed from" in o for o in outs)
    want, got = _losses(one), _losses(two)
    assert sorted(got) == sorted(want) == [0, 1, 2, 3, 4, 5]
    for s, w in want.items():
        assert got[s] == pytest.approx(w, rel=TOL_LOSS), s
