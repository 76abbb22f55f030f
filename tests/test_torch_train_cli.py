"""``python -m lm2a_tpu_torch.cli train`` on the CPU at a tiny size, and
checkpoints interchanged with the JAX package both ways.

- The CLI (through the dispatcher): CSV columns, checkpoint names and
  epochs, ``.opt_state.step``; a run stopped at an epoch's end and resumed
  logs the same losses, bit for bit, as one uninterrupted run (per-step
  generators seeded from the run seed and the step);
- JAX's ``restore_checkpoint`` loads a port-written checkpoint (fp32 and
  bf16 optimizer state) into a JAX ``init_train_state`` template, leaf for
  leaf equal;
- the port resumes a JAX-written checkpoint and its next step matches the
  JAX package's next step with injected randomness, within
  ``test_torch_train.py``'s tolerances;
- the refusals: features the port does not have fail loudly; the
  ``--steps_per_call``/``--device_data`` flags (once refused) reach the
  config and the loop.
"""

import csv
import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lm2a_tpu.training import init_train_state as jax_init_train_state
from lm2a_tpu.training import restore_checkpoint as jax_restore
from lm2a_tpu.training import save_checkpoint as jax_save
from lm2a_tpu.training.train_step import make_train_step as jax_make_train_step
from lm2a_tpu_torch.cli import __main__ as cli_main
from lm2a_tpu_torch.cli import train as cli_train
from lm2a_tpu_torch.core.config import config_from_dict
from lm2a_tpu_torch.diffusion.schedule import make_schedule
from lm2a_tpu_torch.training.checkpoint import (
    latest_checkpoint, list_checkpoints, restore_checkpoint, save_checkpoint, state_arrays,
)
from lm2a_tpu_torch.training.train_step import init_train_state, make_train_step

import chip_smoke
from test_torch_train import (
    MEAN, STD, T, assert_state_close, jax_cfg, jax_draws, make_batch, make_setup,
)

from _torch_port_util import jax_state_arrays, one_torch_thread  # noqa: F401

TINY = ["--batch_size", "2", "--base_dim", "32", "--dim_mults", "1,2", "--cond_dim", "16",
        "--time_emb_dim", "32", "--num_res_blocks", "1", "--mid_blocks", "1",
        "--attn_heads", "2", "--timesteps", "50", "--log_interval", "1", "--no_tensorboard",
        "--device", "cpu", "--fused_resblock_grad", "--opt_backend", "pallas", "--seed", "3"]


def _train(monkeypatch, *args):
    monkeypatch.setattr(sys, "argv", ["lm2a_tpu_torch.cli", "train", *TINY, *args])
    cli_main.main()


def _losses(save_dir):
    with open(os.path.join(save_dir, "train_log.csv")) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["epoch", "step", "train_loss", "val_loss", "time_seconds"]
    return {int(r[1]): r[2] for r in rows[1:] if r[4] == ""}  # per-step rows


@pytest.fixture(scope="module")
def pack(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    chip_smoke.write_clips(str(d / "clips"), 4, seed=2, mel_t=T, motion_t=12)
    sys_argv = sys.argv
    sys.argv = ["lm2a_tpu_torch.cli", "pack", "--npz_dir", str(d / "clips"), "--out_dir",
                str(d / "pack")]
    try:
        cli_main.main()
    finally:
        sys.argv = sys_argv
    return str(d / "pack")


def test_cli_train_resume_and_determinism(pack, tmp_path, monkeypatch):
    whole, split = str(tmp_path / "whole"), str(tmp_path / "split")
    _train(monkeypatch, "--npz_dir", pack, "--save_dir", whole, "--epochs", "2",
           "--save_interval", "3")
    assert list_checkpoints(whole) == [4]  # the save at step 3 and the final one
    with open(latest_checkpoint(whole) + ".meta.json") as f:
        meta = json.load(f)
    assert meta["epoch"] == 2 and meta["step"] == 4
    assert meta["config"]["model"]["fused_resblock_grad"]
    assert meta["config"]["train"]["opt_backend"] == "pallas"
    with np.load(os.path.join(latest_checkpoint(whole), "state.npz")) as z:
        assert int(z[".step"]) == int(z[".opt_state.step"]) == 4
    _train(monkeypatch, "--npz_dir", pack, "--save_dir", split, "--epochs", "1")
    assert list_checkpoints(split) == [2]
    _train(monkeypatch, "--npz_dir", pack, "--save_dir", split, "--epochs", "2", "--resume")
    assert list_checkpoints(split) == [2, 4]
    a, b = _losses(whole), _losses(split)
    assert sorted(a) == sorted(b) == [0, 1, 2, 3]
    assert a == b
    assert all(np.isfinite(float(v)) for v in a.values())


@pytest.mark.parametrize("opt_dtype", ["float32", "bfloat16"])
def test_jax_restores_port_checkpoint(tmp_path, opt_dtype):
    jcfg = jax_cfg(True)
    jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(jcfg.train, opt_dtype=opt_dtype))
    from lm2a_tpu.core.config import config_to_dict as jax_config_to_dict
    from lm2a_tpu.models.factory import build_cond_projection, build_denoiser

    pcfg = config_from_dict(jax_config_to_dict(jcfg))
    state = init_train_state(pcfg, 5, "cpu")
    step = make_train_step(make_schedule(pcfg.diffusion), pcfg, dataset_mean=MEAN,
                           dataset_std=STD)
    step(state, {k: torch.tensor(v) for k, v in make_batch(1).items()},
         generator=torch.Generator().manual_seed(0))
    path = save_checkpoint(str(tmp_path), state, pcfg, epoch=1, dataset_mean=MEAN,
                           dataset_std=STD)
    template, _ = jax_init_train_state(build_denoiser(jcfg.model, "float32"),
                                       build_cond_projection(jcfg.model, "float32"), jcfg,
                                       jax.random.key(1), seq_len=T)
    restored, meta = jax_restore(path, template)
    assert meta["epoch"] == 1 and meta["dataset_mean"] == MEAN
    want, got = state_arrays(state), jax_state_arrays(restored)
    assert set(want) == set(got)
    for k, w in want.items():
        g = got[k]
        if w.dtype == np.uint16:  # bf16 state: JAX restores it as bfloat16
            assert g.dtype == jnp.bfloat16
            g = g.view(np.uint16)
        assert g.shape == w.shape and np.array_equal(g, w), k


def test_port_resumes_jax_checkpoint(tmp_path):
    s = make_setup(False)
    cfg, port_cfg = s["cfg"], s["port_cfg"]
    jstep = jax_make_train_step(s["den"], s["cp"], s["schedule"], cfg, s["tx"],
                                dataset_mean=MEAN, dataset_std=STD)
    jstate = jax.tree.map(jnp.copy, s["state"])
    jstate, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in make_batch(30).items()},
                      jax.random.key(30))
    path = jax_save(str(tmp_path), jstate, cfg, epoch=3, dataset_mean=MEAN, dataset_std=STD)
    pstate = init_train_state(port_cfg, 9, "cpu")
    meta = restore_checkpoint(path, pstate)
    assert meta["epoch"] == 3 and pstate.step == pstate.opt.step == 1
    got0, want0 = state_arrays(pstate), jax_state_arrays(jstate)
    for k, w in want0.items():
        assert np.array_equal(got0[k], w), k
    batch, key = make_batch(31), jax.random.key(31)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jstate, jloss = jstep(jstate, jbatch, key)
    draws = jax_draws(key, jbatch["mel"], cfg.train.cond_drop_prob, cfg.diffusion.timesteps,
                      train=True)
    pstep = make_train_step(make_schedule(port_cfg.diffusion), port_cfg, dataset_mean=MEAN,
                            dataset_std=STD)
    loss = pstep(pstate, {k: torch.tensor(v) for k, v in batch.items()}, draws=draws)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    assert_state_close(state_arrays(pstate), jax_state_arrays(jstate), got0, want0, warm=True)


@pytest.mark.parametrize("flags,match", [
    (["--rng", "rbg"], "TPU"),
    # TINY trains with --opt_backend pallas: the chained form runs on the
    # plain update only, and the CUDA kernel refuses it as the JAX package's
    # Pallas updater does
    (["--fused_opt", "0"], "opt_backend='pallas' needs fused_opt=1"),
    # the multi-process flags are ported: what is refused is a coordinator
    # without the world's size and rank, and a model axis wider than the
    # processes
    (["--coordinator", "localhost:1"], "needs a coordinator, num_processes and process_id"),
    (["--model_parallel", "2"], "1 devices not divisible by model=2"),
], ids=["flags0-TPU", "flags1-opt_backend='pallas' needs fused_opt=1", "flags2-multi-host",
        "flags3-multi-host"])
def test_cli_refuses_what_is_not_ported(flags, match, tmp_path):
    with pytest.raises(SystemExit, match=match):
        cli_train.main(["--npz_dir", str(tmp_path), "--save_dir", str(tmp_path / "run"),
                        *TINY, *flags])


def test_cli_steps_per_call_and_device_data_reach_the_loop(pack, tmp_path, monkeypatch):
    """``--steps_per_call 2 --device_data`` (once refused) reach the config
    and the loop: the pack goes onto the device, K = 2 steps a call, and the
    saved config keeps both flags."""
    from lm2a_tpu_torch.training import loop

    seen = {}
    real = loop.make_device_data_multistep

    def spy(*a, **kw):
        multi = real(*a, **kw)

        def call(state, data, idx, seed, offsets):
            seen.setdefault("calls", []).append(list(offsets))
            seen["resident"] = data["mel"].shape[0] == 4 and data["mel"].device.type == "cpu"
            return multi(state, data, idx, seed, offsets)

        return call

    monkeypatch.setattr(loop, "make_device_data_multistep", spy)
    out = tmp_path / "run"
    _train(monkeypatch, "--npz_dir", pack, "--save_dir", str(out), "--epochs", "1",
           "--steps_per_call", "2", "--device_data")
    assert seen == {"calls": [[0, 1]], "resident": True}
    ckpt = latest_checkpoint(str(out))
    with open(ckpt + ".meta.json") as f:
        tc = json.load(f)["config"]["train"]
    assert tc["steps_per_call"] == 2 and tc["device_data"] is True


def test_cli_needs_a_card_unless_cpu(pack, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    args = [a for a in TINY if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_train.main(["--npz_dir", pack, "--save_dir", str(tmp_path / "r"), *args])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_train_state(config_from_dict({}), 0)  # the default device is the card


def test_route_comparison_restores_each_seed_and_catches_a_stale_ema(pack, tmp_path,
                                                                      monkeypatch):
    """``chip_smoke.py``'s phase 4e on the CPU at the tiny size: one step per
    seed from the same state on both routes, and an EMA that is never
    updated fails the EMA check. Limits: the flagship's for the loss and the
    EMA; the gradient and the step at 0.1 (at widths of 32-64 channels the
    bf16 roundings the routes make at different places weigh more: readings
    up to 3.4e-2 per leaf, 3.8e-2 for the step)."""
    from lm2a_tpu_torch.data.dataset import PackedDataset

    _train(monkeypatch, "--npz_dir", pack, "--save_dir", str(tmp_path), "--epochs", "1")
    routes = chip_smoke.route_states(latest_checkpoint(str(tmp_path)), "cpu")
    batch = {k: torch.from_numpy(v) for k, v in PackedDataset(pack).gather(np.arange(2)).items()}
    tol = dict(chip_smoke.ROUTE_TOL, leaf_rel_l2=0.1, grad_rel_l2=0.1, step_rel_l2=0.1)
    first = chip_smoke.route_comparison(routes, batch, "cpu", seeds=(5, 6), tol=tol)
    assert [r["seed"] for r in first] == [5, 6]
    assert first[0]["loss"] != first[1]["loss"]
    assert all(r["ema_change_rel_l2"] <= tol["ema_change_rel_l2"] for r in first)
    state, step = routes["kernel"]

    def stale_ema(state, batch, **kw):
        ema = {k: e.clone() for k, e in state.ema.items()}
        loss = step(state, batch, **kw)
        for k, e in state.ema.items():
            e.copy_(ema[k])
        return loss

    with pytest.raises(chip_smoke.SmokeFailure, match="disagree"):
        chip_smoke.route_comparison(dict(routes, kernel=(state, stale_ema)), batch, "cpu",
                                    seeds=(5,), tol=tol)
