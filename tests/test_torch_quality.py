"""The training quality monitor (``training/quality.py``) against the JAX
package's ``QualityMonitor``, on the CPU.

- The monitor's mel: the port's ``QualityMonitor.generate`` and the JAX
  monitor's jitted DDIM program (``uncond_fast`` CFG 2.1, 4 steps, two
  validation clips) on the same EMA weights (moved off the parameters, so
  the EMA is what is read) and the same injected start noise, fp32 on both
  sides: 1e-3 absolute on the de-normalised mel (``test_torch_slice``'s
  figure: a few-step chain of ~20-layer forwards summed in another order);
  the mean metrics within the differences those mels give (1e-3 relative,
  1e-4 absolute).
- ``cli train --quality_every_epochs 1`` (one epoch, a validation split)
  writes ``quality_log.csv`` with the JAX logger's columns and finite
  values, and the JAX loop's noise key (``seed + 777``) is the port's seed.
- The chain entry reads the EMA where the Adan+EMA update writes it: the
  view's parameters are the EMA tensors (the same storage), and after an
  in-place update (a train step, then a direct in-place change) the same
  entry's next run gives a fresh monitor's mel, bit for bit on the CPU, and
  not the previous one; the serving model the entry samples keeps the
  storage of every tensor it reads across those runs.
"""

import copy
import csv
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lm2a_tpu.data.dataset import MelNpzDataset as JaxDataset
from lm2a_tpu.diffusion import make_schedule as jax_make_schedule
from lm2a_tpu.models.factory import build_cond_projection as jax_bcp
from lm2a_tpu.models.factory import build_denoiser as jax_bd
from lm2a_tpu.training import init_train_state as jax_init_train_state
from lm2a_tpu.training import quality as jax_quality
from lm2a_tpu.utils.logging import TrainLogger as JaxLogger
from lm2a_tpu_torch.core.config import config_from_dict
from lm2a_tpu_torch.data.dataset import open_dataset
from lm2a_tpu_torch.diffusion.schedule import make_schedule
from lm2a_tpu_torch.training import quality
from lm2a_tpu_torch.training.train_step import make_train_step

import chip_smoke
from _torch_port_util import TINY_CFG, one_torch_thread, port_train_state, rand  # noqa: F401

MEL_T, CLIPS, STEPS, MEAN, STD = 32, 2, 4, -4.6, 1.9
CFG = dataclasses.replace(TINY_CFG, train=dataclasses.replace(
    TINY_CFG.train, compute_dtype="float32", quality_every_epochs=1, quality_clips=CLIPS,
    quality_steps=STEPS, quality_guidance=2.1))


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    from lm2a_tpu.core.config import config_to_dict as jax_config_to_dict

    val = str(tmp_path_factory.mktemp("val"))
    chip_smoke.write_clips(val, 3, seed=8, mel_t=MEL_T, motion_t=20)
    den, cp = jax_bd(CFG.model, "float32"), jax_bcp(CFG.model, "float32")
    state, _ = jax_init_train_state(den, cp, CFG, jax.random.key(3), seq_len=MEL_T)
    # the EMA moved off the parameters: the monitor must read the EMA
    state = state.replace(ema_params=jax.tree_util.tree_map(lambda a: a * 1.1 + 0.01,
                                                            state.params))
    return dict(val=val, den=den, cp=cp, state=state,
                port_cfg=config_from_dict(jax_config_to_dict(CFG)))


def _x_init():
    return rand(np.random.default_rng(11), CLIPS, MEL_T, 80)


def test_monitor_mel_and_metrics_match_jax(env, monkeypatch):
    x0 = _x_init()
    real_ddim = jax_quality.ddim_sample
    monkeypatch.setattr(jax_quality, "ddim_sample",
                        lambda *a, **kw: real_ddim(*a, x_init=jnp.asarray(x0), **kw))
    jmon = jax_quality.QualityMonitor(
        env["den"], env["cp"], jax_make_schedule(CFG.diffusion), JaxDataset(env["val"]),
        n_clips=CLIPS, num_steps=STEPS, guidance=2.1, dataset_mean=MEAN, dataset_std=STD,
        seed=CFG.train.seed)
    want_mel = np.asarray(jmon._generate(env["state"].ema_params, jmon._motion, jmon._lyrics,
                                         jmon._key))
    want = jmon.run(env["state"].ema_params)

    pstate = port_train_state(env["port_cfg"], env["state"])
    pmon = quality.QualityMonitor(env["port_cfg"], pstate.ema, make_schedule(
        env["port_cfg"].diffusion), open_dataset(env["val"]), n_clips=CLIPS, num_steps=STEPS,
        guidance=2.1, dataset_mean=MEAN, dataset_std=STD, seed=CFG.train.seed)
    got_mel = pmon.generate(torch.tensor(x0))
    assert got_mel.shape == want_mel.shape == (CLIPS, MEL_T, 80)
    np.testing.assert_allclose(got_mel, want_mel, atol=1e-3, rtol=0)
    np.testing.assert_array_equal(pmon._gt_mel, jmon._gt_mel)  # the first clips, unshuffled
    got = pmon.run(torch.tensor(x0))
    assert list(got) == list(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-3, abs=1e-4), k


def test_cli_train_logs_quality_rows(env, tmp_path, monkeypatch):
    import sys

    from lm2a_tpu_torch.cli import __main__ as cli_main

    train_dir = str(tmp_path / "train")
    chip_smoke.write_clips(train_dir, 4, seed=9, mel_t=MEL_T, motion_t=20)
    run = str(tmp_path / "run")
    monkeypatch.setattr(sys, "argv", [
        "lm2a_tpu_torch.cli", "train", "--npz_dir", train_dir, "--val_npz_dir", env["val"],
        "--save_dir", run, "--batch_size", "2", "--epochs", "1", "--base_dim", "16",
        "--dim_mults", "1,2", "--cond_dim", "8", "--time_emb_dim", "16",
        "--num_res_blocks", "1", "--mid_blocks", "1", "--attn_heads", "2", "--timesteps", "8",
        "--quality_every_epochs", "1", "--quality_clips", "2", "--quality_steps", "2",
        "--no_tensorboard", "--device", "cpu", "--seed", "1"])
    cli_main.main()
    with open(os.path.join(run, "quality_log.csv")) as f:
        rows = list(csv.reader(f))
    # the JAX logger's columns for the same metrics
    jlog = JaxLogger(str(tmp_path / "jax_log"), use_tensorboard=False)
    jlog.log_quality(0, 2, {k: 0.0 for k in rows[0][2:]})
    jlog.close()
    with open(tmp_path / "jax_log" / "quality_log.csv") as f:
        jrows = list(csv.reader(f))
    assert rows[0] == jrows[0] == ["epoch", "step", "mse", "ssim", "avg_cos_sim", "mean_error",
                                   "std_error", "snr"]
    assert len(rows) == 2 and rows[1][:2] == ["0", "2"]
    assert all(np.isfinite(float(v)) for v in rows[1][2:])


def test_chain_entry_reads_the_ema_in_place(env):
    pcfg = env["port_cfg"]
    pstate = port_train_state(pcfg, env["state"])
    sched = make_schedule(pcfg.diffusion)
    ds = open_dataset(env["val"])

    def monitor():
        return quality.QualityMonitor(pcfg, pstate.ema, sched, ds, n_clips=CLIPS,
                                      num_steps=STEPS, guidance=2.1, dataset_mean=MEAN,
                                      dataset_std=STD, seed=0)

    mon = monitor()
    views = dict(mon.unet.named_parameters(prefix="unet"))
    views.update(mon.cond_proj.named_parameters(prefix="cond_proj"))
    assert len(views) == len(pstate.ema)
    for name, p in views.items():
        key = name.replace(".", "/", 1)
        assert p.data_ptr() == pstate.ema[key].data_ptr(), key  # the EMA itself, no copy
    def serving_ptrs():  # every tensor the chain entry reads
        ptrs = [p.data_ptr() for p in mon.serving.parameters()]
        for blk in mon.serving.resblocks():
            ptrs += [t.data_ptr() for t in vars(blk.chain).values() if torch.is_tensor(t)]
            if blk.use_attn and blk.cross_attn.folded is not None:
                ptrs += [t.data_ptr() for t in blk.cross_attn.folded.values()]
        return ptrs

    ptrs = serving_ptrs()
    before = mon.generate()
    assert np.array_equal(mon.generate(), before)  # the seeded noise, every run
    entries = dict(mon.chain.steps)

    batch = {k: torch.tensor(v) for k, v in
             (("mel", MEAN + STD * rand(np.random.default_rng(1), 2, MEL_T, 80)),
              ("motion", rand(np.random.default_rng(2), 2, MEL_T, 234)),
              ("lyrics", rand(np.random.default_rng(3), 2, MEL_T, 768)))}
    step = make_train_step(sched, pcfg, dataset_mean=MEAN, dataset_std=STD)
    for _ in range(2):  # the second step moves the parameters, and the EMA with them
        step(pstate, batch, generator=torch.Generator().manual_seed(5))
    after_step = mon.generate()
    assert not np.array_equal(after_step, before)
    np.testing.assert_array_equal(after_step, monitor().generate())
    with torch.no_grad():
        for t in pstate.ema.values():
            t.mul_(1.01)
    moved = mon.generate()
    assert not np.array_equal(moved, after_step)
    np.testing.assert_array_equal(moved, monitor().generate())
    assert dict(mon.chain.steps) == entries  # one entry, reused
    assert serving_ptrs() == ptrs  # refreshed in place, into the storage the entry reads


@pytest.mark.parametrize("fused_attention", [False, True])
def test_refresh_is_prepare_in_place(fused_attention):
    """``UNet1DUltimate.refresh`` of a prepared bf16 model from an fp32
    source gives every tensor ``prepare`` gives the source (parameters,
    chain weights, folded attention weights), bit for bit, each in the
    storage it had."""
    from lm2a_tpu_torch.models.factory import build_denoiser

    model_cfg = dataclasses.replace(TINY_CFG.model, fused_attention=fused_attention)
    torch.manual_seed(0)
    stale = build_denoiser(model_cfg).prepare(torch.bfloat16)
    torch.manual_seed(1)
    src = build_denoiser(model_cfg)
    want = copy.deepcopy(src).prepare(torch.bfloat16)

    def leaves(m):
        out = list(m.parameters())
        for blk in m.resblocks():
            out += [t for t in vars(blk.chain).values() if torch.is_tensor(t)]
            if blk.use_attn and blk.cross_attn.folded is not None:
                out += list(blk.cross_attn.folded.values())
        return out

    ptrs = [t.data_ptr() for t in leaves(stale)]
    assert len(ptrs) == len(leaves(want))
    stale.refresh(src)
    assert [t.data_ptr() for t in leaves(stale)] == ptrs
    for got, exp in zip(leaves(stale), leaves(want)):
        assert got.dtype == exp.dtype and torch.equal(got, exp)
