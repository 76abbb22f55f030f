"""The v1 UNet (``UNet1D``, ``arch='v1'``) of the port against the JAX
package's, on the CPU, at base width 16, dim_mults (1, 2), 4 heads (head
dims 4, 8 and 12; GroupNorm's 8 groups at 16, 32 and 48 channels).

- the forward with the weights of a JAX init carried across (transposed
  convs flipped along K), at T = 64 and at T = 13, where the up path's
  transposed conv gives 12 frames against the skip's 13 (``_fix_time_len``):
  plain (unprepared; 1e-5 absolute and relative, only float sums in another
  order), prepared (folded attention, as JAX's ``folded_attention``; 1e-4
  absolute: the fold reassociates the out and fuse projections), prepared
  with the CFG constant ``uncond_rows`` (1e-4), and on the fused attention
  route (the CPU's plain core against JAX's Pallas kernel in interpret mode;
  1e-5 absolute, 1e-4 relative);
- two train steps against the JAX ``make_train_step`` on the kernel route
  (``--opt_backend pallas``; the tolerances of ``tests/test_torch_train.py``)
  and the eval step;
- a DDIM chain under CFG with injected start noise against ``lm2a_tpu``'s
  (1e-3 absolute on the de-normalised mel, ``tests/test_torch_slice.py``'s
  figure);
- checkpoints both ways: the port's full state restored by JAX and the
  JAX's restored by the port, leaf for leaf; the port's params-only writer's
  flax tree applied by the JAX ``UNet1D``, its forward the port's within 1e-4;
- ``cli train --arch v1`` (2 steps, then ``--resume`` for 2 at K = 2), ``cli
  sample`` of its checkpoint and ``cli distill`` with a v1 teacher and
  student, on the CPU.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lm2a_tpu.core.config import DiffusionConfig, LM2AConfig, ModelConfig, TrainConfig
from lm2a_tpu.core.config import config_to_dict as jax_config_to_dict
from lm2a_tpu.diffusion import make_schedule as jax_make_schedule
from lm2a_tpu.diffusion.gaussian import ddim_sample as jax_ddim
from lm2a_tpu.models.factory import build_cond_projection as jax_bcp
from lm2a_tpu.models.factory import build_denoiser as jax_bd
from lm2a_tpu.training import init_train_state as jax_init_train_state
from lm2a_tpu.training import restore_checkpoint as jax_restore
from lm2a_tpu.training import save_checkpoint as jax_save
from lm2a_tpu.training.train_step import make_eval_step as jax_make_eval_step
from lm2a_tpu.training.train_step import make_train_step as jax_make_train_step
from lm2a_tpu_torch.cli import __main__ as cli_main
from lm2a_tpu_torch.convert import UNET_CONV_TRANSPOSE
from lm2a_tpu_torch.core.config import config_from_dict
from lm2a_tpu_torch.diffusion.gaussian import ddim_sample
from lm2a_tpu_torch.diffusion.schedule import make_schedule
from lm2a_tpu_torch.inference.sample import load_models
from lm2a_tpu_torch.models.factory import build_denoiser, param_count
from lm2a_tpu_torch.models.unet1d import UNet1D
from lm2a_tpu_torch.training.checkpoint import (
    latest_checkpoint, list_checkpoints, restore_checkpoint, save_checkpoint, state_arrays,
)
from lm2a_tpu_torch.training.train_step import (
    init_train_state, make_eval_step, make_train_step,
)

import chip_smoke
from test_torch_train import MEAN, STD, assert_state_close, jax_draws

from _torch_port_util import (  # noqa: F401
    jax_state_arrays, load_jax_params, max_err, one_torch_thread, port_train_state, rand,
)

KEY = jax.random.key(0)
MC = ModelConfig(arch="v1", base_dim=16, dim_mults=(1, 2), cond_dim=8, time_emb_dim=16,
                 attn_heads=4)
B, T = 2, 32


def _port(mc):
    return config_from_dict(jax_config_to_dict(LM2AConfig(model=mc))).model


@pytest.fixture(scope="module")
def jax_params():
    rng = np.random.default_rng(0)
    x, m, l = rand(rng, 2, 64, 80), rand(rng, 2, 64, 8), rand(rng, 2, 64, 8)
    return jax.jit(jax_bd(MC).init)(KEY, x, np.array([3, 7], np.int32), m, l)["params"]


def _inputs(seed, t, uncond=0):
    rng = np.random.default_rng(seed)
    x, m, l = rand(rng, 2, t, 80), rand(rng, 2, t, 8), rand(rng, 2, t, 8)
    if uncond:
        m[:uncond] = 0.0
        l[:uncond] = 0.0
    return x, np.array([5, 31], np.int32), m, l


def _jax_apply(mc, params, inputs, **kw):
    fn = jax.jit(jax_bd(mc).apply, static_argnames=("uncond_rows",))
    return np.asarray(fn({"params": params}, *inputs, **kw))


def _port_apply(model, inputs, **kw):
    x, ts, m, l = (torch.tensor(a) for a in inputs)
    with torch.no_grad():
        return model(x, ts.long(), m, l, **kw).numpy()


def test_v1_builds_with_the_jax_tree(jax_params):
    model = build_denoiser(_port(MC))
    assert isinstance(model, UNet1D)
    load_jax_params(model, jax_params, UNET_CONV_TRANSPOSE)  # strict: every leaf carried
    assert param_count(model) == sum(a.size for a in jax.tree.leaves(jax_params))
    with torch.device("meta"):  # the flagship v1: the parameter count of its JAX init
        assert param_count(build_denoiser(_port(ModelConfig(arch="v1")))) == 88_168_016


@pytest.mark.parametrize("t", [64, 13])
def test_forward_plain_matches_jax(jax_params, t):
    inputs = _inputs(t, t)
    model = load_jax_params(build_denoiser(_port(MC)), jax_params, UNET_CONV_TRANSPOSE)
    got = _port_apply(model, inputs)
    assert got.shape == (2, t, 80) and got.dtype == np.float32
    np.testing.assert_allclose(got, _jax_apply(MC, jax_params, inputs), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("t", [64, 13])
def test_forward_folded_and_uncond_rows_match_jax(jax_params, t):
    folded = dataclasses.replace(MC, folded_attention=True)
    model = load_jax_params(build_denoiser(_port(MC)), jax_params,
                            UNET_CONV_TRANSPOSE).prepare(torch.float32)
    inputs = _inputs(t + 1, t)
    np.testing.assert_allclose(_port_apply(model, inputs), _jax_apply(folded, jax_params, inputs),
                               atol=1e-4, rtol=0)
    inputs = _inputs(t + 2, t, uncond=1)
    want = _jax_apply(folded, jax_params, inputs, uncond_rows=1)
    got = _port_apply(model, inputs, uncond_rows=1)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(_port_apply(model, inputs), got, atol=1e-5, rtol=0)


def test_forward_fused_attention_matches_jax(jax_params):
    fused = dataclasses.replace(MC, fused_attention=True)
    model = load_jax_params(build_denoiser(_port(fused)), jax_params,
                            UNET_CONV_TRANSPOSE).prepare(torch.float32)
    assert all(a.fused and a.folded is None for a in model.attention_modules())
    inputs = _inputs(5, 24, uncond=1)
    np.testing.assert_allclose(_port_apply(model, inputs, uncond_rows=1),
                               _jax_apply(fused, jax_params, inputs, uncond_rows=1),
                               atol=1e-5, rtol=1e-4)


def test_with_fused_attention_and_refresh(jax_params):
    """The shared interface: a fused view over the same weights, and a
    prepared copy refreshed in place from fp32 parameters."""
    src = load_jax_params(build_denoiser(_port(MC)), jax_params, UNET_CONV_TRANSPOSE)
    served = load_jax_params(build_denoiser(_port(MC)), jax_params,
                             UNET_CONV_TRANSPOSE).prepare(torch.float32)
    inputs = _inputs(9, 20)
    fused = served.with_fused_attention()
    np.testing.assert_allclose(_port_apply(fused, inputs), _port_apply(src, inputs), atol=1e-5)
    with torch.no_grad():
        for p in src.parameters():
            p.mul_(0.9)
    served.refresh(src)
    np.testing.assert_allclose(_port_apply(served, inputs), _port_apply(src, inputs), atol=1e-4)


# ---------------------------------------------------------------- training

def _jax_cfg() -> LM2AConfig:
    return LM2AConfig(model=MC, diffusion=DiffusionConfig(timesteps=50),
                      train=TrainConfig(batch_size=B, compute_dtype="float32",
                                        opt_backend="pallas"))


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"mel": MEAN + STD * rand(rng, B, T, 80), "motion": rand(rng, B, T, 234),
            "lyrics": rand(rng, B, T, 768)}


@pytest.fixture(scope="module")
def setup():
    cfg = _jax_cfg()
    den, cp = jax_bd(cfg.model, "float32"), jax_bcp(cfg.model, "float32")
    state, tx = jax_init_train_state(den, cp, cfg, jax.random.key(0), seq_len=T)
    return dict(cfg=cfg, den=den, cp=cp, state=state, tx=tx,
                schedule=jax_make_schedule(cfg.diffusion),
                port_cfg=config_from_dict(jax_config_to_dict(cfg)))


def test_train_steps_match_jax(setup):
    s = setup
    cfg, port_cfg = s["cfg"], s["port_cfg"]
    jstep = jax_make_train_step(s["den"], s["cp"], s["schedule"], cfg, s["tx"],
                                dataset_mean=MEAN, dataset_std=STD)
    pstate = port_train_state(s["port_cfg"], s["state"])
    assert isinstance(pstate.unet, UNet1D)
    pstep = make_train_step(make_schedule(port_cfg.diffusion), port_cfg, dataset_mean=MEAN,
                            dataset_std=STD)
    jstate = jax.tree.map(jnp.copy, s["state"])
    for i in range(2):
        batch, key = _batch(10 + i), jax.random.key(100 + i)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        got0, want0 = state_arrays(pstate), jax_state_arrays(jstate)
        jstate, jloss = jstep(jstate, jbatch, key)
        draws = jax_draws(key, jbatch["mel"], cfg.train.cond_drop_prob,
                          cfg.diffusion.timesteps, train=True)
        loss = pstep(pstate, {k: torch.tensor(v) for k, v in batch.items()}, draws=draws)
        assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
        assert_state_close(state_arrays(pstate), jax_state_arrays(jstate), got0, want0,
                           warm=i > 0)


def test_eval_step_matches_jax(setup):
    s = setup
    jeval = jax_make_eval_step(s["den"], s["cp"], s["schedule"], s["cfg"], dataset_mean=MEAN,
                               dataset_std=STD)
    batch, key = _batch(20), jax.random.key(7)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want = float(jeval(s["state"].params, jbatch, key))
    draws = jax_draws(key, jbatch["mel"], 0.0, s["cfg"].diffusion.timesteps, train=False)
    got = make_eval_step(make_schedule(s["port_cfg"].diffusion), s["port_cfg"], MEAN, STD)(
        port_train_state(s["port_cfg"], s["state"]),
        {k: torch.tensor(v) for k, v in batch.items()}, draws=draws)
    assert float(got) == pytest.approx(want, rel=1e-5)


def test_ddim_chain_with_injected_noise(jax_params):
    cfg = LM2AConfig(model=MC, diffusion=DiffusionConfig(timesteps=40))
    folded = dataclasses.replace(MC, folded_attention=True)
    jden = jax_bd(folded)
    model = load_jax_params(build_denoiser(_port(MC)), jax_params,
                            UNET_CONV_TRANSPOSE).prepare(torch.float32)
    rng = np.random.default_rng(12)
    shape = (1, 20, 80)
    x_init, mf, tf = rand(rng, *shape), rand(rng, 1, 20, 8), rand(rng, 1, 20, 8)

    def fn(x, t, m, l, **kw):
        return jden.apply({"params": jax_params}, x, t, m, l, **kw)

    want = jax_ddim(fn, jax_make_schedule(cfg.diffusion), jax.random.key(0), shape,
                    jnp.asarray(mf), jnp.asarray(tf), num_steps=5, guidance_weight=2.1,
                    x_init=jnp.asarray(x_init), uncond_fast=True)
    schedule = make_schedule(config_from_dict(jax_config_to_dict(cfg)).diffusion)
    got = ddim_sample(model, schedule, shape, torch.tensor(mf), torch.tensor(tf), num_steps=5,
                      guidance_weight=2.1, x_init=torch.tensor(x_init), uncond_fast=True)
    assert max_err(got.numpy() * STD + MEAN, np.asarray(want) * STD + MEAN) < 1e-3


# ---------------------------------------------------------------- checkpoints

def test_jax_restores_the_port_checkpoint(setup, tmp_path):
    s = setup
    pcfg = s["port_cfg"]
    state = init_train_state(pcfg, 5, "cpu")
    make_train_step(make_schedule(pcfg.diffusion), pcfg, dataset_mean=MEAN, dataset_std=STD)(
        state, {k: torch.tensor(v) for k, v in _batch(1).items()},
        generator=torch.Generator().manual_seed(0))
    path = save_checkpoint(str(tmp_path), state, pcfg, epoch=1, dataset_mean=MEAN,
                           dataset_std=STD)
    restored, meta = jax_restore(path, s["state"])
    assert meta["config"]["model"]["arch"] == "v1"
    want, got = state_arrays(state), jax_state_arrays(restored)
    assert set(want) == set(got)
    for k, w in want.items():
        assert got[k].shape == w.shape and np.array_equal(got[k], w), k
    # the transposed convs are stored in the flax layout: the JAX forward of
    # the restored parameters is the port's
    model = state.unet.eval()
    inputs = _inputs(3, 13)
    np.testing.assert_allclose(_port_apply(model, inputs),
                               _jax_apply(MC, restored.params["unet"], inputs),
                               atol=1e-5, rtol=1e-5)


def test_port_resumes_the_jax_checkpoint(setup, tmp_path):
    s = setup
    jstep = jax_make_train_step(s["den"], s["cp"], s["schedule"], s["cfg"], s["tx"],
                                dataset_mean=MEAN, dataset_std=STD)
    jstate, _ = jstep(jax.tree.map(jnp.copy, s["state"]),
                      {k: jnp.asarray(v) for k, v in _batch(30).items()}, jax.random.key(30))
    path = jax_save(str(tmp_path), jstate, s["cfg"], epoch=3, dataset_mean=MEAN,
                    dataset_std=STD)
    pstate = init_train_state(s["port_cfg"], 9, "cpu")
    meta = restore_checkpoint(path, pstate)
    assert meta["epoch"] == 3 and pstate.step == 1
    for k, w in jax_state_arrays(jstate).items():
        assert np.array_equal(state_arrays(pstate)[k], w), k


def test_params_only_checkpoint_reads_in_jax(tmp_path):
    """``chip_smoke.write_checkpoint`` (the port's params-only writer) of a
    v1 model: its flax-layout tree, applied by the JAX ``UNet1D``, gives the
    forward of the port's ``load_models``."""
    from lm2a_tpu_torch.checkpoint import read_params

    cfg = config_from_dict(jax_config_to_dict(LM2AConfig(model=MC)))
    ckpt = chip_smoke.write_checkpoint(str(tmp_path / "ckpt"), cfg, seed=4)
    tree = {}
    for key, a in read_params(ckpt)[0].items():
        *mods, leaf = key.split("/")
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = jnp.asarray(a)
    pm = load_models(ckpt, compute_dtype="float32", device="cpu")
    inputs = _inputs(6, 13)
    np.testing.assert_allclose(_port_apply(pm.denoiser, inputs), _jax_apply(MC, tree, inputs),
                               atol=1e-4, rtol=0)


# ---------------------------------------------------------------- entry points

V1_ARGS = ["--arch", "v1", "--batch_size", "2", "--base_dim", "16", "--dim_mults", "1,2",
           "--cond_dim", "8", "--time_emb_dim", "16", "--attn_heads", "4", "--timesteps", "40",
           "--log_interval", "1", "--no_tensorboard", "--device", "cpu", "--opt_backend",
           "pallas", "--seed", "3"]


def _cli(monkeypatch, *argv):
    monkeypatch.setattr(sys, "argv", ["lm2a_tpu_torch.cli", *argv])
    cli_main.main()


def test_cli_train_sample_and_distill_v1(tmp_path, monkeypatch, capsys):
    clips = chip_smoke.write_clips(str(tmp_path / "clips"), 4, seed=2, mel_t=T, motion_t=12)
    _cli(monkeypatch, "pack", "--npz_dir", str(tmp_path / "clips"), "--out_dir",
         str(tmp_path / "pack"))
    run = str(tmp_path / "run")
    _cli(monkeypatch, "train", *V1_ARGS, "--npz_dir", str(tmp_path / "pack"), "--save_dir", run,
         "--epochs", "1")
    assert list_checkpoints(run) == [2]
    _cli(monkeypatch, "train", *V1_ARGS, "--npz_dir", str(tmp_path / "pack"), "--save_dir", run,
         "--epochs", "2", "--resume", "--steps_per_call", "2", "--device_data")
    assert list_checkpoints(run) == [2, 4]
    out = capsys.readouterr().out
    assert "batch gatherer: native" in out
    ckpt = latest_checkpoint(run)
    _cli(monkeypatch, "sample", "--npz", clips[0], "--ckpt", ckpt, "--out_dir",
         str(tmp_path / "gen"), "--method", "ddim", "--ddim_steps", "3", "--device", "cpu")
    gen = [f for f in os.listdir(tmp_path / "gen") if f.endswith("_gen.npz")]
    assert len(gen) == 1
    mel = np.load(tmp_path / "gen" / gen[0])["mel"]
    assert mel.shape[-1] == T and np.isfinite(mel).all()
    _cli(monkeypatch, "distill", "--teacher", ckpt, "--npz_dir", str(tmp_path / "pack"),
         "--save_dir", str(tmp_path / "student"), "--start_steps", "4", "--student_steps", "2",
         "--steps_per_stage", "2", "--batch_size", "2", "--device", "cpu")
    student = latest_checkpoint(str(tmp_path / "student"))
    assert student is not None
    pm = load_models(student, compute_dtype="float32", device="cpu")
    assert isinstance(pm.denoiser, UNet1D) and pm.distilled_steps == 2
