"""``python -m lm2a_tpu_torch.cli distill`` on the CPU at a tiny size.

- the parser: every flag and default of ``python -m lm2a_tpu.cli distill``,
  plus ``--device``;
- the refusals: ``--start_steps < --student_steps``, no card without
  ``--device cpu``, bad ``--loss_schedule`` entries, a ``--resume`` target
  without ``distill_progress`` or with other stages;
- the plumbing, as the JAX package's ``TestCLIPlumbing``: each stage's
  loss space and the EMA decay reach the step builders, ``--lr_decay
  cosine`` reaches the optimizer, a folded teacher runs every stage at
  w = 1.0 and keeps its fold in the metadata;
- resume: a run killed mid-stage (after the stage's mid-stage save) and
  resumed ends in the same checkpoint as an uninterrupted run, bit for bit;
  ``--resume`` on a finished run does nothing;
- the student: ``cli sample --device cpu`` with no method, step or
  guidance flags runs DDIM at ``distilled_steps``, guidance 1.0, one row a
  clip per forward.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from lm2a_tpu.cli import distill as jax_cli_distill
from lm2a_tpu_torch.cli import __main__ as cli_main
from lm2a_tpu_torch.cli import distill as cli_distill
from lm2a_tpu_torch.core.config import (
    DiffusionConfig, LM2AConfig, ModelConfig, TrainConfig,
)
from lm2a_tpu_torch.data.dataset import pack_dataset
from lm2a_tpu_torch.data.schema import Sample, save_sample
from lm2a_tpu_torch.training import distill, train_step
from lm2a_tpu_torch.training.adan import cosine_decay_schedule
from lm2a_tpu_torch.training.checkpoint import (
    latest_checkpoint, list_checkpoints, load_metadata, save_checkpoint,
)
from lm2a_tpu_torch.training.train_step import init_train_state

from _torch_port_util import one_torch_thread  # noqa: F401

T_MEL = 16
CFG = LM2AConfig(
    model=ModelConfig(base_dim=16, dim_mults=(1,), cond_dim=8, time_emb_dim=16,
                      num_res_blocks=1, mid_blocks=1, attn_heads=2, motion_dim=12,
                      text_dim=24),
    diffusion=DiffusionConfig(timesteps=40),
    train=TrainConfig(batch_size=2, compute_dtype="float32"),
)
LADDER = ["--student_steps", "2", "--start_steps", "4", "--steps_per_stage", "4",
          "--batch_size", "2", "--steps_per_call", "2", "--save_interval", "2"]


def write_teacher(root, cfg=CFG, seed=0, extra=None) -> str:
    """A full-state checkpoint of a seeded port state (its EMA is the teacher)."""
    return save_checkpoint(str(root), init_train_state(cfg, seed, "cpu"), cfg,
                           dataset_mean=-4.5, dataset_std=2.0, extra=extra)


def write_data(root, n=4, seed=3):
    """``n`` clips (mel 80 x 16, motion 8 x 12, lyrics 8 x 24) and their pack."""
    npz = os.path.join(str(root), "npz")
    os.makedirs(npz, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        save_sample(os.path.join(npz, f"sample_{i:08d}.npz"), Sample(
            mel=rng.normal(size=(80, T_MEL)).astype(np.float32),
            motion=rng.normal(size=(8, 12)).astype(np.float32),
            lyrics=rng.normal(size=(8, 24)).astype(np.float32)))
    return npz, pack_dataset(npz, os.path.join(str(root), "pack"))


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("distill")
    npz, pack = write_data(root)
    return dict(root=root, teacher=write_teacher(root / "teacher"), npz=npz, pack=pack)


def run(argv, device="cpu"):
    """``python -m lm2a_tpu_torch.cli distill`` through the dispatcher."""
    saved = sys.argv
    sys.argv = ["lm2a_tpu_torch.cli", "distill", *argv, "--device", device]
    try:
        cli_main.main()
    finally:
        sys.argv = saved


def flags(env, save_dir, *extra):
    return ["--teacher", env["teacher"], "--npz_dir", env["pack"], "--save_dir",
            str(save_dir), *LADDER, *extra]


class Killed(RuntimeError):
    pass


REAL_MULTI = distill.make_device_data_multistep_distill


def spy_multi(monkeypatch, calls, kill_at=None):
    """Record each K-step call's rows and global steps; raise on call
    ``kill_at`` (before it runs)."""

    def make(*a, **kw):
        fn = REAL_MULTI(*a, **kw)

        def multi(state, teacher, data, idx, seed, offsets):
            calls.append((idx.numpy().copy(), list(offsets)))
            if len(calls) == kill_at:
                raise Killed("killed")
            return fn(state, teacher, data, idx, seed, offsets)

        return multi

    monkeypatch.setattr(distill, "make_device_data_multistep_distill", make)


# ---------------------------------------------------------------- surface

def _actions(parser):
    return {a.dest: (a.option_strings, a.default, a.type, a.choices, a.required,
                     type(a).__name__)
            for a in parser._actions if a.dest != "help"}


def test_parser_has_every_flag_and_default_of_jax():
    got, want = _actions(cli_distill.build_parser()), _actions(jax_cli_distill.build_parser())
    assert got.pop("device") == (["--device"], "cuda", None, None, False, "_StoreAction")
    assert got == want


def test_refusals(env, tmp_path, monkeypatch):
    with pytest.raises(SystemExit, match="start_steps"):
        run(["--teacher", "x", "--npz_dir", "y", "--student_steps", "50",
             "--start_steps", "25"])
    for bad, match in (("eps,bogus", "unknown --loss_schedule"),
                       ("eps,eps,eps", "3 entries for 2 stages")):
        with pytest.raises(SystemExit, match=match):
            run(flags(env, tmp_path / "bad") + ["--loss_schedule", bad])
    # a --resume target must be a distill run with the same stages
    train_dir = tmp_path / "train_run"
    write_teacher(train_dir)
    with pytest.raises(SystemExit, match="no distill_progress"):
        run(flags(env, train_dir, "--resume"))
    other = tmp_path / "other"
    run(["--teacher", env["teacher"], "--npz_dir", env["pack"], "--save_dir", str(other),
         "--student_steps", "2", "--steps_per_stage", "2", "--batch_size", "2",
         "--steps_per_call", "2"])
    with pytest.raises(SystemExit, match="stages"):
        run(flags(env, other, "--resume"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run(flags(env, tmp_path / "card"), device="cuda")


# ---------------------------------------------------------------- plumbing

def test_loss_schedule_ema_and_guidance_reach_the_step_builders(env, tmp_path, monkeypatch):
    """Each stage's builder gets its --loss_schedule entry, the --ema_decay
    override and the stage's guidance (2.1 folded once, then 1.0), on the
    per-step path (npz clips) and the device-data path (the pack)."""
    seen = []
    for name in ("make_distill_step", "make_device_data_multistep_distill"):
        real = getattr(distill, name)

        def spy(schedule, cfg, optimizer, real=real, name=name, **kw):
            seen.append((name, kw["loss_space"], cfg.train.ema_decay, kw["guidance_weight"],
                         kw["num_student_steps"], optimizer.ema_decay))
            return real(schedule, cfg, optimizer, **kw)

        monkeypatch.setattr(distill, name, spy)
    base = ["--teacher", env["teacher"], "--student_steps", "2", "--start_steps", "4",
            "--steps_per_stage", "2", "--batch_size", "2", "--loss_schedule", "eps,x0_snr",
            "--ema_decay", "0.5"]
    run(base + ["--npz_dir", env["npz"], "--save_dir", str(tmp_path / "a"),
                "--steps_per_call", "1"])
    run(base + ["--npz_dir", env["pack"], "--save_dir", str(tmp_path / "b"),
                "--steps_per_call", "2"])
    # the K-step builder builds its step with make_distill_step
    single, multi = "make_distill_step", "make_device_data_multistep_distill"
    stage0, stage1 = ("eps", 0.5, 2.1, 4, 0.5), ("x0_snr", 0.5, 1.0, 2, 0.5)
    assert seen == [(single, *stage0), (single, *stage1), (multi, *stage0), (single, *stage0),
                    (multi, *stage1), (single, *stage1)]
    for d in ("a", "b"):
        assert list_checkpoints(str(tmp_path / d)) == [2, 4]
        meta = load_metadata(latest_checkpoint(str(tmp_path / d)))
        assert meta["distilled_steps"] == 2 and meta["folded_guidance"] == 2.1
        assert meta["config"]["train"]["ema_decay"] == 0.5
        assert meta["config"]["train"]["weight_decay"] == 0.0


def test_lr_decay_cosine_reaches_the_optimizer(env, tmp_path, monkeypatch):
    """--lr_decay cosine: the run's Adan decays its rate over all stages to
    lr/100 (the JAX CLI's optax.cosine_decay_schedule), the student is written."""
    made = []
    real = train_step.make_optimizer

    def spy(cfg, lr_schedule=None):
        made.append(real(cfg, lr_schedule))
        return made[-1]

    monkeypatch.setattr(train_step, "make_optimizer", spy)
    run(flags(env, tmp_path / "out", "--lr_decay", "cosine", "--lr", "1e-3"))
    (opt,) = made
    total = 4 * 2
    want = cosine_decay_schedule(1e-3, total, alpha=0.01)
    rates = [opt.lr_schedule(s) for s in range(1, total + 2)]
    assert rates == [want(s) for s in range(1, total + 2)]
    assert rates[0] > rates[total // 2] > rates[-1] == np.float32(1e-3) * np.float32(0.01)
    assert (opt.weight_decay, opt.grad_clip, opt.backend) == (0.0, 1.0, "pallas")
    meta = load_metadata(latest_checkpoint(str(tmp_path / "out")))
    assert meta["distilled_steps"] == 2 and meta["step"] == 8
    assert meta["config"]["train"]["opt_backend"] == "pallas"


def test_folded_teacher_runs_every_stage_at_guidance_one(env, tmp_path, monkeypatch, capsys):
    """A distilled teacher (folded_guidance 2.1) is distilled further at
    w = 1.0 in every stage whatever --guidance says; the metadata keeps 2.1."""
    teacher = write_teacher(tmp_path / "folded", seed=4,
                            extra={"distilled_steps": 8, "folded_guidance": 2.1})
    gws = []
    real = distill.make_device_data_multistep_distill

    def spy(*a, **kw):
        gws.append(kw["guidance_weight"])
        return real(*a, **kw)

    monkeypatch.setattr(distill, "make_device_data_multistep_distill", spy)
    run(["--teacher", teacher, "--npz_dir", env["pack"], "--save_dir", str(tmp_path / "out"),
         *LADDER, "--guidance", "3.0"])
    assert gws == [1.0, 1.0]
    assert "ignoring --guidance 3.0" in capsys.readouterr().out
    for step in list_checkpoints(str(tmp_path / "out")):
        meta = load_metadata(os.path.join(str(tmp_path / "out"), f"ckpt_step_{step}"))
        assert meta["folded_guidance"] == 2.1 and meta["teacher"] == teacher


# ---------------------------------------------------------------- resume

def _progress(save_dir):
    return {s: load_metadata(os.path.join(str(save_dir), f"ckpt_step_{s}"))["distill_progress"]
            for s in list_checkpoints(str(save_dir))}


def test_kill_mid_stage_then_resume_matches_uninterrupted(env, tmp_path, monkeypatch, capsys):
    """Run A uninterrupted; run B dies on its 4th K-step call (stage 1,
    after its mid-stage save at 2 of 4 steps) and is resumed: the resumed
    run draws the rows the uninterrupted one drew, takes its teacher from
    stage 0's end checkpoint, and ends in the same bits."""
    dir_a, dir_b = tmp_path / "a", tmp_path / "b"
    calls_a, calls_b, calls_r = [], [], []
    spy_multi(monkeypatch, calls_a)
    run(flags(env, dir_a))
    spy_multi(monkeypatch, calls_b, kill_at=4)
    with pytest.raises(Killed):
        run(flags(env, dir_b))
    assert list_checkpoints(str(dir_b)) == [2, 4, 6]
    capsys.readouterr()
    spy_multi(monkeypatch, calls_r)
    run(flags(env, dir_b, "--resume"))
    assert f"resumed {dir_b}/ckpt_step_6: stage 1 step 2/4 (gstep 6)" in capsys.readouterr().out
    assert len(calls_a) == len(calls_b) == 4 and len(calls_r) == 1
    for (ia, oa), (ib, ob) in zip(calls_a, calls_b):
        np.testing.assert_array_equal(ia, ib)
        assert oa == ob
    np.testing.assert_array_equal(calls_r[0][0], calls_a[3][0])
    assert calls_r[0][1] == calls_a[3][1] == [6, 7]
    prog = _progress(dir_a)
    assert prog == _progress(dir_b)
    assert [(p["stage_idx"], p["done_in_stage"], p["gstep"]) for p in prog.values()] == [
        (0, 2, 2), (0, 4, 4), (1, 2, 6), (1, 4, 8)]
    assert all(p["stages"] == [4, 2] for p in prog.values())
    fa, fb = latest_checkpoint(str(dir_a)), latest_checkpoint(str(dir_b))
    assert os.path.basename(fa) == os.path.basename(fb) == "ckpt_step_8"
    with np.load(os.path.join(fa, "state.npz")) as za, np.load(os.path.join(fb, "state.npz")) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            np.testing.assert_array_equal(za[k], zb[k], err_msg=k)


def test_resume_on_a_finished_run_does_nothing(env, tmp_path, capsys):
    out = tmp_path / "out"
    run(flags(env, out))
    before = sorted(os.listdir(str(out)))
    capsys.readouterr()
    run(flags(env, out, "--resume"))
    assert "already complete" in capsys.readouterr().out
    assert sorted(os.listdir(str(out))) == before


# ---------------------------------------------------------------- serving the student

def test_cli_sample_serves_the_student_with_no_flags(env, tmp_path, monkeypatch):
    """``cli sample --device cpu`` on a port-made student, no method, step or
    guidance flag: DDIM over the student's own grid at guidance 1.0, one
    B-row forward a step (no CFG doubling), a finite mel of the clip's shape."""
    from lm2a_tpu_torch.inference import sample as inference_sample

    out = tmp_path / "student"
    run(["--teacher", env["teacher"], "--npz_dir", env["pack"], "--save_dir", str(out),
         "--student_steps", "3", "--steps_per_stage", "2", "--batch_size", "2",
         "--steps_per_call", "2"])
    student = latest_checkpoint(str(out))
    meta = load_metadata(student)
    assert meta["distilled_steps"] == 3 and meta["folded_guidance"] == 2.1
    seen = []
    real = inference_sample.ddim_sample

    def spy(model_fn, schedule, shape, motion_f, text_f, **kw):
        rows = []

        def counted(x, *a, **k):
            rows.append(x.shape[0])
            return model_fn(x, *a, **k)

        res = real(counted, schedule, shape, motion_f, text_f, **kw)
        seen.append(dict(num_steps=kw["num_steps"], guidance=kw["guidance_weight"], rows=rows))
        return res

    monkeypatch.setattr(inference_sample, "ddim_sample", spy)
    monkeypatch.setattr(inference_sample, "ddpm_sample", None)  # must not be reached
    clip = os.path.join(env["npz"], "sample_00000000.npz")
    saved = sys.argv
    sys.argv = ["lm2a_tpu_torch.cli", "sample", "--npz", clip, "--ckpt", student,
                "--out_dir", str(tmp_path / "gen"), "--no_png", "--device", "cpu"]
    try:
        cli_main.main()
    finally:
        sys.argv = saved
    assert seen == [dict(num_steps=3, guidance=1.0, rows=[1, 1, 1])]
    (gen,) = [f for f in os.listdir(str(tmp_path / "gen")) if f.endswith("_gen.npz")]
    mel = np.load(os.path.join(str(tmp_path / "gen"), gen))["mel"]
    assert mel.shape == (80, T_MEL) and np.isfinite(mel).all()
    with open(student + ".meta.json") as f:
        assert json.load(f)["distill_progress"]["stages"] == [3]
