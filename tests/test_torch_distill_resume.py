"""Distill runs resumed across the two packages, on the CPU at a tiny size.

A run of one package's ``cli distill`` dies on its 4th K-step call (stage 1
of a 4 -> 2 ladder, after the stage's mid-stage save at 2 of 4 steps) and
the other package's ``cli distill --resume`` finishes it:

- the resume point it reports (stage 1, step 2 of 4, global step 6);
- the rows it draws for its steps: the dying run's rows of that 4th call,
  the JAX CLI's ``default_rng(seed + stage).integers`` stream continued;
- the resumed stage's teacher: the EMA weights of stage 0's end checkpoint,
  written by the other package;
- the final checkpoint: step 8 in both the archive and the metadata,
  ``distill_progress`` {stage 1, 4 of 4, global step 8, stages [4, 2]}.

The JAX CLI's ``init_train_state`` template (whose values the CLI
overwrites from the teacher checkpoint before its first step) is built from
a port state's arrays (``jax_train_state``) rather than by flax's init.
"""

import os

import jax
import numpy as np
import pytest

import lm2a_tpu.training.distill as jax_distill
import lm2a_tpu.training.train_step as jax_train_step
from lm2a_tpu.cli import distill as jax_cli_distill
from lm2a_tpu_torch.core.config import config_from_dict
from lm2a_tpu_torch.training import distill
from lm2a_tpu_torch.training.checkpoint import (
    flax_path, keystr, latest_checkpoint, list_checkpoints, load_metadata, state_arrays,
    to_flax_layout,
)
from lm2a_tpu_torch.training.train_step import init_train_state

from _torch_port_util import jax_train_state, one_torch_thread  # noqa: F401
from test_torch_distill_cli import Killed, env, flags, run, spy_multi  # noqa: F401

RESUMED = "stage 1 step 2/4 (gstep 6)"


@pytest.fixture
def jax_template(monkeypatch):
    """The JAX CLI's ``init_train_state`` from a port state's arrays."""
    from lm2a_tpu.core.config import config_to_dict

    def init(denoiser, cond_proj, cfg, key, seq_len=516):
        port = init_train_state(config_from_dict(config_to_dict(cfg)), 0, "cpu")
        return jax_train_state(state_arrays(port)), jax_train_step.make_optimizer(cfg)

    monkeypatch.setattr(jax_train_step, "init_train_state", init)


def jax_spy_multi(monkeypatch, calls, kill_at=None):
    """The JAX CLI's K-step calls: rows and offsets recorded, call
    ``kill_at`` raises before it runs."""
    real = jax_distill.make_device_data_multistep_distill

    def make(*a, **kw):
        fn = real(*a, **kw)

        def multi(state, teacher_params, data, idx, root, offsets):
            calls.append((np.asarray(idx).copy(), [int(o) for o in offsets]))
            if len(calls) == kill_at:
                raise Killed("killed")
            return fn(state, teacher_params, data, idx, root, offsets)

        return multi

    monkeypatch.setattr(jax_distill, "make_device_data_multistep_distill", make)


def spy_teachers(monkeypatch, seen):
    real = distill.build_teacher

    def build(cfg, ema):
        seen.append({k: v.clone() for k, v in ema.items()})
        return real(cfg, ema)

    monkeypatch.setattr(distill, "build_teacher", build)


def ema_arrays(path):
    with np.load(os.path.join(path, "state.npz")) as z:
        return {k: z[k] for k in z.files if k.startswith(".ema_params")}


def check_finished(save_dir):
    final = latest_checkpoint(str(save_dir))
    assert os.path.basename(final) == "ckpt_step_8"
    meta = load_metadata(final)
    assert meta["step"] == 8 and meta["distilled_steps"] == 2
    assert meta["distill_progress"] == {"stage_idx": 1, "done_in_stage": 4, "gstep": 8,
                                        "stages": [4, 2]}
    with np.load(os.path.join(final, "state.npz")) as z:
        assert int(z[".step"]) == int(z[".opt_state.step"]) == 8
        assert all(np.isfinite(z[k]).all() for k in z.files)


def test_jax_run_resumed_by_the_port(env, tmp_path, monkeypatch, capsys, jax_template):
    save = tmp_path / "run"
    jax_calls, port_calls, teachers = [], [], []
    jax_spy_multi(monkeypatch, jax_calls, kill_at=4)
    with pytest.raises(Killed):
        jax_cli_distill.main(flags(env, save))
    assert list_checkpoints(str(save)) == [2, 4, 6]
    capsys.readouterr()
    spy_multi(monkeypatch, port_calls)
    spy_teachers(monkeypatch, teachers)
    run(flags(env, save, "--resume"))
    out = capsys.readouterr().out
    assert f"resumed {save}/ckpt_step_6: {RESUMED}" in out
    assert [o for _, o in port_calls] == [[6, 7]]
    np.testing.assert_array_equal(port_calls[0][0], jax_calls[3][0])
    assert jax_calls[3][1] == [6, 7]
    # teachers built: the checkpoint's teacher at start-up, stage 0's end
    # student for the resumed stage, the finished student after it
    want = ema_arrays(os.path.join(str(save), "ckpt_step_4"))
    assert len(teachers) == 3
    for name, t in teachers[1].items():
        np.testing.assert_array_equal(to_flax_layout(t).numpy(),
                                      want[keystr("ema_params", flax_path(name, t.ndim))])
    check_finished(save)


def test_port_run_resumed_by_jax(env, tmp_path, monkeypatch, capsys, jax_template):
    save = tmp_path / "run"
    port_calls, jax_calls, jax_teachers = [], [], []
    spy_multi(monkeypatch, port_calls, kill_at=4)
    with pytest.raises(Killed):
        run(flags(env, save))
    assert list_checkpoints(str(save)) == [2, 4, 6]
    capsys.readouterr()
    jax_spy_multi(monkeypatch, jax_calls)
    real_multi = jax_distill.make_device_data_multistep_distill

    def record_teacher(*a, **kw):
        fn = real_multi(*a, **kw)

        def multi(state, teacher_params, *rest):
            jax_teachers.append(jax.device_get(teacher_params))
            return fn(state, teacher_params, *rest)

        return multi

    monkeypatch.setattr(jax_distill, "make_device_data_multistep_distill", record_teacher)
    jax_cli_distill.main(flags(env, save, "--resume"))
    out = capsys.readouterr().out
    assert f"resumed {save}/ckpt_step_6: {RESUMED}" in out
    assert [o for _, o in jax_calls] == [[6, 7]]
    np.testing.assert_array_equal(jax_calls[0][0], port_calls[3][0])
    # the resumed stage's teacher: the port's stage-0 end checkpoint's EMA
    want = ema_arrays(os.path.join(str(save), "ckpt_step_4"))
    flat, _ = jax.tree_util.tree_flatten_with_path(jax_teachers[0])
    got = {".ema_params" + jax.tree_util.keystr(kp): np.asarray(v) for kp, v in flat}
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    check_finished(save)
