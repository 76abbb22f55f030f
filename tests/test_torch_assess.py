"""Mel-domain assessment (``eval/assess.py``, the ``val`` workflow) of the
port against ``lm2a_tpu.eval.assess_batch``, on the CPU.

Both packages assess one base-16 checkpoint the JAX package wrote (C/G 2
and 4 at ``default_num_groups``), over the same npz test split, with the
same protocol: the seeded random subset (``random.Random(seed)``), the
sorted subset under ``--no-random``, DDPM over the checkpoint's 6 steps,
and the distilled-aware guidance (2.1 for this checkpoint; 1.0 and the
student's own DDIM grid for a distilled one). The chains' randomness is
injected into both samplers alike: the start noise ``x_init`` and the
DDPM step noise, made with numpy from the chain's shape. fp32 compute on
both sides. Tolerances: each generated mel 1e-3 absolute
(``test_torch_slice``'s figure for a chain of ~20-layer forwards summed in
another order); the per-sample and averaged metrics within what those mels
give, 2e-3 relative and 1e-4 absolute.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lm2a_tpu.eval.assess as jax_assess
import lm2a_tpu.inference.sample as jax_sample
import lm2a_tpu_torch.eval.assess as port_assess
import lm2a_tpu_torch.inference.sample as port_sample
from lm2a_tpu.core.config import DiffusionConfig, LM2AConfig, ModelConfig, TrainConfig
from lm2a_tpu.data import Sample, save_sample
from lm2a_tpu.models.factory import build_cond_projection, build_denoiser
from lm2a_tpu.training import init_train_state, save_checkpoint
from lm2a_tpu_torch.cli import val as cli_val

from _torch_port_util import one_torch_thread, rand  # noqa: F401

CFG = LM2AConfig(
    model=ModelConfig(base_dim=16, dim_mults=(1, 2), cond_dim=8, time_emb_dim=16,
                      num_res_blocks=1, mid_blocks=1, attn_heads=2,
                      motion_dim=234, text_dim=768),
    diffusion=DiffusionConfig(timesteps=6),
    train=TrainConfig(batch_size=2),
)
MEL_T = 32


def _save(ckpt_dir, seed, **extra):
    state, _ = init_train_state(build_denoiser(CFG.model), build_cond_projection(CFG.model),
                                CFG, jax.random.key(seed), seq_len=MEL_T)
    state = state.replace(ema_params=jax.tree_util.tree_map(lambda a: a * 1.05, state.params))
    save_checkpoint(ckpt_dir, state, CFG, dataset_mean=-4.6, dataset_std=1.86, extra=extra)
    return os.path.join(ckpt_dir, "ckpt_step_0")


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("assess")
    npz_dir = root / "test_split"
    npz_dir.mkdir()
    rng = np.random.default_rng(0)
    for i in range(5):
        save_sample(str(npz_dir / f"sample_{i:08d}.npz"), Sample(
            mel=(-4.6 + 1.9 * rng.normal(size=(80, MEL_T))).astype(np.float32),
            motion=rng.normal(size=(12, 234)).astype(np.float32),
            lyrics=rng.normal(size=(12, 768)).astype(np.float32)))
    np.savez(str(npz_dir / "motion_stats.npz"), mean=np.zeros(3))  # skipped by both
    return dict(npz=str(npz_dir), ckpt=_save(str(root / "ck"), 0),
                student=_save(str(root / "st"), 1, distilled_steps=3, folded_guidance=2.1),
                root=root)


def _noise(shape, steps):
    """The injected draws of one chain, from its shape alone."""
    rng = np.random.default_rng(int(np.prod(shape)) + steps)
    return rand(rng, *shape), rand(rng, steps, *shape)


@pytest.fixture
def injected(monkeypatch):
    """Both packages' samplers take the start and step noise of ``_noise``,
    and both load the checkpoint in fp32."""
    jddpm, jddim = jax_sample.ddpm_sample, jax_sample.ddim_sample
    pddpm, pddim = port_sample.ddpm_sample, port_sample.ddim_sample

    def jax_ddpm(model_fn, schedule, key, shape, *a, **kw):
        x0, seq = _noise(shape, schedule.timesteps)
        return jddpm(model_fn, schedule, key, shape, *a, x_init=jnp.asarray(x0),
                     noise_seq=jnp.asarray(seq), **kw)

    def jax_ddim(model_fn, schedule, key, shape, *a, **kw):
        return jddim(model_fn, schedule, key, shape, *a,
                     x_init=jnp.asarray(_noise(shape, schedule.timesteps)[0]), **kw)

    def port_ddpm(model_fn, schedule, shape, *a, **kw):
        x0, seq = _noise(shape, schedule.timesteps)
        return pddpm(model_fn, schedule, shape, *a, x_init=torch.tensor(x0),
                     noise_seq=torch.tensor(seq), **kw)

    def port_ddim(model_fn, schedule, shape, *a, **kw):
        return pddim(model_fn, schedule, shape, *a,
                     x_init=torch.tensor(_noise(shape, schedule.timesteps)[0]), **kw)

    monkeypatch.setattr(jax_sample, "ddpm_sample", jax_ddpm)
    monkeypatch.setattr(jax_sample, "ddim_sample", jax_ddim)
    monkeypatch.setattr(port_sample, "ddpm_sample", port_ddpm)
    monkeypatch.setattr(port_sample, "ddim_sample", port_ddim)
    jload, pload = jax_assess.load_models, port_assess.load_models
    monkeypatch.setattr(jax_assess, "load_models",
                        lambda p, **kw: jload(p, compute_dtype="float32", **kw))
    monkeypatch.setattr(port_assess, "load_models",
                        lambda p, **kw: pload(p, compute_dtype="float32", **kw))


def _gen_mels(out_dir):
    return {f: np.load(os.path.join(out_dir, f))["mel"] for f in sorted(os.listdir(out_dir))
            if f.endswith("_gen_mel.npz")}


def _close_metrics(got, want):
    assert list(got) == list(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=2e-3, abs=1e-4), k


@pytest.mark.parametrize("random_sample,seed,max_samples", [(True, 100, 2), (False, 100, 3),
                                                            (True, 7, 2)])
def test_assess_batch_matches_jax(env, injected, tmp_path, random_sample, seed, max_samples):
    kw = dict(max_samples=max_samples, random_sample=random_sample, random_seed=seed, steps=6,
              save_png=False)
    want = jax_assess.assess_batch(env["npz"], env["ckpt"], str(tmp_path / "jax"), **kw)
    got = port_assess.assess_batch(env["npz"], env["ckpt"], str(tmp_path / "port"),
                                   device="cpu", **kw)
    _close_metrics(got, want)
    jm, pm = _gen_mels(tmp_path / "jax"), _gen_mels(tmp_path / "port")
    assert list(pm) == list(jm) and len(pm) == max_samples  # the same subset
    for f in jm:
        np.testing.assert_allclose(pm[f], jm[f], atol=1e-3, rtol=0, err_msg=f)
        name = f.replace("_gen_mel.npz", "_metrics.txt")
        lines = [open(os.path.join(tmp_path / d, name)).read().splitlines()
                 for d in ("port", "jax")]
        assert [ln.split(":")[0] for ln in lines[0]] == [ln.split(":")[0] for ln in lines[1]]
    for d in ("port", "jax"):
        assert not [x for x in os.listdir(tmp_path / d) if x.startswith("temp_")]
    txt = [open(tmp_path / d / "average_metrics.txt").read().split("averages:")[0]
           for d in ("port", "jax")]
    assert txt[0] == txt[1] and f"seed: {seed}" in txt[0]


def test_distilled_checkpoint_assessed_at_its_folded_guidance(env, injected, tmp_path):
    """A distilled student: guidance resolves to 1.0 and the chain to the
    student's own DDIM grid on both sides; an explicit weight wins."""
    pm = port_assess.load_models(env["student"], device="cpu")
    assert port_sample.resolve_eval_guidance(pm, None) == 1.0
    assert port_sample.resolve_eval_guidance(pm, 1.7) == 1.7
    assert port_sample.resolve_eval_guidance(port_assess.load_models(env["ckpt"], device="cpu"),
                                             None) == 2.1
    clip = os.path.join(env["npz"], "sample_00000001.npz")
    want, _ = jax_assess.assess_single_sample(clip, env["student"], str(tmp_path / "jax"),
                                              steps=6, save_png=False)
    got, tdir = port_assess.assess_single_sample(clip, env["student"], str(tmp_path / "port"),
                                                 steps=6, save_png=False, device="cpu")
    assert os.path.isdir(tdir)  # deferred cleanup, as in the JAX package
    _close_metrics(got, want)
    jm, pmels = _gen_mels(tmp_path / "jax"), _gen_mels(tmp_path / "port")
    for f in jm:
        np.testing.assert_allclose(pmels[f], jm[f], atol=1e-3, rtol=0)


def test_cli_val_runs_the_protocol(env, injected, tmp_path, capsys):
    out = tmp_path / "val"
    cli_val.main(["--ckpt", env["ckpt"], "--npz_dir", env["npz"], "--out_dir", str(out),
                  "--max_samples", "2", "--steps", "6", "--device", "cpu"])
    assert "batch assessment averages" in capsys.readouterr().out
    txt = open(out / "average_metrics.txt").read()
    assert "samples: 2" in txt and "seed: 100" in txt and "random: True" in txt
    assert len(_gen_mels(out)) == 2
    pytest.importorskip("matplotlib")  # the PNGs, where matplotlib is there
    assert os.path.exists(out / "average_metrics.png")


def test_plt_is_none_without_matplotlib(monkeypatch, tmp_path):
    import builtins

    real = builtins.__import__

    def no_mpl(name, *a, **kw):
        if name.startswith("matplotlib"):
            raise ImportError(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_mpl)
    assert port_assess._plt() is None and jax_assess._plt() is None
    port_assess.visualize_metrics({"mse": 1.0}, str(tmp_path / "m.png"))
    assert not os.path.exists(tmp_path / "m.png")
