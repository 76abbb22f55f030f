"""Long-form generation of the port (``inference/longform.py``) against the
JAX package on the CPU.

- ``window_conditions`` and ``crossfade_stitch`` equal the JAX functions
  exactly, on ``tests/test_longform.py``'s cases and on random ones;
- ``generate_long`` equals the port's own ``generate_mel_batch`` run on the
  same windows with the same per-chain seeds, stitched by the JAX
  ``crossfade_stitch`` (the torch and JAX random streams cannot be matched,
  so the chain itself is held against JAX in ``test_torch_slice.py``);
- ``with_streaming_attention`` keeps the model below the threshold and
  above it returns a copy on the fused route that shares the weights,
  leaves the caller's models as they are and keeps the distilled metadata;
- ``generate_single_pass`` on a tiny model with the threshold patched low:
  an (80, T) finite mel, and the denoiser it runs equals the JAX model with
  ``fused_attention=True`` on the same inputs (2e-4, the JAX suite's
  fused-vs-unfused figure)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from lm2a_tpu.inference import longform as jlf
from lm2a_tpu.models.factory import build_denoiser as jax_build_denoiser
from lm2a_tpu_torch.core.config import DiffusionConfig, LM2AConfig, ModelConfig
from lm2a_tpu_torch.inference import longform
from lm2a_tpu_torch.inference.sample import LoadedModels, generate_mel_batch, load_models
from lm2a_tpu_torch.models.factory import build_cond_projection, build_denoiser
from lm2a_tpu_torch.ops import attention as att

from _torch_port_util import load_jax_params, one_torch_thread, rand  # noqa: F401

CFG = LM2AConfig(
    model=ModelConfig(base_dim=16, dim_mults=(1, 2), cond_dim=8, time_emb_dim=16,
                      num_res_blocks=1, mid_blocks=1, attn_heads=2),
    diffusion=DiffusionConfig(timesteps=8),
)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    ckpt = chip_smoke.write_checkpoint(str(tmp_path_factory.mktemp("lf") / "ckpt"), CFG, seed=0)
    return load_models(ckpt, device="cpu", compute_dtype="float32")


# ---------------------------------------------------------------- stitching

@pytest.mark.parametrize("windows,hop", [
    (np.ones((3, 80, 20), np.float32) * 5.0, 12),                               # constant
    (np.stack([np.full((2, 10), i, np.float32) for i in range(3)]), 10),        # no overlap
    (np.concatenate([np.zeros((1, 1, 20), np.float32), np.ones((1, 1, 20), np.float32)]), 12),
    (rand(np.random.default_rng(0), 5, 80, 129), 86),                           # random
    (rand(np.random.default_rng(1), 1, 4, 30), 20),                             # one window
])
def test_crossfade_stitch_equals_jax(windows, hop):
    np.testing.assert_array_equal(longform.crossfade_stitch(windows, hop),
                                  jlf.crossfade_stitch(windows, hop))


@pytest.mark.parametrize("lyr_1d", [True, False])
def test_window_conditions_equal_jax(lyr_1d):
    rng = np.random.default_rng(2)
    motion = np.arange(50, dtype=np.float32)[:, None].repeat(3, axis=1)  # held tail
    lyrics = ([rand(rng, 4) for _ in range(2)] if lyr_1d
              else [rand(rng, 30, 4) for _ in range(2)])
    got = longform.window_conditions(motion, lyrics, 3, 30, 15)
    want = jlf.window_conditions(motion, lyrics, 3, 30, 15)
    assert len(got) == len(want) == 3
    for (gm, gl), (wm, wl) in zip(got, want):
        np.testing.assert_array_equal(gm, wm)
        np.testing.assert_array_equal(gl, wl)
    assert (got[2][0][-10:] == got[2][0][19]).all()


# ---------------------------------------------------------------- windowed

def test_generate_long_is_stitched_batches(models):
    rng = np.random.default_rng(3)
    total, window, overlap, batch = 4.0, 1.5, 0.5, 2
    motion = rand(rng, int(total * 30) + 30, 234)
    lyrics = [rand(rng, 768) for _ in range(3)]
    kw = dict(guidance_weight=2.1, method="ddim", ddim_steps=2)
    got = longform.generate_long(models, motion, lyrics, total_seconds=total,
                                 window_seconds=window, overlap_seconds=overlap,
                                 batch_size=batch, seed=5, **kw)
    mel_fps = 22050 / 256
    t_w, hop_w = round(window * mel_fps), round((window - overlap) * mel_fps)
    total_t = round(total * mel_fps)
    n_win = int(np.ceil((total_t - t_w) / hop_w)) + 1
    conds = jlf.window_conditions(motion, lyrics, n_win, round(window * 30),
                                  round((window - overlap) * 30))
    gens = [generate_mel_batch(models, [m for m, _ in conds[i: i + batch]],
                               [l for _, l in conds[i: i + batch]], t_w, seed=5 + i, **kw)[0]
            for i in range(0, n_win, batch)]
    want = jlf.crossfade_stitch(np.concatenate(gens), hop_w)[:, :total_t]
    assert got.shape == (80, total_t) and np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- single pass

def test_with_streaming_attention_shares_the_weights(models):
    distilled = dataclasses.replace(models, distilled_steps=4, folded_guidance=2.1,
                                    guidance_weight=1.0)
    assert longform.with_streaming_attention(distilled, 516) is distilled
    assert longform.with_streaming_attention(distilled, 4096) is distilled
    assert longform.with_streaming_attention(distilled, att.FUSED_ATTENTION_MIN_T) is distilled
    long = longform.with_streaming_attention(distilled, 16384)
    assert long is not distilled and long.denoiser is not distilled.denoiser
    assert long.cfg.model.fused_attention and not distilled.cfg.model.fused_attention
    assert (long.distilled_steps, long.folded_guidance, long.guidance_weight) == (4, 2.1, 1.0)
    assert long.cond_proj is distilled.cond_proj
    # every tensor of the copy is the original's storage
    src = dict(distilled.denoiser.named_parameters())
    for name, p in long.denoiser.named_parameters():
        assert p.data_ptr() == src[name].data_ptr(), name
    for new, old in zip(long.denoiser.resblocks(), distilled.denoiser.resblocks()):
        assert new.chain.conv1_w.data_ptr() == old.chain.conv1_w.data_ptr()
        if old.use_attn:
            assert new.cross_attn.fused and new.cross_attn.folded is None
            # the caller's model keeps its route and its folded weights
            assert not old.cross_attn.fused and old.cross_attn.folded is not None
            assert not old.cross_attn.attn_motion.fused


def test_generate_single_pass_fused_route_matches_jax(monkeypatch):
    """A tiny model carrying a JAX init's weights, threshold patched to 64."""
    mc = CFG.model
    t = 72
    rng = np.random.default_rng(4)
    jm_plain = jax_build_denoiser(mc)
    x1 = rand(rng, 1, t, mc.in_dim)
    m_f, t_f = rand(rng, 1, t, mc.cond_dim), rand(rng, 1, t, mc.cond_dim)
    ts = np.array([3], np.int32)
    params = jax.jit(jm_plain.init)(jax.random.key(0), x1, ts, m_f, t_f)["params"]
    den = load_jax_params(build_denoiser(mc), params).prepare(torch.float32)
    proj = build_cond_projection(mc).eval().requires_grad_(False)
    models = LoadedModels(cfg=CFG, denoiser=den, cond_proj=proj, dataset_mean=-4.0,
                          dataset_std=1.9, timesteps=8, device=torch.device("cpu"))
    monkeypatch.setattr(att, "FUSED_ATTENTION_MIN_T", 64)
    fused = longform.with_streaming_attention(models, t)
    assert fused.cfg.model.fused_attention
    jm = jax_build_denoiser(dataclasses.replace(mc, fused_attention=True))
    want = jax.jit(jm.apply)({"params": params}, x1, ts, m_f, t_f)
    got = fused.denoiser(torch.tensor(x1), torch.tensor(ts).long(), torch.tensor(m_f),
                         torch.tensor(t_f))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=2e-4)

    motion, lyrics = rand(rng, 40, 234), rand(rng, 40, 768)
    mel = longform.generate_single_pass(models, motion, lyrics, total_seconds=t * 256 / 22050,
                                        guidance_weight=2.0, method="ddim", ddim_steps=2,
                                        seed=3)
    assert mel.shape == (80, t) and np.isfinite(mel).all()
