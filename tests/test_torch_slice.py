"""The slice as a whole, checkpoint -> mel -> wav, port against the JAX
package, on checkpoints the JAX package saved (one JAX state per module:
the flax init dominates this file's time).

- Config and checkpoint: the config round-trips ``meta.json["config"]``
  unchanged; every parameter leaf is carried (bf16 leaves stored as uint16
  bit patterns included); EMA weights are preferred; the metadata drives the
  distilled serving defaults; the port's params-only writer produces the JAX
  key layout.
- Chains: both ``load_models`` on the same checkpoint, the same conditions,
  the same injected start noise (and DDPM step noise), a DDIM chain under
  CFG and a full DDPM chain, de-normalised, then vocoded by a small BigVGAN
  whose flax parameters are carried across. fp32 on both sides.

Tolerances: exact for carried leaves; 1e-3 absolute on the de-normalised
mel (the JAX golden tests' figure: a few-step chain of ~20-layer forwards
summed in another order); 1e-4 on the projected conditions; 2e-4 on the
[-1, 1] waveform."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lm2a_tpu.core.config import config_to_dict as jax_config_to_dict
from lm2a_tpu.diffusion import make_schedule as jax_make_schedule
from lm2a_tpu.diffusion.gaussian import ddim_sample as jax_ddim
from lm2a_tpu.diffusion.gaussian import ddpm_sample as jax_ddpm
from lm2a_tpu.inference import load_models as jax_load_models
from lm2a_tpu.models.factory import build_cond_projection as jax_bcp
from lm2a_tpu.models.factory import build_denoiser as jax_bd
from lm2a_tpu.ops.resample import match_len as jax_match_len
from lm2a_tpu.training import init_train_state
from lm2a_tpu.training import save_checkpoint as jax_save_checkpoint
from lm2a_tpu.vocoder import BigVGANGenerator as JaxGenerator
from lm2a_tpu.vocoder import VocoderConfig as JaxVocoderConfig
from lm2a_tpu_torch import checkpoint as port_ckpt
from lm2a_tpu_torch.convert import BIGVGAN_CONV_TRANSPOSE, flatten_params
from lm2a_tpu_torch.core.config import LM2AConfig as PortConfig
from lm2a_tpu_torch.core.config import config_from_dict, config_to_dict
from lm2a_tpu_torch.diffusion.gaussian import ddim_sample, ddpm_sample
from lm2a_tpu_torch.diffusion.schedule import make_schedule
from lm2a_tpu_torch.inference.sample import (
    _resolve_run_params, load_models, resolve_eval_guidance, resolve_method,
)
from lm2a_tpu_torch.ops.resample import match_len
from lm2a_tpu_torch.vocoder.bigvgan import BigVGANGenerator, VocoderConfig

from _torch_port_util import TINY_CFG, load_jax_params, max_err, rand

MEL_T = 20
VOC = dict(upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4), upsample_initial_channel=32,
           resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 2),))


@pytest.fixture(scope="module")
def jax_state():
    init = jax.jit(lambda k: init_train_state(jax_bd(TINY_CFG.model), jax_bcp(TINY_CFG.model),
                                              TINY_CFG, k, seq_len=16)[0])
    state = init(jax.random.key(4))
    # EMA weights moved off the init so that the EMA preference is exercised
    return state.replace(ema_params=jax.tree_util.tree_map(lambda a: a * 1.1 + 0.01,
                                                           state.params))


@pytest.fixture(scope="module")
def ckpt(jax_state, tmp_path_factory):
    return jax_save_checkpoint(str(tmp_path_factory.mktemp("ckpt")), jax_state, TINY_CFG,
                               epoch=3, dataset_mean=-4.6, dataset_std=1.86)


@pytest.fixture(scope="module")
def bf16_ckpt(jax_state, tmp_path_factory):
    """EMA unet leaves in bf16, which the JAX writer stores as uint16."""
    ema = dict(jax_state.ema_params, unet=jax.tree_util.tree_map(
        lambda a: a.astype(jnp.bfloat16), jax_state.ema_params["unet"]))
    state = jax_state.replace(ema_params=ema)
    path = jax_save_checkpoint(str(tmp_path_factory.mktemp("bf16")), state, TINY_CFG, epoch=0)
    return path, state


# ---------------------------------------------------------------- config, checkpoint

def test_config_round_trips_the_jax_meta(ckpt):
    with open(ckpt + ".meta.json") as f:
        meta_cfg = json.load(f)["config"]
    cfg = config_from_dict(meta_cfg)
    assert config_to_dict(cfg) == meta_cfg == jax_config_to_dict(TINY_CFG)
    assert config_to_dict(PortConfig()) == jax_config_to_dict(type(TINY_CFG)())


@pytest.mark.parametrize("prefer_ema", [True, False])
def test_every_leaf_is_carried(bf16_ckpt, prefer_ema):
    path, state = bf16_ckpt
    with np.load(os.path.join(path, "state.npz")) as z:
        assert z[".ema_params['unet']['in_proj']['kernel']"].dtype == np.uint16
    unet, proj = port_ckpt.read_params(path, prefer_ema=prefer_ema)
    src = state.ema_params if prefer_ema else state.params
    for got, tree in ((unet, src["unet"]), (proj, src["cond_proj"])):
        want = flatten_params(jax.device_get(tree))
        assert set(got) == set(want)
        for k, v in want.items():
            assert got[k].dtype == np.float32
            # exact: a bf16 bit pattern widens to fp32 without rounding
            np.testing.assert_array_equal(got[k], np.asarray(v, np.float32), err_msg=k)


def test_port_writer_uses_the_jax_layout(ckpt, tmp_path):
    unet, proj = port_ckpt.read_params(ckpt, prefer_ema=False)
    cfg = config_from_dict(port_ckpt.load_metadata(ckpt)["config"])
    out = port_ckpt.save_checkpoint(str(tmp_path), 7, unet, proj, cfg, dataset_mean=-1.0,
                                    dataset_std=2.0, extra={"distilled_steps": 4})
    assert os.path.basename(out) == "ckpt_step_7"
    with np.load(os.path.join(ckpt, "state.npz")) as z:
        jax_keys = {k for k in z.files if k.startswith((".params", ".ema_params"))}
    with np.load(os.path.join(out, "state.npz")) as z:
        assert set(z.files) - {".step"} == jax_keys
    meta = port_ckpt.load_metadata(out)
    assert meta["config"] == port_ckpt.load_metadata(ckpt)["config"]
    assert (meta["step"], meta["distilled_steps"], meta["dataset_std"]) == (7, 4, 2.0)
    u2, p2 = port_ckpt.read_params(out)
    for got, want in ((u2, unet), (p2, proj)):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_load_models_reads_stats_and_ema(ckpt, jax_state):
    models = load_models(ckpt, device="cpu", compute_dtype="float32")
    assert (models.dataset_mean, models.dataset_std) == (-4.6, 1.86)
    assert models.timesteps == TINY_CFG.diffusion.timesteps
    assert models.distilled_steps is None and models.std_calibration is None
    w = models.cond_proj.motion_proj.weight.numpy()
    want = np.asarray(jax_state.ema_params["cond_proj"]["motion_proj"]["kernel"]).T
    np.testing.assert_array_equal(w, want)
    assert resolve_method(models) == ("ddpm", None)
    assert _resolve_run_params(models, None, None) == (TINY_CFG.diffusion.timesteps, 1.0)
    assert resolve_eval_guidance(models) == 2.1


def test_distilled_meta_drives_serving_defaults(jax_state, tmp_path):
    path = jax_save_checkpoint(str(tmp_path), jax_state, TINY_CFG, epoch=0,
                               extra={"distilled_steps": 4, "folded_guidance": 2.1,
                                      "std_calibration": 1.3})
    models = load_models(path, device="cpu", compute_dtype="float32")
    assert models.distilled_steps == 4
    assert models.folded_guidance == pytest.approx(2.1)
    assert models.std_calibration == pytest.approx(1.3)
    assert _resolve_run_params(models, None, None)[1] == 1.0
    assert resolve_eval_guidance(models) == 1.0
    assert resolve_method(models, None, None) == ("ddim", 4)
    assert resolve_method(models, "ddpm", None) == ("ddpm", None)
    assert resolve_method(models, None, 8) == ("ddim", 8)


# ---------------------------------------------------------------- the chains

@pytest.fixture(scope="module")
def both(ckpt, jax_state):
    # JAX's load_models restores into an init_train_state template; hand it
    # the state already initialised (same tree) instead of a second flax init
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("lm2a_tpu.training.train_step.init_train_state",
                   lambda *a, **k: (jax_state, None))
        jm = jax_load_models(ckpt, compute_dtype="float32")
    pm = load_models(ckpt, compute_dtype="float32", device="cpu")
    rng = np.random.default_rng(11)
    motion, lyrics = rand(rng, 9, 234), rand(rng, 9, 768)
    m_rs, l_rs = match_len(motion, MEL_T, "interp"), match_len(lyrics, MEL_T, "interp")
    np.testing.assert_allclose(m_rs, jax_match_len(motion, MEL_T, "interp"), atol=1e-6)
    jmf, jtf = jm.cond_proj.apply(jm.proj_params, m_rs[None], l_rs[None])
    pmf, ptf = pm.cond_proj(torch.tensor(m_rs[None]), torch.tensor(l_rs[None]))
    np.testing.assert_allclose(pmf.numpy(), np.asarray(jmf), atol=1e-4)
    np.testing.assert_allclose(ptf.numpy(), np.asarray(jtf), atol=1e-4)
    return jm, pm, (jmf, jtf), (pmf, ptf), rng


def _denorm(models, z):
    return np.asarray(z) * models.dataset_std + models.dataset_mean


def _jax_fn(jm):
    def fn(x, t, m, l, **kw):
        return jm.denoiser.apply(jm.unet_params, x, t, m, l, **kw)
    return fn


def _vocode_both(mel_btc):
    """The same de-normalised mel through both generators."""
    jgen = JaxGenerator(cfg=JaxVocoderConfig(**VOC))
    params = jax.jit(jgen.init)(jax.random.key(5), jnp.asarray(mel_btc))["params"]
    want = np.asarray(jax.jit(jgen.apply)({"params": params}, jnp.asarray(mel_btc)))
    gen = load_jax_params(BigVGANGenerator(VocoderConfig(**VOC)), params,
                          BIGVGAN_CONV_TRANSPOSE)
    return gen(torch.tensor(mel_btc)).numpy(), want


def test_ddim_cfg_chain_then_vocode(both):
    jm, pm, (jmf, jtf), (pmf, ptf), rng = both
    shape = (1, MEL_T, TINY_CFG.model.in_dim)
    x_init = rand(rng, *shape)
    want = jax_ddim(_jax_fn(jm), jax_make_schedule(TINY_CFG.diffusion), jax.random.key(0),
                    shape, jmf, jtf, num_steps=4, guidance_weight=2.1,
                    x_init=jnp.asarray(x_init), uncond_fast=True)
    got = ddim_sample(pm.denoiser, make_schedule(TINY_CFG.diffusion), shape, pmf, ptf,
                      num_steps=4, guidance_weight=2.1, x_init=torch.tensor(x_init),
                      uncond_fast=True)
    mel_w, mel_g = _denorm(jm, want), _denorm(pm, got.numpy())
    assert max_err(mel_g, mel_w) < 1e-3
    wav_g, wav_w = _vocode_both(mel_g.astype(np.float32))
    assert wav_g.shape == wav_w.shape == (1, MEL_T * 8)
    assert max_err(wav_g, wav_w) < 2e-4


def test_ddpm_chain_with_injected_noise(both):
    """The whole 8-step DDPM chain under CFG, the noise at t=0 masked."""
    jm, pm, (jmf, jtf), (pmf, ptf), rng = both
    steps = TINY_CFG.diffusion.timesteps
    shape = (1, MEL_T, TINY_CFG.model.in_dim)
    x_init, noise = rand(rng, *shape), rand(rng, steps, *shape)
    want = jax_ddpm(_jax_fn(jm), jax_make_schedule(TINY_CFG.diffusion), jax.random.key(0),
                    shape, jmf, jtf, guidance_weight=2.1, x_init=jnp.asarray(x_init),
                    noise_seq=jnp.asarray(noise), uncond_fast=True)
    got = ddpm_sample(pm.denoiser, make_schedule(TINY_CFG.diffusion), shape, pmf, ptf,
                      guidance_weight=2.1, x_init=torch.tensor(x_init),
                      noise_seq=torch.tensor(noise), uncond_fast=True)
    assert max_err(_denorm(pm, got.numpy()), _denorm(jm, want)) < 1e-3
