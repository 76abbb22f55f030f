"""The benchmark's plain reference against the port's plain path, on the CPU at
tiny widths, both in float32: the denoisers' training and serving forms, the
condition projection, three training steps with Adan and the EMA, a DDIM
chain under CFG, BigVGAN and the condition resampling."""

import dataclasses

import numpy as np
import pytest
import torch

from lm2a_tpu_torch.core.config import LM2AConfig, ModelConfig, TrainConfig, DiffusionConfig
from lm2a_tpu_torch.diffusion.gaussian import ddim_sample, ddpm_sample
from lm2a_tpu_torch.diffusion.schedule import make_schedule
from lm2a_tpu_torch.models.factory import build_cond_projection, build_denoiser
from lm2a_tpu_torch.ops.resample import match_len
from lm2a_tpu_torch.training.train_step import (
    init_train_state, make_device_data_multistep, make_optimizer)
from lm2a_tpu_torch.vocoder.bigvgan import BigVGANGenerator, VocoderConfig
from portbench.reference import adan as ref_adan
from portbench.reference import bigvgan as ref_voc
from portbench.reference import diffusion as ref_diff
from portbench.reference import unet as ref
from portbench.reference.resample import interp_frames
from portbench.weights import make_weights

ARCHS = ("ultimate", "v1")
T = 16


def model(arch: str) -> ModelConfig:
    return ModelConfig(arch=arch, base_dim=16, dim_mults=(1, 2), cond_dim=8, time_emb_dim=16,
                       attn_heads=2, mid_blocks=1)


def loaded(arch: str, seed: int = 1):
    mc = model(arch)
    m = dataclasses.asdict(mc)
    w = make_weights(ref.spec(m), seed, "cpu")
    den = build_denoiser(mc)
    den.load_state_dict(w)
    return mc, m, w, den


def rel(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dropout", [False, True])
def test_training_form_matches(arch, dropout):
    mc, m, w, den = loaded(arch)
    g = torch.Generator().manual_seed(0)
    x, mf, tf = (torch.randn((2, T, d), generator=g) for d in (80, 8, 8))
    t = torch.tensor([3, 800])
    g1 = torch.Generator().manual_seed(5) if dropout else None
    g2 = torch.Generator().manual_seed(5) if dropout else None
    with torch.no_grad():
        got = den.forward_train(x, t, mf, tf, dtype=torch.float32, generator=g1)
    want = ref.denoise(w, m, x, t, mf, tf, generator=g2)
    assert rel(got, want) < 1e-5


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_form_with_uncond_rows_matches(arch):
    mc, m, w, den = loaded(arch)
    den.eval().requires_grad_(False).prepare(torch.float32)
    g = torch.Generator().manual_seed(1)
    x, mf, tf = (torch.randn((2, T, d), generator=g) for d in (80, 8, 8))
    mf[0].zero_()
    tf[0].zero_()
    t = torch.tensor([500, 500])
    with torch.no_grad():
        got = den(x, t, mf, tf, uncond_rows=1)
    want = ref.denoise(w, m, x, t, mf, tf)
    assert rel(got, want) < 1e-5


def test_condition_projection_matches():
    mc = model("ultimate")
    m = dataclasses.asdict(mc)
    w = make_weights(ref.cond_spec(m), 2, "cpu")
    proj = build_cond_projection(mc)
    proj.load_state_dict(w)
    g = torch.Generator().manual_seed(2)
    motion, lyrics = torch.randn((2, T, 234), generator=g), torch.randn((2, T, 768), generator=g)
    with torch.no_grad():
        got = proj(motion, lyrics)
    for a, b in zip(got, ref.project_conditions(w, motion, lyrics)):
        assert rel(a, b) < 1e-6


@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_match(arch):
    """The port's device-data step (float32 compute, the plain optimizer route
    of the CUDA kernel's arithmetic) against the reference's loss, clip, Adan
    and EMA over three steps on the same rows and draws."""
    mc = dataclasses.replace(model(arch), fused_resblock_grad=arch == "ultimate")
    cfg = LM2AConfig(model=mc, train=TrainConfig(compute_dtype="float32", opt_backend="pallas"))
    m = dataclasses.asdict(mc)
    opt = make_optimizer(cfg)
    state = init_train_state(cfg, 0, "cpu", opt)
    w = {**{f"unet/{k}": v for k, v in make_weights(ref.spec(m), 3, "cpu").items()},
         **{f"cond_proj/{k}": v for k, v in make_weights(ref.cond_spec(m), 4, "cpu").items()}}
    with torch.no_grad():
        for k, p in state.params().items():
            p.copy_(w[k])
            state.ema[k].copy_(w[k])
    g = torch.Generator().manual_seed(6)
    pack = {"mel": torch.randn((6, T, 80), generator=g) - 4.0,
            "motion": torch.randn((6, T, 234), generator=g),
            "lyrics": torch.randn((6, T, 768), generator=g)}
    multi = make_device_data_multistep(make_schedule(cfg.diffusion), cfg, opt, -4.0, 1.0)
    rows = np.array([[0, 1], [2, 3], [4, 5]])
    seed = 11
    losses = torch.cat([multi(state, pack, rows[:2], seed, [0, 1]),
                        multi(state, pack, rows[2:], seed, [2])]).tolist()

    params = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    ema = {k: v.clone() for k, v in w.items()}
    pu = {k[5:]: v for k, v in params.items() if k.startswith("unet/")}
    pc = {k[10:]: v for k, v in params.items() if k.startswith("cond_proj/")}
    st, sched = ref_adan.State(), ref_diff.schedule(dataclasses.asdict(cfg.diffusion))
    for s in range(3):
        gen = torch.Generator().manual_seed(ref_diff.step_seed(seed, s))
        batch = {k: v[torch.as_tensor(rows[s])] for k, v in pack.items()}
        loss = ref_diff.training_loss(pu, pc, m, sched, batch, mean=-4.0, std=1.0,
                                      cond_drop=0.2, generator=gen)
        loss.backward()
        ref_adan.step(params, {k: p.grad for k, p in params.items()}, ema, st, ref_adan.Hyper())
        for p in params.values():
            p.grad = None
        assert abs(loss.item() - losses[s]) <= 1e-5 * abs(loss.item())
    # Adan's first steps divide by sqrt(n), near zero for a few elements of a
    # leaf, where float32 sums in another order move them far: the median
    # leaf's change is held, and every leaf's value
    got = state.params()
    gaps = [rel(got[k].detach() - w[k], params[k].detach() - w[k]) for k in got
            if float((params[k].detach() - w[k]).norm()) > 1e-6]
    assert float(np.median(gaps)) < 1e-3
    assert max(rel(got[k].detach(), params[k].detach()) for k in got) < 1e-2
    assert max(rel(state.ema[k], ema[k]) for k in got) < 1e-5


def test_ddim_chain_matches():
    mc = model("ultimate")
    m = dataclasses.asdict(mc)
    d = dataclasses.asdict(DiffusionConfig())
    w = make_weights(ref.spec(m), 5, "cpu")
    den = build_denoiser(mc)
    den.load_state_dict(w)
    den.eval().requires_grad_(False).prepare(torch.float32)
    g = torch.Generator().manual_seed(3)
    mf, tf = torch.randn((1, T, 8), generator=g), torch.randn((1, T, 8), generator=g)
    seed = 2 ** 40 + 3
    got = ddim_sample(den, make_schedule(DiffusionConfig()), (1, T, 80), mf, tf, num_steps=6,
                      guidance_weight=2.1, generator=torch.Generator().manual_seed(seed),
                      uncond_fast=True)
    chain = ref_diff.Chain(d, "ddim", 6, 2.1)
    x = next(chain.draws(seed, 1, T, m, "cpu"))
    for i in range(6):
        x = chain.step(w, m, i, x, mf, tf)
    assert rel(got, x) < 1e-4


def test_ddpm_chain_matches():
    """The ancestral chain over a schedule of 8 timesteps, the reference's
    draws taken in the program's order from the request's seed."""
    mc = model("ultimate")
    m = dataclasses.asdict(mc)
    d = dataclasses.asdict(DiffusionConfig())
    w = make_weights(ref.spec(m), 6, "cpu")
    den = build_denoiser(mc)
    den.load_state_dict(w)
    den.eval().requires_grad_(False).prepare(torch.float32)
    g = torch.Generator().manual_seed(4)
    mf, tf = torch.randn((1, T, 8), generator=g), torch.randn((1, T, 8), generator=g)
    seed = 2 ** 40 + 5
    got = ddpm_sample(den, make_schedule(DiffusionConfig(timesteps=8)), (1, T, 80), mf, tf,
                      guidance_weight=2.1, generator=torch.Generator().manual_seed(seed),
                      uncond_fast=True)
    chain = ref_diff.Chain(d, "ddpm", 8, 2.1)
    draws = chain.draws(seed, 1, T, m, "cpu")
    x = next(draws)
    for i in range(8):
        x = chain.step(w, m, i, x, mf, tf, noise=next(draws))
    assert rel(got, x) < 1e-4


def test_bigvgan_matches():
    v = dict(dataclasses.asdict(VocoderConfig()), upsample_initial_channel=32,
             upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4), resblock_kernel_sizes=(3, 5),
             resblock_dilation_sizes=((1, 3), (1, 2)))
    w = make_weights(ref_voc.spec(v), 7, "cpu")
    gen = BigVGANGenerator(VocoderConfig(**v))
    gen.load_state_dict(w)
    mel = torch.randn((1, 80, 12), generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        got = gen(mel.transpose(1, 2))
    assert rel(got, ref_voc.vocode(w, v, mel)) < 1e-5


def test_condition_resampling_matches():
    a = np.random.default_rng(0).standard_normal((180, 5)).astype(np.float32)
    np.testing.assert_allclose(interp_frames(a, 516), match_len(a, 516, mode="interp"),
                               rtol=1e-6, atol=1e-6)
