"""Sequence parallelism of the port (``parallel/sequence.py``) on the CPU
over gloo: the mel's time axis sharded over 2 and 4 ranks of the model axis.

Each rank runs the serving forward of a tiny ``UNet1DUltimate`` on its rows
(GroupNorm statistics from the kernel's sums form, added over the ranks;
halo rows for the k=3 convs; the stride-2 downsampling and the
align-corners upsampling at global positions; the conditions gathered once
a chain) inside one DDPM or DDIM chain, and every rank returns the gathered
sample. It is held against the unsharded chain of the port and against the
JAX package's ``make_sequence_sharded_sampler`` on the conftest's eight
virtual devices, the same weights (a JAX init carried across), ``x_init``
and (DDPM) ``noise_seq``, at rtol = atol = 1e-4, the JAX test's own bound
(``tests/test_sequence_parallel.py``). Lengths: T = 64 (the JAX test's),
T = 66 (a stage of 33 frames, split 9/8/8/8 over four ranks, and the
upsampled 32 frames padded back to 33), and T = 5168 (60 s, as
``tests/test_multichip_flagship.py``; 1292 frames a rank, 4 DDIM steps,
against the unsharded port at the JAX test's chain bound, 1e-3). The
chain's census: halo exchanges (collective-permute), the all-reduce of
every GroupNorm's sums, and the gathers of the conditions and the sample.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lm2a_tpu.core.config import DiffusionConfig, ModelConfig
from lm2a_tpu.core.mesh import make_mesh as jax_make_mesh
from lm2a_tpu.diffusion import make_schedule as jax_make_schedule
from lm2a_tpu.models import build_denoiser as jax_build_denoiser
from lm2a_tpu.parallel.sequence import make_sequence_sharded_sampler as jax_sp_sampler
from lm2a_tpu_torch.core.config import ModelConfig as PortModelConfig
from lm2a_tpu_torch.diffusion.gaussian import ddim_sample, ddpm_sample
from lm2a_tpu_torch.diffusion.schedule import make_schedule
from lm2a_tpu_torch.models.factory import build_denoiser

from _torch_port_util import load_jax_params, one_torch_thread  # noqa: F401
from _torch_ranks import spawn

MODEL = dict(base_dim=16, dim_mults=(1, 2), cond_dim=8, time_emb_dim=16, num_res_blocks=1,
             mid_blocks=1, attn_heads=2)
TOL = dict(rtol=1e-4, atol=1e-4)
STEPS = 4  # timesteps of the DDPM schedule; DDIM steps over 1000


def _inputs(seed, t, timesteps=None):
    rng = np.random.default_rng(seed)
    x0 = rng.standard_normal((1, t, 80)).astype(np.float32)
    motion = rng.standard_normal((1, t, 8)).astype(np.float32)
    text = rng.standard_normal((1, t, 8)).astype(np.float32)
    ns = (rng.standard_normal((timesteps, 1, t, 80)).astype(np.float32)
          if timesteps else None)
    return x0, motion, text, ns


@pytest.fixture(scope="module")
def weights():
    model = jax_build_denoiser(ModelConfig(**MODEL))
    x = jnp.zeros((1, 64, 80))
    params = model.init(jax.random.key(3), x, jnp.zeros((1,), jnp.int32),
                        jnp.zeros((1, 64, 8)), jnp.zeros((1, 64, 8)))
    unet = load_jax_params(build_denoiser(PortModelConfig(**MODEL)), params["params"])
    return model, params, {"w|" + k: v.numpy() for k, v in unet.state_dict().items()}, unet


def _run(tmp_path, world, arrays, method, timesteps, guidance=2.0, steps=None):
    meta = dict(model=MODEL, timesteps=timesteps, method=method, steps=steps,
                guidance=guidance, uncond_fast=False, model_axis=world)
    return spawn("sp_sampler", world, tmp_path, dict(arrays, meta=meta))


def _port_ref(unet, method, timesteps, x0, motion, text, ns=None, guidance=2.0, steps=None):
    u = build_denoiser(PortModelConfig(**MODEL))
    u.load_state_dict(unet.state_dict())
    u = u.eval().requires_grad_(False).prepare(torch.float32)
    sched = make_schedule(DiffusionConfig(timesteps=timesteps))
    args = (u, sched, x0.shape, torch.tensor(motion), torch.tensor(text))
    if method == "ddim":
        return ddim_sample(*args, num_steps=steps, guidance_weight=guidance,
                           x_init=torch.tensor(x0)).numpy()
    return ddpm_sample(*args, guidance_weight=guidance, x_init=torch.tensor(x0),
                       noise_seq=torch.tensor(ns)).numpy()


def _check_census(census):
    c = census["collectives"]
    assert c["collective-permute"] >= 1 and c["all-gather"] == 2 and c["all-reduce"] >= 1, c


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("t", [64, 66])
def test_sp_ddpm_matches_unsharded_and_jax(weights, tmp_path, world, t):
    model, params, arrays, unet = weights
    x0, motion, text, ns = _inputs(t + world, t, STEPS)
    outs = _run(tmp_path, world, dict(arrays, x_init=x0, motion=motion, text=text,
                                      noise_seq=ns), "ddpm", STEPS)
    ref = _port_ref(unet, "ddpm", STEPS, x0, motion, text, ns)
    for o in outs:
        np.testing.assert_allclose(o["x"], ref, **TOL)
        np.testing.assert_array_equal(o["x"], outs[0]["x"])
        _check_census(o["census"])
    mesh = jax_make_mesh(model=world)
    run = jax_sp_sampler(model.apply, jax_make_schedule(DiffusionConfig(timesteps=STEPS)),
                         mesh, guidance_weight=2.0, x_init=jnp.asarray(x0),
                         noise_seq=jnp.asarray(ns))
    want = np.asarray(run(params, jax.random.key(7), (1, t, 80), jnp.asarray(motion),
                          jnp.asarray(text)))
    np.testing.assert_allclose(outs[0]["x"], want, **TOL)


def test_sp_ddim_60s_matches_unsharded(weights, tmp_path):
    """T = 5168 (60 s) over four ranks, DDIM-4 at CFG 2.1, against the
    unsharded port chain; the JAX test's chain bound (its clamps amplify
    reduction-order noise), 1e-3."""
    _, _, arrays, unet = weights
    t = 5168
    x0, motion, text, _ = _inputs(11, t)
    outs = _run(tmp_path, 4, dict(arrays, x_init=x0, motion=motion, text=text), "ddim", 1000,
                guidance=2.1, steps=4)
    ref = _port_ref(unet, "ddim", 1000, x0, motion, text, guidance=2.1, steps=4)
    np.testing.assert_allclose(outs[0]["x"], ref, rtol=1e-3, atol=1e-3)
    assert np.isfinite(outs[0]["x"]).all()
    _check_census(outs[0]["census"])


# ---------------------------------------------------------------- the train step

def _train_payload(cfg, state0, steps, b, t, draws=(), mode="draws"):
    from lm2a_tpu_torch.core.config import config_to_dict

    rng = np.random.default_rng(b + t)
    arrays = {}
    for i in range(steps):
        arrays.update({f"mel_{i}": (-4.5 + 2.0 * rng.standard_normal((b, t, 80))).astype(np.float32),
                       f"motion_{i}": rng.standard_normal((b, t, 12)).astype(np.float32),
                       f"lyrics_{i}": rng.standard_normal((b, t, 24)).astype(np.float32)})
    for i, d in enumerate(draws):
        arrays.update({f"t_{i}": d.t.numpy(), f"noise_{i}": d.noise.numpy()})
        if d.keep is not None:
            arrays[f"keep_{i}"] = d.keep.numpy()
    arrays.update({"state|" + k: v for k, v in state0.items()})
    arrays["meta"] = dict(cfg=config_to_dict(cfg), batch=b, steps=steps, mode=mode, seed=5,
                          mean=-4.5, std=2.0)
    return arrays


def _sp_cfg(dropout):
    from lm2a_tpu.core.config import LM2AConfig, TrainConfig

    return LM2AConfig(
        model=ModelConfig(base_dim=16, dim_mults=(1, 2), cond_dim=8, time_emb_dim=16,
                          num_res_blocks=1, mid_blocks=1, attn_heads=2, motion_dim=12,
                          text_dim=24, dropout=dropout),
        diffusion=DiffusionConfig(timesteps=20),
        train=TrainConfig(batch_size=4, compute_dtype="float32"),
    )


def _state_at(out, i):
    pre = f"state|{i}|"
    return {k[len(pre):]: v for k, v in out.items() if k.startswith(pre)}


def test_sp_train_step_matches_unsharded(tmp_path):
    """(data=1, model=2) over B=4, T=32, the draws injected (seeded numpy:
    timesteps, noise, the CFG keep mask): the port's unsharded step, two
    steps, ``test_torch_train.py``'s tolerances; both ranks end with one
    state; the census shows the halos, the gathers of the conditions and
    their gradients, and the all-reduces."""
    from lm2a_tpu.core.config import config_to_dict as jax_config_to_dict
    from lm2a_tpu_torch.core.config import config_from_dict
    from lm2a_tpu_torch.training.checkpoint import state_arrays
    from lm2a_tpu_torch.training.train_step import Draws, init_train_state, make_train_step
    from test_torch_train import TOL_LOSS, assert_state_close

    cfg = config_from_dict(jax_config_to_dict(_sp_cfg(0.0)))
    b, t, steps = 4, 32, 2
    one = init_train_state(cfg, 0, "cpu")
    state0 = state_arrays(one)
    rng = np.random.default_rng(9)
    draws = [Draws(torch.tensor(rng.integers(0, 20, size=b)),
                   torch.tensor(rng.standard_normal((b, t, 80)).astype(np.float32)),
                   torch.tensor((rng.random((b, 1, 1)) > 0.2).astype(np.float32)))
             for _ in range(steps)]
    payload = _train_payload(cfg, state0, steps, b, t, draws)
    payload["meta"]["model_axis"] = 2
    outs = spawn("sp_step", 2, tmp_path, payload)
    step = make_train_step(make_schedule(cfg.diffusion), cfg, dataset_mean=-4.5, dataset_std=2.0)
    before = state0
    for i in range(steps):
        batch = {k: torch.tensor(payload[f"{k}_{i}"]) for k in ("mel", "motion", "lyrics")}
        loss = step(one, batch, draws=draws[i])
        got = _state_at(outs[0], i)
        got0 = _state_at(outs[0], i - 1) if i else state0
        assert float(outs[0][f"loss_{i}"]) == pytest.approx(float(loss), rel=TOL_LOSS)
        assert_state_close(got, state_arrays(one), got0, before, warm=i > 0)
        for k, v in got.items():
            assert np.array_equal(v, _state_at(outs[1], i)[k]), k
        before = state_arrays(one)
    c = outs[0]["census"]["collectives"]
    assert c["collective-permute"] >= 1 and c["all-gather"] == 2 and c["all-reduce"] >= 1, c


def test_sp_train_step_with_dropout_matches_unsharded(tmp_path):
    """(data=2, model=2) over four ranks, dropout 0.1 and the CFG drop from
    the step generator, drawn at the global (B, T, C) shapes: the unsharded
    port step's loss and state."""
    from lm2a_tpu_torch.core.config import config_from_dict
    from lm2a_tpu.core.config import config_to_dict as jax_config_to_dict
    from lm2a_tpu_torch.training.checkpoint import state_arrays
    from lm2a_tpu_torch.training.train_step import init_train_state, make_train_step, step_generator
    from test_torch_train import TOL_LOSS, assert_state_close

    cfg = config_from_dict(jax_config_to_dict(_sp_cfg(0.1)))
    b, t, steps = 4, 32, 2
    one = init_train_state(cfg, 0, "cpu")
    state0 = state_arrays(one)
    payload = _train_payload(cfg, state0, steps, b, t, mode="generator")
    payload["meta"]["model_axis"] = 2
    outs = spawn("sp_step", 4, tmp_path, payload)
    step = make_train_step(make_schedule(cfg.diffusion), cfg, dataset_mean=-4.5, dataset_std=2.0)
    before = state0
    for i in range(steps):
        batch = {k: torch.tensor(payload[f"{k}_{i}"]) for k in ("mel", "motion", "lyrics")}
        loss = step(one, batch, generator=step_generator(5, i, "cpu"))
        got0 = _state_at(outs[0], i - 1) if i else state0
        for o in outs:
            assert float(o[f"loss_{i}"]) == pytest.approx(float(loss), rel=TOL_LOSS)
        assert_state_close(_state_at(outs[0], i), state_arrays(one), got0, before, warm=i > 0)
        before = state_arrays(one)


def test_sp_train_step_refuses_a_batch_off_the_cpu():
    """The step takes ``fused_resblock_grad`` (on the card its gated blocks
    launch the kernels; ``tests/test_torch_sp_fused.py`` holds the step on
    the CPU). Off the CPU nothing falls back to a plain version: a gated
    block on a device that is neither the CPU nor the card (here the meta
    device) reaches the fused chain's kernel wrappers, which refuse it."""
    import dataclasses

    from lm2a_tpu.core.config import config_to_dict as jax_config_to_dict
    from lm2a_tpu_torch.core.config import config_from_dict
    from lm2a_tpu_torch.core.mesh import make_mesh
    from lm2a_tpu_torch.models.factory import build_denoiser as port_build_denoiser
    from lm2a_tpu_torch.parallel.sequence import SeqShard, _block_train, make_sp_train_step

    cfg = config_from_dict(jax_config_to_dict(_sp_cfg(0.0)))
    fused = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                               fused_resblock_grad=True))
    make_sp_train_step(make_schedule(cfg.diffusion), fused, mesh=make_mesh())
    unet = port_build_denoiser(fused.model).to("meta")
    blk = unet.down_0_block_0
    x = torch.empty((2, 32, blk.in_channels), device="meta")
    t_emb = torch.empty((2, fused.model.time_emb_dim), device="meta")
    with pytest.raises(ValueError, match="unsupported device meta"):
        _block_train(blk, SeqShard(make_mesh()), x, 32, t_emb, None, None, torch.float32, None,
                     fused=True)
