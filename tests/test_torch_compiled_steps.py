"""The port's compiled steps (the JAX package's jitted hot loops) on the CPU,
where each step runs eagerly through the same step function a CUDA graph
captures on the card.

- ``superbatch_iterator``, ``SuperbatchStream`` and ``superbatch_indices``
  (the device-resident rows): the JAX package's exact row order and
  ``multi``/``single`` tags for K = 2 and 3, across epochs and tails;
- ``make_multistep_train_step``, ``make_device_data_multistep``,
  ``make_device_data_eval`` and ``make_multistep_eval`` (the functions
  ``cli train`` calls): K single steps bit for bit (dropout and the
  CFG drop drawn from the per-step generators), and the JAX package's
  functions under injected draws within ``test_torch_train.py``'s bounds;
- the sampler step functions (``ddpm_step``, ``ddim_step``) as a manual
  eager chain against the JAX chains under ``x_init``/``noise_seq`` at
  ``test_torch_slice.py``'s tolerances;
- the sampler chain cache: its key, LRU eviction at the cap, one entry for
  every weight above 1, a fresh cache from ``with_streaming_attention``;
- ``cli train --steps_per_call 2 --device_data``: checkpoints at the JAX
  rule's steps, the final state the K = 1 run's bit for bit;
- the launch ledger: a capture's launches recorded against its graph and
  added at each replay, the first call's counted eagerly, exercised with a
  stub C entry and a stub CUDA graph;
- the kernels' width rule (channel counts multiples of 8, any C/G) takes
  every block of base widths 16, 32, 48, 64 and 96 and of the flagship, so
  the card routes what the JAX gate routes, and the CPU route is the JAX
  gate's; a width that is not a multiple of 8 is refused by name; the DDIM
  coefficient table against the JAX chain's per-step scalars, bit for bit.
"""

import contextlib
import dataclasses
import json
import os
import sys
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from lm2a_tpu.core.config import config_to_dict as jax_config_to_dict
from lm2a_tpu.data import dataset as jds
from lm2a_tpu.diffusion.gaussian import ddim_sample as jax_ddim
from lm2a_tpu.diffusion.gaussian import ddpm_sample as jax_ddpm
from lm2a_tpu.diffusion.schedule import make_schedule as jax_make_schedule
from lm2a_tpu.training.train_step import make_device_data_eval as jax_dd_eval
from lm2a_tpu.training.train_step import make_device_data_multistep as jax_dd_multi
from lm2a_tpu.training.train_step import make_eval_step as jax_eval
from lm2a_tpu.training.train_step import make_multistep_train_step as jax_multi
from lm2a_tpu_torch.cli import __main__ as cli_main
from lm2a_tpu_torch.core import graphs
from lm2a_tpu_torch.core.config import DiffusionConfig, LM2AConfig, ModelConfig, config_from_dict
from lm2a_tpu_torch.data import dataset as pds
from lm2a_tpu_torch.diffusion import gaussian
from lm2a_tpu_torch.diffusion.schedule import make_schedule
from lm2a_tpu_torch.inference.longform import with_streaming_attention
from lm2a_tpu_torch.inference.sample import generate_mel, load_models
from lm2a_tpu_torch.ops import _build
from lm2a_tpu_torch.ops import attention as att
from lm2a_tpu_torch.ops.resblock import check_widths
from lm2a_tpu_torch.ops.resblock_grad import _check_act, fused_resblock_train, resblock_train_fits
from lm2a_tpu_torch.training import train_step as pts
from lm2a_tpu_torch.training.checkpoint import (
    latest_checkpoint, list_checkpoints, restore_checkpoint, state_arrays,
)
from lm2a_tpu_torch.training.train_step import (
    init_train_state, make_device_data_eval, make_device_data_multistep, make_eval_step,
    make_multistep_eval, make_multistep_train_step, make_train_step, step_generator,
)

from _torch_port_util import jax_state_arrays, one_torch_thread, port_train_state, rand  # noqa: F401
from test_torch_slice import TINY_CFG, MEL_T, _denorm, _jax_fn, both, ckpt, jax_state  # noqa: F401
from test_torch_train import (
    MEAN, STD, T, TOL_LOSS, assert_state_close, jax_cfg, jax_draws, make_batch, make_setup,
)
from test_torch_train_cli import TINY


# ---------------------------------------------------------------- data streams

N_PACK = 11


@pytest.fixture(scope="module")
def pack(tmp_path_factory):
    d = tmp_path_factory.mktemp("sb")
    chip_smoke.write_clips(str(d / "clips"), N_PACK, seed=4, mel_t=12, motion_t=5)
    pds.pack_dataset(str(d / "clips"), str(d / "pack"))
    return str(d / "pack")


def _same_items(got, want):
    got, want = list(got), list(want)
    assert [t for t, _ in got] == [t for t, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert set(a) == set(b)
        for k in a:
            assert a[k].shape == b[k].shape and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("shuffle", [True, False])
def test_superbatch_iterator_matches_jax(pack, k, shuffle):
    port, ref = pds.PackedDataset(pack), jds.PackedDataset(pack, use_native=False)
    for seed in (0, 5):
        got = list(pds.superbatch_iterator(port, 2, k, shuffle=shuffle, seed=seed))
        _same_items(got, jds.superbatch_iterator(ref, 2, k, shuffle=shuffle, seed=seed))
        n_multi = N_PACK // (2 * k)
        assert [t for t, _ in got] == ["multi"] * n_multi + ["single"] * (
            (N_PACK - n_multi * 2 * k) // 2)
        assert got[0][1]["mel"].shape == (k, 2, 12, 80)


@pytest.mark.parametrize("k", [2, 3])
def test_superbatch_stream_matches_jax_across_epochs(pack, k):
    port, ref = pds.PackedDataset(pack), jds.PackedDataset(pack, use_native=False)
    ps = pds.SuperbatchStream(port, 2, k, base_seed=7, total_epochs=4, start_epoch=1)
    rs = jds.SuperbatchStream(ref, 2, k, base_seed=7, total_epochs=4, start_epoch=1)
    for epoch in (1, 2, 3):
        _same_items(ps.epoch(epoch), rs.epoch(epoch))
    with pytest.raises(ValueError, match="in order"):
        next(ps.epoch(1))
    ps.drain()


def test_superbatch_stream_drains_mid_epoch(pack):
    ps = pds.SuperbatchStream(pds.PackedDataset(pack), 2, 2, total_epochs=None)
    tag, batch = next(ps.epoch(0))
    assert tag == "multi" and batch["mel"].shape == (2, 2, 12, 80)
    ps.drain()
    assert ps._thread is None and ps._queue.empty()


@pytest.mark.parametrize("k", [2, 3])
def test_superbatch_indices_are_the_jax_device_data_order(pack, k):
    """The rows ``--device_data`` gathers: the JAX loop's device-resident
    order (``default_rng(seed + epoch)``, K-groups, then single tails), and
    the rows of ``superbatch_iterator``'s batches."""
    ds = pds.PackedDataset(pack)
    for seed in (0, 5):
        order = np.arange(N_PACK)
        np.random.default_rng(seed).shuffle(order)
        group = 2 * k
        n_groups = N_PACK // group
        want = [("multi", order[g * group:(g + 1) * group].reshape(k, 2))
                for g in range(n_groups)]
        want += [("single", order[s:s + 2][None]) for s in range(n_groups * group, N_PACK - 1, 2)]
        got = list(pds.superbatch_indices(N_PACK, 2, k, seed=seed))
        assert [t for t, _ in got] == [t for t, _ in want]
        assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(got, want))
        batches = list(pds.superbatch_iterator(ds, 2, k, seed=seed))
        for (_, rows), (_, batch) in zip(got, batches):
            assert np.array_equal(batch["mel"].reshape(-1, 12, 80), ds.mel[rows.reshape(-1)])


def test_device_prefetch_passes_tags(pack):
    stream = pds.superbatch_iterator(pds.PackedDataset(pack), 2, 2, seed=1)
    want = list(pds.superbatch_iterator(pds.PackedDataset(pack), 2, 2, seed=1))
    got = list(pds.device_prefetch(stream, "cpu", tagged=True))
    assert [t for t, _ in got] == [t for t, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert all(torch.equal(a[key], torch.from_numpy(b[key])) for key in b)


# ---------------------------------------------------------------- the K-step functions

K = 2


def _port_cfg(dropout: float = 0.1):
    cfg = config_from_dict(jax_config_to_dict(jax_cfg(True)))
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, dropout=dropout))


def _stack(batches):
    return {k: torch.tensor(np.stack([b[k] for b in batches])) for k in batches[0]}


def _singles(cfg, batches, seed, offsets):
    state = init_train_state(cfg, 1, "cpu")
    step = make_train_step(make_schedule(cfg.diffusion), cfg, dataset_mean=MEAN,
                           dataset_std=STD)
    losses = [step(state, {k: torch.tensor(v) for k, v in b.items()},
                   generator=step_generator(seed, off, "cpu")) for b, off in zip(batches, offsets)]
    return state, torch.stack(losses)


def _assert_same_state(a, b):
    sa, sb = state_arrays(a), state_arrays(b)
    assert set(sa) == set(sb)
    for k in sa:
        assert np.array_equal(sa[k], sb[k]), k


def test_multistep_equals_single_steps_bit_for_bit():
    cfg = _port_cfg()
    batches = [make_batch(40 + i) for i in range(2 * K)]
    want_state, want = _singles(cfg, batches, 3, [5, 6, 7, 8])
    state = init_train_state(cfg, 1, "cpu")
    multi = make_multistep_train_step(make_schedule(cfg.diffusion), cfg, dataset_mean=MEAN,
                                      dataset_std=STD)
    got = torch.cat([multi(state, _stack(batches[:K]), 3, [5, 6]),
                     multi(state, _stack(batches[K:]), 3, [7, 8])])
    assert torch.equal(got, want) and state.step == state.opt.step == 4
    _assert_same_state(state, want_state)


def test_device_data_multistep_and_eval_equal_single_steps_bit_for_bit():
    cfg = _port_cfg()
    pool = [make_batch(50 + i) for i in range(3)]
    data = {k: torch.tensor(np.concatenate([b[k] for b in pool])) for k in pool[0]}
    idx = np.array([[4, 1], [0, 5], [2, 2]])
    batches = [{k: v[r].numpy() for k, v in data.items()} for r in idx]
    want_state, want = _singles(cfg, batches, 2, [0, 1, 2])
    state = init_train_state(cfg, 1, "cpu")
    multi = make_device_data_multistep(make_schedule(cfg.diffusion), cfg, dataset_mean=MEAN,
                                       dataset_std=STD)
    got = torch.cat([multi(state, data, idx[:2], 2, [0, 1]), multi(state, data, idx[2:], 2, [2])])
    assert torch.equal(got, want)
    _assert_same_state(state, want_state)

    ev = make_eval_step(make_schedule(cfg.diffusion), cfg, MEAN, STD)
    want_ev = torch.stack([ev(state, {k: torch.tensor(v) for k, v in b.items()},
                              generator=step_generator(2, 10 + j, "cpu"))
                           for j, b in enumerate(batches)])
    dd_eval = make_device_data_eval(make_schedule(cfg.diffusion), cfg, MEAN, STD)
    assert torch.equal(dd_eval(state, data, idx, 2, [10, 11, 12]), want_ev)


def test_multistep_eval_equals_eval_steps_bit_for_bit():
    """Streamed validation (``make_multistep_eval``, what ``cli train`` runs
    when the val split is not device-resident) against ``make_eval_step``
    batch by batch, each from its own generator."""
    cfg = _port_cfg()
    state = init_train_state(cfg, 1, "cpu")
    batches = [make_batch(80 + i) for i in range(3)]
    ev = make_eval_step(make_schedule(cfg.diffusion), cfg, MEAN, STD)
    want = torch.stack([ev(state, {k: torch.tensor(v) for k, v in b.items()},
                           generator=step_generator(4, 20 + j, "cpu"))
                        for j, b in enumerate(batches)])
    fn = make_multistep_eval(make_schedule(cfg.diffusion), cfg, MEAN, STD)
    got = torch.cat([fn(state, _stack(batches[:2]), 4, [20, 21]),
                     fn(state, _stack(batches[2:]), 4, [22])])
    assert torch.equal(got, want) and state.step == 0


@pytest.fixture(scope="module")
def setup():
    return make_setup(True)


def _inject(monkeypatch, draws):
    """Make the port's K-step functions take the JAX draws, step by step
    (the steps run eagerly on the CPU)."""
    feed = iter(draws)
    real_train, real_eval = pts.make_train_step, pts.make_eval_step

    def train_step(*a, **kw):
        one = real_train(*a, **kw)
        inner = one.device_step
        one.device_step = lambda state, batch, scal, generator=None: inner(
            state, batch, scal, draws=next(feed))
        return one

    def eval_step(*a, **kw):
        inner = real_eval(*a, **kw)
        return lambda state, batch, generator=None: inner(state, batch, draws=next(feed))

    monkeypatch.setattr(pts, "make_train_step", train_step)
    monkeypatch.setattr(pts, "make_eval_step", eval_step)


@pytest.mark.parametrize("form", ["stacked", "device_data"])
def test_multistep_matches_jax(setup, monkeypatch, form):
    s = setup
    cfg, port_cfg = s["cfg"], s["port_cfg"]
    pool = [make_batch(60 + i) for i in range(3)]
    data = {k: np.concatenate([b[k] for b in pool]) for k in pool[0]}
    idx = np.array([[5, 0], [3, 3]], np.int32)
    base, offsets = jax.random.key(11), np.array([4, 5], np.int32)
    jargs = dict(dataset_mean=MEAN, dataset_std=STD)
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    jstate = jax.tree.map(jnp.copy, s["state"])
    if form == "stacked":
        jbatches = {k: v[idx] for k, v in jdata.items()}
        jstate, jlosses = jax_multi(s["den"], s["cp"], s["schedule"], cfg, s["tx"], **jargs)(
            jstate, jbatches, base, jnp.asarray(offsets))
    else:
        jstate, jlosses = jax_dd_multi(s["den"], s["cp"], s["schedule"], cfg, s["tx"], **jargs)(
            jstate, jdata, jnp.asarray(idx), base, jnp.asarray(offsets))
    _inject(monkeypatch, [jax_draws(jax.random.fold_in(base, int(o)), jdata["mel"][r],
                                    cfg.train.cond_drop_prob, cfg.diffusion.timesteps, True)
                          for r, o in zip(idx, offsets)])
    pstate = port_train_state(port_cfg, s["state"])
    got0, want0 = state_arrays(pstate), jax_state_arrays(s["state"])
    sched = make_schedule(port_cfg.diffusion)
    if form == "stacked":
        losses = make_multistep_train_step(sched, port_cfg, **jargs)(
            pstate, {k: torch.tensor(v[idx]) for k, v in data.items()}, 0, offsets)
    else:
        losses = make_device_data_multistep(sched, port_cfg, **jargs)(
            pstate, {k: torch.tensor(v) for k, v in data.items()}, idx, 0, offsets)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=TOL_LOSS)
    assert_state_close(state_arrays(pstate), jax_state_arrays(jstate), got0, want0, warm=True)


def test_device_data_eval_matches_jax(setup, monkeypatch):
    s = setup
    cfg, port_cfg = s["cfg"], s["port_cfg"]
    pool = [make_batch(70 + i) for i in range(2)]
    data = {k: np.concatenate([b[k] for b in pool]) for k in pool[0]}
    idx = np.array([[0, 1], [2, 3], [3, 1]], np.int32)
    base, offsets = jax.random.key(12), 10_000_000 + np.arange(3, dtype=np.int32)
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    want = jax_dd_eval(s["den"], s["cp"], s["schedule"], cfg, dataset_mean=MEAN,
                       dataset_std=STD)(s["state"].params, jdata, jnp.asarray(idx), base,
                                        jnp.asarray(offsets))
    _inject(monkeypatch, [jax_draws(jax.random.fold_in(base, int(o)), jdata["mel"][r], 0.0,
                                    cfg.diffusion.timesteps, False)
                          for r, o in zip(idx, offsets)])
    got = make_device_data_eval(make_schedule(port_cfg.diffusion), port_cfg, MEAN, STD)(
        port_train_state(port_cfg, s["state"]), {k: torch.tensor(v) for k, v in data.items()},
        idx, 0, offsets)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL_LOSS)


def test_multistep_eval_matches_jax(setup, monkeypatch):
    """``make_multistep_eval`` against the JAX package's ``make_eval_step``
    (the jitted step its loop runs over streamed validation batches) under
    the JAX draws."""
    s = setup
    cfg, port_cfg = s["cfg"], s["port_cfg"]
    batches = [make_batch(90 + i) for i in range(2)]
    base, offsets = jax.random.key(13), 10_000_000 + np.arange(2, dtype=np.int32)
    jev = jax_eval(s["den"], s["cp"], s["schedule"], cfg, dataset_mean=MEAN, dataset_std=STD)
    want, draws = [], []
    for b, o in zip(batches, offsets):
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        key = jax.random.fold_in(base, int(o))
        want.append(float(jev(s["state"].params, jb, key)))
        draws.append(jax_draws(key, jb["mel"], 0.0, cfg.diffusion.timesteps, False))
    _inject(monkeypatch, draws)
    got = make_multistep_eval(make_schedule(port_cfg.diffusion), port_cfg, MEAN, STD)(
        port_train_state(port_cfg, s["state"]), _stack(batches), 0, offsets)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL_LOSS)


def test_step_runner_refuses_rows_it_does_not_hold():
    cfg = _port_cfg()
    state = init_train_state(cfg, 1, "cpu")
    runner = pts.StepRunner(make_train_step(make_schedule(cfg.diffusion), cfg), state, None, 2, 2)
    rows = runner.load(_stack([make_batch(1), make_batch(2)]))
    assert rows.tolist() == [[0, 1], [2, 3]]
    with pytest.raises(ValueError, match="rows"):
        runner.run(np.zeros((3, 2), np.int64), 0, [0, 1, 2])
    with pytest.raises(ValueError, match="does not fit"):
        runner.load(_stack([make_batch(i) for i in range(3)]))


# ---------------------------------------------------------------- the sampler steps

def test_ddim_step_chain_matches_jax(both):
    """``ddim_step`` driven by hand over a ``SamplerChain`` (the loop a graph
    replays on the card) against JAX's DDIM chain, CFG 2.1."""
    jm, pm, (jmf, jtf), (pmf, ptf), rng = both
    shape = (1, MEL_T, TINY_CFG.model.in_dim)
    x_init = rand(rng, *shape)
    want = jax_ddim(_jax_fn(jm), jax_make_schedule(TINY_CFG.diffusion), jax.random.key(0),
                    shape, jmf, jtf, num_steps=5, guidance_weight=2.1,
                    x_init=jnp.asarray(x_init), uncond_fast=True)
    chain = gaussian.SamplerChain(make_schedule(TINY_CFG.diffusion), shape, "ddim", num_steps=5)
    conds, gw, _ = chain.start(pmf, ptf, 2.1, torch.tensor(x_init), None)
    assert gw is chain.gw and float(chain.gw) == np.float32(2.1)
    with torch.no_grad():
        for n in range(chain.n_steps):
            assert int(chain.i) == n
            gaussian.ddim_step(pm.denoiser, chain.x, chain.i, chain.ts, chain.coef, conds, gw,
                               None, True, 0.0, 2.0)
    assert float(np.max(np.abs(_denorm(pm, chain.x.numpy()) - _denorm(jm, want)))) < 1e-3


def test_ddpm_step_chain_matches_jax(both):
    jm, pm, (jmf, jtf), (pmf, ptf), rng = both
    steps = TINY_CFG.diffusion.timesteps
    shape = (1, MEL_T, TINY_CFG.model.in_dim)
    x_init, noise = rand(rng, *shape), rand(rng, steps, *shape)
    want = jax_ddpm(_jax_fn(jm), jax_make_schedule(TINY_CFG.diffusion), jax.random.key(0),
                    shape, jmf, jtf, guidance_weight=2.1, x_init=jnp.asarray(x_init),
                    noise_seq=jnp.asarray(noise), uncond_fast=True)
    sched = make_schedule(TINY_CFG.diffusion)
    chain = gaussian.SamplerChain(sched, shape, "ddpm")
    conds, gw, noise_t = chain.start(pmf, ptf, 2.1, torch.tensor(x_init), torch.tensor(noise))
    with torch.no_grad():
        for _ in range(chain.n_steps):
            gaussian.ddpm_step(pm.denoiser, sched, chain.x, chain.i, chain.ts, conds, gw, None,
                               True, noise_t)
    np.testing.assert_allclose(chain.x.numpy(), np.asarray(want), rtol=2e-5, atol=1e-5)


def test_ddim_coefficients_are_the_host_floats():
    """The DDIM table holds the fp32 values the per-step host code computed,
    and a chain with eta > 0 draws its noise from the chain's generator."""
    sched = make_schedule(TINY_CFG.diffusion)
    ab = sched.alpha_bars.numpy()
    ts, tp = gaussian.ddim_time_grid(8, 4)
    coef = gaussian.ddim_coefficients(ab, ts, tp, 0.0)
    one = np.float32(1)
    assert coef.dtype == np.float32 and coef.shape == (4, 5)
    assert coef[0, 0] == np.sqrt(one - ab[ts[0]]) and coef[-1, 2] == one
    assert (coef[:, 4] == 0).all()
    noisy = gaussian.ddim_coefficients(ab, ts, tp, 1.0)
    assert (noisy[:-2, 4] > 0).all() and noisy[-1, 4] == 0

    def model(x, t, m, l, **kw):
        return torch.zeros_like(x)

    outs = [gaussian.ddim_sample(model, sched, (1, 4, 80), num_steps=4, eta=1.0,
                                 generator=torch.Generator().manual_seed(s)) for s in (1, 1, 2)]
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])


@pytest.mark.parametrize("timesteps,num_steps,eta", [
    (1000, 50, 0.0), (1000, 10, 0.0), (1000, 4, 0.5), (50, 7, 1.0), (8, 3, 0.0)])
def test_ddim_table_is_the_jax_chains_scalars(timesteps, num_steps, eta):
    """Each row of the device table a DDIM step reads against the scalars
    JAX's ``ddim_sample`` step computes at that step (its fp32 ``jnp``
    expressions, ``t_prev < 0`` giving ab_prev = 1 and sigma = 0, noise only
    where ``t_prev > 0``): the same bits."""
    sched = jax_make_schedule(DiffusionConfig(timesteps=timesteps))
    ts, tp = gaussian.ddim_time_grid(timesteps, num_steps)
    table = gaussian.ddim_coefficients(np.asarray(sched.alpha_bars), ts, tp, eta)
    for row, t, t_prev in zip(table, ts, tp):
        ab_t = sched.alpha_bars[t]
        ab_prev = jnp.where(t_prev < 0, 1.0, sched.alpha_bars[max(t_prev, 0)])
        var_ratio = (1.0 - ab_prev) / (1.0 - ab_t) * (1.0 - ab_t / ab_prev)
        sigma = jnp.where(t_prev < 0, 0.0, eta * jnp.sqrt(jnp.maximum(var_ratio, 0.0)))
        want = [jnp.sqrt(1.0 - ab_t), jnp.sqrt(ab_t), jnp.sqrt(ab_prev),
                jnp.sqrt(jnp.maximum(1.0 - ab_prev - sigma ** 2, 0.0)),
                jnp.where(t_prev > 0, sigma, 0.0)]
        np.testing.assert_array_equal(row, np.asarray(want, np.float32), err_msg=f"t={t}")


def test_debug_telemetry_chain_is_the_same_step():
    """``collect_stats`` (the ``--debug`` telemetry, eager on every device)
    runs the same step function: the same final x as the chain without it,
    and a (T, 8) row of statistics a step, its last row the final x's."""
    sched = make_schedule(TINY_CFG.diffusion)

    def model(x, t, m, l, **kw):
        return 0.1 * x + t.float()[:, None, None] / 100

    def run(stats):
        return gaussian.ddpm_sample(model, sched, (2, 6, 80), collect_stats=stats,
                                    generator=torch.Generator().manual_seed(5))

    x, table = run(True)
    assert torch.equal(x, run(False)) and table.shape == (TINY_CFG.diffusion.timesteps, 8)
    assert table[-1, 0] == x.min() and table[-1, 3] == x.std(unbiased=False)


# ---------------------------------------------------------------- the chain cache

CACHE_CFG = LM2AConfig(
    model=ModelConfig(base_dim=16, dim_mults=(1, 2), cond_dim=8, time_emb_dim=16,
                      num_res_blocks=1, mid_blocks=1, attn_heads=2),
    diffusion=DiffusionConfig(timesteps=8),
)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    ckpt = chip_smoke.write_checkpoint(str(tmp_path_factory.mktemp("cache") / "ckpt"),
                                       CACHE_CFG, seed=0)
    return ckpt


def _gen(m, **kw):
    rng = np.random.default_rng(0)
    kw.setdefault("seed", 3)
    return generate_mel(m, rng.standard_normal((16, 234)).astype(np.float32),
                        rng.standard_normal((16, 768)).astype(np.float32), 24, **kw)[0]


def test_chain_cache_key_and_guidance_weights(models):
    m = load_models(models, device="cpu")
    a = _gen(m, guidance_weight=1.5)
    b = _gen(m, guidance_weight=2.1)
    c = _gen(m, guidance_weight=2.1)
    assert list(m._samplers) == [(24, 8, True, "ddpm", 1, None)]  # one chain, every weight
    assert np.array_equal(b, c) and not np.array_equal(a, b)
    assert not np.array_equal(b, _gen(m, guidance_weight=2.1, seed=4))
    _gen(m, guidance_weight=1.0, method="ddim", ddim_steps=4)
    _gen(m, guidance_weight=2.1, batch=2)
    assert list(m._samplers) == [(24, 8, True, "ddpm", 1, None),
                                 (24, 8, False, "ddim", 1, 4),
                                 (24, 8, True, "ddpm", 2, None)]
    chain = m._samplers[(24, 8, True, "ddpm", 1, None)]
    assert len(chain.steps) == 1  # one captured step serves every weight


def test_chain_cache_is_lru_capped(models):
    m = load_models(models, device="cpu")
    m.sampler_cache_max = 2
    for steps in (2, 3, 4):
        _gen(m, steps=steps, guidance_weight=2.1)
    assert [k[1] for k in m._samplers] == [3, 4]  # the oldest geometry evicted
    _gen(m, steps=3, guidance_weight=2.1)  # a hit refreshes its place
    _gen(m, steps=5, guidance_weight=2.1)
    assert [k[1] for k in m._samplers] == [3, 5]


def test_cached_chain_equals_a_fresh_one(models):
    m = load_models(models, device="cpu")
    first = _gen(m, guidance_weight=2.1, method="ddim", ddim_steps=3)
    again = _gen(m, guidance_weight=2.1, method="ddim", ddim_steps=3)
    fresh = _gen(load_models(models, device="cpu"), guidance_weight=2.1, method="ddim",
                 ddim_steps=3)
    assert np.array_equal(first, again) and np.array_equal(first, fresh)


def test_streaming_attention_copy_has_a_fresh_cache(models, monkeypatch):
    m = load_models(models, device="cpu")
    m.sampler_cache_max = 16
    _gen(m, guidance_weight=2.1)
    monkeypatch.setattr(att, "FUSED_ATTENTION_MIN_T", 8)
    long = with_streaming_attention(m, 24)
    assert long is not m and long._samplers is not m._samplers and not long._samplers
    assert long.sampler_cache_max == 16 and len(m._samplers) == 1
    _gen(long, guidance_weight=2.1)
    assert len(long._samplers) == 1 and len(m._samplers) == 1
    assert with_streaming_attention(m, 24)._samplers == {}


# ---------------------------------------------------------------- cli train, K = 2 on the device

def _train(monkeypatch, *args):
    monkeypatch.setattr(sys, "argv", ["lm2a_tpu_torch.cli", "train", *TINY, *args])
    cli_main.main()


@pytest.fixture(scope="module")
def train_pack(tmp_path_factory):
    d = tmp_path_factory.mktemp("kpack")
    chip_smoke.write_clips(str(d / "clips"), 6, seed=2, mel_t=T, motion_t=12)
    pds.pack_dataset(str(d / "clips"), str(d / "pack"))
    return str(d / "pack")


def test_cli_train_k2_device_data_checkpoints_and_state(train_pack, tmp_path, monkeypatch):
    """6 clips at B=2, K=2: a group of two steps and a tail step an epoch.
    Saves every 2 steps by the JAX fused rule (``step % 2 < K``): after the
    groups that end at steps 2 and 5, then the final one; the K=1 run saves
    after steps 3 and 5. Both runs' step-6 states are the same bits."""
    common = ["--npz_dir", train_pack, "--epochs", "2", "--save_interval", "2"]
    _train(monkeypatch, *common, "--save_dir", str(tmp_path / "k2"), "--steps_per_call", "2",
           "--device_data")
    _train(monkeypatch, *common, "--save_dir", str(tmp_path / "k1"))
    assert list_checkpoints(str(tmp_path / "k2")) == [2, 5, 6]
    assert list_checkpoints(str(tmp_path / "k1")) == [3, 5, 6]
    a, b = (latest_checkpoint(str(tmp_path / d)) for d in ("k2", "k1"))
    for path in (a, b):
        with open(path + ".meta.json") as f:
            assert json.load(f)["epoch"] == 2
    with np.load(os.path.join(a, "state.npz")) as za, np.load(os.path.join(b, "state.npz")) as zb:
        assert set(za.files) == set(zb.files)
        for k in za.files:
            assert np.array_equal(za[k], zb[k]), k
    cfg = config_from_dict(json.load(open(a + ".meta.json"))["config"])
    state = init_train_state(cfg, 0, "cpu")
    restore_checkpoint(a, state)
    assert state.step == state.opt.step == 6


def test_cli_train_k2_streaming_equals_k1(train_pack, tmp_path, monkeypatch):
    """Without ``--device_data`` the fused path streams ``SuperbatchStream``
    groups (and the tail batch) and ends in the same state."""
    common = ["--npz_dir", train_pack, "--epochs", "1", "--save_interval", "0"]
    _train(monkeypatch, *common, "--save_dir", str(tmp_path / "k2"), "--steps_per_call", "2")
    _train(monkeypatch, *common, "--save_dir", str(tmp_path / "k1"))
    a, b = (latest_checkpoint(str(tmp_path / d)) for d in ("k2", "k1"))
    with np.load(os.path.join(a, "state.npz")) as za, np.load(os.path.join(b, "state.npz")) as zb:
        for k in za.files:
            assert np.array_equal(za[k], zb[k]), k


def test_device_data_without_k_streams(train_pack, tmp_path, monkeypatch, capsys):
    _train(monkeypatch, "--npz_dir", train_pack, "--epochs", "1", "--save_dir",
           str(tmp_path / "run"), "--device_data")
    assert "falling back to the streaming path" in capsys.readouterr().out


# ---------------------------------------------------------------- the launch ledger

class _StubLib:
    def __init__(self):
        self.calls = 0

    def lm2a_stub(self, *args):
        self.calls += 1
        return 0


class _StubGraph:
    """Stands in for ``torch.cuda.CUDAGraph``: a replay runs nothing."""

    replays = 0

    def register_generator_state(self, gen):
        self.gen = gen

    def replay(self):
        _StubGraph.replays += 1


class _StubCapture:
    def __init__(self, graph, pool=None, stream=None):
        self.graph = graph

    def __enter__(self):
        _StubCapture.capturing = True

    def __exit__(self, *exc):
        _StubCapture.capturing = False


@pytest.fixture
def stub_card(monkeypatch):
    lib = _StubLib()
    monkeypatch.setattr(_build, "library", lambda name: lib)
    for name, fn in (("CUDAGraph", _StubGraph), ("graph", _StubCapture),
                     ("current_stream", lambda dev=None: _StubStream()),
                     ("stream", lambda s: contextlib.nullcontext()),
                     ("synchronize", lambda dev=None: None), ("empty_cache", lambda: None),
                     ("memory_reserved", lambda dev=None: 0)):
        monkeypatch.setattr(torch.cuda, name, fn)
    monkeypatch.setattr(graphs, "side_stream", lambda dev: _StubStream())
    _build.reset_launches()
    yield lib
    _build.reset_launches()


class _StubStream:
    def wait_stream(self, other):
        pass


def test_launch_ledger_counts_capture_per_replay(stub_card):
    def step():
        _build.launch("stub", "lm2a_stub", "gn_stats")
        _build.launch("stub", "lm2a_stub", "gn_stats")
        _build.launch("stub", "lm2a_stub", "conv3_fused")

    gen = object()
    g = graphs.GraphedStep(step, device="cuda", generators=(gen,))
    g()  # warm-up: this call's work, counted by the launches themselves
    assert _build.LAUNCHES == Counter(gn_stats=2, conv3_fused=1)
    assert stub_card.calls == 6  # the warm-up and the capture both called the C entry
    assert g.launches == Counter(gn_stats=2, conv3_fused=1) and g.graph.gen is gen
    for _ in range(3):
        g()
    assert _build.LAUNCHES == Counter(gn_stats=8, conv3_fused=4) and g.replays == 3
    assert stub_card.calls == 6  # replays make no Python call
    with _build.recording(Counter()) as rec:
        _build.launch("stub", "lm2a_stub", "adan_ema")
    assert rec == Counter(adan_ema=1) and "adan_ema" not in _build.LAUNCHES


def test_a_failed_capture_raises_and_never_runs_eagerly(stub_card):
    calls = []

    def step():
        calls.append(_StubCapture.capturing)
        if _StubCapture.capturing:
            raise RuntimeError("CUDA kernel conv3_fused (lm2a_conv3_fused) failed: the kernel "
                               "does not take this launch plan")
        _build.launch("stub", "lm2a_stub", "conv3_fused")

    _StubCapture.capturing = False
    g = graphs.GraphedStep(step, device="cuda")
    with pytest.raises(RuntimeError, match="launch plan"):
        g()
    with pytest.raises(RuntimeError, match="capture failed"):
        g()
    assert calls == [False, True] and g.graph is None
    with graphs.eager_on_card():
        g()
    assert calls == [False, True, False]


def test_graphed_step_runs_eagerly_on_the_cpu():
    seen = []
    g = graphs.GraphedStep(lambda: seen.append(1), device="cpu")
    g()
    g()
    assert seen == [1, 1] and g.graph is None


# ---------------------------------------------------------------- the card's route

def _kernels_take(cin: int, cout: int) -> bool:
    """The widths the forward and backward kernels' wrappers take for a
    block at ``default_num_groups``: Cin and Cout multiples of 8
    (``check_widths``) and ``_check_act``'s group rule at both GroupNorms
    (each raises else)."""
    for c in (cin, cout):
        x = torch.zeros((1, 2, c))
        g = chip_smoke.default_num_groups(c)
        stats = torch.zeros((1, g))
        _check_act("conv3_wgrad", x, stats, stats, torch.ones(c), torch.zeros(c))
    check_widths("conv3_fused", Cin=cin, Cout=cout)
    return True


@pytest.mark.parametrize("geo", chip_smoke.resblock_geometries(ModelConfig(), chip_smoke.MEL_T)
                         + [(f"base64_{g[0]}",) + g[1:] for g in chip_smoke.resblock_geometries(
                             ModelConfig(base_dim=64), chip_smoke.MEL_T)],
                         ids=lambda g: g[0])
def test_every_flagship_block_keeps_its_card_route(geo):
    """At the flagship and at base width 64 with 8 groups (C/G = 8) the
    kernels take every block's widths, so the card runs each block the JAX
    gate routes through the fused train chain, and every serving chain,
    on its kernels."""
    _, t, cin, cout, skip, _ = geo
    assert _kernels_take(cin, cout)


def test_card_routes_at_base_64_and_at_the_flagship():
    """Base width 64 routes blocks with C/G = 8 through the JAX gate, and
    the kernels take them; so do base widths 16, 32, 48 and 96 (C/G 2, 4,
    6 and 12). A width that is not a multiple of 8 is refused by name."""
    narrow = chip_smoke.resblock_geometries(ModelConfig(base_dim=64), chip_smoke.MEL_T)
    assert any(64 in (cin, cout) and resblock_train_fits(t, cin, cout, skip, 2)
               for _, t, cin, cout, skip, _ in narrow)
    assert all(_kernels_take(cin, cout) for _, t, cin, cout, skip, _ in narrow)
    for base in (16, 32, 48, 96):
        geos = chip_smoke.resblock_geometries(ModelConfig(base_dim=base), chip_smoke.MEL_T)
        assert all(_kernels_take(cin, cout) for _, t, cin, cout, skip, _ in geos), base
    with pytest.raises(ValueError, match="multiples of 8, got Cin=36"):
        check_widths("conv3_dgrad", Cin=36, Cout=64)


def test_cpu_route_is_the_jax_gate_at_c_over_g_8():
    rng = np.random.default_rng(0)
    x = torch.tensor(rand(rng, 2, 16, 64)).to(torch.bfloat16)
    w = [torch.tensor(rand(rng, *s, scale=0.05)) for s in ((64, 64, 3), (64, 64, 3))]
    vec = [torch.tensor(rand(rng, 64)) for _ in range(6)]
    film = [torch.tensor(rand(rng, 2, 64)) for _ in range(2)]
    out = fused_resblock_train(x, vec[0], vec[1], w[0], vec[2], *film, vec[3], vec[4], w[1],
                               vec[5], groups1=8, groups2=8)
    assert out is not None and out.shape == (2, 16, 64)
