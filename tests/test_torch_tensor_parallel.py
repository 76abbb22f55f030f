"""Tensor parallelism of the port (``parallel/tensor.py``) on the CPU over
gloo, against the replicated port and the JAX package's
``make_tp_train_step``.

- The leaf rule: for every leaf of the small model (UNet and condition
  projection), the port's rule on the leaf's JAX name and layout gives the
  JAX package's ``_leaf_spec`` at TP = 2 and 4.
- Two ranks of the model axis (one row line, the same rows), the compute
  split over them (the library route): each holds its shard of every
  eligible parameter, EMA leaf and Adan moment (the sharded dimension
  halved, the rest whole), the state's bytes a rank below the replicated
  state's; two steps with the JAX draws injected give the replicated
  port's and the JAX TP step's loss, gradients (``prev_grad``), parameters
  and EMA within ``test_torch_train.py``'s tolerances, the shards put back
  together; the clip's norm (the sharded leaves' sums of squares
  all-reduced) is the replicated step's within 1e-5; during the step every
  split weight (conv 1/2, the skip, FiLM, q/k/v/out_proj) has its shard's
  shape, never the whole; the first step's census is the one
  ``chip_smoke.tp_census`` derives from the model; a DDIM chain of the
  EMA's shards through ``make_tp_sampler`` is the replicated chain's, fp32.
- Four ranks, on the fused train chain (``fused_resblock_grad``; the JAX
  step on its XLA path, the same math): the same checks. At 2 heads the
  attention sites do not split over four ranks and run replicated on their
  gathered weights.
- The v1 UNet (base 16, mults (1, 2), 2 heads): its leaf rule, its split
  plan (``split_modules``) at 2, 3 and 4 ranks, and the same step and
  sampler checks at 2 ranks and at 4 (the 2-head sites replicated): every
  ``ResBlockV1``'s conv 1, ``time_proj``, GroupNorm 2 and conv 2, and the
  final conv, split.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lm2a_tpu.core.mesh import make_mesh as jax_make_mesh
from lm2a_tpu.diffusion import make_schedule as jax_make_schedule
from lm2a_tpu.parallel.tensor import _leaf_spec as jax_leaf_spec
from lm2a_tpu.parallel.tensor import make_tp_train_step as jax_make_tp_train_step
from lm2a_tpu.parallel.tensor import shard_state_tp as jax_shard_state_tp
from lm2a_tpu_torch.core.config import config_to_dict
from lm2a_tpu_torch.core.mesh import Mesh
from lm2a_tpu_torch.diffusion.gaussian import ddim_sample
from lm2a_tpu_torch.diffusion.schedule import make_schedule
from lm2a_tpu_torch.models.factory import build_denoiser
from lm2a_tpu_torch.ops.adan import global_norm
from lm2a_tpu_torch.parallel.tensor import _leaf_spec, jax_leaf, split_modules, tp_shardings
from lm2a_tpu_torch.training.checkpoint import flax_path, keystr, state_arrays, to_flax_layout
from lm2a_tpu_torch.training.train_step import make_train_step

import chip_smoke
from _torch_port_util import jax_state_arrays, one_torch_thread, port_train_state  # noqa: F401
from _torch_ranks import spawn
from test_torch_dp import B, STATE, STEPS, T, _batch, _cfg
from test_torch_train import MEAN, STD, TOL_LOSS, assert_state_close, jax_draws

TP = 2


def _setup(cfg):
    from lm2a_tpu.core.config import config_to_dict as jax_config_to_dict
    from lm2a_tpu.models.factory import build_cond_projection as jax_bcp
    from lm2a_tpu.models.factory import build_denoiser as jax_bd
    from lm2a_tpu.training import init_train_state as jax_init_train_state
    from lm2a_tpu_torch.core.config import config_from_dict

    den, cp = jax_bd(cfg.model, "float32"), jax_bcp(cfg.model, "float32")
    state, tx = jax_init_train_state(den, cp, cfg, jax.random.key(0), seq_len=T)
    return dict(cfg=cfg, den=den, cp=cp, state=state, tx=tx,
                port_cfg=config_from_dict(jax_config_to_dict(cfg)))


def _v1_cfg():
    cfg = _cfg(0.0)
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, arch="v1", base_dim=16))


@pytest.fixture(scope="module")
def setup():
    return _setup(_cfg(0.0))


@pytest.fixture(scope="module")
def setup_v1():
    return _setup(_v1_cfg())


@pytest.mark.parametrize("arch,tp", [("ultimate", 2), ("ultimate", 4), ("v1", 2), ("v1", 4)],
                         ids=["2", "4", "v1-2", "v1-4"])
def test_leaf_rule_is_the_jax_rule(request, arch, tp):
    setup = request.getfixturevalue("setup" if arch == "ultimate" else "setup_v1")
    flat, _ = jax.tree_util.tree_flatten_with_path(setup["state"].params)
    want = {tuple(str(e.key) for e in kp): (tuple(jax_leaf_spec(kp, leaf, tp)), np.shape(leaf))
            for kp, leaf in flat}
    pstate = port_train_state(setup["port_cfg"], setup["state"])
    seen = set()
    for name, p in pstate.params().items():
        path, jshape, _ = jax_leaf(name, tuple(p.shape))
        spec, shape = want[path]
        assert jshape == shape, name
        assert _leaf_spec(path, jshape, tp) == spec, name
        seen.add(path)
    assert seen == set(want)


def test_tp_step_and_sampler_match_replicated_and_jax(setup, tmp_path):
    check_tp_step(setup, tmp_path, TP, fused=False)


def test_tp4_fused_step_and_sampler_match_replicated_and_jax(setup, tmp_path):
    check_tp_step(setup, tmp_path, 4, fused=True)


V1_BLOCKS = ("down_0_res", "down_1_res", "mid_res", "up_0_res", "up_1_res")
V1_SITES = tuple(f"{b}.cross_attn" for b in V1_BLOCKS)


@pytest.mark.parametrize("parts", [2, 3, 4])
def test_split_modules_of_v1(parts):
    """The split plan of a small v1 UNet (widths 16, 16, 32, 48, 32; GroupNorm
    of 8 groups; 2 heads): every block whose width divides, with conv 1,
    ``time_proj``, GroupNorm 2 and conv 2; every site whose width and heads
    divide; the final conv where its 32 input channels divide."""
    from lm2a_tpu_torch.parallel.tensor import _ATTN_SPLIT, _V1_SPLIT

    unet = build_denoiser(_v1_cfg().model)
    widths = dict(zip(V1_BLOCKS, (16, 16, 32, 48, 32)))
    want = {b: _V1_SPLIT for b, c in widths.items() if c % parts == 0}
    if 2 % parts == 0:
        want.update({f"{b}.cross_attn": _ATTN_SPLIT for b in want})
    if 32 % parts == 0:
        want["out_proj"] = ("weight",)
    got = split_modules(unet, parts)
    assert got == want
    assert {3: {"up_0_res"}, 2: {*V1_BLOCKS, *V1_SITES, "out_proj"},
            4: {*V1_BLOCKS, "out_proj"}}[parts] == set(got)
    assert split_modules(unet, 1) == {}


def test_v1_tp_step_and_sampler_match_replicated_and_jax(setup_v1, tmp_path):
    check_tp_step(setup_v1, tmp_path, TP, fused=False)


def test_v1_tp4_step_and_sampler_match_replicated_and_jax(setup_v1, tmp_path):
    check_tp_step(setup_v1, tmp_path, 4, fused=False)


def check_tp_step(setup, tmp_path, tp: int, fused: bool):
    cfg, port_cfg = setup["cfg"], setup["port_cfg"]
    state0 = jax_state_arrays(setup["state"])
    # the JAX TP step over a (data=8/tp, model=tp) mesh of the eight virtual devices
    mesh = jax_make_mesh(model=tp)
    jstep, _ = jax_make_tp_train_step(setup["den"], setup["cp"],
                                      jax_make_schedule(cfg.diffusion), cfg, setup["tx"], mesh,
                                      setup["state"], dataset_mean=MEAN, dataset_std=STD)
    jstate, _ = jax_shard_state_tp(jax.tree.map(jnp.copy, setup["state"]), mesh)
    draws, jstates, jlosses = [], [], []
    for i in range(STEPS):
        key = jax.random.key(300 + i)
        jb = {k: jnp.asarray(v) for k, v in _batch(i).items()}
        with mesh:
            jstate, loss = jstep(jstate, jb, key)
        jstates.append(jax_state_arrays(jstate))
        jlosses.append(float(loss))
        draws.append(jax_draws(key, jb["mel"], cfg.train.cond_drop_prob, cfg.diffusion.timesteps,
                               train=True))
    rng = np.random.default_rng(5)
    payload = {f"{k}_{i}": v for i in range(STEPS) for k, v in _batch(i).items()}
    for i, d in enumerate(draws):
        payload.update({f"t_{i}": d.t.numpy(), f"noise_{i}": d.noise.numpy()})
        if d.keep is not None:
            payload[f"keep_{i}"] = d.keep.numpy()
    payload.update({STATE + k: v for k, v in state0.items()})
    payload["x_init"] = rng.standard_normal((1, T, 80)).astype(np.float32)
    payload["cond"] = rng.standard_normal((1, T, port_cfg.model.cond_dim)).astype(np.float32)
    rank_cfg = dataclasses.replace(port_cfg, model=dataclasses.replace(
        port_cfg.model, fused_resblock_grad=fused))
    payload["meta"] = dict(cfg=config_to_dict(rank_cfg), batch=B, steps=STEPS, mean=MEAN,
                           std=STD, model_axis=tp)
    outs = spawn("tp_step", tp, tmp_path, payload)

    # the replicated port over the same batches and draws
    one = port_train_state(port_cfg, setup["state"])
    step = make_train_step(make_schedule(port_cfg.diffusion), port_cfg, dataset_mean=MEAN,
                           dataset_std=STD)
    dims = tp_shardings(one.params(), Mesh(np.arange(tp).reshape(1, tp)))
    census, _ = chip_smoke.tp_census(rank_cfg.model, tp, T)
    for o in outs:  # each rank's shards: the sharded dimension cut TP-fold, the rest whole
        assert o["dims"] == {k: v for k, v in dims.items()}
        for k, p in one.params().items():
            want = list(p.shape)
            if dims[k] is not None:
                want[dims[k]] //= tp
            assert list(o[f"params|0|{k}"].shape) == want, k
            if k in o["split"]:  # as the step's forward read it: the shard
                assert o["split_shapes"][k] == want, k
        assert len(o["split"]) > 0 and set(o["split_shapes"]) == set(o["split"])
        assert o["census"] == census
        assert o["state_bytes"] < (0.6 if tp == 2 else 0.35) * o["full_bytes"]

    def whole(tree, i):
        return {k: np.concatenate([o[f"{tree}|{i}|{k}"] for o in outs], axis=dims[k])
                if dims[k] is not None else outs[0][f"{tree}|{i}|{k}"] for k in dims}

    before, jbefore = state_arrays(one), state0
    for i in range(STEPS):
        loss = step(one, {k: torch.tensor(v) for k, v in _batch(i).items()}, draws=draws[i])
        norm = float(global_norm([p.grad for p in one.params().values()]))
        for o in outs:
            assert float(o[f"loss_{i}"]) == pytest.approx(float(loss), rel=TOL_LOSS)
            assert float(o[f"loss_{i}"]) == pytest.approx(jlosses[i], rel=TOL_LOSS)
            assert float(o[f"norm_{i}"]) == pytest.approx(norm, rel=1e-5)
        got = dict(state_arrays(one))  # its v and n: the replicated run's
        for tree, coll in (("params", "params"), ("ema", "ema_params"),
                           ("m", "opt_state.m"), ("prev_grad", "opt_state.prev_grad")):
            for k, v in whole(tree, i).items():
                key = keystr(coll, flax_path(k, v.ndim))
                got[key] = to_flax_layout(torch.tensor(v), k).numpy()
        assert_state_close(got, state_arrays(one), before, before, warm=False) if i == 0 else \
            assert_state_close(got, state_arrays(one), before_tp, before, warm=True)
        assert_state_close(got, jstates[i], before_tp if i else jbefore, jbefore, warm=i > 0)
        before_tp, before, jbefore = got, state_arrays(one), jstates[i]

    # the TP sampler: the EMA's shards against the replicated chain
    unet = build_denoiser(port_cfg.model)
    unet.load_state_dict({k.split("/", 1)[1]: e for k, e in one.ema.items()
                          if k.startswith("unet/")})
    serving = unet.eval().requires_grad_(False).prepare(torch.float32)
    cond = torch.tensor(payload["cond"])
    want = ddim_sample(serving, make_schedule(port_cfg.diffusion), (1, T, 80), cond, cond * 0.5,
                       num_steps=3, guidance_weight=2.0, x_init=torch.tensor(payload["x_init"]))
    for o in outs:
        np.testing.assert_allclose(o["sample"], want.numpy(), rtol=1e-5, atol=1e-5)
