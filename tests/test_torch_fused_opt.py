"""``fused_opt=False``, the chained clip-then-Adan optimizer, against the JAX
package's ``optax.chain(clip_by_global_norm, adan)``, on the CPU.

- One and three steps from one flax-initialised state (carried into the
  port in the checkpoint layout), the same batches and injected draws: loss,
  parameters, EMA and Adan state within ``test_torch_train``'s tolerances
  (fp32 on both sides, sums in another order; its docstring gives each),
  the third step's Adan state within ``TOL_STATE_STEP3`` (its reason there).
- The port's chained form against its own folded form (``fused_opt=1``,
  the plain update) over three steps from one state: the same bits in every
  leaf, as the JAX package's comment on the two forms says (its
  ``train_step.py:69-84``); only the state's place in a checkpoint differs.
- Checkpoints: a JAX ``fused_opt=0`` checkpoint (Adan state at index 1 of
  the chain's tuple, ``.opt_state[1].m[...]``) resumed by the port and one
  step taken on both sides; a port checkpoint restored by the JAX package
  into its chained template, every leaf equal.
- ``--opt_backend pallas`` with ``fused_opt=0`` refused by both packages
  with the same message.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lm2a_tpu.core.config import config_to_dict as jax_config_to_dict
from lm2a_tpu.diffusion import make_schedule as jax_make_schedule
from lm2a_tpu.models.factory import build_cond_projection as jax_bcp
from lm2a_tpu.models.factory import build_denoiser as jax_bd
from lm2a_tpu.training import init_train_state as jax_init_train_state
from lm2a_tpu.training import restore_checkpoint as jax_restore
from lm2a_tpu.training import save_checkpoint as jax_save
from lm2a_tpu.training.train_step import make_pallas_opt_fn
from lm2a_tpu.training.train_step import make_train_step as jax_make_train_step
from lm2a_tpu_torch.core.config import config_from_dict
from lm2a_tpu_torch.diffusion.schedule import make_schedule
from lm2a_tpu_torch.training.checkpoint import (
    load_state_arrays, restore_checkpoint, save_checkpoint, state_arrays,
)
from lm2a_tpu_torch.training.loop import check_supported
from lm2a_tpu_torch.training.train_step import init_train_state, make_optimizer, make_train_step

from _torch_port_util import jax_state_arrays, one_torch_thread, port_train_state  # noqa: F401
import test_torch_train
from test_torch_train import MEAN, STD, T, assert_state_close, jax_cfg, jax_draws, make_batch

# The third step's Adan state: 1e-3 relative L2 per leaf. Its gradients are
# taken at parameters that already differ by the second step's (up to
# test_torch_train's 5e-2 relative L2 of the step, where Adan amplifies the
# gradients' 1e-5 differences), so they differ by more than the first two
# steps' 1e-4; loss, EMA and the step vector keep test_torch_train's bounds.
TOL_STATE_STEP3 = 1e-3


def chained_cfg():
    cfg = jax_cfg(False)  # the plain route: no fused blocks, opt_backend xla
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, fused_opt=False))


@pytest.fixture(scope="module")
def setup():
    cfg = chained_cfg()
    den, cp = jax_bd(cfg.model, "float32"), jax_bcp(cfg.model, "float32")
    state, tx = jax_init_train_state(den, cp, cfg, jax.random.key(0), seq_len=T)
    return dict(cfg=cfg, den=den, cp=cp, state=state, tx=tx,
                schedule=jax_make_schedule(cfg.diffusion),
                port_cfg=config_from_dict(jax_config_to_dict(cfg)))


def _batch(i):
    b = make_batch(40 + i)
    return b, {k: jnp.asarray(v) for k, v in b.items()}, jax.random.key(400 + i)


def test_chained_steps_match_jax(setup):
    """Three steps, each held against the JAX chain after it is taken."""
    cfg, port_cfg = setup["cfg"], setup["port_cfg"]
    assert any(k.startswith(".opt_state[1]") for k in jax_state_arrays(setup["state"]))
    jstep = jax_make_train_step(setup["den"], setup["cp"], setup["schedule"], cfg, setup["tx"],
                                dataset_mean=MEAN, dataset_std=STD)
    pstate = port_train_state(port_cfg, setup["state"])
    assert pstate.opt.chained
    pstep = make_train_step(make_schedule(port_cfg.diffusion), port_cfg, dataset_mean=MEAN,
                            dataset_std=STD)
    jstate = jax.tree.map(jnp.copy, setup["state"])
    for i in range(3):
        batch, jbatch, key = _batch(i)
        got0, want0 = state_arrays(pstate), jax_state_arrays(jstate)
        jstate, jloss = jstep(jstate, jbatch, key)
        draws = jax_draws(key, jbatch["mel"], cfg.train.cond_drop_prob, cfg.diffusion.timesteps,
                          train=True)
        loss = pstep(pstate, {k: torch.tensor(v) for k, v in batch.items()}, draws=draws)
        assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
        if i < 2:
            assert_state_close(state_arrays(pstate), jax_state_arrays(jstate), got0, want0,
                               warm=i > 0)
        else:
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(test_torch_train, "TOL_STATE", TOL_STATE_STEP3)
                assert_state_close(state_arrays(pstate), jax_state_arrays(jstate), got0, want0,
                                   warm=True)


def test_chained_form_is_the_folded_form_bit_for_bit(setup):
    """Three steps of ``fused_opt=0`` and of ``fused_opt=1`` (plain update)
    from one state, the same batches and draws: every parameter, EMA and
    Adan leaf the same bits; the keys differ by the chain's index alone."""
    port_cfg = setup["port_cfg"]
    folded_cfg = dataclasses.replace(port_cfg, train=dataclasses.replace(port_cfg.train,
                                                                         fused_opt=True))
    states = {}
    for label, c in (("chained", port_cfg), ("folded", folded_cfg)):
        st = init_train_state(c, 0, "cpu")
        arrays = jax_state_arrays(setup["state"])
        if label == "folded":
            arrays = {k.replace(".opt_state[1]", ".opt_state"): v for k, v in arrays.items()}
        load_state_arrays(st, arrays)
        step = make_train_step(make_schedule(c.diffusion), c, dataset_mean=MEAN, dataset_std=STD)
        for i in range(3):
            batch, jbatch, key = _batch(i)
            step(st, {k: torch.tensor(v) for k, v in batch.items()},
                 draws=jax_draws(key, jbatch["mel"], c.train.cond_drop_prob,
                                 c.diffusion.timesteps, train=True))
        states[label] = state_arrays(st)
    chained = {k.replace(".opt_state[1]", ".opt_state"): v for k, v in states["chained"].items()}
    assert set(chained) == set(states["folded"])
    for k, v in states["folded"].items():
        assert np.array_equal(chained[k], v), k


def test_jax_chained_checkpoint_round_trips(setup, tmp_path):
    cfg, port_cfg = setup["cfg"], setup["port_cfg"]
    jstep = jax_make_train_step(setup["den"], setup["cp"], setup["schedule"], cfg, setup["tx"],
                                dataset_mean=MEAN, dataset_std=STD)
    jstate = jax.tree.map(jnp.copy, setup["state"])
    batch, jbatch, key = _batch(7)
    jstate, _ = jstep(jstate, jbatch, key)
    path = jax_save(str(tmp_path / "jax"), jstate, cfg, epoch=2, dataset_mean=MEAN,
                    dataset_std=STD)
    pstate = init_train_state(port_cfg, 9, "cpu")
    meta = restore_checkpoint(path, pstate)
    assert meta["epoch"] == 2 and pstate.step == pstate.opt.step == 1
    got0, want0 = state_arrays(pstate), jax_state_arrays(jstate)
    assert set(got0) == set(want0)
    for k, w in want0.items():
        assert np.array_equal(got0[k], w), k
    batch, jbatch, key = _batch(8)
    jstate, jloss = jstep(jstate, jbatch, key)
    pstep = make_train_step(make_schedule(port_cfg.diffusion), port_cfg, dataset_mean=MEAN,
                            dataset_std=STD)
    loss = pstep(pstate, {k: torch.tensor(v) for k, v in batch.items()},
                 draws=jax_draws(key, jbatch["mel"], cfg.train.cond_drop_prob,
                                 cfg.diffusion.timesteps, train=True))
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    assert_state_close(state_arrays(pstate), jax_state_arrays(jstate), got0, want0, warm=True)
    # and back: the port's checkpoint into the JAX package's chained template
    back = save_checkpoint(str(tmp_path / "port"), pstate, port_cfg, epoch=3,
                           dataset_mean=MEAN, dataset_std=STD)
    restored, meta = jax_restore(back, setup["state"])
    assert meta["epoch"] == 3
    want, got = state_arrays(pstate), jax_state_arrays(restored)
    assert set(want) == set(got)
    for k, w in want.items():
        assert got[k].shape == w.shape and np.array_equal(got[k], w), k


def test_pallas_with_the_chained_form_is_refused_as_in_jax(setup):
    port_cfg, cfg = setup["port_cfg"], setup["cfg"]
    pcfg = dataclasses.replace(port_cfg, train=dataclasses.replace(port_cfg.train,
                                                                   opt_backend="pallas"))
    jcfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, opt_backend="pallas"))
    msg = "opt_backend='pallas' needs fused_opt=1"
    with pytest.raises(ValueError, match=msg):
        make_pallas_opt_fn(jcfg)
    with pytest.raises(ValueError, match=msg):
        make_optimizer(pcfg)
    with pytest.raises(ValueError, match=msg):
        check_supported(pcfg)
    check_supported(port_cfg)  # the plain update takes it
    # no clip: the JAX optimizer is Adan alone, the bare layout
    noclip = dataclasses.replace(port_cfg, train=dataclasses.replace(port_cfg.train,
                                                                     grad_clip=0.0))
    assert not make_optimizer(noclip).chained
    assert ".opt_state.step" in state_arrays(init_train_state(noclip, 0, "cpu"))
