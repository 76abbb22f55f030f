"""Training steps of the port against the JAX package's ``make_train_step``,
on the kernel route (this file) and the plain route
(``test_torch_train_plain.py``, which imports these helpers).

Both sides start from the same flax-initialised state (carried into the port
leaf by leaf in the checkpoint layout), take the same batch, and use the
same randomness: the test repeats the key splits of ``_loss`` and
``diffusion_loss`` (``train_step.py:100``, ``gaussian.py:65-67``) and injects
their keep mask, timesteps and noise into the port. Dropout is 0 (the two
packages' generators cannot be matched). Two steps are taken, so the second
runs Adan past its step-0 freeze.

Routes: the kernel route (``fused_resblock_grad``, ``opt_backend='pallas'``;
JAX runs its Pallas kernels in interpret mode, the port the kernels' plain
versions) and the plain route (neither). fp32 compute, tiny UNet.

Every gradient leaf is compared through ``opt_state.prev_grad``, which holds
the step's clipped gradient (the same clip factor on both sides).

Tolerances (fp32 on both sides, sums in another order): loss 1e-5 relative;
Adan state (gradients included) 1e-4 relative L2 per leaf (floor 1e-8
absolute). EMA 1e-5 absolute per element (it moves by 1e-3 of the
parameters' step, which differs by up to ~1e-3 at the elements described
below). Parameters: after the first step (moments frozen, the
update is the weight-decay shrink alone) 1e-6 absolute per element; after
the second, the whole model's step (new minus old, all leaves together)
5e-2 relative L2. Not per element or per leaf: Adan's step is
lr * m / sqrt(n), and where ``g2 + (1-b2)(g2 - g1)`` nearly cancels for an
element, n is tiny and that element's step both grows to many lr and
amplifies the gradients' 1e-5 relative differences; a leaf whose true
gradient is zero (the attention key biases: softmax ignores a shift shared
by all keys) steps on rounding noise on both sides. The update's arithmetic
on identical inputs is held exactly in ``test_torch_adan.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lm2a_tpu.core.config import DiffusionConfig, LM2AConfig, ModelConfig, TrainConfig
from lm2a_tpu.core.config import config_to_dict as jax_config_to_dict
from lm2a_tpu.diffusion import make_schedule as jax_make_schedule
from lm2a_tpu.models.factory import build_cond_projection as jax_bcp
from lm2a_tpu.models.factory import build_denoiser as jax_bd
from lm2a_tpu.training import init_train_state as jax_init_train_state
from lm2a_tpu.training.train_step import make_eval_step as jax_make_eval_step
from lm2a_tpu.training.train_step import make_train_step as jax_make_train_step
from lm2a_tpu_torch.core.config import config_from_dict
from lm2a_tpu_torch.diffusion.schedule import make_schedule
from lm2a_tpu_torch.models.factory import build_denoiser
from lm2a_tpu_torch.models.unet1d import UNet1DUltimate
from lm2a_tpu_torch.training.checkpoint import state_arrays
from lm2a_tpu_torch.training.train_step import Draws, make_eval_step, make_train_step

from _torch_port_util import jax_state_arrays, one_torch_thread, port_train_state, rand, rel_l2  # noqa: F401

B, T = 2, 32
MEAN, STD = -4.5, 2.0
TOL_LOSS, TOL_STATE, TOL_PARAM, TOL_STEP, TOL_EMA = 1e-5, 1e-4, 1e-6, 5e-2, 1e-5


def jax_cfg(fused: bool) -> LM2AConfig:
    return LM2AConfig(
        model=ModelConfig(base_dim=32, dim_mults=(1, 2), cond_dim=16, time_emb_dim=32,
                          num_res_blocks=1, mid_blocks=1, attn_heads=2, dropout=0.0,
                          fused_resblock_grad=fused),
        diffusion=DiffusionConfig(timesteps=50),
        train=TrainConfig(batch_size=B, compute_dtype="float32",
                          opt_backend="pallas" if fused else "xla"),
    )


def make_batch(seed):
    rng = np.random.default_rng(seed)
    return {"mel": MEAN + STD * rand(rng, B, T, 80), "motion": rand(rng, B, T, 234),
            "lyrics": rand(rng, B, T, 768)}


def jax_draws(key, x0, p: float, timesteps: int, train: bool) -> Draws:
    """The keep mask, timesteps and noise ``_loss`` draws from ``key``."""
    kdrop, kdiff, _ = jax.random.split(key, 3)
    keep = None
    if train and p > 0:
        keep = 1.0 - jax.random.bernoulli(kdrop, p, (x0.shape[0], 1, 1)).astype(jnp.float32)
        keep = torch.tensor(np.asarray(keep))
    kt, kn = jax.random.split(kdiff)
    t = jax.random.randint(kt, (x0.shape[0],), 0, timesteps)
    noise = jax.random.normal(kn, x0.shape, dtype=x0.dtype)
    return Draws(torch.tensor(np.asarray(t)).long(), torch.tensor(np.asarray(noise)), keep)


def assert_state_close(got: dict, want: dict, got0: dict, want0: dict, warm: bool):
    """``got``/``want`` after the step, ``got0``/``want0`` before it."""
    assert set(got) == set(want)
    num = den = 0.0
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape and g.dtype == w.dtype, k
        coll = k.split("[")[0]
        if k.endswith("step"):
            assert int(g) == int(w), k
        elif coll == ".ema_params":
            np.testing.assert_allclose(g, w, atol=TOL_EMA, rtol=0, err_msg=k)
        elif coll == ".params" and not warm:
            np.testing.assert_allclose(g, w, atol=TOL_PARAM, rtol=0, err_msg=k)
        elif coll == ".params":  # the whole step vector
            dg, dw = (g - got0[k]).astype(np.float64), (w - want0[k]).astype(np.float64)
            num += float(((dg - dw) ** 2).sum())
            den += float((dw ** 2).sum())
        else:
            assert rel_l2(g, w) <= TOL_STATE or np.abs(g - w).max() <= 1e-8, k
    if warm:
        assert np.sqrt(num / den) <= TOL_STEP


def make_setup(fused: bool) -> dict:
    cfg = jax_cfg(fused)
    den, cp = jax_bd(cfg.model, "float32"), jax_bcp(cfg.model, "float32")
    state, tx = jax_init_train_state(den, cp, cfg, jax.random.key(0), seq_len=T)
    schedule = jax_make_schedule(cfg.diffusion)
    return dict(fused=fused, cfg=cfg, den=den, cp=cp, state=state, tx=tx, schedule=schedule,
                port_cfg=config_from_dict(jax_config_to_dict(cfg)))


@pytest.fixture(scope="module")
def setup():
    return make_setup(True)


def check_train_steps(s):
    cfg, port_cfg = s["cfg"], s["port_cfg"]
    jstep = jax_make_train_step(s["den"], s["cp"], s["schedule"], cfg, s["tx"],
                                dataset_mean=MEAN, dataset_std=STD)
    pstate = port_train_state(port_cfg, s["state"])
    assert pstate.unet.fused_resblock_grad == s["fused"]
    pstep = make_train_step(make_schedule(port_cfg.diffusion), port_cfg,
                            dataset_mean=MEAN, dataset_std=STD)
    jstate = jax.tree.map(jnp.copy, s["state"])  # the step donates its input
    for i in range(2):
        batch = make_batch(10 + i)
        key = jax.random.key(100 + i)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        got0, want0 = state_arrays(pstate), jax_state_arrays(jstate)
        jstate, jloss = jstep(jstate, jbatch, key)
        draws = jax_draws(key, jbatch["mel"], cfg.train.cond_drop_prob,
                          cfg.diffusion.timesteps, train=True)
        loss = pstep(pstate, {k: torch.tensor(v) for k, v in batch.items()}, draws=draws)
        assert float(loss) == pytest.approx(float(jloss), rel=TOL_LOSS)
        assert_state_close(state_arrays(pstate), jax_state_arrays(jstate), got0, want0,
                           warm=i > 0)


def test_train_steps_match_jax(setup):
    check_train_steps(setup)


def check_eval_step(s):
    cfg, port_cfg = s["cfg"], s["port_cfg"]
    jeval = jax_make_eval_step(s["den"], s["cp"], s["schedule"], cfg, dataset_mean=MEAN,
                               dataset_std=STD)
    batch = make_batch(20)
    key = jax.random.key(7)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want = float(jeval(s["state"].params, jbatch, key))
    pstate = port_train_state(port_cfg, s["state"])
    draws = jax_draws(key, jbatch["mel"], 0.0, cfg.diffusion.timesteps, train=False)
    got = make_eval_step(make_schedule(port_cfg.diffusion), port_cfg, MEAN, STD)(
        pstate, {k: torch.tensor(v) for k, v in batch.items()}, draws=draws)
    assert float(got) == pytest.approx(want, rel=TOL_LOSS)


def test_serving_form_unchanged_by_training_form():
    """The serving forward of a model built with the training switches (and
    after a training forward) is bit for bit the forward of one built
    without them; the eval form agrees with it to fp32 rounding."""
    pcfg = config_from_dict(jax_config_to_dict(jax_cfg(True)))
    torch.manual_seed(0)
    ref = build_denoiser(pcfg.model)
    trained = UNet1DUltimate(in_dim=80, base_dim=32, dim_mults=(1, 2), cond_dim=16,
                             time_emb_dim=32, num_res_blocks=1, mid_blocks=1, attn_heads=2,
                             dropout=0.1, fused_resblock_grad=True)
    trained.load_state_dict(ref.state_dict())
    rng = np.random.default_rng(3)
    x, m, l = (torch.tensor(rand(rng, 2, T, c)) for c in (80, 16, 16))
    t = torch.tensor([3, 40])
    with torch.no_grad():
        trained.forward_train(x, t, m, l, dtype=torch.float32, generator=torch.Generator())
        want = ref.prepare(torch.float32)(x, t, m, l)
        got = trained.prepare(torch.float32)(x, t, m, l)
        eval_form = build_denoiser(pcfg.model)
        eval_form.load_state_dict(ref.state_dict())
        ev = eval_form.forward_train(x, t, m, l, dtype=torch.float32)
    assert torch.equal(got, want)
    np.testing.assert_allclose(ev.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)
