"""Adan + EMA of the port against the JAX package, on identical inputs.

- The kernel's plain version (``ops.adan.adan_ema_plain``, what
  ``opt_backend='pallas'`` runs on the CPU) against JAX's
  ``fused_adan_ema_update`` with its Pallas kernel in interpret mode;
- the plain route (``training.adan.Adan``, ``opt_backend='xla'``) against
  JAX's ``adan(grad_clip=...)`` + ``optax.apply_updates`` + the EMA lerp;

over three steps (step 0 freezes the moments), fp32 and bf16 state,
clipping on and off, a constant rate and a step-decay list, on a tree with
a leaf above 65,536 elements (the JAX package's big-leaf path). The route
test builds the port's optimizer from the train config with both
``opt_big_backend`` values, which the port keeps for the round trip and
ignores. Also ``make_lr_schedule`` at its boundaries.

The update is fed identical inputs (JAX's global norm; the route test
keeps the norm below the clip) and gradients that drift from step to step,
since Adan's ``m / sqrt(n)`` magnifies a last-bit difference many times
where ``g + (1-b2)(g - g_prev)`` cancels.
Tolerances: fp32 state and parameters 1e-6 relative plus 1e-6 of the
array's largest magnitude absolute (the same fp32 expressions; the bias
corrections' fp32 power may differ in the last bit, and ``g - g_prev``
magnifies that where the two nearly cancel); bf16 state one bf16 ulp (2^-7
relative), and its parameters and EMA 0.25 lr absolute (a clipped gradient
whose last fp32 bit differs, XLA against PyTorch, can round to the other
bf16 neighbour in ``prev_grad``, which moves that element's next step by a
fraction of lr: two elements in 66,770 do).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lm2a_tpu.ops.pallas_opt import fused_adan_ema_update as jax_fused_update
from lm2a_tpu.training.adan import AdanState as JaxAdanState
from lm2a_tpu.training.adan import adan as jax_adan
from lm2a_tpu.training.adan import make_lr_schedule as jax_make_lr_schedule
from lm2a_tpu_torch.core.config import LM2AConfig, TrainConfig
from lm2a_tpu_torch.ops.adan import adan_ema_plain, global_norm, step_scalars
from lm2a_tpu_torch.training.adan import BETAS, EPS, make_lr_schedule
from lm2a_tpu_torch.training.train_step import make_optimizer

from _torch_port_util import one_torch_thread  # noqa: F401

SHAPES = {"a": (3, 4, 5), "b": (7,), "c": ((1 << 16) + 1234,)}  # c: a JAX big leaf
LR, WD, EMA = 2e-4, 1e-4, 0.999
BF16_STATE_PARAM_ATOL = 0.25 * LR
DECAY = ((1,), (0.5,))


def _trees(seed):
    rng = np.random.default_rng(seed)
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    return params, {k: v + 0.01 * rng.standard_normal(v.shape).astype(np.float32)
                    for k, v in params.items()}


def _grads(step, scale):
    """Gradients that drift slowly from step to step, as in training: a
    fixed base plus 10% fresh noise (independent draws would make
    ``g + (1-b2)(g - g_prev)`` cancel for some elements, where Adan's
    ``m / sqrt(n)`` turns a last-bit difference into a large one)."""
    base, noise = np.random.default_rng(99), np.random.default_rng(100 + step)
    return {k: (scale * (base.standard_normal(s) + 0.1 * noise.standard_normal(s)))
            .astype(np.float32) for k, s in SHAPES.items()}


def _close(got: torch.Tensor, want, bf16: bool, what: str, param_of_bf16_state=False):
    want = np.asarray(want.astype(jnp.float32) if hasattr(want, "astype") else want, np.float32)
    scale = float(np.abs(want).max())
    tol = (dict(rtol=2.0 ** -7, atol=2.0 ** -7 * 1e-6 * scale) if bf16
           else dict(rtol=1e-6, atol=1e-6 * scale))
    if param_of_bf16_state:
        tol["atol"] = max(tol["atol"], BF16_STATE_PARAM_ATOL)
    np.testing.assert_allclose(got.float().numpy(), want, err_msg=what, **tol)


@pytest.mark.parametrize("decay", [False, True], ids=["constant_lr", "decay_list"])
@pytest.mark.parametrize("clip", [1.0, 0.0], ids=["clip", "no_clip"])
@pytest.mark.parametrize("state_dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_kernel_plain_version_matches_jax_pallas(state_dtype, clip, decay):
    bf16 = state_dtype == torch.bfloat16
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    params, ema = _trees(0)
    sched = make_lr_schedule(LR, *DECAY) if decay else make_lr_schedule(LR)
    jsched = jax_make_lr_schedule(LR, *DECAY) if decay else jax_make_lr_schedule(LR)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    je = {k: jnp.asarray(v) for k, v in ema.items()}
    zeros = lambda: {k: jnp.zeros(s, jdt) for k, s in SHAPES.items()}  # noqa: E731
    jstate = JaxAdanState(jnp.zeros((), jnp.int32), zeros(), zeros(), zeros(), zeros())
    tp = {k: torch.tensor(v) for k, v in params.items()}
    te = {k: torch.tensor(v) for k, v in ema.items()}
    ts = {n: {k: torch.zeros(s, dtype=state_dtype) for k, s in SHAPES.items()}
          for n in ("m", "v", "n", "pg")}
    for step in range(3):
        grads = _grads(step, 0.3 if clip else 0.01)
        jp, je, jstate = jax_fused_update(
            jp, je, jstate, {k: jnp.asarray(v) for k, v in grads.items()},
            lr=jsched(jstate.step + 1), ema_decay=EMA, weight_decay=WD, grad_clip=clip,
            state_dtype=jdt if bf16 else None, interpret=True)
        tg = {k: torch.tensor(v) for k, v in grads.items()}
        # JAX's own norm: identical inputs, so the update's arithmetic is held
        # exactly (Adan's m / sqrt(n) magnifies a last-bit difference of the
        # clipped gradient many times where g + (1-b2)(g - g_prev) cancels)
        gnorm = torch.ones(())
        if clip:
            gnorm = torch.tensor(float(optax.global_norm(grads)))
            assert float(global_norm(list(tg.values()))) == pytest.approx(float(gnorm), rel=1e-6)
        scal = step_scalars(step, gnorm, sched(step + 1), betas=BETAS, weight_decay=WD,
                            ema_decay=EMA, device="cpu")
        for k in SHAPES:
            adan_ema_plain((tg[k], tp[k], te[k], ts["m"][k], ts["v"][k], ts["n"][k], ts["pg"][k]),
                           scal, betas=BETAS, eps=EPS, clip=clip)
        for k in SHAPES:
            _close(tp[k], jp[k], False, f"p[{k}] step {step}", bf16)
            _close(te[k], je[k], False, f"ema[{k}] step {step}", bf16)
            for n, jtree in (("m", jstate.m), ("v", jstate.v), ("n", jstate.n),
                             ("pg", jstate.prev_grad)):
                _close(ts[n][k], jtree[k], bf16, f"{n}[{k}] step {step}")
        if step == 0:  # the freeze: zero moments, the clipped gradient kept
            assert all(float(ts[n][k].abs().max()) == 0 for n in ("m", "v", "n") for k in SHAPES)
            assert all(float(ts["pg"][k].abs().max()) > 0 for k in SHAPES)


@pytest.mark.parametrize("big_backend", ["pallas", "xla"])
@pytest.mark.parametrize("state_dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_routes_match_jax_adan(state_dtype, big_backend):
    """``make_optimizer``'s ``Adan`` on both routes (the CPU runs the
    kernel's plain version) against JAX's ``adan(grad_clip)`` +
    ``apply_updates`` + EMA lerp, whatever ``opt_big_backend`` says."""
    bf16 = state_dtype == torch.bfloat16
    jdt = jnp.bfloat16 if bf16 else None
    params, _ = _trees(1)
    tx = jax_adan(jax_make_lr_schedule(LR, *DECAY), weight_decay=WD, state_dtype=jdt,
                  grad_clip=1.0)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    je = dict(jp)
    jstate = tx.init(jp)
    ports = {}
    for backend in ("xla", "pallas"):
        opt = make_optimizer(LM2AConfig(train=TrainConfig(
            lr=LR, weight_decay=WD, grad_clip=1.0, ema_decay=EMA, lr_decay_steps=DECAY[0],
            lr_decay_factors=DECAY[1], opt_dtype="bfloat16" if bf16 else "float32",
            opt_backend=backend, opt_big_backend=big_backend)))
        tp = {k: torch.tensor(v) for k, v in params.items()}
        ports[backend] = (opt, tp, {k: v.clone() for k, v in tp.items()}, opt.init(tp))
    for step in range(3):
        grads = _grads(10 + step, 1e-3)  # norm below the clip: identical inputs to the update
        jg = {k: jnp.asarray(v) for k, v in grads.items()}
        updates, jstate = tx.update(jg, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        je = jax.tree.map(lambda e, p: e * EMA + p * (1.0 - EMA), je, jp)
        for backend, (opt, tp, te, state) in ports.items():
            opt.update(tp, {k: torch.tensor(v) for k, v in grads.items()}, te, state)
            assert state.step == step + 1
            for k in SHAPES:
                _close(tp[k], jp[k], False, f"{backend} p[{k}]", bf16)
                # the kernel's EMA takes 1 - decay in fp32 from its scalars
                _close(te[k], je[k], False, f"{backend} ema[{k}]", bf16)
                for n, jtree in (("m", jstate.m), ("v", jstate.v), ("n", jstate.n),
                                 ("prev_grad", jstate.prev_grad)):
                    _close(getattr(state, n)[k], jtree[k], bf16, f"{backend} {n}[{k}]")


def test_lr_schedule_matches_jax():
    for steps, factors in (((), ()), ((5,), (0.1,)), ((10, 3), (0.5, 0.2))):
        port, ref = make_lr_schedule(1e-3, steps, factors), jax_make_lr_schedule(1e-3, steps,
                                                                                 factors)
        for s in range(1, 16):  # the decay starts at the 1-indexed step D + 2
            assert port(s) == np.float32(ref(jnp.asarray(s, jnp.int32))), (steps, s)
    assert make_lr_schedule(1e-3, (5,), (0.1,))(6) == np.float32(1e-3)
    assert make_lr_schedule(1e-3, (5,), (0.1,))(7) == np.float32(1e-3) * np.float32(0.1)
    with pytest.raises(ValueError):
        make_lr_schedule(1e-3, (1, 2), (0.5,))
