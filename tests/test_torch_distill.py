"""Distillation in the port (``lm2a_tpu_torch/training/distill.py``) against
the JAX package's ``lm2a_tpu/training/distill.py``, on the CPU at a tiny size.

Both sides hold the same weights: a seeded port student and a second seeded
port state as the teacher, carried into JAX trees leaf by leaf in the
checkpoint layout (``_torch_port_util.jax_train_state``). The draws (student
grid indices, noise) come from JAX's key, as ``_distill_one_step`` splits
it, and are injected into the port (``DistillDraws``).

- the student grid (exact) and ``ddim_det_step`` (1e-6 absolute, fp32);
- the loss of one batch for each loss space at guidance 1.0 and 2.1,
  against the loss builder ``_distill_one_step`` hands to
  ``make_update_step`` (1e-5 relative; fp32 on both sides, the port's
  teacher on the serving route and JAX's on the training form, sums in
  another order). The schedule reaches SNR < 1, so w = max(SNR, 1) is not
  the eps weight everywhere, and the draws include the last grid point (t = 0,
  mid and t_prev = -1);
- four ``make_distill_step`` steps against JAX's, with
  ``test_torch_train.py``'s tolerances at its rate and EMA decay (2e-4,
  0.999). The first step leaves the parameters as they are (weight decay
  0, Adan's moments frozen) and the second repeats its draws, so both see
  one gradient g and Adan's n takes (1.92 g - 0.92 g)^2 = g^2. With other
  draws at the second step an element where 1.92 g2 nearly equals 0.92 g1
  gets an n near 0 and a step of hundreds of lr on both sides, which
  turns the packages' 1e-6 relative gradient differences into a
  per-element step difference no bound of that file covers (seen: 0.046
  against 0.066 at one of ~1e5 elements). The third and fourth steps take
  fresh draws and batches on that warmed n (each element's step stays
  below lr), under the same bounds;
- the cosine rate against the jitted ``optax.cosine_decay_schedule`` over
  whole runs (1e-5 relative: XLA folds pi / D into one constant and its
  fp32 cosine is not correctly rounded);
- in the port alone: the K-step device-data call against K single steps
  (bit for bit), the index stream's replay, and a teacher that no student
  step can reach.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lm2a_tpu.core.config import DiffusionConfig, LM2AConfig, ModelConfig, TrainConfig
from lm2a_tpu.core.config import config_to_dict as jax_config_to_dict
from lm2a_tpu.diffusion.schedule import make_schedule as jax_make_schedule
from lm2a_tpu.models.factory import build_cond_projection as jax_bcp
from lm2a_tpu.models.factory import build_denoiser as jax_bd
from lm2a_tpu.training import distill as jdistill
from lm2a_tpu.training import train_step as jts
from lm2a_tpu_torch.core.config import config_from_dict
from lm2a_tpu_torch.diffusion.schedule import make_schedule
from lm2a_tpu_torch.training import distill
from lm2a_tpu_torch.training.adan import cosine_decay_schedule
from lm2a_tpu_torch.training.checkpoint import state_arrays
from lm2a_tpu_torch.training.train_step import init_train_state, make_optimizer, step_generator

from _torch_port_util import (  # noqa: F401
    jax_state_arrays, jax_train_state, one_torch_thread, rand,
)
from test_torch_train import assert_state_close

B, T, N_STUDENT = 4, 32, 3
MEAN, STD = -4.5, 2.0
TOL_LOSS, TOL_DET = 1e-5, 1e-6
SPACES = ("eps", "x0_snr", "x0_snr_mm")
GUIDANCES = (1.0, 2.1)
KEY = 7  # JAX's key of the loss and of both steps; it draws the last grid point

JCFG = LM2AConfig(
    model=ModelConfig(base_dim=16, dim_mults=(1, 2), cond_dim=8, time_emb_dim=16,
                      num_res_blocks=1, mid_blocks=1, attn_heads=2, motion_dim=12,
                      text_dim=24),
    diffusion=DiffusionConfig(timesteps=40, beta_end=0.3),
    train=TrainConfig(batch_size=B, weight_decay=0.0, compute_dtype="float32"),
)
# the port's side at cli distill's optimizer route (adan_ema's plain version here)
PCFG = config_from_dict(jax_config_to_dict(JCFG))
PCFG = dataclasses.replace(PCFG, train=dataclasses.replace(PCFG.train, opt_backend="pallas"))


def make_batch(seed, b=B, t=T):
    rng = np.random.default_rng(seed)
    return {"mel": MEAN + STD * rand(rng, b, t, 80), "motion": rand(rng, b, t, 12),
            "lyrics": rand(rng, b, t, 24)}


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def jax_draws(key, b=B, n=N_STUDENT, t=T) -> distill.DistillDraws:
    """The grid indices and noise ``_distill_one_step``'s loss draws from ``key``."""
    k_idx, k_noise = jax.random.split(key)
    idx = jax.random.randint(k_idx, (b,), 0, n)
    noise = jax.random.normal(k_noise, (b, t, 80), dtype=jnp.float32)
    return distill.DistillDraws(torch.tensor(np.asarray(idx)).long(),
                                torch.tensor(np.asarray(noise)))


def jax_loss_builder(den, cp, schedule, tx, guidance, space):
    """The ``loss_builder(params, batch, key, teacher_params)`` that
    ``_distill_one_step`` passes to ``make_update_step``."""
    seen = {}
    real = jts.make_update_step

    def spy(loss_builder, *a, **kw):
        seen["lb"] = loss_builder
        return real(loss_builder, *a, **kw)

    jts.make_update_step = spy
    try:
        jdistill._distill_one_step(den, cp, schedule, JCFG, tx, N_STUDENT,
                                   dataset_mean=MEAN, dataset_std=STD,
                                   guidance_weight=guidance, loss_space=space)
    finally:
        jts.make_update_step = real
    return seen["lb"]


@pytest.fixture(scope="module")
def setup():
    """Port student (seed 0) and teacher (a second seeded state's EMA), the
    same weights as JAX trees, the JAX modules and a batch."""
    student = init_train_state(PCFG, 0, "cpu", make_optimizer(PCFG))
    teacher_state = init_train_state(PCFG, 5, "cpu")
    jstate = jax_train_state(state_arrays(student))
    jteacher = jax_train_state(state_arrays(teacher_state)).ema_params
    return dict(student=student, teacher_ema=teacher_state.ema, jstate=jstate,
                jteacher=jteacher, den=jax_bd(JCFG.model, "float32"),
                cp=jax_bcp(JCFG.model, "float32"), jschedule=jax_make_schedule(JCFG.diffusion),
                tx=jts.make_optimizer(JCFG), batch=make_batch(3))


@pytest.fixture(scope="module")
def losses(setup):
    """Every (loss space, guidance) loss at ``KEY``, both packages."""
    s = setup
    builders = {(sp, w): jax_loss_builder(s["den"], s["cp"], s["jschedule"], s["tx"], w, sp)
                for sp in SPACES for w in GUIDANCES}

    @jax.jit
    def all_losses(params, teacher, batch, key):
        return {f"{sp}@{w}": lb(params, batch, key, teacher) for (sp, w), lb in builders.items()}

    key = jax.random.key(KEY)
    want = jax.device_get(all_losses(s["jstate"].params, s["jteacher"], s["batch"], key))
    teacher = distill.build_teacher(PCFG, s["teacher_ema"])
    schedule = make_schedule(PCFG.diffusion)
    grid = tuple(torch.as_tensor(a) for a in distill.student_time_grid(40, N_STUDENT))
    draws = jax_draws(key)
    got = {}
    with torch.no_grad():
        for sp in SPACES:
            for w in GUIDANCES:
                got[f"{sp}@{w}"] = float(distill.distill_loss(
                    s["student"], teacher, schedule, grid, torch_batch(s["batch"]), PCFG,
                    dataset_mean=MEAN, dataset_std=STD, guidance_weight=w, x0_clip=2.0,
                    loss_space=sp, draws=draws))
    return got, {k: float(v) for k, v in want.items()}, draws


# ---------------------------------------------------------------- grid, step, rate

@pytest.mark.parametrize("timesteps,n", [(40, 3), (40, 40), (40, 1), (1000, 50),
                                         (1000, 100), (1000, 25), (999, 7)])
def test_student_time_grid_matches_jax(timesteps, n):
    got = distill.student_time_grid(timesteps, n)
    want = jdistill.student_time_grid(timesteps, n)
    for g, w in zip(got, want):
        assert g.dtype == np.int64
        np.testing.assert_array_equal(g, np.asarray(w))
    ts, ts_prev, ts_mid = got
    assert ts_prev[-1] == -1 and ts_mid[-1] == (ts[-1] - 1) // 2
    assert ((ts_mid >= ts_prev) & (ts_mid < ts)).all()


@pytest.mark.parametrize("stages,guidance", [(1, 2.1), (3, 2.1), (2, 1.0), (4, 3.0)])
def test_stage_guidance_schedule_matches_jax(stages, guidance):
    got = distill.stage_guidance_schedule(stages, guidance)
    assert got == jdistill.stage_guidance_schedule(stages, guidance)
    assert got[0] == guidance and all(w == 1.0 for w in got[1:])


def test_ddim_det_step_matches_jax():
    rng = np.random.default_rng(1)
    x, eps = rand(rng, 6, 32, 80, scale=2.0), rand(rng, 6, 32, 80)
    t = np.array([39, 30, 10, 1, 0, 0])
    t_prev = np.array([20, 29, 0, 0, -1, -1])
    schedule = make_schedule(PCFG.diffusion)
    for clip in (2.0, 0.5):
        got = distill.ddim_det_step(torch.from_numpy(x), torch.from_numpy(eps),
                                    torch.from_numpy(t), torch.from_numpy(t_prev), schedule, clip)
        want = jdistill.ddim_det_step(jnp.asarray(x), jnp.asarray(eps), jnp.asarray(t),
                                      jnp.asarray(t_prev), jax_make_schedule(JCFG.diffusion), clip)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL_DET)


@pytest.mark.parametrize("lr,total", [(5e-5, 8), (5e-5, 1200), (1e-3, 600), (2e-4, 7)])
def test_cosine_rate_matches_optax(lr, total):
    """The rate at each 1-indexed step of a whole run and two past its end."""
    got = cosine_decay_schedule(lr, total, alpha=0.01)
    want = jax.jit(optax.cosine_decay_schedule(lr, decay_steps=total, alpha=0.01))
    steps = np.arange(1, total + 3)
    g = np.array([got(int(s)) for s in steps])
    w = np.array([np.float32(want(jnp.int32(s))) for s in steps])
    assert g.dtype == np.float32
    np.testing.assert_allclose(g, w, rtol=1e-5, atol=0)
    assert g[-1] == np.float32(lr) * np.float32(0.01)
    with pytest.raises(ValueError):
        cosine_decay_schedule(lr, 0)


# ---------------------------------------------------------------- loss and step

def test_draws_reach_the_last_grid_point(losses):
    """The key's indices include the last student step (t = 0 -> -1 via -1)."""
    idx = losses[2].idx.numpy()
    assert (N_STUDENT - 1) in idx and len(set(idx.tolist())) > 1


def test_schedule_reaches_snr_below_one():
    ab = make_schedule(PCFG.diffusion).alpha_bars
    assert float(ab[-1] / (1 - ab[-1])) < 1.0


@pytest.mark.parametrize("guidance", GUIDANCES)
@pytest.mark.parametrize("space", SPACES)
def test_loss_matches_jax(losses, space, guidance):
    got, want, _ = losses
    k = f"{space}@{guidance}"
    assert np.isfinite(got[k]) and got[k] > 0
    assert abs(got[k] - want[k]) <= TOL_LOSS * abs(want[k]), (got[k], want[k])


def test_loss_spaces_differ(losses):
    """The three objectives are different numbers (a silent fallthrough to
    one loss would make them equal), and guidance changes the target."""
    got = losses[0]
    for w in GUIDANCES:
        vals = [got[f"{sp}@{w}"] for sp in SPACES]
        assert len({round(v, 9) for v in vals}) == 3, vals
        assert got[f"x0_snr_mm@{w}"] > got[f"x0_snr@{w}"]
    assert got["eps@1.0"] != got["eps@2.1"]


def test_distill_step_matches_jax(setup):
    """Four steps (x0_snr at guidance 2.1) from the same student and
    teacher: loss, parameters, EMA and Adan state (gradients through
    prev_grad). The first two share their draws and batch; the last two
    take fresh ones, so Adan's moments hold different gradients."""
    s = setup
    jstep = jdistill.make_distill_step(
        s["den"], s["cp"], s["jschedule"], JCFG, s["tx"], N_STUDENT, dataset_mean=MEAN,
        dataset_std=STD, guidance_weight=2.1, loss_space="x0_snr")
    optimizer = make_optimizer(PCFG)
    pstate = init_train_state(PCFG, 0, "cpu", optimizer)
    pstep = distill.make_distill_step(
        make_schedule(PCFG.diffusion), PCFG, optimizer, N_STUDENT, dataset_mean=MEAN,
        dataset_std=STD, guidance_weight=2.1, loss_space="x0_snr")
    teacher = distill.build_teacher(PCFG, s["teacher_ema"])
    jstate = jax.tree.map(jnp.copy, s["jstate"])  # the step donates its input
    batch = s["batch"]
    got0, want0 = state_arrays(pstate), jax_state_arrays(jstate)
    for i, (key, batch) in enumerate([(KEY, batch), (KEY, batch), (KEY + 1, make_batch(4)),
                                      (KEY + 2, make_batch(5))]):
        key = jax.random.key(key)
        jstate, jloss = jstep(jstate, s["jteacher"], batch, key)
        ploss = pstep(pstate, teacher, torch_batch(batch), draws=jax_draws(key))
        assert abs(float(ploss) - float(jloss)) <= TOL_LOSS * abs(float(jloss))
        got, want = state_arrays(pstate), jax_state_arrays(jstate)
        assert_state_close(got, want, got0, want0, warm=i > 0)
        got0, want0 = got, want
    assert pstate.step == pstate.opt.step == 4


@pytest.mark.parametrize("guidance", GUIDANCES)
def test_fused_attention_teacher_loss_matches_jax(guidance):
    """A ``fused_attention`` teacher and student at base width 32 (head dims
    16 and 32): the port's teacher on the serving route through the
    attention core (its plain version on the CPU), JAX's through its Pallas
    kernels in interpret mode; the x0_snr loss of one batch within
    ``TOL_LOSS`` (fp32 on both sides, the kernel's softmax summed in another
    order)."""
    model = dataclasses.replace(JCFG.model, base_dim=32, fused_attention=True)
    jcfg = dataclasses.replace(JCFG, model=model)
    pcfg = dataclasses.replace(PCFG, model=config_from_dict(jax_config_to_dict(jcfg)).model)
    student = init_train_state(pcfg, 0, "cpu", make_optimizer(pcfg))
    teacher_state = init_train_state(pcfg, 5, "cpu")
    jstate = jax_train_state(state_arrays(student))
    jteacher = jax_train_state(state_arrays(teacher_state)).ema_params
    seen = {}
    real = jts.make_update_step

    def spy(loss_builder, *a, **kw):
        seen["lb"] = loss_builder
        return real(loss_builder, *a, **kw)

    jts.make_update_step = spy
    try:
        jdistill._distill_one_step(jax_bd(jcfg.model, "float32"), jax_bcp(jcfg.model, "float32"),
                                   jax_make_schedule(jcfg.diffusion), jcfg,
                                   jts.make_optimizer(jcfg), N_STUDENT, dataset_mean=MEAN,
                                   dataset_std=STD, guidance_weight=guidance,
                                   loss_space="x0_snr")
    finally:
        jts.make_update_step = real
    batch, key = make_batch(3), jax.random.key(KEY)
    want = float(jax.jit(seen["lb"])(jstate.params, batch, key, jteacher))
    teacher = distill.build_teacher(pcfg, teacher_state.ema)
    assert teacher.unet.fused_attention
    grid = tuple(torch.as_tensor(a) for a in distill.student_time_grid(40, N_STUDENT))
    with torch.no_grad():
        got = float(distill.distill_loss(
            student, teacher, make_schedule(pcfg.diffusion), grid, torch_batch(batch), pcfg,
            dataset_mean=MEAN, dataset_std=STD, guidance_weight=guidance, x0_clip=2.0,
            loss_space="x0_snr", draws=jax_draws(key)))
    assert np.isfinite(got) and abs(got - want) <= TOL_LOSS * abs(want), (got, want)


# ---------------------------------------------------------------- the port alone

def test_teacher_is_a_copy_the_student_cannot_reach(setup):
    """The teacher built from the student's EMA shares no storage with the
    student, and a student step (which moves the EMA in place) leaves it
    as it was."""
    optimizer = make_optimizer(PCFG)
    state = init_train_state(PCFG, 2, "cpu", optimizer)
    teacher = distill.build_teacher(PCFG, state.ema)
    tensors = [*teacher.unet.parameters(), *teacher.cond_proj.parameters()]
    theirs = {t.untyped_storage().data_ptr() for t in [*state.params().values(),
                                                       *state.ema.values()]}
    assert not theirs & {t.untyped_storage().data_ptr() for t in tensors}
    assert all(not t.requires_grad for t in tensors)
    before = [t.clone() for t in tensors]
    ema_before = {k: v.clone() for k, v in state.ema.items()}
    step = distill.make_distill_step(make_schedule(PCFG.diffusion), PCFG, optimizer,
                                     N_STUDENT, guidance_weight=2.1, loss_space="eps")
    for i in range(2):
        step(state, teacher, torch_batch(setup["batch"]),
             generator=step_generator(0, i, "cpu"))
    assert any(not torch.equal(state.ema[k], ema_before[k]) for k in ema_before)
    assert all(torch.equal(a, b) for a, b in zip(tensors, before))


@pytest.mark.parametrize("fused", [False, True])
def test_multistep_equals_single_steps_bitwise(fused):
    """K = 3 steps over a dataset on the device (rows gathered with
    index_select, generators from the global steps) against 3 single steps
    on the same rows: losses and every state tensor equal bit for bit."""
    cfg = dataclasses.replace(PCFG, model=dataclasses.replace(PCFG.model,
                                                              fused_resblock_grad=fused))
    schedule = make_schedule(cfg.diffusion)
    data = {k: torch.from_numpy(v) for k, v in make_batch(11, b=6).items()}
    idx = np.random.default_rng(4).integers(0, 6, size=(3, B))
    offsets = range(5, 8)
    out = []
    for multi in (True, False):
        optimizer = make_optimizer(cfg)
        state = init_train_state(cfg, 0, "cpu", optimizer)
        teacher = distill.build_teacher(cfg, init_train_state(cfg, 5, "cpu").ema)
        kw = dict(guidance_weight=2.1, loss_space="x0_snr_mm")
        if multi:
            fn = distill.make_device_data_multistep_distill(schedule, cfg, optimizer, 2, **kw)
            losses = fn(state, teacher, data, torch.from_numpy(idx), 9, offsets)
        else:
            step = distill.make_distill_step(schedule, cfg, optimizer, 2, **kw)
            losses = torch.stack([
                step(state, teacher, {k: v[torch.from_numpy(i)] for k, v in data.items()},
                     generator=step_generator(9, off, "cpu"))
                for i, off in zip(idx, offsets)])
        out.append((losses, state_arrays(state)))
    (lm, am), (ls, as_) = out
    assert lm.shape == (3,) and torch.equal(lm, ls)
    assert set(am) == set(as_)
    for k in am:
        np.testing.assert_array_equal(am[k], as_[k], err_msg=k)
    assert int(am[".step"]) == 3


@pytest.mark.parametrize("k_fuse,done", [(2, 0), (2, 2), (2, 4), (3, 3), (4, 0), (1, 5)])
def test_index_stream_replays_to_the_saved_step(k_fuse, done):
    """The JAX CLI's stream: default_rng(seed).integers(0, n, (k, B)) with k =
    min(k_fuse, steps left); a resumed stage yields the same tail."""
    full = list(distill.index_stream(10, 3, 41, 7, k_fuse))
    rng = np.random.default_rng(41)
    want, d = [], 0
    while d < 7:
        k = min(k_fuse, 7 - d)
        want.append((d, rng.integers(0, 10, size=(k, 3))))
        d += k
    assert len(full) == len(want)
    for g, (_, w) in zip(full, want):
        np.testing.assert_array_equal(g, w)
    tail = list(distill.index_stream(10, 3, 41, 7, k_fuse, done=done))
    assert len(tail) == sum(d0 >= done for d0, _ in want)
    for g, (_, w) in zip(tail, [x for x in want if x[0] >= done]):
        np.testing.assert_array_equal(g, w)
