"""Sequence-parallel training on the fused train chain (``make_sp_train_step``
with ``fused_resblock_grad``), on the CPU.

- The chain across shards: random whole tensors cut into 1 or 3 shards of T
  frames each (local T of 1, 2, 63, 64, 65 and 129, so every (hl, hr) halo
  of {0, 1}), each shard's ``chain_forward_sharded`` and
  ``chain_backward_sharded`` run in a thread of its own, their halo
  exchanges and all-reduces through a board that every shard's thread
  reads. The shards' ``h`` and ``dx`` concatenated, and their weight, norm
  and FiLM gradients summed, against the unsharded ``chain_forward`` and
  ``chain_backward`` at fp32 relative L2 1e-5 (fp32 sums in another order),
  at a width on the 8-channel unit and one off it (Cin 21 -> Cout 42). The
  chain runs through the kernel wrappers, which take the plain versions on
  the CPU: the halo forms of ``conv3_dgrad`` and ``conv3_wgrad`` and the
  totals form of ``gn_bwd``.
- The whole step over gloo ranks: the port's ``make_sp_train_step`` with
  ``fused_resblock_grad`` (and ``opt_backend pallas``) on (data 1, model 2),
  (data 2, model 2) and (data 1, model 4) meshes at T = 32 and T = 66 (a
  33-frame stage split unevenly), two steps from the flax init of
  ``test_torch_train.py`` carried across,
  the JAX draws injected, against the JAX package's ``make_sp_train_step``
  with ``fused_resblock_grad`` on as many of the conftest's virtual devices
  and against the port's unsharded step: ``test_torch_train.py``'s
  ``TOL_LOSS`` and ``assert_state_close``. GSPMD cannot split T = 66 over
  four devices (the JAX step refuses it), so (data 1, model 4) at T = 66
  is held against the JAX package's unsharded fused step. The T = 32 cases
  are in ``test_torch_sp_fused_t32.py``.
- The gate: with the training gate's budget set so that some blocks fit at
  the local length but not at the global one, the sharded step routes
  exactly the blocks ``resblock_train_fits`` routes at the global length.
- The forms alone: zero halo rows give the local forms, the totals form fed
  a shard's own totals gives the pieces form bit for bit, a numpy emulation
  of ``conv3_dgrad``'s halo addressing (its M tiles and windows) reads every
  row's own halo-padded rows at T of 1 to 258, with zeros exactly at global
  edges, and ``conv3_wgrad``'s halo form is its local form on zero-padded
  gradient rows (what the kernel route launches).
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lm2a_tpu.core.mesh import make_mesh as jax_make_mesh
from lm2a_tpu.diffusion import make_schedule as jax_make_schedule
from lm2a_tpu.models.factory import build_cond_projection as jax_bcp
from lm2a_tpu.models.factory import build_denoiser as jax_bd
from lm2a_tpu.parallel.sequence import make_sp_train_step as jax_make_sp_train_step
from lm2a_tpu.training import init_train_state as jax_init_train_state
from lm2a_tpu.training.train_step import make_train_step as jax_make_train_step
from lm2a_tpu_torch.core.config import config_from_dict, config_to_dict
from lm2a_tpu_torch.diffusion.schedule import make_schedule
from lm2a_tpu_torch.ops import resblock_grad as rg
from lm2a_tpu_torch.training.checkpoint import load_state_arrays, state_arrays
from lm2a_tpu_torch.training.train_step import init_train_state, make_train_step

from _torch_port_util import jax_state_arrays, jax_train_state, one_torch_thread, rand, rel_l2  # noqa: F401
from _torch_ranks import spawn
from test_torch_train import MEAN, STD, TOL_LOSS, assert_state_close, jax_cfg, jax_draws

TOL_CHAIN = 1e-5
STATE = "state|"

# ---------------------------------------------------------------- the chain across shards


class BoardShard:
    """One shard's ``halo`` and ``all_reduce`` for threads of one process:
    each shard posts its tensor on a shared board, all wait, each reads its
    neighbours' rows (or adds every post in shard order), all wait again."""

    def __init__(self, index: int, parts: int, board: list, barrier: threading.Barrier):
        self.index, self.parts, self.board, self.barrier = index, parts, board, barrier

    def _post(self, t):
        self.board[self.index] = t
        self.barrier.wait()

    def halo(self, v, n):
        self._post(v)
        i = self.index
        left = self.board[i - 1][:, -1:] if i > 0 else None
        right = self.board[i + 1][:, :1] if i < self.parts - 1 else None
        ext = torch.cat([p for p in (left, v, right) if p is not None], 1).contiguous()
        self.barrier.wait()
        return ext, int(left is not None)

    def all_reduce(self, t):
        self._post(t.clone())
        total = self.board[0].clone()
        for p in self.board[1:]:
            total += p
        self.barrier.wait()
        return t.copy_(total)


def _threads(parts: int, fn):
    """``fn(shard)`` for every shard in a thread of its own; the results in
    shard order (a failure in any shard fails the call)."""
    board, barrier = [None] * parts, threading.Barrier(parts, timeout=60)
    out, errors = [None] * parts, []

    def run(i):
        try:
            out[i] = fn(BoardShard(i, parts, board, barrier))
        except BaseException as e:  # noqa: BLE001 - reraised below
            errors.append(e)
            barrier.abort()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(parts)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    return out


def _chain_inputs(seed, b, n, cin, cout, groups1, groups2, skip):
    rng = np.random.default_rng(seed)
    t = lambda *s, scale=1.0: torch.from_numpy(rand(rng, *s, scale=scale))  # noqa: E731
    w = dict(g1s=1.0 + t(cin, scale=0.1), g1b=t(cin, scale=0.1),
             w1=t(cout, 3 * cin, scale=0.2), b1=t(cout, scale=0.1),
             g2s=1.0 + t(cout, scale=0.1), g2b=t(cout, scale=0.1),
             w2=t(cout, 3 * cout, scale=0.2), b2=t(cout, scale=0.1),
             sw=t(cout, cin, scale=0.2) if skip else None, sb=t(cout, scale=0.1) if skip else None)
    x = t(b, n, cin)
    film = (t(b, cout, scale=0.1), t(b, cout, scale=0.1))
    gh, gxs = t(b, n, cout), t(b, n, cout) if skip else None
    return x, film, w, gh, gxs


WIDTHS = [(16, 32, 4, 8, True), (32, 32, 8, 8, False), (21, 42, 3, 6, True)]


@pytest.mark.parametrize("cin,cout,groups1,groups2,skip", WIDTHS,
                         ids=["16-32-skip", "32-32", "21-42-skip"])
@pytest.mark.parametrize("tl", [1, 2, 63, 64, 65, 129])
@pytest.mark.parametrize("parts", [1, 3])
def test_sharded_chain_matches_unsharded(parts, tl, cin, cout, groups1, groups2, skip):
    b, n = 2, parts * tl
    x, (fs, fh), w, gh, gxs = _chain_inputs(parts * 1000 + tl, b, n, cin, cout, groups1,
                                            groups2, skip)
    wargs = (w["g1s"], w["g1b"], w["w1"], w["b1"], w["g2s"], w["g2b"], w["w2"], w["b2"],
             w["sw"], w["sb"], groups1, groups2)
    h, xs, saved = rg.chain_forward(x, fs, fh, *wargs)
    want = rg.chain_backward(saved, w["g1s"], w["g1b"], w["w1"], w["g2s"], w["g2b"], w["w2"],
                             w["sw"], gh, gxs)

    def shard_run(shard):
        rows = slice(shard.index * tl, (shard.index + 1) * tl)
        hs, xss, sv = rg.chain_forward_sharded(x[:, rows].contiguous(), fs, fh, *wargs, shard, n)
        assert sv[-1] == (int(shard.index > 0), int(shard.index < parts - 1))
        d = rg.chain_backward_sharded(sv, w["g1s"], w["g1b"], w["w1"], w["g2s"], w["g2b"],
                                      w["w2"], w["sw"], gh[:, rows].contiguous(),
                                      gxs[:, rows].contiguous() if skip else None, shard, n)
        return hs, xss, d

    outs = _threads(parts, shard_run)
    assert rel_l2(torch.cat([o[0] for o in outs], 1), h) <= TOL_CHAIN
    if skip:
        assert rel_l2(torch.cat([o[1] for o in outs], 1), xs) <= TOL_CHAIN
    assert set(outs[0][2]) == set(want)
    for k, v in want.items():
        got = (torch.cat([o[2][k] for o in outs], 1) if k == "dx"
               else sum(o[2][k] for o in outs))
        assert got.shape == v.shape, k
        assert rel_l2(got, v) <= TOL_CHAIN, (k, rel_l2(got, v))


@pytest.mark.parametrize("hl,hr", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_halo_forms_equal_the_local_forms_on_the_padded_rows(hl, hr):
    """A halo form whose halo rows are zero (a zero output gradient row, a
    source row whose activation is zero) is the local form: the halo rows
    carry exactly what a neighbour adds."""
    rng = np.random.default_rng(hl * 2 + hr)
    b, t, cin, cout, g = 2, 65, 24, 16, 4
    gh = torch.from_numpy(rand(rng, b, t, cout))
    w = torch.from_numpy(rand(rng, cout, 3 * cin, scale=0.2))
    pre = torch.from_numpy(rand(rng, b, t, cin))
    mean, rstd = torch.from_numpy(rand(rng, b, g)), 1.0 + torch.from_numpy(rand(rng, b, g)) ** 2
    ga, be = torch.from_numpy(rand(rng, cin)), torch.from_numpy(rand(rng, cin))
    a = dict(pre=pre, mean=mean, rstd=rstd, gamma=ga, beta=be)
    padded = torch.nn.functional.pad(gh, (0, 0, hl, hr))
    d0, p0 = rg.conv3_dgrad(gh, w, taps=3, **a)
    d1, p1 = rg.conv3_dgrad(padded, w, taps=3, halo=(hl, hr), **a)
    torch.testing.assert_close(d1, d0, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(p1, p0, rtol=1e-6, atol=1e-5)
    # a halo row of zeros' activation: beta = 0 and the row at the mean
    act = dict(mean=mean, rstd=rstd, gamma=ga, beta=torch.zeros_like(be))
    srcp = torch.cat([mean.repeat_interleave(cin // g, -1)[:, None]] * hl + [pre]
                     + [mean.repeat_interleave(cin // g, -1)[:, None]] * hr, 1)
    w0, _ = rg.conv3_wgrad(pre, gh, taps=3, **act)
    w1, _ = rg.conv3_wgrad(srcp, gh, taps=3, halo=(hl, hr), **act)
    torch.testing.assert_close(w1, w0, rtol=1e-6, atol=1e-5)


def test_gn_bwd_totals_form_is_the_pieces_form():
    """``gn_bwd``'s totals form fed one shard's own totals is its pieces form."""
    rng = np.random.default_rng(3)
    b, t, c, g = 2, 70, 24, 6
    dy, pre = (torch.from_numpy(rand(rng, b, t, c)) for _ in range(2))
    mean, rstd = torch.from_numpy(rand(rng, b, g)), 1.0 + torch.from_numpy(rand(rng, b, g)) ** 2
    gamma = torch.from_numpy(rand(rng, c))
    _, pieces = rg.conv3_dgrad_plain(torch.from_numpy(rand(rng, b, t, 16)),
                                     torch.from_numpy(rand(rng, 16, 3 * c)), pre=pre, mean=mean,
                                     rstd=rstd, gamma=gamma, beta=gamma)
    want, _ = rg.gn_bwd(dy, pre, mean, rstd, gamma, pieces)
    got, _ = rg.gn_bwd(dy, pre, mean, rstd, gamma, None, totals=rg.gn_totals(pieces, gamma, g),
                       count=t * (c // g))
    assert torch.equal(got, want)


# ---------------------------------------------------------------- the step over gloo ranks

MESHES = [(1, 2), (2, 2), (1, 4)]


def _step_batch(i, t):
    rng = np.random.default_rng(60 + i + t)
    b = jax_cfg(True).train.batch_size
    return {"mel": MEAN + STD * rand(rng, b, t, 80), "motion": rand(rng, b, t, 234),
            "lyrics": rand(rng, b, t, 768)}


@pytest.fixture(scope="module")
def setup():
    """The flax-initialised kernel-route state of ``test_torch_train.py``
    (its config, ``jax.random.key(0)``), as host arrays in the checkpoint
    layout, the JAX modules and optimizer."""
    cfg = jax_cfg(True)
    den, cp = jax_bd(cfg.model, "float32"), jax_bcp(cfg.model, "float32")
    state, tx = jax_init_train_state(den, cp, cfg, jax.random.key(0), seq_len=32)
    return dict(cfg=cfg, den=den, cp=cp, arrays=jax_state_arrays(state), tx=tx,
                port_cfg=config_from_dict(config_to_dict(cfg)))


def _state_at(out, i):
    pre = f"{STATE}{i}|"
    return {k[len(pre):]: v for k, v in out.items() if k.startswith(pre)}


def check_sp_fused_step(s, tmp_path, data: int, model: int, t: int):
    """Two steps of the port's sequence-parallel fused step over ``data *
    model`` gloo ranks against the JAX package's on as many virtual devices
    (its unsharded ``make_train_step`` where GSPMD cannot split T over the
    model axis: T = 66 over 4) and against the port's unsharded step."""
    cfg, port_cfg = s["cfg"], s["port_cfg"]
    mesh = jax_make_mesh(jax.devices()[:data * model], model=model)
    jstate = jax_train_state(s["arrays"])
    if t % model == 0:
        jstep = jax_make_sp_train_step(s["den"], s["cp"], jax_make_schedule(cfg.diffusion), cfg,
                                       s["tx"], mesh, dataset_mean=MEAN, dataset_std=STD)
        # replicated from the start, as the step leaves it: one compile
        jstate = jax.device_put(jstate, jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec()))
    else:
        jstep = jax_make_train_step(s["den"], s["cp"], jax_make_schedule(cfg.diffusion), cfg,
                                    s["tx"], dataset_mean=MEAN, dataset_std=STD)
    states, losses, draws = [s["arrays"]], [], []
    for i in range(2):
        key = jax.random.key(300 + i)
        jb = {k: jnp.asarray(v) for k, v in _step_batch(i, t).items()}
        with mesh:
            jstate, loss = jstep(jstate, jb, key)
        states.append(jax_state_arrays(jstate))
        losses.append(float(loss))
        draws.append(jax_draws(key, jb["mel"], cfg.train.cond_drop_prob,
                               cfg.diffusion.timesteps, train=True))
    b = cfg.train.batch_size
    arrays = {f"{k}_{i}": v for i in range(2) for k, v in _step_batch(i, t).items()}
    for i, d in enumerate(draws):
        arrays.update({f"t_{i}": d.t.numpy(), f"noise_{i}": d.noise.numpy()})
        if d.keep is not None:
            arrays[f"keep_{i}"] = d.keep.numpy()
    arrays.update({STATE + k: v for k, v in states[0].items()})
    arrays["meta"] = dict(cfg=config_to_dict(port_cfg), batch=b, steps=2, mode="draws", seed=5,
                          mean=MEAN, std=STD, model_axis=model)
    outs = spawn("sp_step", data * model, tmp_path, arrays, timeout=240.0)
    one = init_train_state(port_cfg, 0, "cpu")
    load_state_arrays(one, s["arrays"])
    step = make_train_step(make_schedule(port_cfg.diffusion), port_cfg, dataset_mean=MEAN,
                           dataset_std=STD)
    for i in range(2):
        before = state_arrays(one)
        loss = step(one, {k: torch.tensor(v) for k, v in _step_batch(i, t).items()},
                    draws=draws[i])
        got = _state_at(outs[0], i)
        got0 = _state_at(outs[0], i - 1) if i else states[0]
        for o in outs:
            assert float(o[f"loss_{i}"]) == pytest.approx(losses[i], rel=TOL_LOSS)
            assert float(o[f"loss_{i}"]) == pytest.approx(float(loss), rel=TOL_LOSS)
        assert_state_close(got, states[i + 1], got0, states[i], warm=i > 0)
        assert_state_close(got, state_arrays(one), got0, before, warm=i > 0)
        for o in outs[1:]:  # every rank holds one state
            for k, v in got.items():
                assert np.array_equal(v, _state_at(o, i)[k]), k
    c = outs[0]["census"]["collectives"]
    assert c["collective-permute"] >= 1 and c["all-reduce"] >= 1, c


@pytest.mark.parametrize("data,model", MESHES, ids=[f"d{d}m{m}" for d, m in MESHES])
def test_sp_fused_step_matches_jax_and_unsharded(setup, tmp_path, data, model):
    """T = 66: the 33-frame stage split 17/16 and 9/8/8/8 (the T = 32 cases
    are in ``test_torch_sp_fused_t32.py``)."""
    check_sp_fused_step(setup, tmp_path, data, model, 66)


def _footprint(t, cin, cout, skip):
    """The training gate's bytes at fp32 compute (``resblock_train_fits``)."""
    wcount = 3 * cin * cout + 3 * cout * cout + (cin * cout if skip else 0)
    return wcount * 8 + t * max(cin, cout) * 4 * 8


def test_sp_fused_step_routes_the_blocks_the_global_gate_routes(setup, tmp_path):
    """T = 64 over two ranks, the gate's budget set just below the second
    smallest global footprint, so some blocks fit at the local length but
    not at the global one: the sharded step routes exactly the blocks
    ``resblock_train_fits`` routes at the global length, in forward order."""
    from chip_smoke import resblock_geometries

    port_cfg = setup["port_cfg"]
    t = 64
    geos = [(tt, cin, cout, skip) for _, tt, cin, cout, skip, _ in
            resblock_geometries(port_cfg.model, t)]
    budget = sorted({_footprint(*g) for g in geos})[1] - 1
    old, rg.BWD_VMEM_BUDGET = rg.BWD_VMEM_BUDGET, budget
    try:
        want = [list(g) for g in geos if rg.resblock_train_fits(*g, weight_itemsize=4)]
        local = [g for g in geos if rg.resblock_train_fits(-(-g[0] // 2), *g[1:],
                                                           weight_itemsize=4)]
    finally:
        rg.BWD_VMEM_BUDGET = old
    assert want and len(want) < len(local), (want, local)
    arrays = {f"{k}_0": v for k, v in _step_batch(0, t).items()}
    arrays.update({STATE + k: v for k, v in setup["arrays"].items()})
    arrays["meta"] = dict(cfg=config_to_dict(port_cfg), batch=2, steps=1, mode="generator",
                          seed=5, mean=MEAN, std=STD, model_axis=2, gate_budget=budget)
    outs = spawn("sp_step", 2, tmp_path, arrays)
    for o in outs:
        assert o["routed"] == want


# ---------------------------------------------------------------- the halo forms' addressing

def _dgrad_halo_rows(b, t, hl, hr, bm):
    """An emulation of ``conv3_dgrad``'s halo form's addressing
    (``csrc/resblock_bwd.cu``): for every M tile of ``m_tiles`` and every
    row and tap, the row of the halo-padded g that the tile's window holds
    at the tap's window row (-1: the zero row), as {(b, t, k): g row}."""
    te, m = t + hl + hr, b * t
    rowwise = 2 * t < bm
    tpr = -(-t // bm) if rowwise else 1
    got = {}
    for bx in range(rg.m_tiles(b, t, bm, True)):
        rb0 = bx // tpr
        m0 = rb0 * t + (bx - rb0 * tpr) * bm if rowwise else bx * bm
        b0, t0 = m0 // t, m0 - (m0 // t) * t
        e0 = b0 * te + hl + t0 - 1  # window row 0
        wrows = bm + 6
        for r in range(bm):
            mm = m0 + r
            bb, tt = (b0, t0 + r) if rowwise else (mm // t, mm - (mm // t) * t)
            if (tt >= t) if rowwise else (mm >= m):
                continue
            for k in range(3):
                src = tt + 1 - k
                if not -hl <= src < t + hr:
                    got[(bb, tt, k)] = -1
                    continue
                w = r + 2 - k + (bb - b0) * (hl + hr)
                assert 0 <= w < wrows, (bx, r, k, w)
                q = e0 + w
                assert 0 <= q < b * te
                got[(bb, tt, k)] = q
    return got


@pytest.mark.parametrize("bm", [64, 128])
@pytest.mark.parametrize("t", [1, 2, 31, 32, 33, 63, 64, 65, 129, 258])
@pytest.mark.parametrize("hl,hr", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_dgrad_halo_tiles_read_each_rows_own_gradient(bm, t, hl, hr):
    """Every output row and tap of the halo form reads the halo-padded g
    row of its own batch row and frame t + 1 - k, or the zero row exactly
    where that frame leaves [-hl, T + hr); each row once."""
    b = 3
    got = _dgrad_halo_rows(b, t, hl, hr, bm)
    assert len(got) == b * t * 3
    for bb in range(b):
        for tt in range(t):
            for k in range(3):
                src = tt + 1 - k
                want = bb * (t + hl + hr) + hl + src if -hl <= src < t + hr else -1
                assert got[(bb, tt, k)] == want


@pytest.mark.parametrize("t", [1, 2, 31, 32, 33, 63, 64, 65, 129, 258])
@pytest.mark.parametrize("hl,hr", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_wgrad_halo_form_is_the_local_form_on_padded_gradient_rows(t, hl, hr):
    """``conv3_wgrad``'s halo form is the local form on the source with its
    halo rows and the gradient zero-padded to the same rows (what the
    wrapper launches on the card): a padded row adds nothing, and the zero
    row past a global end is the conv's own padding. Conv 2's fp32 source
    with the bias sums, conv 1's bf16 one without."""
    rng = np.random.default_rng(t * 4 + hl * 2 + hr)
    b, cin, cout, g = 3, 24, 16, 4
    gh = torch.from_numpy(rand(rng, b, t, cout)).to(torch.bfloat16)
    mean, rstd = torch.from_numpy(rand(rng, b, g)), 1.0 + torch.from_numpy(rand(rng, b, g)) ** 2
    act = dict(mean=mean, rstd=rstd, gamma=torch.from_numpy(rand(rng, cin)),
               beta=torch.from_numpy(rand(rng, cin)))
    padded = torch.nn.functional.pad(gh, (0, 0, hl, hr))
    for dtype, bias in ((torch.float32, True), (torch.bfloat16, False)):
        src = torch.from_numpy(rand(rng, b, hl + t + hr, cin)).to(dtype)
        w0, b0 = rg.conv3_wgrad_plain(src, padded, taps=3, bias=bias, **act)
        w1, b1 = rg.conv3_wgrad(src, gh, taps=3, bias=bias, halo=(hl, hr), **act)
        assert rel_l2(w1, w0) <= TOL_CHAIN, (dtype, rel_l2(w1, w0))
        if bias:
            assert rel_l2(b1, b0) <= TOL_CHAIN
