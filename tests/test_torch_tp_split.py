"""Tensor parallelism's split compute (``parallel/tensor.py``,
``ops/resblock_grad.py`` ``chain_forward_tp``/``chain_backward_tp``) on the
CPU, module by module.

- The fused train chain split over the model axis: random whole weights cut
  into each rank's shards (conv 1 on its output channels, conv 2 on its
  input channels, GroupNorm 2, FiLM, the skip on the rank's channels), each
  rank's ``chain_forward_tp`` and ``chain_backward_tp`` in a thread of its
  own, their all-reduces and gathers through a board every thread reads.
  Every rank's ``h``, ``xs`` and ``dx`` and the whole GroupNorm 1 and conv 2
  bias gradients, and the shards put together, against the unsharded
  ``chain_forward`` and ``chain_backward`` at relative L2 1e-5: 2 and 4
  ranks, and 3 ranks of 24 channels in 8 groups (the groups straddle the
  ranks: the statistics and GroupNorm 2's backward from group sums added
  over the axis), with and without a skip, on and off the 8-channel unit.
- Each split module on gloo ranks against the JAX package's module (its
  XLA path, fp32): a ``ResBlockUltimate`` with a skip and attention, its
  training form on the fused train chain and on the library route (output
  and the gradients of ``sum(out * cot)`` for the input, the time
  embedding, the conditions and every parameter, the split leaves' shards
  put together), the split FiLM's scale and shift (the FiLM exchange), and
  a ``CrossAttentionFusion`` site in the training form (with gradients) and
  in the folded serving form (also with ``uncond_rows``): 2 ranks, and 3
  ranks at 24 channels and 2 heads (GroupNorm 2's groups straddle the
  ranks; the heads do not divide, so the site runs replicated on its
  gathered weights).
- A ``ResBlockV1`` of the v1 UNet split on gloo ranks against the JAX
  package's ``ResBlockV1`` (XLA, fp32): the training form (output and the
  gradients of ``sum(out * cot)`` for the input, the time embedding, both
  conditions and every parameter, the split leaves' shards put together),
  the folded serving form, and ``uncond_rows=1``: 2 ranks, and 3 ranks at 24
  channels and 2 heads (GroupNorm 2's 8 groups straddle the ranks, the site
  runs replicated on its gathered weights).
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lm2a_tpu.models import attention as jatt
from lm2a_tpu.models import unet1d as junet
from lm2a_tpu_torch.convert import flatten_params, jax_params_to_torch
from lm2a_tpu_torch.core.mesh import Mesh
from lm2a_tpu_torch.ops import resblock_grad as rg
from lm2a_tpu_torch.parallel.tensor import tp_shardings

from _torch_port_util import one_torch_thread, rand, rel_l2  # noqa: F401
from _torch_rank_jobs import v1_block_payload
from _torch_ranks import spawn
from test_torch_sp_fused import _chain_inputs

TOL = 1e-5


class BoardTP:
    """One rank's ``all_reduce`` and ``gather`` for threads of one process:
    each posts its tensor on a shared board, all wait, each reads every
    post in rank order, all wait again."""

    def __init__(self, index, parts, board, barrier):
        self.index, self.parts, self.board, self.barrier = index, parts, board, barrier

    def _all(self, t):
        self.board[self.index] = t
        self.barrier.wait()
        posts = list(self.board)
        self.barrier.wait()
        return posts

    def all_reduce(self, t):
        posts = self._all(t.clone())
        total = posts[0].clone()
        for p in posts[1:]:
            total += p
        return t.copy_(total)

    def gather(self, x):
        return torch.cat(self._all(x), -1)


def _ranks(parts, fn):
    board, barrier = [None] * parts, threading.Barrier(parts, timeout=60)
    out, errors = [None] * parts, []

    def run(i):
        try:
            out[i] = fn(BoardTP(i, parts, board, barrier))
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


CHAINS = [(2, 16, 32, 4, 8, True), (2, 32, 32, 8, 8, False), (4, 16, 32, 4, 8, True),
          (3, 24, 24, 8, 8, True), (3, 21, 24, 3, 8, False), (2, 21, 42, 3, 6, True)]


@pytest.mark.parametrize("parts,cin,cout,groups1,groups2,skip", CHAINS,
                         ids=["2-16-32-skip", "2-32-32", "4-16-32-skip", "3-24-24-straddle-skip",
                              "3-21-24-straddle", "2-21-42-skip"])
def test_split_chain_matches_unsplit(parts, cin, cout, groups1, groups2, skip):
    b, t = 2, 9
    x, (fs, fh), w, gh, gxs = _chain_inputs(parts * 100 + cout, b, t, cin, cout, groups1,
                                            groups2, skip)
    wargs = (w["g1s"], w["g1b"], w["w1"], w["b1"], w["g2s"], w["g2b"], w["w2"], w["b2"],
             w["sw"], w["sb"], groups1, groups2)
    h, xs, saved = rg.chain_forward(x, fs, fh, *wargs)
    want = rg.chain_backward(saved, w["g1s"], w["g1b"], w["w1"], w["g2s"], w["g2b"], w["w2"],
                             w["sw"], gh, gxs)
    cs = cout // parts

    def rank(tp):
        lo, hi = rg.tp_cols(cout, tp)
        own = lambda v: v[..., lo:hi].contiguous() if v is not None else None  # noqa: E731
        w1, sb = w["w1"][lo:hi], own(w["sb"])
        sw = w["sw"][lo:hi] if skip else None
        w2 = w["w2"].view(cout, 3, cout)[:, :, lo:hi].reshape(cout, 3 * cs)
        hh, xx, sv = rg.chain_forward_tp(x, own(fs), own(fh), w["g1s"], w["g1b"], w1,
                                         own(w["b1"]), own(w["g2s"]), own(w["g2b"]), w2, w["b2"],
                                         sw, sb, groups1, groups2, tp)
        d = rg.chain_backward_tp(sv, w["g1s"], w["g1b"], w1, own(w["g2s"]), own(w["g2b"]), w2,
                                 sw, gh, gxs, groups2, tp)
        return hh, xx, d

    outs = _ranks(parts, rank)
    for hh, xx, d in outs:  # what every rank holds whole
        assert rel_l2(hh, h) <= TOL
        if skip:
            assert rel_l2(xx, xs) <= TOL
        for k in ("dx", "dg1s", "dg1b", "db2"):
            assert d[k].shape == want[k].shape and rel_l2(d[k], want[k]) <= TOL, k
    assert set(outs[0][2]) == set(want)
    for k, v in want.items():  # the shards put together
        if k in ("dx", "dg1s", "dg1b", "db2"):
            continue
        if k == "dw2":  # (3 * Cin/TP, Cout) a rank: its input channels of each tap
            got = torch.cat([o[2][k].view(3, cs, cout) for o in outs], 1).reshape(v.shape)
        else:  # the rank's output channels, last
            got = torch.cat([o[2][k] for o in outs], -1)
        assert got.shape == v.shape and rel_l2(got, v) <= TOL, (k, rel_l2(got, v))


# ---------------------------------------------------------------- the modules on gloo ranks

def _torch_tree(params):
    return {k: v.numpy() for k, v in jax_params_to_torch(
        flatten_params(jax.device_get(params))).items()}


def _close(got, want, scale=None):
    """Relative L2 within TOL, with a floor of 1e-6 of ``scale`` (a gradient
    that is zero in exact arithmetic: the attention key biases')."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    d, n = np.linalg.norm(got - want), np.linalg.norm(want)
    return d <= TOL * n + 1e-6 * (scale or 0.0)


@pytest.mark.parametrize("parts,c,heads", [(2, 32, 2), (3, 24, 2)], ids=["2-ranks", "3-ranks"])
def test_split_modules_match_jax(tmp_path, parts, c, heads):
    rng = np.random.default_rng(parts)
    b, t, s, cin, temb, cond = 2, 9, 7, c // 2, 16, 8
    x, t_emb = rand(rng, b, t, cin), rand(rng, b, temb)
    m, l, h = rand(rng, b, s, cond), rand(rng, b, s, cond), rand(rng, b, t, c)
    cot, cot_attn = rand(rng, b, t, c), rand(rng, b, t, c)
    key = jax.random.key(parts)
    jblk = junet.ResBlockUltimate(c, cond_dim=cond, use_attn=True, num_heads=heads, dropout=0.0)
    bparams = jax.jit(jblk.init)(key, x, t_emb, m, l)["params"]
    jattn = jatt.CrossAttentionFusion(c, cond, heads)
    aparams = jax.jit(jattn.init)(key, h, m, l)["params"]

    def blk_loss(p, *a):
        return jnp.sum(jblk.apply({"params": p}, *a, deterministic=True) * cot)

    def attn_loss(p, *a):
        return jnp.sum(jattn.apply({"params": p}, *a) * cot_attn)

    # jitted: the same fp32 math, compiled once instead of dispatched op by op
    blk_out = jax.jit(lambda p, *a: jblk.apply({"params": p}, *a, deterministic=True))(
        bparams, x, t_emb, m, l)
    blk_grads = jax.jit(jax.grad(blk_loss, argnums=(0, 1, 2, 3, 4)))(bparams, x, t_emb, m, l)
    attn_out = jattn.apply({"params": aparams}, h, m, l)
    attn_grads = jax.jit(jax.grad(attn_loss, argnums=(0, 1, 2, 3)))(aparams, h, m, l)
    folded = jatt.CrossAttentionFusion(c, cond, heads, folded=True).apply({"params": aparams},
                                                                          h, m, l)
    zero = lambda v: v.at[0].set(0.0)  # noqa: E731 - the CFG-unconditional row
    uncond = jattn.apply({"params": aparams}, h, zero(jnp.asarray(m)), zero(jnp.asarray(l)))

    payload = dict(x=x, t_emb=t_emb, m=m, l=l, h=h, cot=cot, cot_attn=cot_attn)
    payload.update({f"blk|{k}": v for k, v in _torch_tree(bparams).items()})
    payload.update({f"attn|{k}": v for k, v in _torch_tree(aparams).items()})
    payload["meta"] = dict(c=c, cin=cin, temb=temb, cond=cond, heads=heads, model_axis=parts)
    outs = spawn("tp_modules", parts, tmp_path, payload)

    mesh = Mesh(np.arange(parts).reshape(1, parts))
    lo = lambda r: r * c // parts  # noqa: E731
    film = np.asarray(jax.nn.silu(t_emb) @ bparams["film"]["to_scale_shift"]["kernel"]
                      + bparams["film"]["to_scale_shift"]["bias"])

    def whole_grads(route, want, split):
        dims = tp_shardings({f"unet/m.{k}": torch.tensor(v) for k, v in want.items()}, mesh)
        scale = float(np.sqrt(sum(np.sum(np.square(v)) for v in want.values())))
        for k, v in want.items():
            d = dims[f"unet/m.{k}"]
            if k in split:
                got = np.concatenate([o[f"{route}|grad|{k}"] for o in outs], axis=d)
                assert _close(got, v, scale), (route, k)
            else:
                for o in outs:
                    assert _close(o[f"{route}|grad|{k}"], v, scale), (route, k)

    bgrads = _torch_tree(blk_grads[0])
    for route in ("fused", "library"):
        split = set(outs[0][f"split_{route}"])
        assert split and all(set(o[f"split_{route}"]) == split for o in outs)
        assert ("cross_attn.attn_motion.q_proj.weight" in split) == (heads % parts == 0)
        for o in outs:
            assert _close(o[f"{route}|out"], blk_out), route
            for i, k in enumerate(("x", "t_emb", "m", "l")):
                assert _close(o[f"{route}|d_{k}"], blk_grads[i + 1]), (route, k)
        whole_grads(route, bgrads, split)
    for r, o in enumerate(outs):  # the FiLM exchange: the rank's channels of each half
        assert _close(o["film_scale"], film[:, lo(r):lo(r + 1)])
        assert _close(o["film_shift"], film[:, c + lo(r):c + lo(r + 1)])
        assert _close(o["attn|out"], attn_out)
        for i, k in enumerate(("h", "m", "l")):
            assert _close(o[f"attn|d_{k}"], attn_grads[i + 1]), k
        assert _close(o["folded|out"], folded)
        assert _close(o["folded|uncond"], uncond)
    attn_split = {k[len("cross_attn."):] for k in outs[0]["split_fused"]
                  if k.startswith("cross_attn.")}
    whole_grads("attn", _torch_tree(attn_grads[0]), attn_split)


@pytest.mark.parametrize("parts,c,heads", [(2, 32, 2), (3, 24, 2)], ids=["2-ranks", "3-ranks"])
def test_split_v1_block_matches_jax(tmp_path, parts, c, heads):
    """A ``ResBlockV1`` split over gloo ranks against the JAX package's
    ``ResBlockV1`` (XLA, fp32): its training form's output and the gradients
    of ``sum(out * cot)`` for the input, the time embedding, both
    conditions and every parameter (the split leaves' shards put together),
    and its folded serving form, with ``uncond_rows=1`` against the JAX
    block on conditions whose first row is zero. At 3 ranks GroupNorm 2's
    8 groups straddle the ranks and the 2-head site runs replicated."""
    from lm2a_tpu_torch.convert import torch_params_to_jax

    rng = np.random.default_rng(10 + parts)
    payload = v1_block_payload(rng, c, heads)
    x, t_emb, m, l, cot = (payload[k] for k in ("x", "t_emb", "m", "l", "cot"))
    params = {}
    for key, a in torch_params_to_jax({k[len("v1|"):]: torch.tensor(v) for k, v in
                                       payload.items() if k.startswith("v1|")}).items():
        *mods, leaf = key.split("/")
        node = params
        for mod in mods:
            node = node.setdefault(mod, {})
        node[leaf] = jnp.asarray(a)
    cond = m.shape[-1]
    jblk = junet.ResBlockV1(c, cond_dim=cond, num_heads=heads)
    fblk = junet.ResBlockV1(c, cond_dim=cond, num_heads=heads, folded_attention=True)

    def loss(p, *a):
        return jnp.sum(jblk.apply({"params": p}, *a) * cot)

    want = jax.jit(lambda p, *a: jblk.apply({"params": p}, *a))(params, x, t_emb, m, l)
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))(params, x, t_emb, m, l)
    zero = lambda v: jnp.asarray(v).at[0].set(0.0)  # noqa: E731 - the CFG-unconditional row
    folded = fblk.apply({"params": params}, x, t_emb, m, l)
    uncond = fblk.apply({"params": params}, x, t_emb, zero(m), zero(l))

    payload["meta"] = dict(arch="v1", c=c, temb=t_emb.shape[-1], cond=cond, heads=heads,
                           model_axis=parts)
    outs = spawn("tp_modules", parts, tmp_path, payload)
    split = set(outs[0]["split_v1"])
    assert all(set(o["split_v1"]) == split for o in outs)
    assert "conv2.weight" in split and "time_proj.weight" in split
    assert ("cross_attn.attn_motion.q_proj.weight" in split) == (heads % parts == 0)
    for o in outs:
        assert _close(o["v1|out"], want)
        for i, k in enumerate(("x", "t_emb", "m", "l")):
            assert _close(o[f"v1|d_{k}"], grads[i + 1]), k
        assert _close(o["v1|serve"], folded)
        assert _close(o["v1|uncond"], uncond)
    mesh = Mesh(np.arange(parts).reshape(1, parts))
    wgrads = _torch_tree(grads[0])
    dims = tp_shardings({f"unet/m.{k}": torch.tensor(v) for k, v in wgrads.items()}, mesh)
    scale = float(np.sqrt(sum(np.sum(np.square(v)) for v in wgrads.values())))
    for k, v in wgrads.items():
        if k in split:  # the shards put together along the dimension the rule shards
            got = np.concatenate([o[f"v1|grad|{k}"] for o in outs], axis=dims[f"unet/m.{k}"])
            assert _close(got, v, scale), k
        else:
            for o in outs:
                assert _close(o[f"v1|grad|{k}"], v, scale), k
