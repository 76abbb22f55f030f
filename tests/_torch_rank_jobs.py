"""The jobs one rank of a gloo group runs for the port's parallelism tests
(``_torch_ranks.spawn`` starts them): ``python _torch_rank_jobs.py <job>
<rank> <world> <init url> <dir>``. Each reads ``<dir>/in.npz`` and
``in.json`` and writes ``out_<rank>.npz`` and ``out_<rank>.json``. They
import the port alone, never JAX.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from lm2a_tpu_torch.core import distributed
from lm2a_tpu_torch.core.config import config_from_dict
from lm2a_tpu_torch.core.draws import RowShard
from lm2a_tpu_torch.diffusion.schedule import make_schedule
from lm2a_tpu_torch.parallel.audit import audit
from lm2a_tpu_torch.training.checkpoint import load_state_arrays, state_arrays
from lm2a_tpu_torch.training.train_step import (
    Draws, init_train_state, make_eval_step, make_train_step, step_generator,
)

STATE = "state|"


def _state(meta, arrays):
    cfg = config_from_dict(meta["cfg"])
    state = init_train_state(cfg, meta.get("init_seed", 0), "cpu")
    given = {k[len(STATE):]: v for k, v in arrays.items() if k.startswith(STATE)}
    if given:
        load_state_arrays(state, given)
    return cfg, state


def dp_step(meta, arrays, mesh):
    """``meta["steps"]`` data-parallel train steps over global batches
    ``mel_i``/``motion_i``/``lyrics_i``, this rank's rows; randomness
    injected (``t_i``, ``noise_i``, ``keep_i`` at the global shape, this
    rank's rows taken) or drawn from the step generator at the global
    shape. Then one eval step. The first step is audited; the state after
    each step is written under ``state|<step>|``."""
    cfg, state = _state(meta, arrays)
    stats = dict(dataset_mean=meta["mean"], dataset_std=meta["std"])
    schedule = make_schedule(cfg.diffusion)
    step = make_train_step(schedule, cfg, mesh=mesh, **stats)
    b = meta["batch"]
    sl = distributed.local_batch_slice(mesh, b)
    out, census = {}, None
    for i in range(meta["steps"]):
        batch = {k: torch.tensor(arrays[f"{k}_{i}"][sl]) for k in ("mel", "motion", "lyrics")}
        kw = {}
        if meta["mode"] == "draws":
            keep = arrays.get(f"keep_{i}")
            kw["draws"] = Draws(torch.tensor(arrays[f"t_{i}"][sl]),
                                torch.tensor(arrays[f"noise_{i}"][sl]),
                                None if keep is None else torch.tensor(keep[sl]))
        else:
            kw["generator"] = RowShard(step_generator(meta["seed"], i, "cpu"), sl, b)
        if i == 0:
            census = audit(step, state, batch, **kw)
            loss = census.pop("result")
        else:
            loss = step(state, batch, **kw)
        out[f"loss_{i}"] = np.float32(loss)
        out.update({f"{STATE}{i}|{k}": v for k, v in state_arrays(state).items()})
    batch = {k: torch.tensor(arrays[f"{k}_0"][sl]) for k in ("mel", "motion", "lyrics")}
    ev = make_eval_step(schedule, cfg, mesh=mesh, **stats)
    out["eval"] = np.float32(ev(state, batch, generator=RowShard(
        step_generator(meta["seed"], 99, "cpu"), sl, b)))
    return out, {"census": census, "rows": [sl.start, sl.stop]}


WEIGHTS = "w|"


def _denoiser(meta, arrays):
    """The prepared (fp32) port denoiser of ``meta["model"]`` with the
    weights under ``w|``."""
    from lm2a_tpu_torch.core.config import ModelConfig
    from lm2a_tpu_torch.models.factory import build_denoiser

    from lm2a_tpu_torch.models.factory import random_init_

    unet = build_denoiser(ModelConfig(**meta["model"]))
    weights = {k[len(WEIGHTS):]: torch.tensor(v) for k, v in arrays.items()
               if k.startswith(WEIGHTS)}
    if weights:
        unet.load_state_dict(weights)
    else:
        random_init_(unet, meta["init_seed"])
    return unet.eval().requires_grad_(False).prepare(getattr(torch, meta.get("dtype", "float32")))


def sp_sampler(meta, arrays, mesh):
    """One chain of the sequence-parallel sampler over the whole inputs,
    audited: every rank's gathered sample and the chain's census."""
    from lm2a_tpu_torch.diffusion.schedule import make_schedule
    from lm2a_tpu_torch.core.config import DiffusionConfig
    from lm2a_tpu_torch.parallel.sequence import make_sequence_sharded_sampler

    unet = _denoiser(meta, arrays)
    if meta.get("forward") is not None:  # one guided forward's eps, gathered
        from lm2a_tpu_torch.parallel.sequence import SeqShard, sequence_sharded_forward

        shard = SeqShard(mesh)
        x = torch.tensor(arrays["x_init"])
        n = x.shape[1]
        dt = unet.in_proj.weight.dtype
        m, l = (torch.tensor(arrays[k]).to(dt) for k in ("motion", "text"))
        x2, t2 = torch.cat([x, x]), torch.full((2,), meta["forward"])
        m2, l2 = torch.cat([torch.zeros_like(m), m]), torch.cat([torch.zeros_like(l), l])
        with torch.no_grad():
            eps = sequence_sharded_forward(unet, shard, shard.rows(x2), t2, m2, l2, n,
                                           uncond_rows=1)
        return {"x": shard.gather(eps, n).numpy()}, {}
    schedule = make_schedule(DiffusionConfig(timesteps=meta["timesteps"]))
    kw = {"num_steps": meta["steps"]} if meta["method"] == "ddim" else {}
    run = make_sequence_sharded_sampler(unet, schedule, mesh, meta["guidance"],
                                        meta["method"], uncond_fast=meta["uncond_fast"], **kw)
    ns = arrays.get("noise_seq")
    census = audit(run, None, tuple(arrays["x_init"].shape), torch.tensor(arrays["motion"]),
                   torch.tensor(arrays["text"]), x_init=torch.tensor(arrays["x_init"]),
                   noise_seq=None if ns is None else torch.tensor(ns))
    x = census.pop("result")
    return {"x": x.numpy()}, {"census": census}


def tp_step(meta, arrays, mesh):
    """``meta["steps"]`` tensor-parallel train steps (injected draws at the
    global shape, this rank's rows) from the given state, this rank's shards
    and the step's clip norm after each, the first step audited and the
    split leaves' shapes as its forward reads them; then one DDIM chain of
    the EMA's ``unet`` shards through ``make_tp_sampler``."""
    from lm2a_tpu_torch.core.mesh import MODEL_AXIS
    from lm2a_tpu_torch.diffusion.schedule import make_schedule
    from lm2a_tpu_torch.models.factory import build_denoiser
    from lm2a_tpu_torch.parallel import tensor as tp_mod
    from lm2a_tpu_torch.parallel.tensor import (
        make_tp_sampler, make_tp_train_step, shard_state_tp,
    )
    from lm2a_tpu_torch.training.train_step import make_optimizer

    cfg, state = _state(meta, arrays)
    full_bytes = sum(t.numel() * t.element_size() for t in state_arrays_tensors(state))
    step, shardings = make_tp_train_step(make_schedule(cfg.diffusion), cfg, make_optimizer(cfg),
                                         mesh, state, dataset_mean=meta["mean"],
                                         dataset_std=meta["std"])
    tps, _ = shard_state_tp(state, mesh)
    b = meta["batch"]
    sl = distributed.local_batch_slice(mesh, b)
    out, shapes, census = {}, {}, None
    split_forward = tp_mod.tensor_sharded_forward_train

    def spied(*a, **kw):
        shapes.update({k: list(p.shape) for k, p in tps.state.params().items()
                       if k in tps.split})
        return split_forward(*a, **kw)

    tp_mod.tensor_sharded_forward_train = spied
    for i in range(meta["steps"]):
        batch = {k: torch.tensor(arrays[f"{k}_{i}"][sl]) for k in ("mel", "motion", "lyrics")}
        keep = arrays.get(f"keep_{i}")
        draws = Draws(torch.tensor(arrays[f"t_{i}"][sl]), torch.tensor(arrays[f"noise_{i}"][sl]),
                      None if keep is None else torch.tensor(keep[sl]))
        if i == 0:
            census = audit(step, tps, batch, draws=draws)
            out[f"loss_{i}"] = np.float32(census.pop("result"))
        else:
            out[f"loss_{i}"] = np.float32(step(tps, batch, draws=draws))
        out[f"norm_{i}"] = np.float32(step.norm)
        for tree, d in (("params", tps.params), ("ema", tps.state.ema),
                        ("m", tps.state.opt.m), ("prev_grad", tps.state.opt.prev_grad)):
            out.update({f"{tree}|{i}|{k}": v.detach().numpy().copy() for k, v in d.items()})
    unet = build_denoiser(cfg.model)
    run = make_tp_sampler(unet, make_schedule(cfg.diffusion), mesh, dict(unet.named_parameters()),
                          guidance_weight=2.0, method="ddim", num_steps=3, dtype=torch.float32)
    ema = {k.split("/", 1)[1]: v for k, v in tps.state.ema.items() if k.startswith("unet/")}
    out["sample"] = run(ema, None, tuple(arrays["x_init"].shape), torch.tensor(arrays["cond"]),
                        torch.tensor(arrays["cond"]) * 0.5,
                        x_init=torch.tensor(arrays["x_init"])).numpy()
    return out, {"dims": {k: v for k, v in shardings["params"].items()},
                 "state_bytes": tps.state_bytes(), "full_bytes": full_bytes,
                 "index": mesh.axis_index(MODEL_AXIS), "split_shapes": shapes,
                 "split": sorted(tps.split), "census": census["collectives"]}


def tp_modules(meta, arrays, mesh):
    """The split modules of ``parallel/tensor.py`` on this rank, from the
    whole weights under ``blk|`` (a ``ResBlockUltimate`` with a skip and
    attention) and ``attn|`` (a ``CrossAttentionFusion``): the block's
    training form on the fused train chain (``chain_*_tp``) and on the
    library route, each with the gradients of ``sum(out * cot)``; the
    split FiLM's scale and shift; the attention site's training form with
    its gradients, and its folded serving form (with ``uncond_rows=1`` too).
    A split leaf's gradient is this rank's shard, the others whole."""
    from lm2a_tpu_torch.core.mesh import MODEL_AXIS
    from lm2a_tpu_torch.models.attention import CrossAttentionFusion
    from lm2a_tpu_torch.models.unet1d import ResBlockUltimate
    from lm2a_tpu_torch.parallel import tensor as T

    if meta.get("arch") == "v1":
        return _tp_v1_block(meta, arrays, mesh)
    parts, r = mesh.shape[MODEL_AXIS], mesh.axis_index(MODEL_AXIS)
    c, cin, temb, cond, heads = (meta[k] for k in ("c", "cin", "temb", "cond", "heads"))
    t = lambda k: torch.tensor(arrays[k]).requires_grad_(True)  # noqa: E731

    def split(module, prefix, names):
        return _split_module(module, arrays, prefix, names, mesh)

    out, info = {}, {}
    for route in ("fused", "library"):
        blk = ResBlockUltimate(cin, c, temb, cond, True, heads, dropout=0.0)
        ids = {id(blk)}
        names = set(T._BLOCK_SPLIT)
        if c % parts == 0 and heads % parts == 0:
            ids.add(id(blk.cross_attn))
            names |= {"cross_attn." + k for k in T._ATTN_SPLIT}
        info[f"split_{route}"] = sorted(split(blk, "blk|", names))
        tp = T.ModelShard(mesh, ids)
        x, t_emb, m, l = t("x"), t("t_emb"), t("m"), t("l")
        res = T._block_train(blk, tp, x, t_emb, tp.copy(t_emb), m, l, torch.float32, None,
                             route == "fused")
        (res * torch.tensor(arrays["cot"])).sum().backward()
        out[f"{route}|out"] = res.detach().numpy()
        for k, v in (("x", x), ("t_emb", t_emb), ("m", m), ("l", l)):
            out[f"{route}|d_{k}"] = v.grad.numpy()
        for k, p in blk.named_parameters():
            out[f"{route}|grad|{k}"] = p.grad.numpy()
        if route == "fused":
            with torch.no_grad():
                cols = (r * c // parts, (r + 1) * c // parts)
                sc, sh = T._film(blk.film, tp, t_emb, torch.float32, cols)
            out["film_scale"], out["film_shift"] = sc.numpy(), sh.numpy()
    attn = CrossAttentionFusion(c, cond, heads)
    names = {k for k in T._ATTN_SPLIT} if heads % parts == 0 else set()
    split(attn, "attn|", names)
    tp = T.ModelShard(mesh, {id(attn)} if names else set())
    h, m, l = t("h"), t("m"), t("l")
    res = T.attend(attn, tp, h, m, l, torch.float32)
    (res * torch.tensor(arrays["cot_attn"])).sum().backward()
    out["attn|out"] = res.detach().numpy()
    for k, v in (("h", h), ("m", m), ("l", l)):
        out[f"attn|d_{k}"] = v.grad.numpy()
    for k, p in attn.named_parameters():
        out[f"attn|grad|{k}"] = p.grad.numpy()
    with torch.no_grad():
        attn.fold(torch.float32)
        out["folded|out"] = T.attend(attn, tp, h, m, l).numpy()
        out["folded|uncond"] = T.attend(attn, tp, h, m, l, uncond_rows=1).numpy()
    return out, info


def v1_block_payload(rng, c, heads, b=2, t=9, s=7, temb=16, cond=8):
    """Inputs, a cotangent and the whole weights (under ``v1|``) of a
    ``ResBlockV1`` of ``c`` channels and ``heads`` heads from ``rng``: the
    port's block, seeded, its 1-D leaves moved off their init."""
    from lm2a_tpu_torch.models.factory import random_init_
    from lm2a_tpu_torch.models.unet1d import ResBlockV1

    def rand(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    blk = random_init_(ResBlockV1(c, temb, cond, heads), int(rng.integers(1 << 30)))
    with torch.no_grad():
        for p in blk.parameters():
            if p.ndim == 1:
                p.add_(torch.from_numpy(rand(*p.shape)) * 0.3)
    payload = dict(x=rand(b, t, c), t_emb=rand(b, temb), m=rand(b, s, cond), l=rand(b, s, cond),
                   cot=rand(b, t, c))
    payload.update({f"v1|{k}": v.detach().numpy() for k, v in blk.state_dict().items()})
    return payload


def _split_module(module, arrays, prefix, names, mesh, device="cpu"):
    """Load the whole weights under ``prefix`` into ``module`` (moved to
    ``device``), then make the leaves ``names`` this rank's shards; returns
    the names it split."""
    from lm2a_tpu_torch.core.mesh import MODEL_AXIS
    from lm2a_tpu_torch.parallel import tensor as T

    parts, r = mesh.shape[MODEL_AXIS], mesh.axis_index(MODEL_AXIS)
    module.load_state_dict({k[len(prefix):]: torch.tensor(v) for k, v in arrays.items()
                            if k.startswith(prefix)})
    module.to(device)
    dims = T.tp_shardings({f"unet/m.{k}": v for k, v in module.named_parameters()}, mesh)
    done = set()
    for k, p in module.named_parameters():
        if k in names:
            p.data = T._piece(p.data, dims[f"unet/m.{k}"], r, parts).contiguous()
            done.add(k)
    return done


def _tp_v1_block(meta, arrays, mesh):
    """A ``ResBlockV1`` split over the model axis (``parallel/tensor.py``
    ``_block_v1_train``, ``_block_v1``), from the whole weights under
    ``v1|``: its training form in fp32 with the gradients of ``sum(out *
    cot)`` (a split leaf's gradient this rank's shard, the others whole),
    then its serving form (folded attention, or the attention kernel's
    route with ``meta["fused"]``; weights in ``meta["dtype"]``), with
    ``uncond_rows=1`` too. On ``meta["device"]`` (TF32 off); the heads of
    every call of the attention kernel's wrapper are recorded
    (``heads``)."""
    import torch.nn as nn

    from lm2a_tpu_torch.core.mesh import MODEL_AXIS
    from lm2a_tpu_torch.models import attention as att_mod
    from lm2a_tpu_torch.models.unet1d import ResBlockV1
    from lm2a_tpu_torch.ops import _build
    from lm2a_tpu_torch.parallel import tensor as T

    parts = mesh.shape[MODEL_AXIS]
    c, temb, cond, heads = (meta[k] for k in ("c", "temb", "cond", "heads"))
    dev = distributed.rank_device()
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    dtype = getattr(torch, meta.get("dtype", "float32"))
    fused = meta.get("fused", False)
    seen_heads = []
    core = att_mod.attention_core

    def spied(q, k, v):
        seen_heads.append(q.shape[1])
        return core(q, k, v)

    att_mod.attention_core = spied

    def t(k):
        return torch.tensor(arrays[k]).to(dev).requires_grad_(True)

    blk = ResBlockV1(c, temb, cond, heads)
    names, ids = set(), set()
    if c % parts == 0:
        names, ids = set(T._V1_SPLIT), {id(blk)}
        if heads % parts == 0:
            names |= {"cross_attn." + k for k in T._ATTN_SPLIT}
            ids.add(id(blk.cross_attn))
    split = _split_module(blk, arrays, "v1|", names, mesh, dev)
    tp = T.ModelShard(mesh, ids)
    x, t_emb, m, l = t("x"), t("t_emb"), t("m"), t("l")
    _build.reset_launches()
    res = T._block_v1_train(blk, tp, x, t_emb, tp.copy(t_emb), m, l, torch.float32, None,
                            False)
    (res * torch.tensor(arrays["cot"]).to(dev)).sum().backward()
    out = {"v1|out": res.detach().cpu().numpy()}
    for k, v in (("x", x), ("t_emb", t_emb), ("m", m), ("l", l)):
        out[f"v1|d_{k}"] = v.grad.cpu().numpy()
    for k, p in blk.named_parameters():
        out[f"v1|grad|{k}"] = p.grad.cpu().numpy()
    train_launches = dict(_build.LAUNCHES)
    with torch.no_grad():  # the serving form
        blk.cross_attn.set_fused(fused)
        if not fused:
            blk.cross_attn.fold(dtype)
        for mod in blk.modules():
            if isinstance(mod, (nn.Linear, nn.Conv1d)):
                mod.to(dtype)
        x, t_emb, m, l = (v.detach().to(dtype) for v in (x, t_emb, m, l))
        _build.reset_launches()
        out["v1|serve"] = T._block_v1(blk, tp, x, t_emb, m, l, 0).float().cpu().numpy()
        out["v1|uncond"] = T._block_v1(blk, tp, x, t_emb, m, l, 1).float().cpu().numpy()
    att_mod.attention_core = core
    return out, {"split_v1": sorted(split), "heads": seen_heads, "train_launches": train_launches,
                 "serve_launches": dict(_build.LAUNCHES)}


def state_arrays_tensors(state):
    o = state.opt
    return [*state.params().values(), *state.ema.values(),
            *(t for d in (o.m, o.v, o.n, o.prev_grad) for t in d.values())]


def sp_step(meta, arrays, mesh):
    """``meta["steps"]`` sequence-parallel train steps over this rank's rows
    of global batches (whole in T), randomness injected or from the step
    generator; the state after each step and the first step's census."""
    from lm2a_tpu_torch.models import unet1d
    from lm2a_tpu_torch.ops import resblock_grad
    from lm2a_tpu_torch.parallel.sequence import make_sp_train_step

    routed = []
    if meta.get("gate_budget") is not None:  # record the geometry of every fused block
        resblock_grad.BWD_VMEM_BUDGET = meta["gate_budget"]
        fused = unet1d.fused_resblock_train

        def spy(x, *a, **kw):
            res = fused(x, *a, **kw)
            if res is not None:
                routed.append([kw["n"], x.shape[-1], a[2].shape[0], a[10] is not None])
            return res

        unet1d.fused_resblock_train = spy
    cfg, state = _state(meta, arrays)
    step = make_sp_train_step(make_schedule(cfg.diffusion), cfg, mesh=mesh,
                              dataset_mean=meta["mean"], dataset_std=meta["std"])
    b = meta["batch"]
    sl = distributed.local_batch_slice(mesh, b)
    out, census = {}, None
    for i in range(meta["steps"]):
        batch = {k: torch.tensor(arrays[f"{k}_{i}"][sl]) for k in ("mel", "motion", "lyrics")}
        if meta["mode"] == "draws":
            keep = arrays.get(f"keep_{i}")
            kw = {"draws": Draws(torch.tensor(arrays[f"t_{i}"]), torch.tensor(arrays[f"noise_{i}"]),
                                 None if keep is None else torch.tensor(keep))}
        else:
            kw = {"generator": step_generator(meta["seed"], i, "cpu")}
        rep = audit(step, state, batch, **kw)
        out[f"loss_{i}"] = np.float32(rep.pop("result"))
        census = census or rep
        out.update({f"{STATE}{i}|{k}": v for k, v in state_arrays(state).items()})
    return out, {"census": census, "routed": routed}


def audit_census(meta, arrays, mesh):
    """On a (data, model) mesh: the census of one data-parallel train step
    and of one sequence-parallel DDIM chain."""
    from lm2a_tpu_torch.core.config import DiffusionConfig
    from lm2a_tpu_torch.parallel.sequence import make_sequence_sharded_sampler

    cfg, state = _state(meta, arrays)
    step = make_train_step(make_schedule(cfg.diffusion), cfg, mesh=mesh)
    b = meta["batch"]
    sl = distributed.local_batch_slice(mesh, b)
    batch = {k: torch.tensor(arrays[k][sl]) for k in ("mel", "motion", "lyrics")}
    dp = audit(step, state, batch, generator=RowShard(step_generator(0, 0, "cpu"), sl, b))
    dp.pop("result")
    unet = state.unet.eval().requires_grad_(False).prepare(torch.float32)
    run = make_sequence_sharded_sampler(unet, make_schedule(DiffusionConfig(timesteps=20)), mesh,
                                        2.0, "ddim", num_steps=2)
    x0 = torch.tensor(arrays["x_init"])
    cond = torch.tensor(arrays["cond"])
    sp = audit(run, None, tuple(x0.shape), cond, cond, x_init=x0)
    sp.pop("result")
    n_params = sum(p.numel() for p in state.params().values())
    return {}, {"dp": dp, "sp": sp, "n_params": n_params}


JOBS = {"dp_step": dp_step, "sp_sampler": sp_sampler, "sp_step": sp_step, "tp_step": tp_step,
        "audit_census": audit_census, "tp_modules": tp_modules}


def main():
    job, rank, world, url, d = sys.argv[1:6]
    torch.set_num_threads(1)
    with open(os.path.join(d, "in.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(d, "in.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    assert distributed.init_distributed(url, int(world), int(rank),
                                        device=meta.get("device", "cpu"))
    mesh = distributed.make_hybrid_mesh(model=meta.get("model_axis", 1))
    out, info = JOBS[job](meta, arrays, mesh)
    np.savez(os.path.join(d, f"out_{rank}.npz"), **out)
    with open(os.path.join(d, f"out_{rank}.json"), "w") as f:
        json.dump(info, f)
    import torch.distributed as dist

    dist.destroy_process_group()


if __name__ == "__main__":
    main()
