"""Generation: conditioned mel sampling from npz clips (port of
``lm2a_tpu/inference/sample.py``).

Load npz conditions -> rebuild the models from the checkpointed config ->
prefer EMA weights -> dataset stats from the checkpoint, else the documented
fallback constants -> interp-resample conditions to the mel length -> DDPM or
DDIM chain with optional CFG -> de-normalise -> ``<base>_gen.npz`` (mel +
conditions + projected conditions), same schema as the JAX package.

Reads this framework's checkpoint directories and reference ``torch.save``
files (``utils/torch_convert.py``). The denoiser takes the attention route
the checkpoint's config names (``fused_attention``). Noise comes from a
``torch.Generator`` seeded per call, with the JAX package's per-chunk seed
offsets, so runs are reproducible per device but do not reproduce JAX's
random streams.

``LoadedModels`` caches one sampler chain per geometry (``mel_t``, steps,
guided?, method, batch, DDIM steps) in an LRU of ``sampler_cache_max``
entries, as the JAX package caches its jitted chains: on the card an entry
holds the chain's static buffers and the CUDA graph of its step, captured
at the entry's first chain and replayed by every later one; every CFG
weight above 1 shares one entry. The entries' captures share one memory
pool: all replay on one stream, one at a time, and each keeps its static
buffers referenced, so one graph's dead intermediates are all another may
reuse. The ``--debug`` telemetry chain runs eagerly, outside the cache.
"""

from __future__ import annotations

import os
import sys
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from lm2a_tpu_torch.checkpoint import load_metadata, read_params
from lm2a_tpu_torch.convert import jax_params_to_torch
from lm2a_tpu_torch.core.config import DiffusionConfig, LM2AConfig, config_from_dict
from lm2a_tpu_torch.core.device import DeviceLike, dtype_from_str, resolve_device
from lm2a_tpu_torch.core.graphs import new_pool
from lm2a_tpu_torch.data.schema import load_sample, normalize_mel_layout
from lm2a_tpu_torch.diffusion.gaussian import SamplerChain, ddim_sample, ddpm_sample
from lm2a_tpu_torch.diffusion.schedule import make_schedule
from lm2a_tpu_torch.models.factory import build_cond_projection, build_denoiser
from lm2a_tpu_torch.ops.resample import match_len
from lm2a_tpu_torch.utils.torch_convert import load_torch_checkpoint

# Documented fallback stats (reference sample.py:47-48), used only when the
# checkpoint carries none.
FALLBACK_MEL_MEAN = -4.63706636428833
FALLBACK_MEL_STD = 1.8648223876953125


@dataclass
class LoadedModels:
    cfg: LM2AConfig
    denoiser: torch.nn.Module
    cond_proj: torch.nn.Module
    dataset_mean: float
    dataset_std: float
    timesteps: int
    device: torch.device
    # checkpoint-carried CFG weight (the reference lets it override the CLI)
    guidance_weight: Optional[float] = None
    # distilled students serve only at method='ddim', ddim_steps=
    # distilled_steps, guidance 1.0 (their teacher's CFG is folded in)
    distilled_steps: Optional[int] = None
    folded_guidance: Optional[float] = None
    # post-hoc z-space std rescale of each generated clip; None = off
    std_calibration: Optional[float] = None
    # the sampler chain cache (see the module docstring); cli serve sets 16.
    # Not init fields, so a dataclasses.replace copy starts with a fresh cache
    sampler_cache_max: int = 64
    _samplers: "OrderedDict" = field(default_factory=OrderedDict, init=False, repr=False)
    _pool: object = field(default=None, init=False, repr=False)

    def _sampler_get(self, key) -> Optional[SamplerChain]:
        chain = self._samplers.get(key)
        if chain is not None:  # refresh its LRU position
            self._samplers.move_to_end(key)
        return chain

    def _sampler_put(self, key, chain: SamplerChain) -> None:
        while len(self._samplers) >= max(1, self.sampler_cache_max):
            self._samplers.popitem(last=False)
        self._samplers[key] = chain

    def sampler_pool(self):
        """The CUDA graph memory pool this model's cached chains share."""
        if self._pool is None:
            self._pool = new_pool(self.device)
        return self._pool


def load_models(ckpt_path: str, cfg: Optional[LM2AConfig] = None, prefer_ema: bool = True,
                compute_dtype: str = "bfloat16", device: DeviceLike = None) -> LoadedModels:
    """Load a checkpoint directory written by either package, or a
    reference ``torch.save`` file (then ``cfg`` defaults to ``LM2AConfig()``,
    the reference's production geometry, as in the JAX package).

    The denoiser is readied for serving (``UNet1DUltimate.prepare``): on the
    card every residual block runs the CUDA chain kernels, which take bf16
    (the default compute dtype, as on the TPU)."""
    dev = resolve_device(device)
    mean, std = FALLBACK_MEL_MEAN, FALLBACK_MEL_STD
    timesteps = guidance_weight = distilled_steps = folded_guidance = None
    std_calibration = None
    if os.path.isdir(ckpt_path):
        meta = load_metadata(ckpt_path)
        cfg = config_from_dict(meta["config"]) if cfg is None else cfg
        unet_flat, proj_flat = read_params(ckpt_path, prefer_ema)
        unet_sd, proj_sd = jax_params_to_torch(unet_flat), jax_params_to_torch(proj_flat)
        mean = float(meta.get("dataset_mean", mean))
        std = float(meta.get("dataset_std", std))
        if meta.get("distilled_steps"):
            distilled_steps = int(meta["distilled_steps"])
            folded_guidance = float(meta.get("folded_guidance") or 0.0) or None
            guidance_weight = 1.0  # the fold is baked into the student's eps
        if meta.get("std_calibration"):
            std_calibration = float(meta["std_calibration"])
    else:  # reference torch .pt file
        cfg = LM2AConfig() if cfg is None else cfg
        unet_sd, proj_sd, meta = load_torch_checkpoint(ckpt_path, prefer_ema)
        if meta.get("dataset_mean") is not None:
            mean, std = float(meta["dataset_mean"]), float(meta["dataset_std"])
        if meta.get("timesteps") is not None:
            timesteps = int(meta["timesteps"])
        if meta.get("guidance_weight") is not None:
            guidance_weight = float(meta["guidance_weight"])
    dt = dtype_from_str(compute_dtype)

    denoiser = build_denoiser(cfg.model)
    _load_strict(denoiser, unet_sd, ckpt_path)
    denoiser.to(dev).eval().requires_grad_(False).prepare(dt)
    cond_proj = build_cond_projection(cfg.model)
    _load_strict(cond_proj, proj_sd, ckpt_path)
    cond_proj.to(dev, dt).eval().requires_grad_(False)
    return LoadedModels(
        cfg=cfg, denoiser=denoiser, cond_proj=cond_proj,
        dataset_mean=mean, dataset_std=std,
        timesteps=timesteps or cfg.diffusion.timesteps, device=dev,
        guidance_weight=guidance_weight, distilled_steps=distilled_steps,
        folded_guidance=folded_guidance, std_calibration=std_calibration,
    )


def _load_strict(module: torch.nn.Module, sd: dict, path: str) -> None:
    """Every parameter of ``module`` must come from the checkpoint; keys the
    module does not have are ignored, as the JAX converters ignore them."""
    missing, _ = module.load_state_dict(sd, strict=False)
    if missing:
        raise KeyError(f"{path}: no weights for {missing[:8]}"
                       f"{' ...' if len(missing) > 8 else ''}")


def _resolve_run_params(models: LoadedModels, steps, guidance_weight):
    """An explicit value wins; else the checkpoint's timesteps /
    guidance_weight; else 1.0 for guidance."""
    steps = int(steps) if steps else models.timesteps
    if guidance_weight is None:
        guidance_weight = (models.guidance_weight
                           if models.guidance_weight is not None else 1.0)
    return steps, float(guidance_weight)


def _apply_std_calibration(out_z: np.ndarray, models: LoadedModels) -> np.ndarray:
    """Rescale each clip about its own mean in z-space by the checkpoint's
    ``std_calibration`` (no-op when unset)."""
    r = models.std_calibration
    if not r or r == 1.0:
        return out_z
    mu = out_z.mean(axis=tuple(range(1, out_z.ndim)), keepdims=True)
    return mu + (out_z - mu) * np.float32(r)


def resolve_eval_guidance(models: LoadedModels, guidance: Optional[float] = None) -> float:
    """Distilled-aware CFG weight for the val protocol: an explicit value
    wins; a distilled student runs at its checkpoint weight (1.0); else 2.1."""
    if guidance is not None:
        return float(guidance)
    if models.guidance_weight is not None:
        return float(models.guidance_weight)
    return 2.1


def resolve_method(models: LoadedModels, method: Optional[str] = None,
                   ddim_steps: Optional[int] = None):
    """An explicit value wins; a distilled checkpoint defaults to its own
    DDIM grid."""
    if method is None:
        method = "ddim" if models.distilled_steps else "ddpm"
    if ddim_steps is None and method == "ddim":
        ddim_steps = models.distilled_steps
    return method, ddim_steps


def _ddim_num_steps(steps: int, ddim_steps: Optional[int]) -> int:
    if ddim_steps is not None:
        return int(ddim_steps)
    if steps > 50:
        print(f"[sample] ddim: running 50 sampler steps over the {steps}-step "
              "schedule (pass --ddim_steps to change)", file=sys.stderr)
        return 50
    return steps


def _run_chain(models: LoadedModels, motion_f, text_f, mel_t: int, steps: int,
               guidance_weight: float, method: str, ddim_steps, seed: int,
               debug: bool = False):
    cfg = models.cfg
    dev = models.device
    if method not in ("ddpm", "ddim"):
        raise ValueError(f"unknown method {method!r}; use 'ddpm' or 'ddim'")
    guided = guidance_weight > 1.0
    shape = (motion_f.shape[0], mel_t, cfg.model.in_dim)
    num_ddim = None if method == "ddpm" else _ddim_num_steps(steps, ddim_steps)
    kw = dict(guidance_weight=guidance_weight if guided else 1.0,
              uncond_fast=guided)  # constant-fold the CFG uncond rows' attention

    def schedule():
        return make_schedule(DiffusionConfig(
            timesteps=steps, beta_start=cfg.diffusion.beta_start,
            beta_end=cfg.diffusion.beta_end), device=dev)

    if debug and method == "ddpm":  # the telemetry chain runs eagerly, uncached
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        return ddpm_sample(models.denoiser, schedule(), shape, motion_f, text_f,
                           generator=gen, collect_stats=True, **kw)
    key = (mel_t, steps, guided, method, shape[0], num_ddim)
    chain = models._sampler_get(key)
    if chain is None:
        chain = SamplerChain(schedule(), shape, method, num_steps=num_ddim,
                             generator=torch.Generator(device=dev),
                             pool=models.sampler_pool())
        models._sampler_put(key, chain)
    chain.generator.manual_seed(int(seed))
    if method == "ddpm":
        return ddpm_sample(models.denoiser, chain.schedule, shape, motion_f, text_f,
                           generator=chain.generator, chain=chain, **kw)
    return ddim_sample(models.denoiser, chain.schedule, shape, motion_f, text_f,
                       num_steps=num_ddim, generator=chain.generator, chain=chain, **kw)


def _finish(models: LoadedModels, out: torch.Tensor) -> np.ndarray:
    out = _apply_std_calibration(out.float().cpu().numpy(), models)
    out = out * models.dataset_std + models.dataset_mean
    return out.transpose(0, 2, 1)  # (B, 80, T) npz layout


@torch.no_grad()
def generate_mel(models: LoadedModels, motion: np.ndarray, lyrics: np.ndarray, mel_t: int,
                 steps: Optional[int] = None, guidance_weight: Optional[float] = None,
                 method: Optional[str] = None, seed: int = 0, batch: int = 1,
                 debug: bool = False, ddim_steps: Optional[int] = None):
    """Run the sampler; returns (mel (B, 80, mel_T) de-normalised, motion_f,
    text_f, motion_rs, lyrics_rs). ``method`` None resolves via
    ``resolve_method``; ``debug`` (DDPM) prints per-decile telemetry."""
    steps, guidance_weight = _resolve_run_params(models, steps, guidance_weight)
    method, ddim_steps = resolve_method(models, method, ddim_steps)
    debug = debug and method == "ddpm"
    motion_rs = match_len(np.asarray(motion, np.float32), mel_t, mode="interp")
    lyrics_rs = match_len(np.asarray(lyrics, np.float32), mel_t, mode="interp")
    dev = models.device
    motion_b = torch.as_tensor(motion_rs, device=dev).expand(batch, *motion_rs.shape)
    lyrics_b = torch.as_tensor(lyrics_rs, device=dev).expand(batch, *lyrics_rs.shape)
    motion_f, text_f = models.cond_proj(motion_b, lyrics_b)
    out = _run_chain(models, motion_f, text_f, mel_t, steps, guidance_weight, method,
                     ddim_steps, seed, debug)
    if debug:
        out, stats = out
        _print_sampling_telemetry(stats.cpu().numpy(), steps, models.cfg)
    return (_finish(models, out), motion_f.float().cpu().numpy(),
            text_f.float().cpu().numpy(), motion_rs, lyrics_rs)


def _print_sampling_telemetry(stats: np.ndarray, steps: int, cfg) -> None:
    """Per-decile coefficient + tensor-stat rows (reference sample.py debug)."""
    betas = np.linspace(cfg.diffusion.beta_start, cfg.diffusion.beta_end, steps)
    alphas = 1.0 - betas
    abars = np.cumprod(alphas)
    interval = max(1, steps // 10)
    for i in range(0, steps, interval):
        t = steps - 1 - i
        c1 = 1.0 / np.sqrt(alphas[t])
        c2 = betas[t] / np.sqrt(1.0 - abars[t])
        print(f"[coeff] t={t:4d} beta={betas[t]:.6e} alpha={alphas[t]:.6e} "
              f"alpha_bar={abars[t]:.6e} coef1={c1:.6e} coef2={c2:.6e}")
        xm, xM, xu, xs, em, eM, eu, es = stats[i]
        print(f"[sampling] step t={t:4d}  x min={xm:.6f} max={xM:.6f} "
              f"mean={xu:.6f} std={xs:.6f} | eps min={em:.6f} max={eM:.6f} "
              f"mean={eu:.6f} std={es:.6f}")


@torch.no_grad()
def generate_mel_batch(models: LoadedModels, motions, lyrics_list, mel_t: int,
                       steps: Optional[int] = None, guidance_weight: Optional[float] = None,
                       method: Optional[str] = None, seed: int = 0,
                       ddim_steps: Optional[int] = None):
    """Multi-clip batched generation, different conditions per row, one chain.
    Returns (mel (B, 80, mel_t), motion_rs list, lyrics_rs list)."""
    steps, guidance_weight = _resolve_run_params(models, steps, guidance_weight)
    method, ddim_steps = resolve_method(models, method, ddim_steps)
    motion_rs = [match_len(np.asarray(m, np.float32), mel_t, "interp") for m in motions]
    lyrics_rs = [match_len(np.asarray(l, np.float32), mel_t, "interp") for l in lyrics_list]
    dev = models.device
    motion_f, text_f = models.cond_proj(torch.as_tensor(np.stack(motion_rs), device=dev),
                                        torch.as_tensor(np.stack(lyrics_rs), device=dev))
    out = _run_chain(models, motion_f, text_f, mel_t, steps, guidance_weight, method,
                     ddim_steps, seed)
    return _finish(models, out), motion_rs, lyrics_rs


def compute_batch_from_npz(models: LoadedModels, npz_paths, steps: Optional[int] = None,
                           guidance_weight: Optional[float] = None,
                           method: Optional[str] = None, seed: int = 0,
                           batch_size: int = 8, ddim_steps: Optional[int] = None):
    """Batched generation over npz files grouped by mel length; one result
    dict per input path, arrays on the host."""
    by_len: dict = {}
    for p in npz_paths:
        s = load_sample(p)
        by_len.setdefault(normalize_mel_layout(s.mel).shape[1], []).append((p, s))
    results = []
    chunk_no = 0  # a distinct noise stream per chunk across length groups
    for mel_t, group in by_len.items():
        for i in range(0, len(group), batch_size):
            chunk = group[i: i + batch_size]
            gen, motion_rs, lyrics_rs = generate_mel_batch(
                models, [s.motion for _, s in chunk], [s.lyrics for _, s in chunk], mel_t,
                steps=steps, guidance_weight=guidance_weight, method=method,
                seed=seed + chunk_no, ddim_steps=ddim_steps)
            chunk_no += 1
            for j, (p, s) in enumerate(chunk):
                results.append({
                    "base": os.path.splitext(os.path.basename(p))[0],
                    "gen_mel": gen[j].astype(np.float32),
                    "motion": motion_rs[j], "lyrics": lyrics_rs[j],
                    "sr": s.sr, "hop_length": s.hop_length,
                })
    return results


def compute_single_from_npz(models: LoadedModels, npz_path: str, steps: Optional[int] = None,
                            guidance_weight: Optional[float] = None,
                            method: Optional[str] = None, seed: int = 0,
                            debug: bool = False, ddim_steps: Optional[int] = None) -> dict:
    """Single-clip generation (see compute_batch_from_npz)."""
    s = load_sample(npz_path)
    real_mel = normalize_mel_layout(s.mel)
    gen, motion_f, text_f, motion_rs, lyrics_rs = generate_mel(
        models, s.motion, s.lyrics, real_mel.shape[1], steps=steps,
        guidance_weight=guidance_weight, method=method, seed=seed, debug=debug,
        ddim_steps=ddim_steps)
    gen_mel = gen[0]
    if not np.isfinite(gen_mel).all():
        raise FloatingPointError("sampling produced non-finite values")
    return {
        "base": os.path.splitext(os.path.basename(npz_path))[0],
        "gen_mel": gen_mel.astype(np.float32), "real_mel": real_mel,
        "motion": motion_rs, "lyrics": lyrics_rs,
        "motion_proj": motion_f, "lyrics_proj": text_f,
        "sr": s.sr, "hop_length": s.hop_length,
    }


def write_clip_outputs(result: dict, out_dir: str, save_png: bool = False,
                       compress: bool = True) -> str:
    """Write one clip's ``<base>_gen.npz`` (+ optional PNGs, + a
    ``<base>_gen.wav`` when the result carries ``wav``)."""
    os.makedirs(out_dir, exist_ok=True)
    base = result["base"]
    out_npz = os.path.join(out_dir, base + "_gen.npz")
    extra = {}
    if "motion_proj" in result:
        extra = {"motion_proj": result["motion_proj"], "lyrics_proj": result["lyrics_proj"]}
    (np.savez_compressed if compress else np.savez)(
        out_npz, mel=result["gen_mel"], motion=result["motion"], lyrics=result["lyrics"],
        sr=result["sr"], hop_length=result["hop_length"], **extra)
    if "wav" in result:
        from lm2a_tpu_torch.utils.audio import write_wav

        write_wav(os.path.join(out_dir, base + "_gen.wav"), result["wav"],
                  result.get("wav_sr", result["sr"]))
    if save_png:
        _save_mel_png(result["gen_mel"], os.path.join(out_dir, base + "_gen.png"),
                      "Generated mel")
        if "real_mel" in result:
            _save_mel_png(result["real_mel"], os.path.join(out_dir, base + "_real.png"),
                          "Real mel")
    return out_npz


def sample_batch_from_npz(npz_paths, ckpt_path: str, out_dir: str,
                          steps: Optional[int] = None, guidance_weight: Optional[float] = None,
                          method: Optional[str] = None, seed: int = 0,
                          cfg: Optional[LM2AConfig] = None,
                          models: Optional[LoadedModels] = None, batch_size: int = 8,
                          ddim_steps: Optional[int] = None, device: DeviceLike = None):
    """Batched generation over a list of npz files; a ``<base>_gen.npz`` each."""
    if models is None:
        models = load_models(ckpt_path, cfg=cfg, device=device)
    results = compute_batch_from_npz(models, npz_paths, steps=steps,
                                     guidance_weight=guidance_weight, method=method,
                                     seed=seed, batch_size=batch_size, ddim_steps=ddim_steps)
    return [write_clip_outputs(r, out_dir) for r in results]


def sample_from_npz(npz_path: str, ckpt_path: str, out_dir: str,
                    steps: Optional[int] = None, guidance_weight: Optional[float] = None,
                    method: Optional[str] = None, seed: int = 0,
                    cfg: Optional[LM2AConfig] = None, save_png: bool = True,
                    models: Optional[LoadedModels] = None, debug: bool = False,
                    ddim_steps: Optional[int] = None, device: DeviceLike = None) -> str:
    """End-to-end: npz conditions + checkpoint -> ``<base>_gen.npz`` (+PNGs)."""
    if models is None:
        models = load_models(ckpt_path, cfg=cfg, device=device)
    result = compute_single_from_npz(models, npz_path, steps=steps,
                                     guidance_weight=guidance_weight, method=method,
                                     seed=seed, debug=debug, ddim_steps=ddim_steps)
    return write_clip_outputs(result, out_dir, save_png=save_png)


def _save_mel_png(mel: np.ndarray, path: str, title: str) -> None:
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return
    plt.figure(figsize=(8, 4))
    plt.imshow(mel, aspect="auto", origin="lower")
    plt.colorbar()
    plt.title(title)
    plt.savefig(path)
    plt.close()
