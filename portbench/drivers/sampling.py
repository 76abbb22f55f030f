"""Sampling traffic, one client in a closed loop: a request is sent when the
previous one has come back.

The traffic file names the entry (``entry``): ``generate_mel`` of one clip,
as ``cli serve`` answers a ``wav`` request, or ``generate_mel_batch`` of
``batch`` clips, as ``cli serve`` list requests and ``cli sample`` of many
clips run it; the sampler (``method``, ``ddim`` or ``ddpm``, and its
``steps``: DDIM's sub-steps, or DDPM's schedule of that many timesteps) and
its CFG weight (``guidance``); and whether the request's first clip is
vocoded (``vocode``: ``Vocoder.mel_to_wav``). A request's latency runs from
its start to its mel, or its waveform, on the host.

The models are built as ``load_models`` builds them from a checkpoint, with
the benchmark's weights in place of a file. Requests draw their clips from
a pool made from the seed, and their noise seeds from the seed. Warm-up
requests (set-up) capture the chain's graph and run the vocoder once.

What is checked: requests of the window drawn from the seed before it
opens (``check_requests`` of the first ``check_within``). A bf16 chain and a
float32 one from the same noise end far apart (DDIM's first x0 divides the
forward's differences by sqrt(alpha_bar) = 0.0064, and the chain compounds
them), so the chain is held step by step from the program's own states: for
a checked request the benchmark reads the chain's state buffer before each
of its steps, and the served mel, normalised again, is the state after the
last. The reference makes each step in float32 from the program's state
before it (its own conditions from the raw features, its own CFG, DDIM
coefficients and clamp), and the worst step's relative L2 gap is compared;
the start (the noise drawn from the request's seed) is held exactly. A DDPM
step's noise is the reference's own draw from the request's generator, in
the program's order (the start, then one draw a step). The served waveform
is held against the reference's BigVGAN of the served mel.
"""

from __future__ import annotations

import gc
import sys
from typing import Dict, List

import numpy as np
import torch

from portbench.reference import bigvgan as ref_voc
from portbench.reference import diffusion as ref_diff
from portbench.reference import unet as ref
from portbench.reference.precision import EXACT, Precision, exact_math
from portbench.reference.resample import interp_frames
from portbench.weights import sync, make_clips, make_weights

MEL_MEAN, MEL_STD = -4.63706636428833, 1.8648223876953125  # the reference's fallback statistics


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


class Driver:
    def __init__(self, cell, seeds, device, spans):
        self.cell, self.seeds, self.dev, self.spans = cell, seeds, torch.device(device), spans
        t = cell.traffic
        self.batch, self.t = int(t["batch"]), int(t["mel_t"])
        self.vocode = bool(t.get("vocode"))
        self.rng = seeds.rng("order")
        self.noise_rng = seeds.rng("noise")
        self.latency: List[float] = []
        self.checked: List[dict] = []
        within = int(t["check_within"])
        self.check_at = set(seeds.rng("check").choice(
            within, size=min(int(t["check_requests"]), within), replace=False).tolist())

    # ------------------------------------------------------------ set-up
    def _weights(self, spec, stream):
        return make_weights(spec, self.seeds[stream], self.dev)

    def setup(self) -> None:
        from lm2a_tpu_torch.core.config import config_from_dict
        from lm2a_tpu_torch.inference.sample import LoadedModels
        from lm2a_tpu_torch.models.factory import build_cond_projection, build_denoiser

        cfg = config_from_dict(self.cell.config)
        m = self.cell.model
        dt = torch.bfloat16
        with torch.device("meta"):
            denoiser, cond_proj = build_denoiser(cfg.model), build_cond_projection(cfg.model)
        denoiser = denoiser.to_empty(device=self.dev)
        denoiser.load_state_dict(self._weights(ref.spec(m), "unet"))
        denoiser.eval().requires_grad_(False).prepare(dt)
        cond_proj = cond_proj.to_empty(device=self.dev)
        cond_proj.load_state_dict(self._weights(ref.cond_spec(m), "cond"))
        cond_proj.to(self.dev, dt).eval().requires_grad_(False)
        self.models = LoadedModels(cfg=cfg, denoiser=denoiser, cond_proj=cond_proj,
                                   dataset_mean=MEL_MEAN, dataset_std=MEL_STD,
                                   timesteps=cfg.diffusion.timesteps, device=self.dev)
        if self.vocode:
            self.vocoder = self._vocoder()
        tr = self.cell.traffic
        self.clips = make_clips(int(tr["clips"]), int(tr["motion_frames"]), m,
                                self.seeds.rng("data"))
        for _ in range(int(tr["warmup_requests"])):
            self._request(self._draw())
        self.chain = next(iter(self.models._samplers.values()))  # the one chain geometry
        sync(self.dev)

    def _vocoder(self):
        from lm2a_tpu_torch.vocoder.bigvgan import VocoderConfig
        from lm2a_tpu_torch.vocoder.vocode import Vocoder

        v = self.cell.config["vocoder"]
        vcfg = VocoderConfig(**{k: tuple(tuple(d) for d in x) if k == "resblock_dilation_sizes"
                                else tuple(x) if isinstance(x, list) else x
                                for k, x in v.items()})
        voc = Vocoder(cfg=vcfg, device=self.dev)
        # the benchmark's weights over the program's random init, cast as it casts
        voc.model.load_state_dict(self._weights(ref_voc.spec(v), "vocoder"))
        return voc

    def _draw(self) -> dict:
        picks = self.rng.choice(len(self.clips), size=self.batch, replace=False).tolist()
        return {"clips": picks, "seed": int(self.noise_rng.integers(0, 2 ** 62))}

    def _recorded(self, req: dict):
        """``_request`` with the chain's state read before each of its steps:
        the step the chain replays is wrapped for this request alone."""
        chain = self.chain
        (key, step), = chain.steps.items()
        states = []

        def recorded():
            states.append(chain.x.clone())
            step()

        chain.steps[key] = recorded
        try:
            out = self._request(req)
        finally:
            chain.steps[key] = step
        out["states"] = states
        return out

    def _request(self, req: dict) -> dict:
        from lm2a_tpu_torch.inference.sample import generate_mel, generate_mel_batch

        tr = self.cell.traffic
        ddim = tr["method"] == "ddim"
        kw = dict(steps=int(self.cell.config["diffusion"]["timesteps"]) if ddim
                  else int(tr["steps"]), guidance_weight=float(tr["guidance"]),
                  method=tr["method"], ddim_steps=int(tr["steps"]) if ddim else None,
                  seed=req["seed"])
        out = {"req": req}
        with self.spans("sampler"):
            if tr["entry"] == "generate_mel":
                motion, lyrics = self.clips[req["clips"][0]]
                out["mel"] = generate_mel(self.models, motion, lyrics, self.t, **kw)[0]
            else:  # generate_mel_batch
                out["mel"] = generate_mel_batch(self.models,
                                                [self.clips[c][0] for c in req["clips"]],
                                                [self.clips[c][1] for c in req["clips"]],
                                                self.t, **kw)[0]
        if self.vocode:
            with self.spans("vocode"):
                out["wav"] = self.vocoder.mel_to_wav(out["mel"][0])[0]
        return out

    # ------------------------------------------------------------ the window
    def unit(self, i: int) -> None:
        import time

        req = self._draw()
        t0 = time.perf_counter()
        out = self._recorded(req) if i in self.check_at else self._request(req)
        self.latency.append(time.perf_counter() - t0)
        if i in self.check_at:
            self.checked.append(out)

    def drain(self) -> None:
        sync(self.dev)

    def end_to_end(self, window_s: float, units: int) -> Dict[str, float]:
        """The 95th percentile of every request's latency, and the mel frames
        of every completed clip over the window's seconds."""
        ms = np.asarray(self.latency) * 1e3
        q = np.percentile(ms, [50, 90, 95, 99])
        print(f"[latency] {len(ms)} requests: median {q[0]!r} p90 {q[1]!r} p95 {q[2]!r} "
              f"p99 {q[3]!r} max {ms.max()!r} ms", file=sys.stderr)
        return {"request_p95_ms": float(q[2]),
                "gen_mel_frames_per_s": units * self.batch * self.t / window_s}

    def flops_per_unit(self) -> float:
        from torch.utils.flop_counter import FlopCounterMode

        m, meta = self.cell.model, torch.device("meta")
        tr = self.cell.traffic
        pu = {k: torch.empty(s, device=meta) for k, (s, _) in ref.spec(m).items()}
        pc = {k: torch.empty(s, device=meta) for k, (s, _) in ref.cond_spec(m).items()}
        b = self.batch
        cond = [torch.empty((b, self.t, m[d]), device=meta) for d in ("motion_dim", "text_dim")]
        x = torch.empty((b, self.t, m["in_dim"]), device=meta)
        tt = torch.zeros((b,), dtype=torch.long, device=meta)
        with torch.no_grad(), FlopCounterMode(display=False) as fc:
            mf, tf = ref.project_conditions(pc, *cond)
            once = float(fc.get_total_flops())
            ref_diff.guided_eps(pu, m, x, tt, mf, tf, float(tr["guidance"]), EXACT)
            forward = float(fc.get_total_flops()) - once
            if self.vocode:
                v = self.cell.config["vocoder"]
                pv = {k: torch.empty(s, device=meta) for k, (s, _) in ref_voc.spec(v).items()}
                ref_voc.vocode(pv, v, torch.empty((1, v["num_mels"], self.t), device=meta))
        vocode = float(fc.get_total_flops()) - once - forward
        return once + int(tr["steps"]) * forward + vocode

    def release(self) -> None:
        self.models._samplers.clear()
        del self.models, self.chain
        if self.vocode:
            del self.vocoder
        gc.collect()
        torch.cuda.empty_cache()

    # ------------------------------------------------------------ the check
    def reference(self, served: List[dict], q: Precision = EXACT) -> List[dict]:
        """For each checked request: the reference's start, its step from each
        of the program's states, and its waveform of the served mel."""
        m, d, tr = self.cell.model, self.cell.config["diffusion"], self.cell.traffic
        pu = self._weights(ref.spec(m), "unet")
        pc = self._weights(ref.cond_spec(m), "cond")
        pv = self._weights(ref_voc.spec(self.cell.config["vocoder"]), "vocoder") \
            if self.vocode else None
        chain = ref_diff.Chain(d, tr["method"], int(tr["steps"]), float(tr["guidance"]))
        out = []
        with exact_math(), torch.no_grad():
            for s in served:
                req = s["req"]
                b = len(req["clips"])
                motion = torch.as_tensor(np.stack([interp_frames(self.clips[c][0], self.t)
                                                   for c in req["clips"]]), device=self.dev)
                lyrics = torch.as_tensor(np.stack([interp_frames(self.clips[c][1], self.t)
                                                   for c in req["clips"]]), device=self.dev)
                mf, tf = ref.project_conditions(pc, motion, lyrics, q)
                draws = chain.draws(req["seed"], b, self.t, m, self.dev)
                r = {"start": next(draws),
                     "steps": [chain.step(pu, m, i, x, mf, tf, q, noise=next(draws))
                               for i, x in enumerate(s["states"])]}
                if pv is not None:
                    mel = torch.as_tensor(s["mel"][:1], device=self.dev)
                    r["wav"] = ref_voc.vocode(pv, self.cell.config["vocoder"], mel, q)
                out.append(r)
        return out

    def check(self, control: Precision = None) -> Dict[str, float]:
        """The checked requests against the reference; with ``control``, the
        reference's steps in that precision (from the same program states)
        and its waveform in the program's place."""
        want = self.reference(self.checked)
        if control is None:
            return compare(self.checked, want)
        alt = self.reference(self.checked, control)
        stand_in = []
        for s, a in zip(self.checked, alt):
            last = a["steps"][-1].double().transpose(1, 2) * MEL_STD + MEL_MEAN
            stand_in.append(dict(s, states=s["states"][:1] + a["steps"][:-1],
                                 mel=last.float().cpu().numpy(),
                                 **({"wav": a["wav"][0].cpu().numpy()} if "wav" in a else {})))
        return compare(stand_in, want)


def normalised(mel: np.ndarray, dev) -> torch.Tensor:
    """A served (B, 80, T) de-normalised mel back to the chain's (B, T, 80)."""
    x = (torch.as_tensor(np.asarray(mel), device=dev).double() - MEL_MEAN) / MEL_STD
    return x.transpose(1, 2)


def program_states(s: dict, dev):
    """The chain's states before each step, then the served mel normalised."""
    return [x.double() for x in s["states"]] + [normalised(s["mel"], dev)]


def compare(served: List[dict], want: List[dict]) -> Dict[str, float]:
    """The start's largest difference (exact); the worst step's relative L2
    gap over every checked clip, and the last step's alone (the served mel:
    the chain's last step and its finish, de-normalised on the host), whose
    own gap is a hundredth of the early steps' (x0 is x less 0.01 eps
    there); the worst clip's waveform gap."""
    if not served:
        return {"checked_requests": 0.0}
    out = {"start_gap": 0.0, "step_gap": 0.0, "last_step_gap": 0.0}
    for s, w in zip(served, want):
        xs = program_states(s, w["start"].device)
        out["start_gap"] = max(out["start_gap"], float((xs[0] - w["start"]).abs().max()))
        for i, ref_next in enumerate(w["steps"]):
            for j in range(ref_next.shape[0]):
                gap = rel_l2(xs[i + 1][j], ref_next[j])
                out["step_gap"] = max(out["step_gap"], gap)
                if i == len(w["steps"]) - 1:
                    out["last_step_gap"] = max(out["last_step_gap"], gap)
        if "wav" in w:
            wav = torch.as_tensor(np.asarray(s["wav"]), device=w["wav"].device)
            out["wav_gap"] = max(out.get("wav_gap", 0.0), rel_l2(wav, w["wav"][0]))
    return out
