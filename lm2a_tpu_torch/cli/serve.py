"""Persistent serving loop: load models once, answer many sampling requests.

The port of ``python -m lm2a_tpu.cli serve``: a long-lived process reads one
JSON request per line on stdin and writes one JSON response per line on
stdout. Model parameters load once (a checkpoint directory or a reference
``.pt`` file); ``--device`` (default ``cuda``; ``cpu`` runs the kernels'
plain versions) places them. As in the JAX package, the sampler chain is
cached per request geometry (mel_t, steps, guided?, method, batch) in an LRU
capped at 16 entries for this long-lived process: on the card an entry is
the CUDA graph of the chain's step, captured at the first request of that
geometry; the CFG weight is a device scalar, so every weight above 1 shares
one entry. A later request of a cached geometry costs only the graph
replays and the host's file work. ``--warmup_t`` runs one chain at that
geometry before the first request: on the card that builds the CUDA
kernels and captures that geometry's chain.

Two-stage pipeline: device compute runs on the main thread; host IO (npz /
wav / PNG writes) runs on a single writer thread, overlapping the NEXT
request's chain. Responses are emitted in request order. ``--serial``
disables the overlap.

Request fields (one JSON object per line on stdin):
    npz         input clip path, or a LIST of paths — a list is served as
                batched generation (clips grouped by mel length, one chain
                per group) (required unless "cmd")
    id          echoed back in the response (optional)
    out_dir     overrides the server default (optional)
    steps       schedule length        (default: server --steps / checkpoint)
    guidance    CFG weight             (default: server --guidance / ckpt)
    method      "ddpm" | "ddim"        (default: server --method)
    ddim_steps  DDIM sampler steps     (default: server --ddim_steps)
    batch_size  clips per chain of a list request (default 8)
    seed        noise seed. Default: crc32 of the request "id" (or of the
                npz path(s) when no id is given), so replaying a request
                yields the same audio regardless of its position in the
                stream
    wav         true -> also vocode mel -> waveform and write
                "<base>_gen.wav" (BigVGAN weights from --vocoder_weights;
                random-init smoke vocoder with a warning otherwise)
    png         also write gen/real PNGs (default: false)
    compress    true -> compressed response npz (server default: plain
                np.savez; see --compress_npz)
    cmd         "quit" ends the loop; "ping" answers without sampling

Response (one JSON object per line on stdout):
    {"id": ..., "ok": true, "out": "<base>_gen.npz", "seconds": 0.84, "seed": ...}
    {"id": ..., "ok": true, "out": ["a_gen.npz", ...], "wav": [...], ...}
    {"id": ..., "ok": false, "error": "..."}
EOF on stdin also ends the loop. Diagnostics go to stderr. "seconds" is the
compute time of that request (the chain and the vocoder); host IO overlaps
the next request.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor


def build_parser(p=None):
    p = p or argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ckpt", required=True,
                   help="checkpoint dir OR reference torch .pt file")
    p.add_argument("--out_dir", default="serve_out",
                   help="default output dir (per-request out_dir overrides)")
    p.add_argument("--steps", type=int, default=None,
                   help="default schedule length (default: ckpt timesteps)")
    p.add_argument("--guidance", type=float, default=None,
                   help="default CFG weight (default: ckpt guidance, else 1.0)")
    p.add_argument("--method", default=None, choices=["ddpm", "ddim"],
                   help="default: the checkpoint's distilled DDIM grid when "
                        "serving a distilled student, else ddpm")
    p.add_argument("--ddim_steps", type=int, default=None)
    p.add_argument("--vocoder_weights", default=None,
                   help="NVIDIA BigVGAN checkpoint for wav requests (without "
                        "it, wav requests run a random-init smoke vocoder)")
    p.add_argument("--warmup_t", type=int, default=None,
                   help="run one B=1 chain at this mel length before accepting "
                        "requests (e.g. 516), at the server's resolved default "
                        "method and guidance")
    p.add_argument("--warmup_batch", type=int, default=None,
                   help="also run the batched chain at this batch size")
    p.add_argument("--serial", action="store_true",
                   help="disable the IO/compute two-stage pipeline")
    p.add_argument("--compress_npz", action="store_true",
                   help="write compressed response npz (the reference's "
                        "sample artifact format); off by default, as "
                        "compression costs host time per clip")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def default_seed(req: dict) -> int:
    """Deterministic per-request seed: crc32 of the request id, else of the
    npz path(s), so a replayed request reproduces its audio at any stream
    position."""
    tag = req.get("id")
    if tag is None:
        npz = req.get("npz", "")
        tag = "|".join(npz) if isinstance(npz, (list, tuple)) else str(npz)
    return zlib.crc32(str(tag).encode("utf-8"))


class _Writer:
    """Single writer thread + in-order response emitter.

    ``submit`` queues one request's host IO. Emission is driven by the IO
    thread itself: each future's done-callback drains the in-order prefix of
    ``pending``, so a completed reply reaches the stream as soon as its IO
    finishes, while the main thread may already be blocked reading the next
    request (a send-one-await-one client gets its reply).

    ``ok_count`` counts successfully *emitted* sampling responses: a request
    whose compute succeeded but whose host IO failed is not counted."""

    def __init__(self, out_stream, serial: bool = False):
        self.out = out_stream
        self.serial = serial
        self.pool = None if serial else ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="serve-io")
        self.pending = collections.deque()
        self.lock = threading.Lock()
        self.ok_count = 0

    def submit(self, fn, reply_base: dict) -> None:
        """fn() does the host IO and returns extra response fields."""
        if self.serial:
            self._emit(fn, reply_base)
            return
        with self.lock:
            fut = self.pool.submit(fn)
            self.pending.append((fut, reply_base))
        # runs on the IO thread once fn returns (or here if it already has)
        fut.add_done_callback(lambda _f: self._drain())

    def emit_now(self, obj: dict) -> None:
        """Drain everything pending (blocking), then write obj: error and
        command replies must not overtake earlier sampling replies."""
        with self.lock:
            while self.pending:
                fut, base = self.pending.popleft()
                self._emit(None, base, fut)
            _reply(self.out, obj)

    def _drain(self) -> None:
        with self.lock:
            while self.pending and self.pending[0][0].done():
                fut, base = self.pending.popleft()
                self._emit(None, base, fut)

    def _emit(self, fn, base: dict, fut=None) -> None:
        try:
            extra = fut.result() if fut is not None else fn()
            _reply(self.out, {**base, **(extra or {})})
            if base.get("ok"):
                self.ok_count += 1
        except Exception as e:  # write failure -> error reply, keep serving
            _reply(self.out, {"id": base.get("id"), "ok": False,
                              "error": f"{type(e).__name__}: {e}"})

    def close(self) -> None:
        if self.pool is not None:
            self.pool.shutdown(wait=True)
        with self.lock:
            while self.pending:
                fut, base = self.pending.popleft()
                self._emit(None, base, fut)


def serve_loop(models, requests, out_stream, *, out_dir="serve_out",
               steps=None, guidance=None, method=None, ddim_steps=None,
               vocoder=None, vocoder_weights=None, serial=False,
               compress_npz=False):
    """Handle an iterable of JSON-line requests; write JSON-line responses.

    Returns the number of served sampling requests: those whose compute AND
    host IO both completed and whose ok reply was emitted. ``vocoder`` may
    be a pre-built ``Vocoder``; otherwise one is created on the first wav
    request, on the models' device."""
    from lm2a_tpu_torch.inference.sample import (
        compute_batch_from_npz, compute_single_from_npz, write_clip_outputs,
    )

    writer = _Writer(out_stream, serial=serial)
    voc = vocoder

    def get_vocoder():
        nonlocal voc
        if voc is None:
            from lm2a_tpu_torch.vocoder.vocode import Vocoder

            if not vocoder_weights:
                print("[serve] wav requested with no --vocoder_weights: "
                      "using a random-init smoke vocoder", file=sys.stderr)
            voc = Vocoder(weights_path=vocoder_weights, device=models.device)
        return voc

    try:
        for line in requests:
            line = line.strip()
            if not line:
                continue
            req_id = None
            try:
                req = json.loads(line)
                if not isinstance(req, dict):
                    raise ValueError("request must be a JSON object")
                req_id = req.get("id")
                cmd = req.get("cmd")
                if cmd == "quit":
                    writer.emit_now({"id": req_id, "ok": True, "bye": True})
                    break
                if cmd == "ping":
                    writer.emit_now({"id": req_id, "ok": True, "pong": True})
                    continue
                if "npz" not in req:
                    raise ValueError("request needs 'npz' (or 'cmd')")

                req_gw = req.get("guidance", guidance)
                if (models.distilled_steps and req_gw is not None
                        and float(req_gw) != 1.0):
                    # a folded student's eps already carries its teacher's
                    # CFG; re-guiding it doubles the weight. Honour the
                    # explicit request but say so.
                    print(f"[serve] warning: request {req_id!r} guidance "
                          f"{req_gw} on a distilled checkpoint (folded "
                          f"guidance {models.folded_guidance}) double-"
                          "guides; expect a biased output", file=sys.stderr)
                seed = int(req.get("seed", default_seed(req)))
                want_wav = bool(req.get("wav", False))
                save_png = bool(req.get("png", False))
                req_out = req.get("out_dir", out_dir)
                batched = isinstance(req["npz"], (list, tuple))
                kw = dict(steps=req.get("steps", steps), guidance_weight=req_gw,
                          method=req.get("method", method), seed=seed,
                          ddim_steps=req.get("ddim_steps", ddim_steps))

                # ---- compute stage (main thread) ----
                t0 = time.perf_counter()
                if batched:
                    results = compute_batch_from_npz(
                        models, list(req["npz"]),
                        batch_size=int(req.get("batch_size", 8)), **kw)
                else:
                    results = [compute_single_from_npz(models, req["npz"], **kw)]
                if want_wav:
                    v = get_vocoder()
                    for r in results:
                        r["wav"] = v.mel_to_wav(r["gen_mel"])[0]
                        r["wav_sr"] = v.cfg.sample_rate
                secs = round(time.perf_counter() - t0, 3)

                # ---- host-IO stage (writer thread) ----
                req_compress = bool(req.get("compress", compress_npz))

                def io_job(results=results, req_out=req_out, batched=batched,
                           save_png=save_png, want_wav=want_wav,
                           compress=req_compress):
                    outs = [write_clip_outputs(r, req_out, save_png=save_png,
                                               compress=compress)
                            for r in results]
                    resp = {"out": outs if batched else outs[0]}
                    if want_wav:
                        wavs = [os.path.splitext(o)[0] + ".wav" for o in outs]
                        resp["wav"] = wavs if batched else wavs[0]
                    return resp

                writer.submit(io_job, {"id": req_id, "ok": True,
                                       "seconds": secs, "seed": seed})
            except Exception as e:  # a bad request must not kill the server
                writer.emit_now({"id": req_id, "ok": False,
                                 "error": f"{type(e).__name__}: {e}"})
    finally:
        writer.close()
    return writer.ok_count


def _reply(stream, obj) -> None:
    stream.write(json.dumps(obj) + "\n")
    stream.flush()


def main(args=None):
    args = build_parser().parse_args(args)
    import numpy as np

    from lm2a_tpu_torch.inference.sample import (
        _resolve_run_params, generate_mel, generate_mel_batch, load_models, resolve_method,
    )

    t0 = time.perf_counter()
    models = load_models(args.ckpt, device=args.device)
    models.sampler_cache_max = 16  # long-lived process: bound the cached chains
    print(f"[serve] loaded {args.ckpt} on {models.device} in "
          f"{time.perf_counter() - t0:.1f}s (timesteps={models.timesteps})",
          file=sys.stderr)
    method, ddim_steps = resolve_method(models, args.method, args.ddim_steps)
    if models.distilled_steps:
        print(f"[serve] distilled checkpoint: serving {method}-"
              f"{ddim_steps} single-forward (folded guidance "
              f"{models.folded_guidance})", file=sys.stderr)

    if args.warmup_t:
        # the chain the first real request will use: the resolved default
        # guidance decides guided (2-row forwards) or not
        _, gw = _resolve_run_params(models, args.steps, args.guidance)
        m0 = np.zeros((args.warmup_t, models.cfg.model.motion_dim), np.float32)
        l0 = np.zeros((args.warmup_t, models.cfg.model.text_dim), np.float32)
        t0 = time.perf_counter()
        generate_mel(models, m0, l0, args.warmup_t, steps=args.steps,
                     guidance_weight=gw, method=method, ddim_steps=ddim_steps)
        print(f"[serve] warmup T={args.warmup_t} guidance={gw} B=1 ran in "
              f"{time.perf_counter() - t0:.1f}s", file=sys.stderr)
        if args.warmup_batch:
            t0 = time.perf_counter()
            generate_mel_batch(models, [m0] * args.warmup_batch, [l0] * args.warmup_batch,
                               args.warmup_t, steps=args.steps, guidance_weight=gw,
                               method=method, ddim_steps=ddim_steps)
            print(f"[serve] warmup B={args.warmup_batch} ran in "
                  f"{time.perf_counter() - t0:.1f}s", file=sys.stderr)

    print("[serve] ready: one JSON request per line on stdin", file=sys.stderr)
    served = serve_loop(
        models, sys.stdin, sys.stdout, out_dir=args.out_dir,
        steps=args.steps, guidance=args.guidance, method=method,
        ddim_steps=ddim_steps, vocoder_weights=args.vocoder_weights,
        serial=args.serial, compress_npz=args.compress_npz,
    )
    print(f"[serve] done: {served} requests served", file=sys.stderr)


if __name__ == "__main__":
    main()
