"""``cli serve`` of the port (``lm2a_tpu_torch/cli/serve.py``) on the CPU:
the behavioural cases of ``tests/test_serve.py`` with ``--device cpu``, a
tiny checkpoint written by the port, and ``default_seed`` and the parser
against the JAX module.

The JAX suite's three compiled-chain-cache cases (one chain shared by many
requests and by every guidance weight, the LRU cap) hold the port's chain
cache the same way (on the card each entry is a captured CUDA graph; on
the CPU the same entries run eagerly)."""

import io
import json
import os
import subprocess
import sys
import threading
import zipfile
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
from lm2a_tpu.cli import serve as jax_serve
from lm2a_tpu.utils.audio import read_wav
from lm2a_tpu_torch.cli import serve
from lm2a_tpu_torch.core.config import DiffusionConfig, LM2AConfig, ModelConfig
from lm2a_tpu_torch.inference.sample import load_models
from lm2a_tpu_torch.vocoder.bigvgan import VocoderConfig
from lm2a_tpu_torch.vocoder.vocode import Vocoder

from _torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)

CFG = LM2AConfig(
    model=ModelConfig(base_dim=16, dim_mults=(1, 2), cond_dim=8, time_emb_dim=16,
                      num_res_blocks=1, mid_blocks=1, attn_heads=2),
    diffusion=DiffusionConfig(timesteps=8),
)
MEL_T = 48


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return chip_smoke.write_checkpoint(str(tmp_path_factory.mktemp("serve") / "ckpt"), CFG,
                                       seed=0)


@pytest.fixture(scope="module")
def models(ckpt):
    return load_models(ckpt, device="cpu")


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    return chip_smoke.write_clips(str(tmp_path_factory.mktemp("clips")), 3, seed=0,
                                  mel_t=MEL_T, motion_t=16)


def _run(models, requests, **kw):
    out = io.StringIO()
    served = serve.serve_loop(models, [json.dumps(r) for r in requests], out, **kw)
    return served, [json.loads(line) for line in out.getvalue().splitlines()]


def _mel(path):
    return np.load(path)["mel"]


def test_per_request_overrides_and_methods(models, clips, tmp_path):
    served, resp = _run(models, [
        {"npz": clips[0], "id": "ddpm", "out_dir": str(tmp_path / "a")},
        {"npz": clips[0], "id": "ddim", "method": "ddim", "ddim_steps": 4,
         "out_dir": str(tmp_path / "b")},
        {"npz": clips[0], "id": "short", "steps": 3, "guidance": 2.1,
         "out_dir": str(tmp_path / "c")},
    ])
    assert served == 3 and all(r["ok"] for r in resp)
    mels = [_mel(r["out"]) for r in resp]
    assert all(m.shape == (80, MEL_T) and np.isfinite(m).all() for m in mels)
    assert not np.array_equal(mels[0], mels[1]) and not np.array_equal(mels[0], mels[2])


def test_same_seed_is_deterministic_and_seeds_differ(models, clips, tmp_path):
    _, resp = _run(models, [
        {"npz": clips[0], "id": "x", "seed": 7, "out_dir": str(tmp_path / "x")},
        {"npz": clips[0], "id": "y", "seed": 7, "out_dir": str(tmp_path / "y")},
        {"npz": clips[0], "id": "z", "seed": 8, "out_dir": str(tmp_path / "z")},
    ])
    a, b, c = (_mel(r["out"]) for r in resp)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def test_requests_of_one_geometry_share_one_chain(ckpt, clips, tmp_path):
    fresh = load_models(ckpt, device="cpu")
    served, resp = _run(fresh, [
        {"npz": clips[0], "id": "a", "seed": 1, "out_dir": str(tmp_path / "a")},
        {"npz": clips[0], "id": "b", "seed": 2, "out_dir": str(tmp_path / "b")},
    ])
    assert served == 2 and all(r["ok"] for r in resp)
    assert len(fresh._samplers) == 1
    a, b = (np.load(r["out"])["mel"] for r in resp)
    assert not np.array_equal(a, b)


def test_guidance_values_share_one_chain(ckpt, clips, tmp_path):
    fresh = load_models(ckpt, device="cpu")
    served, resp = _run(fresh, [
        {"npz": clips[0], "id": f"g{w}", "guidance": w, "seed": 3,
         "out_dir": str(tmp_path / f"g{w}")} for w in (1.5, 2.1, 3.0)])
    assert served == 3 and all(r["ok"] for r in resp)
    assert len(fresh._samplers) == 1  # one guided chain for every weight above 1
    mels = [np.load(r["out"])["mel"] for r in resp]
    assert not np.array_equal(mels[0], mels[1]) and not np.array_equal(mels[1], mels[2])


def test_sampler_cache_is_lru_capped(ckpt, clips, tmp_path):
    fresh = load_models(ckpt, device="cpu")
    fresh.sampler_cache_max = 2
    served, resp = _run(fresh, [
        {"npz": clips[0], "id": f"s{k}", "steps": k, "out_dir": str(tmp_path / f"s{k}")}
        for k in (2, 3, 4)])
    assert served == 3 and all(r["ok"] for r in resp)
    assert [key[1] for key in fresh._samplers] == [3, 4]  # the oldest geometry evicted


def test_batched_request(models, clips, tmp_path):
    served, resp = _run(models, [{"npz": clips, "id": "batch", "batch_size": 2}],
                        out_dir=str(tmp_path / "out"))
    assert served == 1
    (r,) = resp
    assert r["ok"] and isinstance(r["out"], list) and len(r["out"]) == 3
    mels = [_mel(o) for o in r["out"]]
    assert all(m.shape == (80, MEL_T) and np.isfinite(m).all() for m in mels)
    assert not np.array_equal(mels[0], mels[1])  # per-row conditions differ


def test_bad_requests_do_not_kill_the_server(models, clips, tmp_path):
    out = io.StringIO()
    served = serve.serve_loop(models, [
        "this is not json",
        json.dumps(["not", "an", "object"]),
        json.dumps({"id": "no-npz"}),
        json.dumps({"npz": str(tmp_path / "missing.npz"), "id": "gone"}),
        json.dumps({"npz": clips[0], "id": "good"}),
    ], out, out_dir=str(tmp_path / "out"))
    resp = [json.loads(line) for line in out.getvalue().splitlines()]
    assert served == 1
    assert [r["ok"] for r in resp] == [False, False, False, False, True]
    assert all("error" in r for r in resp[:4])


def test_ping_quit_and_blank_lines(models, clips, tmp_path):
    out = io.StringIO()
    served = serve.serve_loop(models, [
        "",
        json.dumps({"cmd": "ping", "id": "p"}),
        json.dumps({"cmd": "quit"}),
        json.dumps({"npz": clips[0], "id": "after-quit"}),
    ], out, out_dir=str(tmp_path / "out"))
    resp = [json.loads(line) for line in out.getvalue().splitlines()]
    assert served == 0
    assert resp[0] == {"id": "p", "ok": True, "pong": True}
    assert resp[1]["bye"] is True and len(resp) == 2


def test_parser_is_the_jax_parser_plus_device():
    def flags(parser):
        return {a.dest: (a.option_strings, a.default, a.required)
                for a in parser._actions if a.dest != "help"}

    port, jax_flags = flags(serve.build_parser()), flags(jax_serve.build_parser())
    assert set(port) - set(jax_flags) == {"device"}
    assert {k: port[k] for k in jax_flags} == jax_flags
    args = serve.build_parser().parse_args(["--ckpt", "c", "--method", "ddim",
                                            "--warmup_t", "516"])
    assert (args.ckpt, args.method, args.warmup_t, args.device) == ("c", "ddim", 516, "cuda")
    assert args.out_dir == "serve_out" and args.warmup_batch is None and not args.serial


@pytest.mark.parametrize("req", [
    {"id": "rep"}, {"id": 17}, {"npz": "a.npz"}, {"npz": ["a.npz", "b.npz"]}, {},
    {"id": None, "npz": "x.npz"},
])
def test_default_seed_equals_jax(req):
    assert serve.default_seed(req) == jax_serve.default_seed(req)


def test_default_seed_is_position_independent(models, clips, tmp_path):
    _, resp1 = _run(models, [{"npz": clips[0], "id": "rep", "out_dir": str(tmp_path / "p0")}])
    _, resp2 = _run(models, [
        {"npz": clips[0], "id": "other", "seed": 5, "out_dir": str(tmp_path / "other")},
        {"npz": clips[0], "id": "rep", "out_dir": str(tmp_path / "p1")},
    ])
    assert resp1[0]["seed"] == resp2[1]["seed"] == serve.default_seed({"id": "rep"})
    np.testing.assert_array_equal(_mel(resp1[0]["out"]), _mel(resp2[1]["out"]))


def test_wav_request_writes_waveform(models, clips, tmp_path):
    tiny = VocoderConfig(upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
                         upsample_initial_channel=32, resblock_kernel_sizes=(3, 5),
                         resblock_dilation_sizes=((1, 2), (1, 2)))
    voc = Vocoder(cfg=tiny, device="cpu", compute_dtype="float32")
    served, resp = _run(models, [{"npz": clips[0], "id": "w", "wav": True,
                                  "out_dir": str(tmp_path / "w")}], vocoder=voc)
    assert served == 1 and resp[0]["ok"]
    assert resp[0]["wav"].endswith("_gen.wav")
    y, sr = read_wav(resp[0]["wav"])
    assert sr == tiny.sample_rate and y.shape == (MEL_T * tiny.hop,)
    assert np.isfinite(y).all()


def test_pipelined_stream_keeps_response_order(models, clips, tmp_path):
    served, resp = _run(models, [
        {"npz": clips[0], "id": "r0", "seed": 0},
        {"npz": clips[:2], "id": "r1", "seed": 1},
        {"npz": str(tmp_path / "nope.npz"), "id": "r2"},
        {"npz": clips[1], "id": "r3", "seed": 3},
    ], out_dir=str(tmp_path / "out"))
    assert served == 3
    assert [r["id"] for r in resp] == ["r0", "r1", "r2", "r3"]
    assert [r["ok"] for r in resp] == [True, True, False, True]
    for r in resp:
        if r["ok"]:
            outs = r["out"] if isinstance(r["out"], list) else [r["out"]]
            assert all(os.path.exists(o) for o in outs)


def test_lockstep_client_gets_reply_without_next_request(models, clips, tmp_path):
    """Request N+1 is yielded only after reply N reached the stream; a
    bounded wait turns a deadlock into a failure."""

    class EventStream(io.StringIO):
        def __init__(self):
            super().__init__()
            self.got_line = threading.Event()

        def write(self, s):
            r = super().write(s)
            if "\n" in s:
                self.got_line.set()
            return r

    out = EventStream()
    timed_out = []

    def requests():
        for i in range(3):
            out.got_line.clear()
            yield json.dumps({"npz": clips[0], "id": f"q{i}", "seed": i,
                              "out_dir": str(tmp_path / "out")})
            if not out.got_line.wait(timeout=60):
                timed_out.append(i)
                return

    served = serve.serve_loop(models, requests(), out, out_dir=str(tmp_path / "out"))
    assert timed_out == []
    resp = [json.loads(line) for line in out.getvalue().splitlines()]
    assert served == 3 and [r["id"] for r in resp] == ["q0", "q1", "q2"]


def test_failed_host_io_not_counted_as_served(models, clips, tmp_path):
    blocker = tmp_path / "blocked"
    blocker.write_text("not a directory")
    served, resp = _run(models, [
        {"npz": clips[0], "id": "bad-io", "seed": 1, "out_dir": str(blocker)},
        {"npz": clips[0], "id": "good", "seed": 2, "out_dir": str(tmp_path / "ok")},
    ])
    assert served == 1
    assert [r["id"] for r in resp] == ["bad-io", "good"]
    assert [r["ok"] for r in resp] == [False, True] and "error" in resp[0]


def test_serial_mode_matches_pipelined(models, clips, tmp_path):
    _, resp_p = _run(models, [{"npz": clips[0], "id": "s", "seed": 11,
                               "out_dir": str(tmp_path / "p")}])
    served, resp_s = _run(models, [{"npz": clips[0], "id": "s", "seed": 11,
                                    "out_dir": str(tmp_path / "s")}], serial=True)
    assert served == 1
    np.testing.assert_array_equal(_mel(resp_p[0]["out"]), _mel(resp_s[0]["out"]))


def test_uncompressed_output_by_default(models, clips, tmp_path):
    served, resp = _run(models, [
        {"npz": clips[0], "steps": 4, "out_dir": str(tmp_path / "u"), "id": "u"},
        {"npz": clips[0], "steps": 4, "out_dir": str(tmp_path / "c"), "id": "c",
         "compress": True, "seed": 0},
    ])
    assert served == 2 and all(r["ok"] for r in resp)
    pu, pc = resp[0]["out"], resp[1]["out"]
    with zipfile.ZipFile(pu) as z:
        assert all(i.compress_type == zipfile.ZIP_STORED for i in z.infolist())
    with zipfile.ZipFile(pc) as z:
        assert any(i.compress_type == zipfile.ZIP_DEFLATED for i in z.infolist())
    assert _mel(pu).shape == _mel(pc).shape == (80, MEL_T)


def test_main_warms_up_and_serves_stdin(ckpt, clips, tmp_path, monkeypatch, capsys):
    """``python -m lm2a_tpu_torch.cli serve`` as a user runs it, on the CPU."""
    reqs = [{"cmd": "ping", "id": "p"},
            {"npz": clips[0], "id": "a", "out_dir": str(tmp_path / "a")},
            {"cmd": "quit"}]
    monkeypatch.setattr("sys.stdin", io.StringIO("".join(json.dumps(r) + "\n" for r in reqs)))
    serve.main(["--ckpt", ckpt, "--device", "cpu", "--method", "ddim", "--ddim_steps", "3",
                "--guidance", "2.1", "--warmup_t", "24", "--warmup_batch", "2"])
    captured = capsys.readouterr()
    resp = [json.loads(line) for line in captured.out.splitlines()]
    assert [r["id"] for r in resp] == ["p", "a", None]
    assert all(r["ok"] for r in resp) and os.path.exists(resp[1]["out"])
    assert "warmup T=24 guidance=2.1" in captured.err and "1 requests served" in captured.err


def test_dispatcher_runs_serve(ckpt, clips, tmp_path):
    """``python -m lm2a_tpu_torch.cli serve``, requests piped to stdin."""
    reqs = [{"npz": clips[1], "id": "x", "seed": 3}, {"cmd": "quit"}]
    r = subprocess.run(
        [sys.executable, "-m", "lm2a_tpu_torch.cli", "serve", "--ckpt", ckpt, "--device", "cpu",
         "--method", "ddim", "--ddim_steps", "2", "--out_dir", str(tmp_path)],
        input="".join(json.dumps(q) + "\n" for q in reqs), capture_output=True, text=True,
        cwd=Path(__file__).resolve().parents[1], timeout=300)
    assert r.returncode == 0, r.stderr
    resp = [json.loads(line) for line in r.stdout.splitlines()]
    assert [q["ok"] for q in resp] == [True, True] and resp[1]["bye"]
    assert _mel(resp[0]["out"]).shape == (80, MEL_T)
