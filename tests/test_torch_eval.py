"""The port's evaluation layer against the JAX package's, on the CPU.

Every public function of ``lm2a_tpu_torch.eval`` (mel metrics, MFCC
embeddings, beat tracking and matching, the set-level wav metrics, the
wav-domain orchestrator) runs on the same numpy-seeded arrays and wav files
as its ``lm2a_tpu.eval`` counterpart and must agree to 1e-6 relative: they
are the same numpy and scipy code with the port's imports, so the only
freedom is none. ``ops/mel.py``'s log-mel (torch.fft against jnp.fft, both
fp32) is held to 1e-4 absolute in log-mel units (on a pure tone where the
mel energy is above the fp32 FFTs' leakage floor, and there within 1e-2
of a float64 log-mel: ``TONE_FLOOR``); its numpy filterbank and window
exactly. ``read_wav``/``resample_poly`` on 8/16/24/32-bit PCM and
32/64-bit float files, mono and stereo, exactly. ``evaluate_all`` over a
directory of three ``sample_*/{gt,gen}.wav`` pairs writes the same JSON
keys and values (1e-6 relative). The ``val``, ``evaluate``, ``graph`` and
``inspect_train_log`` CLIs run with the JAX CLIs' flags and defaults.
"""

import importlib
import json
import os
import struct
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lm2a_tpu import eval as jev
from lm2a_tpu.cli import evaluate as jax_cli_evaluate
from lm2a_tpu.cli import inspect_train_log as jax_cli_inspect
from lm2a_tpu.cli import val as jax_cli_val
from lm2a_tpu.core.config import MelConfig as JaxMelConfig
from lm2a_tpu.eval import beat as jbeat
from lm2a_tpu.ops import mel as jmel
from lm2a_tpu.utils import audio as jaudio
from lm2a_tpu_torch import eval as pev
from lm2a_tpu_torch.cli import __main__ as cli_main
from lm2a_tpu_torch.cli import evaluate as cli_evaluate
from lm2a_tpu_torch.cli import graph as cli_graph
from lm2a_tpu_torch.cli import inspect_train_log as cli_inspect
from lm2a_tpu_torch.cli import val as cli_val
from lm2a_tpu_torch.core.config import MelConfig
from lm2a_tpu_torch.eval import beat as pbeat
from lm2a_tpu_torch.ops import mel as pmel
from lm2a_tpu_torch.utils import audio as paudio

from _torch_port_util import one_torch_thread  # noqa: F401

# the eval packages export functions named like their modules (mfcc,
# evaluate_all): the modules themselves
jmfcc = importlib.import_module("lm2a_tpu.eval.mfcc")
pmfcc = importlib.import_module("lm2a_tpu_torch.eval.mfcc")
jea = importlib.import_module("lm2a_tpu.eval.evaluate_all")
pea = importlib.import_module("lm2a_tpu_torch.eval.evaluate_all")

REL = 1e-6
SR = 22050


def assert_same(got, want, path="out"):
    """Equal structure; floats and arrays to REL relative (1e-12 absolute
    floor for exact zeros), everything else equal."""
    if isinstance(want, dict):
        assert set(got) == set(want), (path, sorted(set(got) ^ set(want)))
        for k in want:
            assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, (np.ndarray, float, np.floating)) and not isinstance(want, bool):
        np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                                   rtol=REL, atol=1e-12, err_msg=path)
    else:
        assert got == want, (path, got, want)


def _tone(rng, seconds, sr=SR, bpm=120.0):
    """Clicks at ``bpm`` over a tone and noise: something for the beat tracker."""
    n = int(seconds * sr)
    t = np.arange(n) / sr
    y = 0.2 * np.sin(2 * np.pi * 220.0 * t) + 0.05 * rng.standard_normal(n)
    period = int(sr * 60.0 / bpm)
    for k in range(0, n, period):
        y[k:k + 200] += np.hanning(400)[200:] * 0.8
    return np.clip(y, -1, 1).astype(np.float32)


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    """Three gt/gen pairs under sample_*/ (2-3 s at 22.05 kHz), written as
    16-bit PCM by the port's writer."""
    root = tmp_path_factory.mktemp("evaluation")
    rng = np.random.default_rng(0)
    pairs = []
    for i, (secs, bpm) in enumerate(((2.0, 120.0), (2.5, 100.0), (3.0, 140.0))):
        d = root / f"sample_{i:03d}"
        d.mkdir()
        gt, gen = str(d / "gt.wav"), str(d / "gen.wav")
        paudio.write_wav(gt, _tone(rng, secs, bpm=bpm), SR)
        paudio.write_wav(gen, _tone(rng, secs, bpm=bpm * 1.05), SR)
        pairs.append((gt, gen))
    return str(root), pairs


# ---------------------------------------------------------------- audio IO

def _write_riff(path, data: bytes, fmt: int, channels: int, sr: int, bits: int):
    block = channels * bits // 8
    with open(path, "wb") as f:
        f.write(struct.pack("<4sI4s", b"RIFF", 36 + len(data) + (len(data) & 1), b"WAVE"))
        f.write(struct.pack("<4sIHHIIHH", b"fmt ", 16, fmt, channels, sr, sr * block, block,
                            bits))
        f.write(struct.pack("<4sI", b"data", len(data)) + data + b"\0" * (len(data) & 1))


@pytest.mark.parametrize("fmt,bits", [(1, 8), (1, 16), (1, 24), (1, 32), (3, 32), (3, 64)])
@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("sr,target", [(22050, None), (16000, 22050), (44100, 22050)])
def test_read_wav_and_resample_match(tmp_path, fmt, bits, channels, sr, target):
    rng = np.random.default_rng(bits + channels)
    n = 1001 * channels
    if fmt == 3:
        data = (0.5 * rng.standard_normal(n)).astype("<f4" if bits == 32 else "<f8").tobytes()
    elif bits == 24:
        data = rng.integers(0, 256, size=3 * n, dtype=np.uint8).tobytes()
    else:
        dt = {8: np.uint8, 16: "<i2", 32: "<i4"}[bits]
        info = np.iinfo(np.dtype(dt))
        data = rng.integers(info.min, info.max, size=n, dtype=dt, endpoint=True).tobytes()
    path = str(tmp_path / "a.wav")
    _write_riff(path, data, fmt, channels, sr, bits)
    got, want = paudio.read_wav(path, target_sr=target), jaudio.read_wav(path, target_sr=target)
    assert got[1] == want[1] and got[0].dtype == want[0].dtype == np.float32
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(paudio._parse_riff(path)[0], jaudio._parse_riff(path)[0])
    np.testing.assert_array_equal(paudio.resample_poly(got[0], 22050, 16000),
                                  jaudio.resample_poly(want[0], 22050, 16000))


def test_read_wav_refuses_what_the_jax_reader_refuses(tmp_path):
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"RIFX" + b"\0" * 40)
    for mod in (paudio, jaudio):
        with pytest.raises(ValueError, match="not a RIFF"):
            mod.read_wav(str(bad))
    alaw = str(tmp_path / "alaw.wav")
    _write_riff(alaw, b"\0" * 20, 6, 1, 8000, 8)
    for mod in (paudio, jaudio):
        with pytest.raises(ValueError, match="format code 6"):
            mod.read_wav(alaw)


# ---------------------------------------------------------------- ops/mel.py

@pytest.mark.parametrize("sr,n_fft,mels,fmin,fmax", [(22050, 1024, 80, 0.0, None),
                                                     (16000, 512, 40, 50.0, 7000.0),
                                                     (24000, 1024, 100, 0.0, 12000.0)])
def test_filterbank_and_window_match_exactly(sr, n_fft, mels, fmin, fmax):
    np.testing.assert_array_equal(pmel.slaney_mel_filterbank(sr, n_fft, mels, fmin, fmax),
                                  jmel.slaney_mel_filterbank(sr, n_fft, mels, fmin, fmax))
    np.testing.assert_array_equal(pmel.hann_window_periodic(n_fft),
                                  jmel.hann_window_periodic(n_fft))


def _log_mel_f64(wav: np.ndarray, cfg: MelConfig) -> np.ndarray:
    """The same log-mel in float64 (torch.fft), the exact value both fp32
    implementations round towards."""
    pad = (cfg.n_fft - cfg.hop_size) // 2
    x = torch.nn.functional.pad(torch.tensor(wav, dtype=torch.float64)[:, None], (pad, pad),
                                mode="reflect")[:, 0]
    n_frames = 1 + (x.shape[-1] - cfg.n_fft) // cfg.hop_size
    idx = torch.arange(n_frames)[:, None] * cfg.hop_size + torch.arange(cfg.n_fft)[None, :]
    win = pmel.hann_window_periodic(cfg.win_size).astype(np.float64)
    lpad = (cfg.n_fft - cfg.win_size) // 2
    win = np.pad(win, (lpad, cfg.n_fft - cfg.win_size - lpad))
    spec = torch.fft.rfft(x[..., idx] * torch.tensor(win), dim=-1)
    mag = torch.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-9)
    fb = torch.tensor(pmel.slaney_mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.num_mels),
                      dtype=torch.float64)
    return torch.log(torch.clamp(mag @ fb.t(), min=1e-5)).numpy()


# A pure tone's leakage bins sit near the 1e-5 clip, where an fp32 FFT
# (either library's) is up to ~7e-3 from the float64 value in log-mel: the
# two implementations are held to 1e-4 of each other above a log-mel of -7
# (mel energy 9e-4), and the port to 1e-2 of float64 everywhere. Above the
# floor lie 11.6-24.9% of the tone's (frame, band) bins in these cases (the
# bands the 175 Hz tone reaches), so the share asserted is 10%.
TONE_FLOOR, TONE_F64_TOL = -7.0, 1e-2


@pytest.mark.parametrize("n", [4096, 22050, 132300 + 17])
@pytest.mark.parametrize("win", [1024, 800])
def test_mel_spectrogram_matches(n, win):
    """Log-mel of seeded noise and a tone, batched (2, n): the noise within
    1e-4 of the JAX package's everywhere, the tone above its fp32 floor (see
    ``TONE_FLOOR``); the frame count exact."""
    rng = np.random.default_rng(n + win)
    wav = np.stack([0.3 * rng.standard_normal(n),
                    0.5 * np.sin(np.arange(n) * 0.05)]).astype(np.float32)
    cfg, jcfg = MelConfig(win_size=win), JaxMelConfig(win_size=win)
    got = pmel.mel_spectrogram(torch.tensor(wav), cfg).numpy()
    want = np.asarray(jmel.mel_spectrogram(jnp.asarray(wav), jcfg))
    assert got.shape == want.shape == (2, pmel.frame_count(n, cfg), 80)
    assert pmel.frame_count(n, cfg) == jmel.frame_count(n, jcfg)
    np.testing.assert_allclose(got[0], want[0], atol=1e-4, rtol=0)
    above = want[1] > TONE_FLOOR
    assert above.mean() > 0.1
    np.testing.assert_allclose(got[1][above], want[1][above], atol=1e-4, rtol=0)
    np.testing.assert_allclose(got[1], _log_mel_f64(wav, cfg)[1], atol=TONE_F64_TOL, rtol=0)
    mag = pmel.stft_magnitude(torch.tensor(wav[0]), cfg).numpy()
    np.testing.assert_allclose(mag, np.asarray(jmel.stft_magnitude(jnp.asarray(wav[0]), jcfg)),
                               atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------- mel metrics, MFCC, beats

@pytest.mark.parametrize("t_real,t_gen", [(516, 516), (300, 290), (64, 80)])
def test_mel_metrics_match(t_real, t_gen):
    rng = np.random.default_rng(t_real + t_gen)
    real = (-4.6 + 1.9 * rng.standard_normal((80, t_real))).astype(np.float32)
    gen = (real[:, :min(t_real, t_gen)].mean() + 2.1 * rng.standard_normal((80, t_gen))
           ).astype(np.float32)
    assert_same(pev.compute_metrics(real, gen), jev.compute_metrics(real, gen))
    a, b = rng.random((5, 40)), rng.random((5, 40))
    assert_same(pev.ssim_1d_channels(a, b), jev.ssim_1d_channels(a, b))


def test_mfcc_and_embeddings_match(wavs):
    _, pairs = wavs
    rng = np.random.default_rng(3)
    y = _tone(rng, 1.5)
    for fn in ("melspectrogram", "mfcc", "mfcc_embedding"):
        assert_same(getattr(pev, fn)(y), getattr(jev, fn)(y), fn)
    assert_same(pmfcc.power_to_db(pmfcc.melspectrogram(y)),
                jmfcc.power_to_db(jmfcc.melspectrogram(y)))
    assert_same(pmfcc._stft_power(y), jmfcc._stft_power(y))
    for gt, _ in pairs:
        assert_same(pev.embed_file(gt), jev.embed_file(gt))
        assert_same(pev.embed_file(gt, sr=16000, n_mfcc=20), jev.embed_file(gt, sr=16000,
                                                                            n_mfcc=20))


def test_beats_match(wavs):
    _, pairs = wavs
    y = jaudio.read_wav(pairs[1][0])[0]
    env = pbeat.onset_strength(y)
    assert_same(env, jbeat.onset_strength(y))
    assert_same(pbeat.estimate_tempo(env), jbeat.estimate_tempo(env))
    assert_same(pev.track_beats(y), jev.track_beats(y))
    ref, est = np.array([0.5, 1.0, 1.5, 2.0]), np.array([0.52, 1.2, 1.49, 2.06, 2.5])
    assert_same(pev.match_beats(ref, est), jev.match_beats(ref, est))
    gts, gens = [p[0] for p in pairs], [p[1] for p in pairs]
    assert_same(pev.compute_beat_metrics(gts, gens), jev.compute_beat_metrics(gts, gens))


# ---------------------------------------------------------------- set-level wav metrics

def test_wav_metrics_match(wavs):
    _, pairs = wavs
    gts, gens = [p[0] for p in pairs], [p[1] for p in pairs]
    rng = np.random.default_rng(4)
    mu1, mu2 = rng.standard_normal(6), rng.standard_normal(6)
    a, b = rng.standard_normal((20, 6)), rng.standard_normal((20, 6))
    s1, s2 = np.cov(a, rowvar=False), np.cov(b, rowvar=False)
    assert_same(pev.frechet_distance(mu1, s1, mu2, s2), jev.frechet_distance(mu1, s1, mu2, s2))
    fad, fad_j = pev.compute_fad(gts, gens), jev.compute_fad(gts, gens)
    assert_same(fad, fad_j)
    assert_same(pev.compute_js_kl(gts, gens), jev.compute_js_kl(gts, gens))
    assert_same(pev.compute_pairwise_cosine(gts, gens), jev.compute_pairwise_cosine(gts, gens))
    va1, va2 = rng.standard_normal((4, 2)), rng.standard_normal((4, 2))
    assert_same(pev.compute_va_metrics(va1, va2), jev.compute_va_metrics(va1, va2))
    pytest.importorskip("sklearn")
    assert_same(pev.compute_ndb(gts, gens, K=2), jev.compute_ndb(gts, gens, K=2))


def test_clap_is_gated_as_in_the_jax_package():
    """Without ``laion_clap`` both evaluators raise ImportError at
    construction (evaluate_all then goes on without CLAP)."""
    try:
        import laion_clap  # noqa: F401
    except ImportError:
        for mod in (pev, jev):
            with pytest.raises(ImportError):
                mod.CLAPEvaluator()
    else:  # the package is there: both construct the same model type
        assert type(pev.CLAPEvaluator().model) is type(jev.CLAPEvaluator().model)


def test_evaluate_all_writes_the_same_results(wavs, tmp_path):
    root, pairs = wavs
    assert pev.scan_evaluation_dir(root) == jev.scan_evaluation_dir(root)
    assert_same(pea.evaluate_single(*pairs[0]), jea.evaluate_single(*pairs[0]))
    got = pev.evaluate_all(root, str(tmp_path / "port"), use_clap=False)
    want = jev.evaluate_all(root, str(tmp_path / "jax"), use_clap=False)
    on_disk = [json.load(open(tmp_path / d / "evaluation_results.json")) for d in ("port", "jax")]
    assert_same(on_disk[0], on_disk[1])
    assert_same(json.loads(json.dumps(got)), json.loads(json.dumps(want)))
    assert set(got["metadata"]) >= {"total_samples", "acoustic_similarity_mean",
                                    "beat_precision_mean", "beat_recall_mean",
                                    "beat_error_mean", "fad_overall", "js_kl_overall"}


# ---------------------------------------------------------------- the CLIs

def _defaults(parser, required):
    ns = parser.parse_args(required)
    return {k: v for k, v in vars(ns).items()}


def test_cli_flags_and_defaults_match_the_jax_clis():
    req = ["--ckpt", "c", "--npz_dir", "n", "--out_dir", "o"]
    got, want = _defaults(cli_val.build_parser(), req), _defaults(jax_cli_val.build_parser(), req)
    assert got.pop("device") == "cuda" and got == want
    assert _defaults(cli_evaluate.build_parser(), []) == _defaults(
        jax_cli_evaluate.build_parser(), [])
    assert _defaults(cli_inspect.build_parser(), ["x.csv"]) == _defaults(
        jax_cli_inspect.build_parser(), ["x.csv"])
    from lm2a_tpu.cli import graph as jax_cli_graph

    assert _defaults(cli_graph.build_parser(), ["r.json"]) == _defaults(
        jax_cli_graph.build_parser(), ["r.json"])
    for cmd in ("val", "evaluate", "graph", "inspect_train_log"):
        assert cmd in cli_main.COMMANDS


def test_cli_evaluate_and_graph(wavs, tmp_path, monkeypatch, capsys):
    root, _ = wavs
    out = tmp_path / "results"
    monkeypatch.setattr(sys, "argv", ["lm2a_tpu_torch.cli", "evaluate", "--eval-dir", root,
                                      "--output-dir", str(out), "--no-clap"])
    cli_main.main()
    printed = capsys.readouterr().out
    assert "samples: 3" in printed and "fad_overall" in printed
    res = json.load(open(out / "evaluation_results.json"))
    assert res["metadata"]["total_samples"] == 3
    pytest.importorskip("matplotlib")
    cli_graph.main([str(out / "evaluation_results.json"), "--out_dir", str(tmp_path / "png")])
    made = sorted(os.listdir(tmp_path / "png"))
    assert made == ["acoustic_similarity_hist.png", "beat_f1_hist.png"]  # no CLAP values


def test_cli_inspect_train_log(tmp_path, capsys):
    path = tmp_path / "train_log.csv"
    rows = ["epoch,step,train_loss,val_loss,time_seconds"]
    rows += [f"0,{s},{1.0 / (s + 1):.6f},," for s in range(12)]
    rows += ["0,12,0.08,0.09,3.5", "1,24,0.05,0.06,3.4"]
    path.write_text("\n".join(rows) + "\n")
    cli_inspect.main([str(path), "--head", "2"])
    got = capsys.readouterr().out
    jax_cli_inspect.main([str(path), "--head", "2"])
    assert got == capsys.readouterr().out
    assert "14 rows" in got and "val loss: last=0.060000 min=0.060000" in got
    pytest.importorskip("matplotlib")
    cli_inspect.main([str(path), "--plot", str(tmp_path / "loss.png")])
    assert os.path.getsize(tmp_path / "loss.png") > 0


_BLOCKED = """
import importlib, sys
class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "lm2a_tpu"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, _Block())
for n in sys.argv[1:]:
    importlib.import_module(n)
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "lm2a_tpu")]
print("ok", len(sys.argv) - 1)
"""

NEW_MODULES = [
    "lm2a_tpu_torch.ops.mel", "lm2a_tpu_torch.utils.audio", "lm2a_tpu_torch.utils.logging",
    "lm2a_tpu_torch.eval", "lm2a_tpu_torch.eval.mel_metrics", "lm2a_tpu_torch.eval.mfcc",
    "lm2a_tpu_torch.eval.beat", "lm2a_tpu_torch.eval.wav_metrics",
    "lm2a_tpu_torch.eval.evaluate_all", "lm2a_tpu_torch.eval.assess",
    "lm2a_tpu_torch.training.quality", "lm2a_tpu_torch.cli.val", "lm2a_tpu_torch.cli.evaluate",
    "lm2a_tpu_torch.cli.graph", "lm2a_tpu_torch.cli.inspect_train_log",
]


def test_new_modules_import_without_jax():
    """This slice's modules import with JAX and the JAX package blocked."""
    import subprocess

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", _BLOCKED, *NEW_MODULES], cwd=root,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["ok", str(len(NEW_MODULES))]
