"""Beat tracking and beat-alignment metrics.

Parity target: ``reference/metrics/beat.py`` — per-file beat times via
``librosa.beat.beat_track``, greedy nearest matching within a 70 ms
tolerance, per-sample precision/recall/F1 and mean absolute timing error.

librosa is not a dependency of the package, so the tracker is a native implementation of
the same algorithm family (Ellis 2007 dynamic-programming beat tracker, the
one librosa implements): spectral-flux onset envelope on a log-mel
spectrogram, autocorrelation tempo estimate with a log-normal prior around
120 BPM, then DP over onset strength with a log-squared tempo-deviation
penalty. Identical beat times to librosa are not guaranteed (different
onset-envelope numerics); the matching/metric layer is exact.

A copy of ``lm2a_tpu/eval/beat.py`` (numpy and scipy only) with the port's
imports, so the port imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from lm2a_tpu_torch.eval.mfcc import melspectrogram, power_to_db

HOP = 512
SR_DEFAULT = 22050


def onset_strength(y: np.ndarray, sr: int = SR_DEFAULT, hop: int = HOP) -> np.ndarray:
    """Half-wave-rectified spectral flux over a log-mel spectrogram."""
    s = power_to_db(melspectrogram(y, sr=sr, hop=hop))
    flux = np.maximum(0.0, np.diff(s, axis=1))
    env = flux.mean(axis=0)
    env = np.concatenate([[0.0], env])
    if env.max() > 0:
        env = env / env.max()
    return env


def estimate_tempo(
    env: np.ndarray, sr: int = SR_DEFAULT, hop: int = HOP, start_bpm: float = 120.0
) -> float:
    """Autocorrelation peak weighted by a log-normal prior (sigma=1 octave)."""
    if len(env) < 4:
        return start_bpm
    x = env - env.mean()
    ac = np.correlate(x, x, mode="full")[len(x) - 1 :]
    ac = np.maximum(ac, 0.0)
    fps = sr / hop
    lags = np.arange(len(ac), dtype=np.float64)
    lags[0] = 1e-9
    bpms = 60.0 * fps / lags
    prior = np.exp(-0.5 * ((np.log2(np.maximum(bpms, 1e-6) / start_bpm)) ** 2))
    prior[0] = 0.0
    lo, hi = int(fps * 60 / 320), int(fps * 60 / 30)  # 30..320 BPM
    weighted = ac * prior
    weighted[: max(lo, 1)] = 0.0
    weighted[hi:] = 0.0
    lag = int(np.argmax(weighted))
    return start_bpm if lag == 0 else 60.0 * fps / lag


def track_beats(
    y: np.ndarray, sr: int = SR_DEFAULT, hop: int = HOP, tightness: float = 100.0
) -> np.ndarray:
    """Beat times (seconds) via DP over the onset envelope (Ellis 2007)."""
    env = onset_strength(y, sr=sr, hop=hop)
    n = len(env)
    if n < 4 or env.max() == 0:
        return np.array([])
    fps = sr / hop
    tempo = estimate_tempo(env, sr=sr, hop=hop)
    period = max(1, int(round(60.0 * fps / tempo)))

    # smooth the envelope with a beat-length gaussian (librosa does similar)
    win = np.exp(-0.5 * (np.arange(-period, period + 1) / (period / 32.0)) ** 2)
    local = np.convolve(env, win / win.sum(), mode="same")

    score = np.zeros(n)
    backlink = -np.ones(n, dtype=int)
    window = np.arange(-2 * period, -period // 2)
    for i in range(n):
        cand = i + window
        valid = cand >= 0
        if not valid.any():
            score[i] = local[i]
            continue
        cand = cand[valid]
        txcost = -tightness * (np.log(-window[valid] / period) ** 2)
        total = score[cand] + txcost
        k = int(np.argmax(total))
        score[i] = local[i] + total[k]
        backlink[i] = cand[k]

    # pick the best terminal beat among strong late candidates
    mask = local > 0.5 * np.median(local[local > 0]) if (local > 0).any() else local > 0
    tail = np.where(mask)[0]
    start = int(np.argmax(score)) if tail.size == 0 else tail[np.argmax(score[tail])]
    beats = [start]
    while backlink[beats[-1]] >= 0:
        beats.append(int(backlink[beats[-1]]))
    beats = np.array(sorted(beats))
    return beats / fps


def match_beats(
    ref_times: np.ndarray, est_times: np.ndarray, tol: float = 0.07
) -> Tuple[List[Tuple[int, int, float]], List[int], List[int]]:
    """Greedy nearest-match within tolerance; one est beat matches once."""
    ref_times = np.asarray(ref_times)
    est_times = np.asarray(est_times)
    matched_ref: set = set()
    matched_est: set = set()
    matches = []
    for i, rt in enumerate(ref_times):
        if est_times.size == 0:
            continue
        diffs = np.abs(est_times - rt)
        j = int(np.argmin(diffs))
        if diffs[j] <= tol and j not in matched_est:
            matched_ref.add(i)
            matched_est.add(j)
            matches.append((i, j, float(est_times[j] - rt)))
    unmatched_ref = sorted(set(range(len(ref_times))) - matched_ref)
    unmatched_est = sorted(set(range(len(est_times))) - matched_est)
    return matches, unmatched_ref, unmatched_est


def compute_beat_metrics(
    gt_files: Sequence[str], gen_files: Sequence[str],
    sr: int = SR_DEFAULT, tol: float = 0.07,
) -> Dict:
    from lm2a_tpu_torch.utils.audio import read_wav

    precision, recall, f1s, errs, hits = [], [], [], [], []
    for g, s in zip(gt_files, gen_files):
        try:
            gt_bt = track_beats(read_wav(g, target_sr=sr)[0], sr=sr)
        except Exception:
            gt_bt = np.array([])
        try:
            gen_bt = track_beats(read_wav(s, target_sr=sr)[0], sr=sr)
        except Exception:
            gen_bt = np.array([])
        matches, _, _ = match_beats(gt_bt, gen_bt, tol=tol)
        n_ref, n_est, n_m = len(gt_bt), len(gen_bt), len(matches)
        p = n_m / n_est if n_est else 0.0
        r = n_m / n_ref if n_ref else 0.0
        f = 2 * p * r / (p + r) if (p + r) else 0.0
        e = float(np.mean([abs(x[2]) for x in matches])) if matches else 0.0
        precision.append(p)
        recall.append(r)
        f1s.append(f)
        errs.append(e)
        hits.append(n_m)

    precision = np.asarray(precision)
    recall = np.asarray(recall)
    f1s = np.asarray(f1s)
    errs = np.asarray(errs)
    return {
        "per_sample_hits": np.asarray(hits),
        "precision_mean": float(precision.mean()) if len(precision) else 0.0,
        "recall_mean": float(recall.mean()) if len(recall) else 0.0,
        "f1_mean": float(f1s.mean()) if len(f1s) else 0.0,
        "err_mean": float(errs.mean()) if len(errs) else 0.0,
        "per_sample_precision": precision,
        "per_sample_recall": recall,
        "per_sample_f1": f1s,
        "per_sample_err": errs,
    }
