"""Wav-domain evaluation orchestrator.

Parity with ``reference/evaluate_all.py``: scan
``eval_root/sample_*/{gt.wav, gen.wav}``; per sample compute MFCC acoustic
cosine, CLAP semantic cosine (optional — gated on laion_clap), and beat
precision/recall/F1/error; at the set level compute FAD, NDB(K=50) and
JS/KL; aggregate the means into ``metadata`` and write
``evaluation_results.json``. Per-metric failures are captured into the
result rather than aborting the run. VA stays a placeholder needing labels.

A copy of ``lm2a_tpu/eval/evaluate_all.py`` (numpy and scipy only) with the port's
imports, so the port imports nothing of the JAX package.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from lm2a_tpu_torch.eval.beat import compute_beat_metrics
from lm2a_tpu_torch.eval.wav_metrics import (
    compute_fad,
    compute_js_kl,
    compute_ndb,
    compute_pairwise_cosine,
)


def scan_evaluation_dir(eval_root: str) -> List[Tuple[str, str, str]]:
    samples = []
    for d in sorted(glob.glob(os.path.join(eval_root, "sample_*"))):
        gt, gen = os.path.join(d, "gt.wav"), os.path.join(d, "gen.wav")
        if os.path.exists(gt) and os.path.exists(gen):
            samples.append((os.path.basename(d), gt, gen))
    return samples


def evaluate_single(gt: str, gen: str, clap=None) -> Dict:
    result: Dict = {"gt": gt, "gen": gen}
    for k in ("fad", "js_mean", "kl_mean", "ndb"):
        result[k] = None  # batch-only metrics; placeholders avoid confusion
    result["batch_only_note"] = "fad/js/kl/ndb are set-level; see batch_metrics"

    try:
        ac = compute_pairwise_cosine([gt], [gen])
        result["acoustic_similarity"] = float(ac["per_sample"][0])
    except Exception as e:
        result["acoustic_similarity"] = None
        result["acoustic_error"] = str(e)

    if clap is not None:
        try:
            cl = clap.compute_metrics([gt], [gen])
            result["cosine_similarity"] = float(cl["per_sample"][0])
            result["clap_type"] = "LAION-CLAP (semantic embedding)"
        except Exception as e:
            result["cosine_similarity"] = None
            result["clap_error"] = str(e)
    else:
        result["cosine_similarity"] = None
        result["clap_note"] = "laion_clap unavailable; semantic similarity skipped"

    try:
        bm = compute_beat_metrics([gt], [gen])
        result["beat_f1"] = float(bm["per_sample_f1"][0])
        result["beat_precision"] = float(bm["per_sample_precision"][0])
        result["beat_recall"] = float(bm["per_sample_recall"][0])
        result["beat_error"] = float(bm["per_sample_err"][0])
    except Exception as e:
        for k in ("beat_f1", "beat_precision", "beat_recall", "beat_error"):
            result[k] = None
        result["beat_error_msg"] = str(e)

    result["va_distance"] = None
    result["va_cosine"] = None
    result["va_status"] = "requires external valence/arousal labels"
    return result


def evaluate_batch(gt_list, gen_list) -> Dict:
    results: Dict = {}
    try:
        fad, _ = compute_fad(gt_list, gen_list)
        results["fad_overall"] = float(fad)
    except Exception as e:
        results["fad_overall"] = None
        results["fad_overall_error"] = str(e)
    try:
        ndb = compute_ndb(gt_list, gen_list, K=50)
        results["ndb_overall"] = int(ndb["ndb"])
        results["ndb_K"] = 50
    except Exception as e:
        results["ndb_overall"] = None
        results["ndb_overall_error"] = str(e)
    try:
        jk = compute_js_kl(gt_list, gen_list)
        results["js_kl_overall"] = {
            "js_mean": float(jk["js_mean"]),
            "kl_mean": float(jk["kl_mean"]),
        }
    except Exception as e:
        results["js_kl_overall"] = None
        results["js_kl_overall_error"] = str(e)
    return results


def _mean_of(results: Dict[str, Dict], key: str) -> Optional[float]:
    vals = [r[key] for r in results.values() if r.get(key) is not None]
    return float(np.mean(vals)) if vals else None


def evaluate_all(
    eval_root: str, output_dir: str, use_clap: bool = True,
    clap_ckpt: Optional[str] = None,
) -> Dict:
    os.makedirs(output_dir, exist_ok=True)
    samples = scan_evaluation_dir(eval_root)
    print(f"found {len(samples)} samples under {eval_root}")
    if not samples:
        raise SystemExit("no sample_*/{gt.wav,gen.wav} pairs found")

    clap = None
    if use_clap:
        try:
            from lm2a_tpu_torch.eval.wav_metrics import CLAPEvaluator

            clap = CLAPEvaluator(ckpt=clap_ckpt)
        except Exception as e:
            print(f"CLAP unavailable ({type(e).__name__}); continuing without it")

    sample_results: Dict[str, Dict] = {}
    gt_list, gen_list = [], []
    for sid, gt, gen in samples:
        print(f"evaluating {sid}")
        sample_results[sid] = evaluate_single(gt, gen, clap)
        gt_list.append(gt)
        gen_list.append(gen)

    batch = evaluate_batch(gt_list, gen_list)

    metadata: Dict = {
        "total_samples": len(samples),
        "eval_dir": eval_root,
        "acoustic_similarity_mean": _mean_of(sample_results, "acoustic_similarity"),
        "beat_precision_mean": _mean_of(sample_results, "beat_precision"),
        "beat_recall_mean": _mean_of(sample_results, "beat_recall"),
        "beat_error_mean": _mean_of(sample_results, "beat_error"),
    }
    if batch.get("fad_overall") is not None:
        metadata["fad_overall"] = batch["fad_overall"]
    if batch.get("js_kl_overall"):
        metadata["js_kl_overall"] = batch["js_kl_overall"]
    if batch.get("ndb_overall") is not None:
        metadata["ndb_overall"] = batch["ndb_overall"]
        metadata["ndb_K"] = batch["ndb_K"]
    beat_f1 = _mean_of(sample_results, "beat_f1")
    if beat_f1 is not None:
        metadata["beat_F1"] = beat_f1
    clap_mean = _mean_of(sample_results, "cosine_similarity")
    if clap_mean is not None:
        metadata["clap_mean"] = clap_mean
        metadata["clap_type"] = "LAION-CLAP (semantic embedding)"

    final = {
        "metadata": metadata,
        "batch_metrics": batch,
        "per_sample_metrics": sample_results,
    }
    out_file = os.path.join(output_dir, "evaluation_results.json")
    with open(out_file, "w", encoding="utf-8") as f:
        json.dump(final, f, indent=2, ensure_ascii=False)
    print(f"wrote {out_file}")
    return final
