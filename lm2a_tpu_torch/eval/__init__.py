"""Evaluation (port of ``lm2a_tpu/eval``): mel metrics, MFCC embeddings, beat
alignment, set-level wav metrics, the wav-domain orchestrator and the
mel-domain assessment on the port's sampler."""

from lm2a_tpu_torch.eval.assess import assess_batch, assess_single_sample
from lm2a_tpu_torch.eval.beat import compute_beat_metrics, match_beats, track_beats
from lm2a_tpu_torch.eval.evaluate_all import evaluate_all, scan_evaluation_dir
from lm2a_tpu_torch.eval.mel_metrics import compute_metrics, ssim_1d_channels
from lm2a_tpu_torch.eval.mfcc import embed_file, melspectrogram, mfcc, mfcc_embedding
from lm2a_tpu_torch.eval.wav_metrics import (
    CLAPEvaluator,
    compute_fad,
    compute_js_kl,
    compute_ndb,
    compute_pairwise_cosine,
    compute_va_metrics,
    frechet_distance,
)

__all__ = [
    "assess_batch",
    "assess_single_sample",
    "compute_beat_metrics",
    "match_beats",
    "track_beats",
    "evaluate_all",
    "scan_evaluation_dir",
    "compute_metrics",
    "ssim_1d_channels",
    "embed_file",
    "melspectrogram",
    "mfcc",
    "mfcc_embedding",
    "CLAPEvaluator",
    "compute_fad",
    "compute_js_kl",
    "compute_ndb",
    "compute_pairwise_cosine",
    "compute_va_metrics",
    "frechet_distance",
]
