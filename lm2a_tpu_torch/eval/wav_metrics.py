"""Set-level and pairwise wav-domain metrics.

Parity targets in ``reference/metrics/``:
- FAD          (fad.py): Frechet distance between MFCC-embedding Gaussians,
  scipy sqrtm with eps-jitter retry and imaginary-part strip.
- NDB          (ndb.py): KMeans(K=min(50,n)) bins on GT embeddings, pooled
  two-proportion z-test per bin, alpha=0.05 (no Bonferroni — matching the
  reference's shipped behavior, where the correction is commented out).
- JS/KL        (js_kl.py): per-dimension 100-bin histograms over the joint
  range, epsilon-smoothed KL and JS, means over dims.
- acoustic sim (acoustic_similarity.py): pairwise cosine of MFCC embeddings.
- VA           (va.py): euclidean + cosine in 2-D valence/arousal space.
- CLAP         (clap.py): LAION-CLAP cosine — optional, gated on the
  laion_clap package being importable.

A copy of ``lm2a_tpu/eval/wav_metrics.py`` (numpy and scipy only) with the port's
imports, so the port imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
from scipy import linalg

from lm2a_tpu_torch.eval.mfcc import embed_file

EmbedFn = Callable[[str], np.ndarray]


def _embeddings(files: Sequence[str], embed_fn: Optional[EmbedFn], sr: int):
    fn = embed_fn or (lambda p: embed_file(p, sr=sr))
    return np.stack([np.asarray(fn(p), dtype=np.float64) for p in files])


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1 @ sigma2)
    if isinstance(covmean, tuple):
        covmean = covmean[0]
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
        if isinstance(covmean, tuple):
            covmean = covmean[0]
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(
        diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2.0 * np.trace(covmean)
    )


def compute_fad(
    gt_files, gen_files, embed_fn: Optional[EmbedFn] = None, sr: int = 22050
):
    gt = _embeddings(gt_files, embed_fn, sr)
    gen = _embeddings(gen_files, embed_fn, sr)
    mu1, mu2 = gt.mean(axis=0), gen.mean(axis=0)
    s1 = np.cov(gt, rowvar=False)
    s2 = np.cov(gen, rowvar=False)
    fad = frechet_distance(mu1, s1, mu2, s2)
    return fad, {"mu_gt": mu1, "mu_gen": mu2, "cov_gt": s1, "cov_gen": s2}


def compute_ndb(
    gt_files, gen_files, K: int = 50,
    embed_fn: Optional[EmbedFn] = None, alpha: float = 0.05, sr: int = 22050,
) -> Dict:
    from scipy.stats import norm
    from sklearn.cluster import KMeans

    gt = _embeddings(gt_files, embed_fn, sr)
    gen = _embeddings(gen_files, embed_fn, sr)
    n_gt, n_gen = len(gt), len(gen)
    k_use = min(K, n_gt)
    km = KMeans(n_clusters=k_use, random_state=0, n_init=10).fit(gt)
    counts_gt = np.bincount(km.predict(gt), minlength=k_use)
    counts_gen = np.bincount(km.predict(gen), minlength=k_use)
    p_gt = counts_gt / n_gt
    p_gen = counts_gen / n_gen

    pvals = np.ones(k_use)
    sig = np.zeros(k_use, dtype=bool)
    for i in range(k_use):
        pooled = (counts_gt[i] + counts_gen[i]) / (n_gt + n_gen)
        se = np.sqrt(pooled * (1 - pooled) * (1 / n_gt + 1 / n_gen))
        if se == 0:
            continue
        z = (p_gen[i] - p_gt[i]) / se
        pvals[i] = 2.0 * (1.0 - norm.cdf(abs(z)))
        sig[i] = pvals[i] < alpha
    return {
        "ndb": int(sig.sum()),
        "sig_mask": sig,
        "pvals": pvals,
        "counts_gt": counts_gt,
        "counts_gen": counts_gen,
        "centers": km.cluster_centers_,
    }


def _kl(p, q, eps=1e-12):
    p = np.asarray(p, dtype=np.float64) + eps
    q = np.asarray(q, dtype=np.float64) + eps
    return float(np.sum(p * np.log(p / q)))


def _js(p, q, eps=1e-12):
    p = np.asarray(p, dtype=np.float64) + eps
    q = np.asarray(q, dtype=np.float64) + eps
    m = 0.5 * (p + q)
    return 0.5 * (_kl(p, m) + _kl(q, m))


def compute_js_kl(
    gt_files, gen_files, embed_fn: Optional[EmbedFn] = None,
    bins: int = 100, sr: int = 22050,
) -> Dict:
    gt = _embeddings(gt_files, embed_fn, sr)
    gen = _embeddings(gen_files, embed_fn, sr)
    js_d: List[float] = []
    kl_d: List[float] = []
    for d in range(gt.shape[1]):
        a, b = gt[:, d], gen[:, d]
        lo, hi = min(a.min(), b.min()), max(a.max(), b.max())
        if lo == hi:
            js_d.append(0.0)
            kl_d.append(0.0)
            continue
        ha, _ = np.histogram(a, bins=bins, range=(lo, hi), density=True)
        hb, _ = np.histogram(b, bins=bins, range=(lo, hi), density=True)
        ha = ha / (ha.sum() + 1e-12)
        hb = hb / (hb.sum() + 1e-12)
        kl_d.append(_kl(ha, hb))
        js_d.append(_js(ha, hb))
    return {
        "js_per_dim": np.asarray(js_d),
        "kl_per_dim": np.asarray(kl_d),
        "js_mean": float(np.mean(js_d)),
        "kl_mean": float(np.mean(kl_d)),
    }


def _cosine_sim(a: np.ndarray, b: np.ndarray) -> float:
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    if na == 0 or nb == 0:
        return 0.0
    return float(a @ b / (na * nb))


def compute_pairwise_cosine(
    gt_files, gen_files, embed_fn: Optional[EmbedFn] = None, sr: int = 22050
) -> Dict:
    fn = embed_fn or (lambda p: embed_file(p, sr=sr))
    sims = np.array(
        [_cosine_sim(np.asarray(fn(g), np.float64), np.asarray(fn(s), np.float64))
         for g, s in zip(gt_files, gen_files)]
    )
    return {"per_sample": sims, "mean": float(sims.mean()), "std": float(sims.std())}


def compute_va_metrics(gt_va, gen_va) -> Dict:
    gt = np.asarray(gt_va, dtype=np.float64)
    gen = np.asarray(gen_va, dtype=np.float64)
    if gt.shape != gen.shape:
        raise ValueError("gt_va and gen_va must have the same shape")
    dists = np.linalg.norm(gt - gen, axis=1)
    cosims = np.array(
        [0.0 if (np.allclose(a, 0) or np.allclose(b, 0)) else _cosine_sim(a, b)
         for a, b in zip(gt, gen)]
    )
    return {
        "per_sample_dist": dists,
        "dist_mean": float(dists.mean()),
        "per_sample_cosine": cosims,
        "cosine_mean": float(cosims.mean()),
    }


class CLAPEvaluator:
    """LAION-CLAP semantic similarity — optional heavy dependency.

    ``ckpt`` points at a local CLAP checkpoint file for zero-egress hosts;
    without it, ``load_ckpt()`` downloads the default 630k-sample model
    (the reference behavior, ``reference/metrics/clap.py:7-14``).
    """

    def __init__(self, device: str = "cpu", ckpt: Optional[str] = None):
        import laion_clap  # gated: not a dependency of the package; raises cleanly

        self.model = laion_clap.CLAP_Module(enable_fusion=False)
        if ckpt:
            self.model.load_ckpt(ckpt)
        else:
            self.model.load_ckpt()
        self.model.eval()

    def compute_metrics(self, gt_files, gen_files) -> Dict:
        import numpy as _np

        gt = self.model.get_audio_embedding_from_filelist(x=list(gt_files))
        gen = self.model.get_audio_embedding_from_filelist(x=list(gen_files))
        gt = gt.cpu().numpy() if hasattr(gt, "cpu") else _np.asarray(gt)
        gen = gen.cpu().numpy() if hasattr(gen, "cpu") else _np.asarray(gen)
        sims = _np.array([_cosine_sim(a, b) for a, b in zip(gt, gen)])
        return {"per_sample": sims, "mean": float(sims.mean()), "std": float(sims.std())}
