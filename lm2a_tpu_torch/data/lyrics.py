"""Lyric-text embedding: RoBERTa when available, deterministic fallback
(port of ``lm2a_tpu/data/lyrics.py``).

The reference embeds each lyric slice with HuggingFace roberta-base
(tokenize with truncation at 128, mean-pool the last hidden state -> 768-d,
tile over the mel time axis; ``reference/preprocess.py:15-18,64-71``).

RoBERTa's weights are not shipped with the repository, so the embedder is
pluggable:

- ``RobertaLyricsEmbedder`` — the real thing, used when ``transformers``
  is installed and the weights resolve (from a local HF cache or an explicit
  ``model_path``); it runs on the device it is given.
- ``HashedLyricsEmbedder`` — a deterministic offline stand-in: each
  lowercase token hashes to a fixed Gaussian 768-d vector (seeded by the
  hash), mean-pooled. It is NOT semantically meaningful — it exists so the
  full preprocess -> train -> sample pipeline runs end-to-end hermetically
  and so npz schemas stay identical. Swap in RoBERTa for real runs.
"""

from __future__ import annotations

import hashlib
import re
from typing import Optional, Protocol

import numpy as np
import torch

EMBED_DIM = 768


class LyricsEmbedder(Protocol):
    def embed(self, text: str) -> np.ndarray:  # (768,) float32
        ...


class HashedLyricsEmbedder:
    """Deterministic token-hash embedding (offline fallback, non-semantic)."""

    def __init__(self, dim: int = EMBED_DIM):
        self.dim = dim
        self._cache: dict = {}

    def _token_vec(self, tok: str) -> np.ndarray:
        v = self._cache.get(tok)
        if v is None:
            seed = int.from_bytes(hashlib.sha256(tok.encode()).digest()[:8], "little")
            v = np.random.default_rng(seed).standard_normal(self.dim).astype(np.float32)
            v /= np.sqrt(self.dim)
            self._cache[tok] = v
        return v

    def embed(self, text: str) -> np.ndarray:
        toks = re.findall(r"\w+", (text or "").lower())[:128]
        if not toks:
            return np.zeros(self.dim, dtype=np.float32)
        return np.mean([self._token_vec(t) for t in toks], axis=0).astype(np.float32)


class RobertaLyricsEmbedder:
    """roberta-base mean-pooled last hidden state (the reference convention),
    on ``device``."""

    def __init__(self, model_path: str = "roberta-base", device="cpu"):
        from transformers import RobertaModel, RobertaTokenizer

        self.device = torch.device(device)
        self.tokenizer = RobertaTokenizer.from_pretrained(model_path)
        self.model = RobertaModel.from_pretrained(model_path).to(self.device)
        self.model.eval()

    def embed(self, text: str) -> np.ndarray:
        toks = self.tokenizer(
            text or "", return_tensors="pt", truncation=True, max_length=128
        )
        with torch.no_grad():
            out = self.model(**{k: v.to(self.device) for k, v in toks.items()})
        return out.last_hidden_state.mean(dim=1)[0].float().cpu().numpy().astype(np.float32)


def get_lyrics_embedder(
    backend: str = "auto", model_path: Optional[str] = None, device="cpu"
) -> LyricsEmbedder:
    """'roberta' | 'hashed' | 'auto' (roberta if weights resolve, else hashed)."""
    if backend == "hashed":
        return HashedLyricsEmbedder()
    if backend == "roberta":
        return RobertaLyricsEmbedder(model_path or "roberta-base", device)
    if backend == "auto":
        import os

        # Fail fast when the hub is unreachable: without this, transformers
        # retries huggingface.co with exponential backoff (~minutes of dead
        # time per preprocess run in an offline image) before the fallback
        # engages. An explicit --lyrics_backend roberta still goes online.
        prev = os.environ.get("HF_HUB_OFFLINE")
        if model_path is None and prev is None:
            os.environ["HF_HUB_OFFLINE"] = "1"
        try:
            return RobertaLyricsEmbedder(model_path or "roberta-base", device)
        except Exception:
            print("lyrics: roberta-base unavailable, using hashed fallback embedder")
            return HashedLyricsEmbedder()
        finally:
            if model_path is None and prev is None:
                os.environ.pop("HF_HUB_OFFLINE", None)
    raise ValueError(f"unknown lyrics backend {backend!r}")


def tile_lyrics_embedding(emb: np.ndarray, mel_t: int) -> np.ndarray:
    """(768,) -> (mel_T, 768), the tiling of preprocess.py:70-71."""
    return np.tile(emb[None, :], (mel_t, 1)).astype(np.float32)
