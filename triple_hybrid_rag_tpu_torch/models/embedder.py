"""Hash embedders: text -> fixed-dim vectors for the dense channel and MaxSim tokens.

Copies of the JAX package's ``HashEmbedder`` and ``BowHashEmbedder`` (text only), so a
query embeds to the same numpy vector on both sides. :func:`get_default_embedder`
resolves ``embedder_backend`` as the reference does: "auto" and "encoder" load the
trained encoder (``models/encoder.py``) from the packaged weights.
:class:`FailSoftEmbedder` is the ingestion side's degradation ladder.
"""

from __future__ import annotations

import hashlib
from typing import List, Optional, Sequence

import numpy as np

from ..analyzer import Analyzer
from ..config import RAGConfig, get_settings


def _seed_from(text: str) -> int:
    return int.from_bytes(hashlib.sha256(text.encode("utf-8")).digest()[:8], "little")


class HashEmbedder:
    """Deterministic per-text Gaussian embedding."""

    def __init__(self, dim: int = 2048) -> None:
        self.dim = dim

    def _one(self, text: str) -> np.ndarray:
        g = np.random.default_rng(_seed_from(text))
        v = g.standard_normal(self.dim).astype(np.float32)
        n = np.linalg.norm(v)
        return v / n if n > 0 else v

    def embed_texts(self, texts: Sequence[str]) -> np.ndarray:
        if not texts:
            return np.zeros((0, self.dim), np.float32)
        return np.stack([self._one(t) for t in texts])

    def embed_query(self, text: str) -> np.ndarray:
        return self._one(text)


class BowHashEmbedder:
    """Bag-of-words hash embedding: each token hashes to a fixed Gaussian direction and
    a text embeds as the L2-normalized tf-weighted sum, so texts sharing vocabulary
    are cosine-similar without trained weights."""

    def __init__(self, dim: int = 2048, config: Optional[RAGConfig] = None) -> None:
        self.dim = dim
        self.config = config or get_settings()
        self._analyzer = Analyzer(self.config)
        self._token_cache: dict[str, np.ndarray] = {}
        self._mtok_cache: dict[tuple, np.ndarray] = {}  # (dim, token) -> unit vec
        self._tok_cache: dict[str, tuple] = {}  # short-text tokenization memo

    def _tok(self, text: str) -> tuple:
        if len(text) > 512:
            return tuple(self._analyzer.tokenize(text))
        toks = self._tok_cache.get(text)
        if toks is None:
            if len(self._tok_cache) > 8192:
                self._tok_cache.clear()
            toks = tuple(self._analyzer.tokenize(text))
            self._tok_cache[text] = toks
        return toks

    def _token_vec(self, token: str) -> np.ndarray:
        v = self._token_cache.get(token)
        if v is None:
            if len(self._token_cache) > 65536:
                self._token_cache.clear()
            g = np.random.default_rng(_seed_from("tok\x00" + token))
            v = g.standard_normal(self.dim).astype(np.float32)
            v /= np.linalg.norm(v)
            self._token_cache[token] = v
        return v

    def _one(self, text: str) -> np.ndarray:
        tokens = self._tok(text)
        if not tokens:
            return np.zeros(self.dim, np.float32)
        acc = np.zeros(self.dim, np.float32)
        for t in tokens:
            acc += self._token_vec(t)
        n = np.linalg.norm(acc)
        return acc / n if n > 0 else acc

    def embed_texts(self, texts: Sequence[str]) -> np.ndarray:
        if not texts:
            return np.zeros((0, self.dim), np.float32)
        return np.stack([self._one(t) for t in texts])

    def embed_query(self, text: str) -> np.ndarray:
        v = self._one(text)
        if not np.any(v):
            raise ValueError(f"query produced no tokens to embed: {text!r}")
        return v

    def mtok_vec(self, token: str, dim: int) -> np.ndarray:
        """Unit MaxSim token vector of one analyzer token."""
        key = (dim, token)
        v = self._mtok_cache.get(key)
        if v is None:
            if len(self._mtok_cache) > 65536:
                self._mtok_cache.clear()
            g = np.random.default_rng(_seed_from(f"mtok{dim}\x00" + token))
            v = g.standard_normal(dim).astype(np.float32)
            v /= np.linalg.norm(v)
            self._mtok_cache[key] = v
        return v

    def token_embeddings(
        self, texts: Sequence[str], max_tokens: Optional[int] = None, dim: Optional[int] = None
    ) -> np.ndarray:
        """f32[N, T, dim] per-token unit hash embeddings for MaxSim late interaction."""
        t = max_tokens or self.config.maxsim_doc_tokens
        d = dim or self.config.maxsim_dim
        out = np.zeros((len(texts), t, d), np.float32)
        for i, text in enumerate(texts):
            for j, tok in enumerate(self._tok(text)[:t]):
                out[i, j] = self.mtok_vec(tok, d)
        return out


def get_default_embedder(config: Optional[RAGConfig] = None, device=None):
    """Resolve ``config.embedder_backend`` to an embedder.

    "auto" prefers the packaged trained encoder, built on ``device`` (CUDA unless
    ``device="cpu"``), and falls back to :class:`BowHashEmbedder` only when the
    weights are absent or unreadable; "encoder" requires the weights and raises
    without them; "bowhash" and "hash" are the hash embedders."""
    cfg = config or get_settings()
    backend = cfg.embedder_backend
    if backend in ("auto", "encoder"):
        from .pretrain import load_default_encoder

        enc = load_default_encoder(cfg, device=device)
        if enc is not None:
            return enc
        if backend == "encoder":
            raise RuntimeError(
                "embedder_backend='encoder' but no packaged weights were found "
                "(triple_hybrid_rag_tpu/models/data/encoder.npz, or encoder_params_path)"
            )
    if backend == "hash":
        return HashEmbedder(dim=cfg.embedding_dim_full)
    return BowHashEmbedder(dim=cfg.embedding_dim_full, config=cfg)


class FailSoftEmbedder:
    """Wrapper adding the reference's degradation ladder to any embedder: a failed
    bulk embed is retried item by item, and an item that still fails becomes a zero
    vector whose index is recorded in ``last_errors`` (reset by each bulk call).
    A caller that must not serve zero rows (a device failure would otherwise turn
    into them silently) checks ``last_errors`` after each call. Query embeds
    raise."""

    def __init__(self, inner) -> None:
        self.inner = inner
        self.dim = inner.dim
        self.last_errors: List[int] = []

    def embed_texts(self, texts: Sequence[str]) -> np.ndarray:
        self.last_errors = []
        try:
            return self.inner.embed_texts(texts)
        except Exception:
            out = np.zeros((len(texts), self.dim), np.float32)
            for i, t in enumerate(texts):
                try:
                    out[i] = self.inner.embed_query(t)
                except Exception:
                    self.last_errors.append(i)
            return out

    def embed_query(self, text: str) -> np.ndarray:
        return self.inner.embed_query(text)

    def __getattr__(self, name: str):
        # the inner embedder's other capabilities (token_embeddings,
        # maxsim_calibration, encode_queries_device, ...)
        return getattr(self.inner, name)
