"""Embedder ``bowhash`` (plain side): the BowHash query vector and MaxSim query
tokens, restated from the reference system's ``models/embedder.py``
``BowHashEmbedder`` and ``retrieval.maxsim_query_weights`` for the texts the traffic
makes. The batched entry sends both across the wire as float16."""

from __future__ import annotations

import numpy as np

from perfbench.lib.hashing import maxsim_direction, token_direction
from perfbench.reference.text import TextRules

FUNCTION_WORD_WEIGHT = 0.25


def query_vector(text: str, rules: TextRules, dim_full: int, dim: int) -> np.ndarray:
    """f32[dim]: the BowHash embedding (the sum of the tokens' unit directions,
    normalized), Matryoshka-truncated to ``dim`` and normalized again."""
    tokens = rules.tokenize(text)
    acc = np.zeros(dim_full, np.float32)
    for t in tokens:
        acc += token_direction(t, dim_full)
    norm = np.linalg.norm(acc)
    v = acc / norm if norm > 0 else acc
    v = np.asarray(v[None], np.float32)[..., :dim]
    return (v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-12))[0]


def query_tokens(text: str, rules: TextRules, n_tokens: int, dim: int):
    """(f32[T, dim] MaxSim query tokens, f32[T] weights): one unit vector per
    analyzer token (the first ``n_tokens``), function words weighted 0.25."""
    tokens = rules.tokenize(text)[:n_tokens]
    vecs = np.zeros((n_tokens, dim), np.float32)
    weights = np.zeros((n_tokens,), np.float32)
    fw = rules.function_words()
    for j, t in enumerate(tokens):
        vecs[j] = maxsim_direction(t, dim)
        weights[j] = FUNCTION_WORD_WEIGHT if t in fw else 1.0
    return vecs, weights


class Embedder:
    def __init__(self, ref) -> None:
        self.rules = ref.rules
        self.cfg = ref.cfg

    def vector(self, text: str, path: str) -> np.ndarray:
        v = query_vector(text, self.rules, self.cfg["embedding_dim_full"], self.cfg["embedding_dim"])
        return v.astype(np.float16).astype(np.float32) if path == "batch" else v

    def tokens(self, text: str, path: str):
        vecs, w = query_tokens(text, self.rules, self.cfg["maxsim_query_tokens"], self.cfg["maxsim_dim"])
        if path == "batch":
            vecs = vecs.astype(np.float16).astype(np.float32)
        return vecs, w


def build(ref, seed: int) -> Embedder:
    return Embedder(ref)
