"""The plain reference of the retrieval that the timed path serves: for each query,
the three channels over the whole corpus, weighted fusion, parent expansion, the
configuration's rerank and the safety gate, in plain PyTorch and NumPy.

It imports nothing of the program and reads only the benchmark's inputs (the
corpus of ``lib/generator.py``). What the program derives from them it works out
again: the int8 rows and their scales, the query plans, the BM25 term selection.
The configuration's query embedder and reranker are the plain sides of its model
plug-ins (``reference/models/<name>.py``, found by ``lib/cell.models``), built
from the run's seed. Scans run over the corpus in blocks of rows on the given
device; float32 products stay float32 (TF32 off).

The two entries differ in a few stated ways, which ``path`` selects:

* ``batch`` (``Engine.retrieve_batch``): the query vector and tokens cross the
  wire as float16; the lexical channel scores the terms of stored df at most
  ``bm25_small_window`` and the ``bm25_large_slots`` rarest of the others; graph
  seeds are three lookups per entity name (or keyword), at most
  ``graph_max_seeds``.
* ``staged`` (``Retriever.retrieve``): float32 query vector and tokens; every
  query term scored; three seeds per entity name, else two per keyword.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..lib.cell import Model, models as find_models
from ..lib.generator import Corpus
from . import text as T

NEG = float("-inf")
ROW_BLOCK = 1 << 17
INT8_LEVELS = 127.0


def quantize_rows_int8(rows: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row absmax int8 (round half to even); all-zero rows scale 1."""
    m = rows.float()
    absmax = m.abs().amax(dim=1)
    scale = torch.where(absmax > 0, absmax / INT8_LEVELS, torch.ones_like(absmax))
    codes = torch.clamp(torch.round(m / scale[:, None]), -INT8_LEVELS, INT8_LEVELS)
    return codes.to(torch.int8), scale


def quantize_query_int8(q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-query symmetric absmax int8 codes (as f32 values) and f32 scales [B, 1]."""
    q = q.float()
    scale = torch.clamp(q.abs().amax(dim=1, keepdim=True), min=1e-12) / INT8_LEVELS
    return torch.clamp(torch.round(q / scale), -INT8_LEVELS, INT8_LEVELS), scale


def top_desc(scores: torch.Tensor, ok: torch.Tensor, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """The ``k`` best entries of ``ok`` by score, ties to the lowest index, padded
    with id -1 / score -inf."""
    masked = torch.where(ok, scores, torch.full_like(scores, NEG))
    vals, idx = torch.sort(masked, descending=True, stable=True)
    vals, idx = vals[:k].cpu().numpy(), idx[:k].cpu().numpy()
    live = vals > NEG
    ids = np.full(k, -1, np.int64)
    out = np.full(k, NEG, np.float32)
    ids[: live.sum()] = idx[live]
    out[: live.sum()] = vals[live]
    return ids, out


@dataclass
class Channel:
    """One channel's whole-corpus scores and its top-k list."""

    full: Optional[torch.Tensor]  # f32[n_pad] (None: the channel did not run)
    hit: Optional[torch.Tensor]  # bool[n_pad]: rows the channel can return
    ids: np.ndarray  # i64[k], -1 pads
    scores: np.ndarray  # f32[k], -inf pads


@dataclass
class Answer:
    """The reference's answer to one query."""

    channels: Dict[str, Channel]
    cand: Dict[int, dict]  # row -> rrf, lexical, semantic, graph, rerank, order, bits
    final: List[Tuple[int, float]]  # (row, order score), best first
    refused: bool
    max_score: float


class Reference:
    """The reference over one corpus and configuration, on ``device``, with the
    configuration's ``models`` (default: the plug-ins its file names) built from
    ``seed``."""

    def __init__(self, corpus: Corpus, config: dict, device, seed: int = 0,
                 models: Optional[Dict[str, Model]] = None) -> None:
        torch.backends.cuda.matmul.allow_tf32 = False  # float32 products stay float32
        torch.backends.cudnn.allow_tf32 = False
        self.c = corpus
        self.cfg = dict(config["rag_config"])
        self.dev = torch.device(device)
        self.rules = T.TextRules(self.cfg["analyzer_min_token_len"], self.cfg["analyzer_stemming"])
        self.entities = T.EntityIndex(corpus.entity_names())
        self.vocab = {t: i for i, t in enumerate(corpus.vocab)}
        self.dtype = self.cfg["embedding_dtype"]
        self.lengths = corpus.lengths.cpu().numpy()
        self.offsets = corpus.offsets.cpu().numpy()
        self.idf = corpus.idf.cpu().numpy()
        self.nbr = corpus.nbr.to(self.dev).long()
        self.ce = corpus.chunk_entities.to(self.dev).long()
        self.parent_of = corpus.parent_of.to(self.dev).long()
        self.valid = corpus.valid.to(self.dev)
        plugins = models if models is not None else find_models(config)
        self.embedder = plugins["embedder"].reference.build(self, seed)
        self.reranker = plugins["reranker"].reference.build(self, seed)

    # ------------------------------------------------------------ query side

    def plan(self, text: str) -> T.Plan:
        return T.plan(text, self.rules, self.cfg)

    def vector(self, text: str, path: str) -> np.ndarray:
        """f32[D]: the embedder's query vector as ``path`` sends it."""
        return self.embedder.vector(text, path)

    def tokens(self, text: str, path: str):
        """(f32[T, Dm] query tokens, f32[T] weights): the embedder's, as ``path`` sends them."""
        return self.embedder.tokens(text, path)

    def terms(self, keywords: Sequence[str], path: str) -> List[int]:
        """The scored term ids: the known keywords, each once (up to
        ``max_query_terms``); the batch path keeps all of stored df at most
        ``bm25_small_window`` and the ``bm25_large_slots`` of highest idf of the rest."""
        ids: List[int] = []
        for kw in keywords:
            t = self.vocab.get(kw, -1)
            if t >= 0 and t not in ids:
                ids.append(t)
            if len(ids) >= self.cfg["max_query_terms"]:
                break
        if path == "staged" or not self.cfg["lexical_tiering"]:
            return ids
        small = [t for t in ids if self.lengths[t] <= self.cfg["bm25_small_window"]]
        large = sorted((t for t in ids if self.lengths[t] > self.cfg["bm25_small_window"]),
                       key=lambda t: -float(self.idf[t]))
        return small + large[: self.cfg["bm25_large_slots"]]

    def seeds(self, p: T.Plan, path: str) -> List[int]:
        if not p.requires_graph:
            return []
        out: List[int] = []
        if path == "batch":
            for name in p.entities or p.keywords:
                for row in self.entities.lookup(name)[:3]:
                    if len(out) < self.cfg["graph_max_seeds"]:
                        out.append(row)
                if len(out) >= self.cfg["graph_max_seeds"]:
                    break
            return out
        for name in p.entities:
            out += self.entities.lookup(name)[:3]
        if not out:
            for kw in p.keywords:
                out += self.entities.lookup(kw)[:2]
        return out

    # ------------------------------------------------------------ channels

    def dense_scores(self, qs: np.ndarray) -> torch.Tensor:
        """f32[Q, n_pad] cosine scores of the stated row type against queries
        f32[Q, D]: bf16 rows against the queries rounded to bf16, or int8 rows
        (quantized here) against int8 queries, ``(acc * row scale) * q scale``."""
        q = torch.from_numpy(qs).to(self.dev)
        rows = self.c.rows
        out = torch.empty((q.shape[0], rows.shape[0]), dtype=torch.float32, device=self.dev)
        if self.dtype == "int8":
            q_codes, q_scale = quantize_query_int8(q)
        else:
            q_b = q.to(torch.bfloat16).float()
        for lo in range(0, rows.shape[0], ROW_BLOCK):
            blk = rows[lo:lo + ROW_BLOCK].to(self.dev)
            if self.dtype == "int8":
                codes, scale = quantize_rows_int8(blk)
                acc = q_codes @ codes.float().T  # exact: integer sums below 2**24
                out[:, lo:lo + ROW_BLOCK] = acc * scale[None, :] * q_scale
            else:
                out[:, lo:lo + ROW_BLOCK] = q_b @ blk.float().T
        return out

    def lexical(self, term_ids: Sequence[int]) -> Channel:
        n_pad = self.c.n_pad
        score = torch.zeros(n_pad, dtype=torch.float32, device=self.dev)
        hit = torch.zeros(n_pad, dtype=torch.bool, device=self.dev)
        for t in term_ids:
            lo, ln = int(self.offsets[t]), int(self.lengths[t])
            docs = self.c.postings_doc[lo:lo + ln].to(self.dev).long()
            score.index_add_(0, docs, self.c.postings_weight[lo:lo + ln].to(self.dev))
            hit[docs] = True
        ids, vals = top_desc(score, hit, self.cfg["lexical_top_k"])
        return Channel(score, hit, ids, vals)

    def semantic(self, scores: torch.Tensor, q: np.ndarray) -> Channel:
        k = self.cfg["semantic_top_k"]
        if not np.any(q):
            return Channel(None, None, np.full(k, -1, np.int64), np.full(k, NEG, np.float32))
        hit = self.valid & (scores > -2.0)
        ids, vals = top_desc(scores, hit, k)
        return Channel(scores, hit, ids, vals)

    def graph(self, seeds: Sequence[int]) -> Channel:
        k = self.cfg["graph_top_k"]
        if not seeds:
            return Channel(None, None, np.full(k, -1, np.int64), np.full(k, NEG, np.float32))
        e_pad, hops = self.nbr.shape[0], self.cfg["graph_hops"]
        dist = torch.full((e_pad,), float("inf"), device=self.dev)
        dist[torch.tensor(list(seeds), device=self.dev)] = 0.0
        live = self.nbr >= 0
        for _ in range(hops):  # an entity is one hop further than its nearest listed neighbour
            near = torch.where(live, dist[self.nbr.clamp(min=0)], torch.full_like(live, float("inf"), dtype=torch.float32))
            dist = torch.minimum(dist, near.amin(dim=1) + 1.0)
        ent = torch.where(dist <= hops, 1.0 / (1.0 + dist), torch.zeros_like(dist))
        ok = self.ce >= 0
        chunk = torch.where(ok, ent[self.ce.clamp(min=0)], torch.zeros(ok.shape, device=self.dev)).amax(dim=1)
        hit = chunk > 0.0
        ids, vals = top_desc(chunk, hit, k)
        return Channel(chunk, hit, ids, vals)

    # ------------------------------------------------------------ fusion and tail

    def fuse(self, chans: Sequence[Channel], weights: np.ndarray):
        """Weighted fusion of the three lists (lexical, semantic, graph): CombSUM of
        per-list min-max scores blended with reciprocal-rank fusion by
        ``fusion_score_blend``, the semantic weight scaled down by the lexical
        top-2 margin; first occurrences kept; the best ``rerank_top_k``, ties to
        the earliest list position."""
        cfg = self.cfg
        f32 = np.float32
        w = weights.astype(f32).copy()
        lex = chans[0]
        gate = cfg["fusion_lex_conf_gate"]
        if gate > 0.0:
            n_lex = int((lex.ids >= 0).sum())
            s0, s1 = f32(lex.scores[0]), f32(lex.scores[1])
            margin = (s0 - s1) / max(s0, f32(1e-9)) if n_lex >= 2 else f32(0.0)
            w[1] = w[1] * (f32(1.0) - f32(min(f32(gate) * max(margin, f32(0.0)), f32(1.0))))
        cand = np.concatenate([c.ids for c in chans])
        kt = cand.shape[0]
        rrf = np.zeros(kt, f32)
        ssum = np.zeros(kt, f32)
        raw, bits = [], np.zeros(kt, np.int32)
        for ci, ch in enumerate(chans):
            pos = {}
            for r, i in enumerate(ch.ids):
                if i >= 0 and int(i) not in pos:
                    pos[int(i)] = r
            ok = ch.ids >= 0
            lo, hi = (ch.scores[ok].min(), ch.scores[ok].max()) if ok.any() else (f32(0), f32(0))
            span = f32(hi - lo)
            norm = np.where(ok, (ch.scores - lo) / span if span > 0 else f32(1.0), f32(0.0)).astype(f32)
            r_raw = np.zeros(kt, f32)
            for j, cid in enumerate(cand):
                r = pos.get(int(cid)) if cid >= 0 else None
                if r is None:
                    continue
                rrf[j] = rrf[j] + w[ci] / (f32(cfg["rrf_k"]) + f32(r) + f32(1.0))
                if cfg["fusion_score_blend"] > 0.0:
                    ssum[j] = ssum[j] + w[ci] * norm[r]
                r_raw[j] = ch.scores[r]
                bits[j] |= 1 << ci
            raw.append(r_raw)
        first = {}
        for j, cid in enumerate(cand):
            if cid >= 0 and int(cid) not in first:
                first[int(cid)] = j
        valid = np.array([cid >= 0 and first[int(cid)] == j for j, cid in enumerate(cand)])
        s = f32(cfg["fusion_score_blend"])
        if s > 0.0:
            r_max = max(rrf[valid].max() if valid.any() else f32(0), f32(0))
            s_max = max(ssum[valid].max() if valid.any() else f32(0), f32(0))
            rrf = ((f32(1.0) - s) * rrf / max(r_max, f32(1e-12)) + s * ssum / max(s_max, f32(1e-12))).astype(f32)
        key = np.where(valid, rrf, f32(NEG))
        order = sorted(range(kt), key=lambda j: (-key[j], j))[: cfg["rerank_top_k"]]
        order = [j for j in order if valid[j]]
        return [
            {"row": int(cand[j]), "rrf": float(rrf[j]), "lexical": float(raw[0][j]),
             "semantic": float(raw[1][j]), "graph": float(raw[2][j]), "bits": int(bits[j])}
            for j in order
        ]

    def answer(self, text: str, path: str, dense_row: torch.Tensor) -> Answer:
        """The reference's answer to ``text`` through ``path``; ``dense_row`` is the
        query's row of :meth:`dense_scores`."""
        cfg = self.cfg
        f32 = np.float32
        p = self.plan(text)
        qv = self.vector(text, path)
        chans = {
            "lexical": self.lexical(self.terms(p.keywords, path)) if p.keywords else
            Channel(None, None, np.full(cfg["lexical_top_k"], -1, np.int64), np.full(cfg["lexical_top_k"], NEG, np.float32)),
            "semantic": self.semantic(dense_row, qv),
            "graph": self.graph(self.seeds(p, path)),
        }
        if cfg.get("conformal_denoise_enabled"):
            raise NotImplementedError("the reference does not model conformal denoising")
        weights = np.array([p.weights["lexical"], p.weights["semantic"], p.weights["graph"]], np.float32)
        fused = self.fuse([chans[c] for c in ("lexical", "semantic", "graph")], weights)
        rows = np.array([f["row"] for f in fused], np.int64)
        parents = self.parent_of[torch.from_numpy(rows).to(self.dev)].cpu().numpy() if rows.size else rows
        rrf = np.array([f["rrf"] for f in fused], f32)
        rerank = np.asarray(self.reranker.scores(text, path, parents, rrf), f32)
        if rrf.size:
            lo, hi = rrf.min(), rrf.max()
            norm = ((rrf - lo) / (hi - lo) if hi - lo > 0 else np.ones_like(rrf)).astype(f32)
        else:
            norm = rrf
        relational = p.requires_graph and p.intent in ("relational", "entity_lookup")
        b = cfg["rerank_blend_rrf_relational"] if relational else cfg["rerank_blend_rrf"]
        if path == "batch":  # the blend weight travels as float32
            bw = f32(b)
            order = ((f32(1.0) - bw) * rerank + bw * norm).astype(f32)
        else:  # a Python float scalar against float32 scores
            order = (f32(1.0 - b) * rerank + f32(b) * norm).astype(f32)
        max_score = float(rerank.max()) if rerank.size else 0.0
        threshold = cfg["safety_threshold"] if cfg["safety_enabled"] else NEG
        refused = rerank.size == 0 or max_score < threshold
        alpha = cfg["denoise_alpha"] if cfg["denoise_enabled"] else 0.0
        cutoff = min(f32(alpha) * f32(max_score), f32(max_score))
        keep = [j for j in range(len(fused)) if rerank[j] >= cutoff and not refused]
        best = sorted(keep, key=lambda j: (-order[j], j))[: cfg["final_top_k"]]
        cand = {}
        for j, f in enumerate(fused):
            cand[f["row"]] = {**f, "rerank": float(rerank[j]), "order": float(order[j])}
        return Answer(chans, cand, [(fused[j]["row"], float(order[j])) for j in best],
                      bool(refused), max_score)

    def answers(self, texts: Sequence[str], path: str, block: int = 64) -> List[Answer]:
        """The answers to ``texts``, the dense scan shared by ``block`` queries at a time."""
        out: List[Answer] = []
        for lo in range(0, len(texts), block):
            part = list(texts[lo:lo + block])
            scores = self.dense_scores(np.stack([self.vector(t, path) for t in part]))
            out += [self.answer(t, path, scores[i]) for i, t in enumerate(part)]
            del scores
        return out
