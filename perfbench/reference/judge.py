"""The comparison that decides ``correct``: the program's answers, as the timed path
returned them, against the plain reference's answers to the same texts.

Three numbers, each the widest over the sampled answers; a configuration's
``limits`` name the ones it compares (a number whose control reads no higher than
sound runs separates nothing and is left out there):

* ``channel_gap``: for every returned chunk, how far each per-channel score the
  program reports (lexical, semantic, graph) lies from the reference's score of
  that chunk, as a share of the reference's best score in that channel; a chunk
  the program puts in a channel's list though the reference ranks it below that
  list's last entry (or keeps out though the reference ranks it above) counts by
  that distance, and a chunk the channel cannot return counts 1. The rerank
  score against the reference reranker's score of the chunk's parent, as is
  (both lie in [0, 1]), counts here too.
* ``score_gap``: how far each returned chunk's fused score and final score lie
  from the reference's for the same chunk, and the reported maximum rerank score
  from the reference's; a chunk outside the reference's fused candidates, a
  refusal that differs or a list of another length counts 1.
* ``rank_gap``: by how much the reference's own score of the chunk the program
  returned at each position lies below the reference's best at that position (a
  tie of the reference reads about 0); a refusal that differs, a list of another
  length or a chunk outside the reference's candidates counts 1.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np

from .pipeline import Answer, Channel

CHANNELS = ("lexical", "semantic", "graph")
BITS = {"lexical": 1, "semantic": 2, "graph": 4}
NUMBERS = ("channel_gap", "score_gap", "rank_gap")


@dataclass
class Served:
    """One answer as the program returned it (the fields the comparison reads)."""

    text: str
    refused: bool
    max_score: float
    rows: List[int]
    final: List[float]
    lexical: List[float]
    semantic: List[float]
    graph: List[float]
    rrf: List[float]
    rerank: List[float]
    bits: List[int]


def served(result) -> Served:
    """The comparison's fields of a ``RetrievalResult``."""
    rs = result.results
    return Served(
        text=result.query, refused=bool(result.refused), max_score=float(result.max_score),
        rows=[int(r.chunk_id[1:]) for r in rs], final=[float(r.final_score) for r in rs],
        lexical=[float(r.lexical_score) for r in rs], semantic=[float(r.semantic_score) for r in rs],
        graph=[float(r.graph_score) for r in rs], rrf=[float(r.rrf_score) for r in rs],
        rerank=[float(r.rerank_score or 0.0) for r in rs],
        bits=[sum(BITS[c] for c in r.source_channels) for r in rs],
    )


def _channel_gap(ch: Channel, row: int, value: float, listed: bool) -> float:
    if ch.full is None:
        return 0.0 if not listed and value == 0.0 else 1.0
    live = ch.ids >= 0
    scale = max(abs(float(ch.scores[0])) if live.any() else 1.0, 1e-6)
    ref = float(ch.full[row])
    can = bool(ch.hit[row])
    full = bool(live.all())
    last = float(ch.scores[live][-1]) if live.any() else 0.0
    if listed:
        if not can:
            return 1.0
        gap = abs(value - ref) / scale
        if full and ref < last:
            gap = max(gap, (last - ref) / scale)
        return gap
    gap = abs(value) / scale
    if can and (not full or ref > last):
        gap = max(gap, (ref - last) / scale if full else 1.0)
    return gap


def compare(prog: Served, ref: Answer) -> Dict[str, float]:
    """The three gaps of one answer."""
    ch_gap = sc_gap = rk_gap = 0.0
    for j, row in enumerate(prog.rows):
        for c in CHANNELS:
            value = getattr(prog, c)[j]
            ch_gap = max(ch_gap, _channel_gap(ref.channels[c], row, value, bool(prog.bits[j] & BITS[c])))
        cand = ref.cand.get(row)
        if cand is None:
            sc_gap = rk_gap = 1.0
            continue
        ch_gap = max(ch_gap, abs(prog.rerank[j] - cand["rerank"]))
        sc_gap = max(sc_gap, abs(prog.final[j] - cand["order"]), abs(prog.rrf[j] - cand["rrf"]))
        if j < len(ref.final):
            rk_gap = max(rk_gap, min(1.0, ref.final[j][1] - cand["order"]))
    sc_gap = max(sc_gap, abs(prog.max_score - ref.max_score))
    if prog.refused != ref.refused or len(prog.rows) != len(ref.final):
        sc_gap = rk_gap = 1.0
    return {"channel_gap": ch_gap, "score_gap": sc_gap, "rank_gap": max(rk_gap, 0.0)}


def judge(progs: Sequence[Served], refs: Sequence[Answer]) -> Dict[str, dict]:
    """Each number's widest value over the answers, with the text that gave it."""
    out = {k: {"value": 0.0, "at": None} for k in NUMBERS}
    for p, r in zip(progs, refs):
        for k, v in compare(p, r).items():
            if v > out[k]["value"] or out[k]["at"] is None:
                out[k] = {"value": float(v), "at": p.text}
    return out


def sample(n_done: int, count: int, seed: int) -> np.ndarray:
    """Which of the ``n_done`` finished answers are compared: ``count`` drawn from
    the seed (all of them when fewer)."""
    if n_done <= count:
        return np.arange(n_done)
    return np.sort(np.random.default_rng([seed, 2]).choice(n_done, size=count, replace=False))
