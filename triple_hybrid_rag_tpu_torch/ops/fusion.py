"""Weighted RRF fusion, conformal denoising, min-max normalisation and the safety
gate, batched over a leading query axis.

The port of the JAX package's ``ops/fusion.py`` (which the JAX engine vmaps over the
batch). Every op works on fixed-width (ids, scores) rows where id -1 marks an
invalid slot. The float arithmetic follows the reference op by op, so scores agree
to the last few ulps and ids exactly.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .topk import NEG_INF, lax_top_k

LEXICAL_BIT = 1
SEMANTIC_BIT = 2
GRAPH_BIT = 4


class FusedCandidates(NamedTuple):
    """Fixed-width fused candidate sets [B, K], sorted by fused score descending."""

    ids: torch.Tensor  # i64[B, K] corpus rows, -1 invalid
    rrf: torch.Tensor  # f32[B, K] fused ordering score
    lexical: torch.Tensor  # f32[B, K] raw per-channel scores (0 when absent)
    semantic: torch.Tensor
    graph: torch.Tensor
    channels: torch.Tensor  # i32[B, K] source-channel bitmask


def minmax_normalize(ids: torch.Tensor, scores: torch.Tensor) -> torch.Tensor:
    """Per row: min-max normalise the valid scores to [0, 1]; all-equal maps to 1."""
    valid = ids >= 0
    inf = torch.tensor(float("inf"), device=scores.device)
    lo = torch.where(valid, scores, inf).amin(dim=-1, keepdim=True)
    hi = torch.where(valid, scores, -inf).amax(dim=-1, keepdim=True)
    span = hi - lo
    pos = span > 0
    normalized = torch.where(
        pos, (scores - lo) / torch.where(pos, span, torch.ones_like(span)), torch.ones_like(scores)
    )
    return torch.where(valid, normalized, torch.zeros_like(normalized))


def _rank_lookup(cand_ids, ch_ids, ch_scores):
    """For each candidate: (found, 0-based rank, raw score) in one channel's list."""
    eq = (cand_ids[:, :, None] == ch_ids[:, None, :]) & (ch_ids[:, None, :] >= 0)
    found = eq.any(dim=2)
    rank = eq.to(torch.uint8).argmax(dim=2)  # first match
    raw = torch.where(found, torch.gather(ch_scores, 1, rank), torch.zeros((), device=rank.device))
    return found, rank, raw


def fuse_rrf(
    lex_ids: torch.Tensor,
    lex_scores: torch.Tensor,
    sem_ids: torch.Tensor,
    sem_scores: torch.Tensor,
    graph_ids: torch.Tensor,
    graph_scores: torch.Tensor,
    weights: torch.Tensor,  # f32[B, 3] (lexical, semantic, graph)
    *,
    rrf_k: int = 60,
    top_k: int = 50,
    score_blend: float = 0.0,
    lex_conf_gate: float = 0.0,
) -> FusedCandidates:
    """Fuse three rank-ordered channels per query with weighted RRF (optionally
    blended with CombSUM of min-max scores), dedupe, sort, truncate to ``top_k``.
    ``lex_conf_gate`` scales the semantic weight down by the lexical top-2 margin."""
    dev = lex_ids.device
    cand_ids = torch.cat([lex_ids, sem_ids, graph_ids], dim=1).long()
    b, kt = cand_ids.shape
    weights = weights.float()
    zero = torch.zeros((), device=dev)

    if lex_conf_gate > 0.0:
        n_lex = (lex_ids >= 0).float().sum(dim=1)
        s0 = lex_scores[:, 0]
        s1 = lex_scores[:, 1] if lex_scores.shape[1] > 1 else torch.zeros_like(s0)
        margin = torch.where(n_lex >= 2.0, (s0 - s1) / torch.clamp(s0, min=1e-9), zero)
        g = 1.0 - torch.clamp(lex_conf_gate * torch.clamp(margin, min=0.0), max=1.0)
        ones = torch.ones_like(g)
        weights = weights * torch.stack([ones, g, ones], dim=1)

    rrf = torch.zeros((b, kt), dtype=torch.float32, device=dev)
    ssum = torch.zeros((b, kt), dtype=torch.float32, device=dev)
    raw_scores = []
    chan_bits = torch.zeros((b, kt), dtype=torch.int32, device=dev)
    for c, (bit, ch_ids, ch_scores) in enumerate(
        (
            (LEXICAL_BIT, lex_ids, lex_scores),
            (SEMANTIC_BIT, sem_ids, sem_scores),
            (GRAPH_BIT, graph_ids, graph_scores),
        )
    ):
        w = weights[:, c:c + 1]
        found, rank, raw = _rank_lookup(cand_ids, ch_ids.long(), ch_scores.float())
        rrf = rrf + torch.where(found, w / (rrf_k + rank.float() + 1.0), zero)
        if score_blend > 0.0:
            norm = minmax_normalize(ch_ids, ch_scores.float())
            ssum = ssum + torch.where(found, w * torch.gather(norm, 1, rank), zero)
        raw_scores.append(raw)
        chan_bits = chan_bits | torch.where(found, bit, 0).to(torch.int32)

    # dedupe: mask every occurrence after the first
    eq = cand_ids[:, :, None] == cand_ids[:, None, :]
    tri = torch.tril(torch.ones((kt, kt), dtype=torch.bool, device=dev), diagonal=-1)
    is_dup = (eq & tri).any(dim=2)
    valid = (cand_ids >= 0) & ~is_dup

    if score_blend > 0.0:
        s = float(score_blend)
        r_max = torch.where(valid, rrf, zero).amax(dim=1, keepdim=True)
        s_max = torch.where(valid, ssum, zero).amax(dim=1, keepdim=True)
        rrf = (1.0 - s) * rrf / torch.clamp(r_max, min=1e-12) + (
            s * ssum / torch.clamp(s_max, min=1e-12)
        )

    sort_key = torch.where(valid, rrf, torch.full_like(rrf, NEG_INF))
    k_sel = min(top_k, kt)
    _, order = lax_top_k(sort_key, k_sel)
    ok = torch.gather(valid, 1, order)
    if k_sel < top_k:
        order = torch.cat([order, order.new_zeros((b, top_k - k_sel))], 1)
        ok = torch.cat([ok, ok.new_zeros((b, top_k - k_sel))], 1)

    def take(x: torch.Tensor, fill) -> torch.Tensor:
        return torch.where(ok, torch.gather(x, 1, order), torch.full_like(x[:, :1], fill))

    return FusedCandidates(
        ids=take(cand_ids, -1),
        rrf=take(rrf, 0.0),
        lexical=take(raw_scores[0], 0.0),
        semantic=take(raw_scores[1], 0.0),
        graph=take(raw_scores[2], 0.0),
        channels=take(chan_bits, 0),
    )


class SafetyResult(NamedTuple):
    ids: torch.Tensor  # i64[B, top_k]
    scores: torch.Tensor  # f32[B, top_k]
    refused: torch.Tensor  # bool[B]
    max_score: torch.Tensor  # f32[B]


def apply_safety_denoise(
    ids: torch.Tensor,  # i[B, K]
    scores: torch.Tensor,  # f32[B, K] ordering scores
    threshold: torch.Tensor,  # f32[] refuse below
    alpha: torch.Tensor,  # f32[] keep gate >= alpha * max
    *,
    top_k: int,
    gate_scores: Optional[torch.Tensor] = None,
) -> SafetyResult:
    """Safety gate + alpha-max denoising per query. ``gate_scores`` (default
    ``scores``) drive refusal, the reported max and the keep mask; ``scores`` drive
    the final order."""
    gate = scores if gate_scores is None else gate_scores
    valid = ids >= 0
    max_score = torch.where(valid, gate, torch.full_like(gate, NEG_INF)).amax(dim=1)
    has_any = valid.any(dim=1)
    max_score = torch.where(has_any, max_score, torch.zeros_like(max_score))
    refused = ~has_any | (max_score < threshold)
    cutoff = torch.minimum(alpha * max_score, max_score)
    keep = valid & (gate >= cutoff[:, None]) & ~refused[:, None]
    key = torch.where(keep, scores, torch.full_like(scores, NEG_INF))
    vals, order = lax_top_k(key, top_k)
    ok = vals > NEG_INF
    return SafetyResult(
        ids=torch.where(ok, torch.gather(ids.long(), 1, order), torch.full_like(order, -1)),
        scores=torch.where(ok, vals, torch.zeros_like(vals)),
        refused=refused,
        max_score=max_score,
    )


def conformal_denoise_mask(
    ids: torch.Tensor, scores: torch.Tensor, alpha: torch.Tensor
) -> torch.Tensor:
    """Per query: keep scores >= percentile(valid scores, (1 - alpha) * 100) with
    linear interpolation; identity when fewer than 3 are valid."""
    valid = ids >= 0
    n = valid.sum(dim=1, keepdim=True)
    sortable = torch.where(valid, scores, torch.full_like(scores, float("inf")))
    ordered = torch.sort(sortable, dim=1).values
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=scores.device)
    q = (1.0 - alpha) * 100.0
    pos = q / 100.0 * torch.clamp(n - 1, min=0).float()
    lo = torch.floor(pos).long()
    hi = torch.ceil(pos).long()
    last = ids.shape[1] - 1
    lo_v = torch.gather(ordered, 1, lo.clamp(0, last))
    hi_v = torch.gather(ordered, 1, hi.clamp(0, last))
    thresh = lo_v + (hi_v - lo_v) * (pos - lo.float())
    keep = valid & (scores >= thresh)
    return torch.where(n < 3, valid, keep)
