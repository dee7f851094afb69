"""Graph channel: k-hop entity expansion and the chunk top-k, batched over queries.

The port of the JAX package's ``ops/graph.py``. The entity graph is a padded
neighbour table ``nbr[E, D]`` (-1 pads); k-hop BFS is ``hops`` rounds of gather +
min. Chunk scores are the max of their entities' ``1 / (1 + distance)``, taken
either by a blocked dense scan of ``chunk_entities[N, M]`` (:func:`graph_topk_batch`)
or over the entity -> chunk mention postings of the activated entities
(:func:`graph_sparse_topk`). The staged retriever scores one query's chunks densely
(:func:`khop_chunk_scores`) and takes their top-k.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .bm25 import sparse_topk_from_windows
from .topk import NEG_INF, lax_top_k, sort_topk_desc

INF_DIST = 1e9


def seed_vectors(seed_rows: torch.Tensor, e_pad: int) -> torch.Tensor:
    """Sparse seed rows i[B, S] (-1 pads) -> bool[B, E] seed masks (a scatter-max:
    a pad, clipped to row 0, can never clear a real row-0 seed)."""
    b = seed_rows.shape[0]
    sr = seed_rows.long()
    seeds = torch.zeros((b, e_pad), dtype=torch.uint8, device=sr.device)
    seeds.scatter_reduce_(
        1, sr.clamp(0, e_pad - 1), (sr >= 0).to(torch.uint8), reduce="amax"
    )
    return seeds.bool()


def khop_distances(nbr: torch.Tensor, seeds: torch.Tensor, *, hops: int) -> torch.Tensor:
    """f32[B, E] minimum hop distance from any seed of each query (INF_DIST when
    unreachable within ``hops``). ``seeds`` is bool[B, E] (or bool[E])."""
    e_pad = nbr.shape[0]
    valid_nbr = nbr >= 0
    safe_nbr = nbr.long().clamp(0, e_pad - 1)
    inf = torch.tensor(INF_DIST, dtype=torch.float32, device=nbr.device)
    dist = torch.where(seeds, torch.zeros((), device=nbr.device), inf)
    for _ in range(hops):
        nd = torch.where(valid_nbr, dist[..., safe_nbr], inf)  # [..., E, D]
        best = nd.amin(dim=-1) + 1.0
        dist = torch.minimum(dist, best)
    return dist


def khop_entity_scores(nbr: torch.Tensor, seeds: torch.Tensor, *, hops: int) -> torch.Tensor:
    """f32[..., E] entity scores ``1 / (1 + distance)``, 0 for entities not reached
    within ``hops``."""
    dist = khop_distances(nbr, seeds, hops=hops)
    return torch.where(dist <= float(hops), 1.0 / (1.0 + dist), torch.zeros_like(dist))


def chunk_scores_from_entities(
    chunk_entities: torch.Tensor,  # i32[N, M] entity rows per chunk (-1 = pad)
    entity_scores: torch.Tensor,  # f32[E]
) -> torch.Tensor:
    """f32[N] chunk scores: the best score among each chunk's entities (0 without
    any)."""
    e_pad = entity_scores.shape[0]
    valid = chunk_entities >= 0
    s = entity_scores.float()[chunk_entities.long().clamp(0, e_pad - 1)]
    return torch.where(valid, s, torch.zeros_like(s)).amax(dim=1)


def khop_chunk_scores(
    nbr: torch.Tensor, chunk_entities: torch.Tensor, seeds: torch.Tensor, *, hops: int
) -> torch.Tensor:
    """Seed entities bool[E] -> f32[N] chunk scores of one query (the staged graph
    channel's dense scan)."""
    return chunk_scores_from_entities(chunk_entities, khop_entity_scores(nbr, seeds, hops=hops))


def graph_topk_batch(
    chunk_entities: torch.Tensor,  # i32[N, M] entity rows per chunk (-1 = pad)
    entity_scores: torch.Tensor,  # f32[B, E] per-query entity scores
    k: int,
    valid: Optional[torch.Tensor] = None,  # bool[B, N] per-query row masks
    query_on: Optional[torch.Tensor] = None,  # bool[B] graph channel active per query
    bucket: int = 16,
    block: int = 1 << 19,
    entity_ranks: Optional[torch.Tensor] = None,  # u8[B, E] monotone ranks (0 = off)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact batched graph top-k without materialising per-chunk scores.

    Bucket maxima over N-blocks (of u8 hop ranks when ``entity_ranks`` is given,
    whose order equals the score order), the top-k buckets, then an exact f32
    rescore of their members and the (score desc, id asc) selection. Scores <= 0
    never surface. Returns (ids i64[B, k], scores f32[B, k])."""
    n, m = chunk_entities.shape
    b, e_pad = entity_scores.shape
    dev = chunk_entities.device
    use_ranks = entity_ranks is not None
    if use_ranks:
        ent_t = entity_ranks.T  # [E, B] u8
        if query_on is not None:
            ent_t = torch.where(query_on[None, :], ent_t, torch.zeros_like(ent_t))
        zero = torch.zeros((), dtype=torch.uint8, device=dev)
    else:
        ent_t = entity_scores.T.float()
        if query_on is not None:
            ent_t = torch.where(query_on[None, :], ent_t, torch.zeros_like(ent_t))
        zero = torch.zeros((), dtype=torch.float32, device=dev)

    n_pad = -(-n // block) * block
    ce = chunk_entities.long()
    va = valid
    if n_pad != n:
        ce = torch.cat([ce, ce.new_full((n_pad - n, m), -1)], 0)
        if va is not None:
            va = torch.cat([va, va.new_zeros((b, n_pad - n))], 1)
    if block % bucket:
        raise ValueError("block must be a multiple of bucket")

    parts = []
    for lo in range(0, n_pad, block):
        ce_blk = ce[lo:lo + block]
        ok = ce_blk >= 0
        s = torch.where(ok[:, :, None], ent_t[ce_blk.clamp(0, e_pad - 1)], zero)
        s = s.amax(dim=1)  # [block, B]
        if not use_ranks:
            s = torch.where(s > 0.0, s, torch.full_like(s, NEG_INF))
        if va is not None:
            fill = zero if use_ranks else torch.full_like(s, NEG_INF)
            s = torch.where(va[:, lo:lo + block].T, s, fill)
        parts.append(s.reshape(block // bucket, bucket, b).amax(dim=1).T)
    bmax = torch.cat(parts, 1)  # [B, n_pad / bucket]
    if use_ranks:
        bmax = bmax.to(torch.int32)  # rank 0 = empty bucket (sorts last)

    kk = min(k, n_pad // bucket)
    _, bucket_ids = lax_top_k(bmax, kk)  # ties -> lowest bucket id
    member = (
        bucket_ids[:, :, None] * bucket + torch.arange(bucket, device=dev)[None, None, :]
    ).reshape(b, kk * bucket)

    # rescore members per query (tiny: B x k*bucket x M gathers)
    mem_ce = ce[member.clamp(0, n_pad - 1)]  # [B, C, M]
    ok = mem_ce >= 0
    safe = mem_ce.clamp(0, e_pad - 1)
    ent = entity_scores.float()
    if query_on is not None:
        ent = torch.where(query_on[:, None], ent, torch.zeros_like(ent))
    gathered = torch.gather(ent, 1, safe.reshape(b, -1)).reshape(safe.shape)
    cand = torch.where(ok, gathered, torch.zeros_like(gathered)).amax(dim=-1)  # [B, C]
    cand = torch.where(cand > 0.0, cand, torch.full_like(cand, NEG_INF))
    cand = torch.where(member < n, cand, torch.full_like(cand, NEG_INF))
    if valid is not None:
        cand = torch.where(
            torch.gather(va, 1, member.clamp(0, n - 1)), cand, torch.full_like(cand, NEG_INF)
        )
    return sort_topk_desc(cand, member, k)


def graph_sparse_topk(
    ent_offsets: torch.Tensor,  # i32[E + 1] CSR offsets into the mention postings
    ent_lengths: torch.Tensor,  # i32[E] mention count per entity (post-cap)
    mention_docs: torch.Tensor,  # i32[nnz_pad] chunk rows, ascending per entity
    act_ents: torch.Tensor,  # i[B, A] activated entity rows (-1 = empty slot)
    act_scores: torch.Tensor,  # f32[B, A] their k-hop scores
    row_mask: Optional[torch.Tensor] = None,  # bool[B, n_pad]
    *,
    l_max_g: int,
    n_pad: int,
    top_k: int,
    run_bound: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sparse graph top-k: score only chunks that mention an activated entity, by
    the per-chunk MAX over the same sort + segmented doubling machinery as the
    lexical channel. Exact vs the dense scan when ``act_ents`` holds every entity
    with a nonzero score and no mention list was truncated."""
    b, a_slots = act_ents.shape
    e_pad = ent_lengths.shape[0]
    dev = act_ents.device
    ae = act_ents.long()
    ok = (ae >= 0) & (act_scores > 0.0)
    e = ae.clamp(0, e_pad - 1)
    start = ent_offsets.long()[e].clamp(0, mention_docs.shape[0] - l_max_g)
    ln = ent_lengths.long()[e]
    pos = torch.arange(l_max_g, device=dev)
    valid = (pos < ln[..., None]) & ok[..., None]  # [B, A, L]
    docs = torch.where(
        valid, mention_docs.long()[start[..., None] + pos], torch.full_like(valid, n_pad, dtype=torch.long)
    )
    contrib = torch.where(valid, act_scores.float()[..., None], torch.zeros((), device=dev))
    slots = torch.arange(a_slots, device=dev)[None, :, None].expand(b, a_slots, l_max_g)
    return sparse_topk_from_windows(
        docs.reshape(b, -1), slots.reshape(b, -1), contrib.reshape(b, -1),
        a_slots, n_pad, top_k, row_mask, combine="max", run_bound=run_bound,
    )
