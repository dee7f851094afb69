"""Top-k selection with validity masks, and the merge of top-k lists.

Every op returns fixed-width (ids, scores) pairs ordered score descending, then id
ascending; invalid slots carry id -1 and score -inf, and the tail pads when k exceeds
the candidate width. Every exactness argument of the engine (bucketed == plain top-k,
sparse graph == dense scan, fused kernel == matmul path) rests on all paths sharing
this order.

``torch.topk`` promises no tie order, so selection here runs on one composite int64
key per element — the score's order key in the high 32 bits, the (inverted) position
or id in the low 32 — whose values are distinct, which makes ``torch.topk`` exact and
deterministic. Two score orders are reproduced, because the reference uses both:

* :func:`lax_top_k` is ``jax.lax.top_k``: IEEE total order, so ``+0.0`` ranks above
  ``-0.0``, ties to the lowest position;
* :func:`sort_topk_desc` is the reference's ``lax.sort`` over ``(-score, id)``, which
  treats the two zeros as equal.

Ids are int64 (PyTorch's index type); the reference returns int32 with the same values.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = float("-inf")
INT32_MAX = 2**31 - 1
_LOW = 2**32 - 1


def _float_order_key(x: torch.Tensor) -> torch.Tensor:
    """f32 -> int64 key monotone in IEEE total order (-0.0 below +0.0)."""
    bits = x.float().contiguous().view(torch.int32)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).long()


def _order_key(x: torch.Tensor) -> torch.Tensor:
    return _float_order_key(x) if x.is_floating_point() else x.long()


def lax_top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: (values, positions), k <= width.
    Raises ValueError, as ``jax.lax.top_k`` does, for k < 0 or k past the width."""
    n = x.shape[-1]
    if k < 0:
        raise ValueError(f"k argument to top_k must be nonnegative, got {k}")
    if k > n:
        raise ValueError(
            "k argument to top_k must be no larger than size along axis; "
            f"got k={k} with shape={list(x.shape)} and axis={x.dim() - 1}"
        )
    pos = torch.arange(n, device=x.device)
    composite = _order_key(x) * 2**32 + (_LOW - pos)
    idx = torch.topk(composite, k, dim=-1, largest=True, sorted=True).indices
    return torch.gather(x, -1, idx), idx


def sort_topk_desc(
    scores: torch.Tensor, ids: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The canonical (score desc, id asc) top-k over the last axis.

    ``scores`` already carry -inf in invalid slots. Returns (ids i64[..., k],
    scores f32[..., k]) with -1 / -inf invalid slots, padded when k exceeds the width."""
    scores = scores.float()
    ids = ids.long()
    sort_ids = torch.where(scores > NEG_INF, ids, torch.full_like(ids, INT32_MAX))
    canon = torch.where(scores == 0, torch.zeros_like(scores), scores)  # -0 == +0
    composite = _float_order_key(canon) * 2**32 + (_LOW - (sort_ids + 2**31))
    kk = min(k, scores.shape[-1])
    idx = torch.topk(composite, kk, dim=-1, largest=True, sorted=True).indices
    top_ids = torch.gather(sort_ids, -1, idx)
    top_vals = torch.gather(scores, -1, idx)
    if kk < k:
        pad_shape = scores.shape[:-1] + (k - kk,)
        top_ids = torch.cat([top_ids, top_ids.new_full(pad_shape, INT32_MAX)], -1)
        top_vals = torch.cat([top_vals, top_vals.new_full(pad_shape, NEG_INF)], -1)
    ok = top_vals > NEG_INF
    return (
        torch.where(ok, top_ids, torch.full_like(top_ids, -1)),
        torch.where(ok, top_vals, torch.full_like(top_vals, NEG_INF)),
    )


def masked_top_k(
    scores: torch.Tensor,
    k: int,
    valid: Optional[torch.Tensor] = None,
    invalid_score_floor: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the last axis; entries <= floor or not ``valid`` never surface.
    Ties break by the lowest position (``lax.top_k``). Returns (ids, scores) with
    -1 / -inf invalid slots."""
    masked = scores.float()
    invalid = masked <= invalid_score_floor
    if valid is not None:
        invalid = invalid | ~valid
    masked = masked.masked_fill(invalid, NEG_INF)
    kk = min(k, masked.shape[-1])
    vals, idx = lax_top_k(masked, kk)
    if kk < k:
        pad_shape = masked.shape[:-1] + (k - kk,)
        vals = torch.cat([vals, vals.new_full(pad_shape, NEG_INF)], -1)
        idx = torch.cat([idx, idx.new_zeros(pad_shape)], -1)
    ok = vals > NEG_INF
    return torch.where(ok, idx, torch.full_like(idx, -1)), vals.masked_fill(~ok, NEG_INF)


def merge_topk(
    ids: torch.Tensor, scores: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge the top-k lists of the last two axes ``[..., S, k_local]`` into one
    global top-k (the same order on any number of lists)."""
    flat_ids = ids.reshape(*ids.shape[:-2], -1).long()
    flat_scores = scores.reshape(*scores.shape[:-2], -1).float()
    masked = flat_scores.masked_fill(flat_ids < 0, NEG_INF)
    return sort_topk_desc(masked, flat_ids, k)


def bucketed_masked_top_k_batch(
    scores: torch.Tensor,
    k: int,
    valid: Optional[torch.Tensor] = None,
    invalid_score_floor: float = 0.0,
    bucket: int = 16,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched :func:`masked_top_k` via bucket maxima — exact, no full sort.

    Per-bucket maxima, top-k over the N/bucket maxima, then an exact rescore of the
    winning buckets' members: any bucket holding a top-k element has a maximum >= the
    k-th value, so it is among the k highest-max buckets; the final (score desc, id
    asc) sort reproduces the plain op's lowest-index tie-break.
    scores f32[B, N], valid bool[N] or bool[B, N] -> (ids i64[B, k], f32[B, k])."""
    b, n = scores.shape
    masked = scores.float()
    invalid = masked <= invalid_score_floor
    if valid is not None:
        invalid = invalid | ~(valid if valid.dim() == 2 else valid[None, :])
    masked = masked.masked_fill(invalid, NEG_INF)

    if n <= max(bucket * k, 4096):  # small corpora: the plain path is cheaper
        vals, idx = lax_top_k(masked, min(k, n))
        ok = vals > NEG_INF
        ids = torch.where(ok, idx, torch.full_like(idx, -1))
        vals = vals.masked_fill(~ok, NEG_INF)
        if n < k:
            ids = torch.cat([ids, ids.new_full((b, k - n), -1)], 1)
            vals = torch.cat([vals, vals.new_full((b, k - n), NEG_INF)], 1)
        return ids, vals

    n_pad = ((n + bucket - 1) // bucket) * bucket
    if n_pad != n:
        masked = torch.cat([masked, masked.new_full((b, n_pad - n), NEG_INF)], 1)
    nb = n_pad // bucket
    bmax = masked.reshape(b, nb, bucket).amax(dim=2)
    kk = min(k, nb)
    _, bucket_ids = lax_top_k(bmax, kk)  # ties -> lowest bucket id
    member = (
        bucket_ids[:, :, None] * bucket
        + torch.arange(bucket, device=scores.device)[None, None, :]
    ).reshape(b, kk * bucket)
    cand = torch.gather(masked, 1, member)
    return sort_topk_desc(cand, member, k)
