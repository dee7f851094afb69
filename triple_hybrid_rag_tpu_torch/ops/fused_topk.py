"""Exact dense top-k without materialising the f32[B, N] score matrix.

The port of the JAX package's ``ops/pallas/fused_topk.py``, for bf16/f32, int8 and
packed-int4 rows:

1. :func:`bucket_maxima` — the hand-written kernel ``csrc/fused_topk.cu`` on a CUDA
   tensor, :func:`bucket_maxima_plain` on a CPU tensor: the scores (``q . e`` with
   f32 sums; for quantized rows the exact int32 dot, then ``(acc * row_scale) *
   q_scale``), validity and per-query collection masks, and the max over each
   bucket of 16 adjacent rows. Only f32[B, ceil(N/16)] is written.
2. the top-k buckets per query (ties to the lowest bucket id);
3. an exact rescore of the k * 16 member rows and the (score desc, id asc)
   selection.

Exactness: any bucket holding a top-k element has a maximum >= the k-th score, so
it is among the k highest-max buckets; the final sort reproduces ``masked_top_k``'s
lowest-index tie-break. Quantized scores are the same bits in the kernel, the plain
version, the rescore and ``index/dense_index.py``'s score functions.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..index.dense_index import (
    RESCORE_QUERIES,
    dense_scores_batch,
    int_member_scores,
    int_scores,
    quantize_queries_int8,
)
from .topk import NEG_INF, lax_top_k, sort_topk_desc

BUCKET = 16  # rows per bucket, fixed by the CUDA kernel's 16-row MMA tiles
INVALID_SCORE_FLOOR = -2.0  # below any unit-vector score: marks masked members
_MAX_INT_DIM = 65536  # keeps the kernels' int32 sums (int4: of 16 * code) far from overflow
# row dtype -> exported kernel function
_KERNELS = {
    torch.bfloat16: "fused_bucket_maxima_bf16",
    torch.float32: "fused_bucket_maxima_f32",
    torch.int8: "fused_bucket_maxima_int8",
    torch.uint8: "fused_bucket_maxima_int4",
}


def _is_int(embeddings: torch.Tensor) -> bool:
    return embeddings.dtype in (torch.int8, torch.uint8)


def _check_rows(embeddings, query_vecs, scales, q_scale) -> None:
    if embeddings.dtype not in _KERNELS:
        raise TypeError(f"unsupported row dtype {embeddings.dtype}")
    if _is_int(embeddings) and (
        scales is None or q_scale is None or query_vecs.dtype != torch.int8
    ):
        raise ValueError(
            "int8/int4 rows take row scales, int8-quantized queries and their scales "
            "(quantize_queries_int8)"
        )
    width = embeddings.shape[1] * (2 if embeddings.dtype == torch.uint8 else 1)
    if query_vecs.shape[1] != width:
        raise ValueError(f"rows of width {width}, queries of width {query_vecs.shape[1]}")


def _row_mask(
    valid: torch.Tensor,
    collection_of: Optional[torch.Tensor],
    coll_cid: Optional[torch.Tensor],
) -> torch.Tensor:
    """bool[B or 1, N]: valid rows, restricted per query to its collection."""
    m = valid.bool()[None, :]
    if collection_of is not None and coll_cid is not None:
        cid = coll_cid.long()[:, None]
        m = m & ((cid == -1) | (collection_of.long()[None, :] == cid))
    return m


def bucket_maxima_plain(
    embeddings: torch.Tensor,
    query_vecs: torch.Tensor,
    valid: torch.Tensor,
    collection_of: Optional[torch.Tensor] = None,
    coll_cid: Optional[torch.Tensor] = None,
    scales: Optional[torch.Tensor] = None,
    q_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: f32[B, ceil(N/16)] bucket maxima."""
    _check_rows(embeddings, query_vecs, scales, q_scale)
    n = embeddings.shape[0]
    if _is_int(embeddings):
        s = int_scores(embeddings, scales, query_vecs, q_scale.reshape(-1, 1))
    else:
        s = dense_scores_batch(embeddings, query_vecs)
    s = s.masked_fill(~_row_mask(valid, collection_of, coll_cid), NEG_INF)
    n_pad = -(-n // BUCKET) * BUCKET
    if n_pad != n:
        s = torch.cat([s, s.new_full((s.shape[0], n_pad - n), NEG_INF)], 1)
    return s.reshape(s.shape[0], n_pad // BUCKET, BUCKET).amax(dim=2)


def _check_launch(embeddings: torch.Tensor, query_vecs: torch.Tensor) -> None:
    """What the kernels do not take, raised before anything is built: TMA and
    cp.async copy 16-byte chunks of a row (for packed int4 rows that also keeps the
    high half of a query's columns, D/2 bytes in, on a 16-byte boundary), and the
    int32 sums bound the width of quantized rows."""
    if embeddings.shape[1] * embeddings.element_size() % 16:
        raise ValueError(f"a row of {tuple(embeddings.shape)} must take a multiple of 16 bytes")
    if _is_int(embeddings) and query_vecs.shape[1] > _MAX_INT_DIM:
        raise ValueError(f"quantized rows wider than {_MAX_INT_DIM} are not supported")


def _launch_bucket_maxima(embeddings, query_vecs, valid, collection_of, coll_cid, scales, q_scale):
    _check_launch(embeddings, query_vecs)
    from ..kernels.build import f32_query_tile, launch

    n = embeddings.shape[0]
    b, d = query_vecs.shape
    is_int = _is_int(embeddings)
    emb = embeddings.contiguous()
    q = query_vecs.to(torch.int8 if is_int else emb.dtype).contiguous()
    val = (valid.view(torch.uint8) if valid.dtype == torch.bool else valid.to(torch.uint8)).contiguous()
    scoped = collection_of is not None and coll_cid is not None
    coll = collection_of.to(torch.int32).contiguous() if scoped else None
    cid = coll_cid.to(torch.int32).contiguous() if scoped else None
    sc = scales.float().contiguous() if is_int else None
    qs = q_scale.float().reshape(-1).contiguous() if is_int else None
    for t, size in ((emb, n), (q, b), (val, n), (coll, n), (cid, b), (sc, n), (qs, b)):
        if t is not None and (t.device != emb.device or t.shape[0] != size):
            raise ValueError("all inputs must be on the rows' device, one entry per row or query")
    if emb.data_ptr() % 16 or q.data_ptr() % 16:
        raise ValueError("rows and queries must be 16-byte aligned")  # contiguous() keeps a view's offset
    out = torch.empty((b, -(-n // BUCKET)), dtype=torch.float32, device=emb.device)
    ptr = [emb.data_ptr()] + ([sc.data_ptr()] if is_int else []) + [q.data_ptr()]
    ptr += ([qs.data_ptr()] if is_int else []) + [
        val.data_ptr(), coll.data_ptr() if scoped else None, cid.data_ptr() if scoped else None,
        out.data_ptr(),
    ]
    shape = [n, d, b] + ([f32_query_tile(b)] if emb.dtype == torch.float32 else [])
    launch("fused_topk", _KERNELS[emb.dtype], emb.device, *ptr, *shape)
    return out


def bucket_maxima(
    embeddings: torch.Tensor,  # bf16|f32|i8[N, D], or packed int4 u8[N, D/2]
    query_vecs: torch.Tensor,  # f32[B, D]; for quantized rows i8[B, D]
    valid: torch.Tensor,  # bool[N]
    collection_of: Optional[torch.Tensor] = None,  # i32[N]
    coll_cid: Optional[torch.Tensor] = None,  # i32[B]: -1 unscoped, -2 nothing
    scales: Optional[torch.Tensor] = None,  # f32[N] row scales (quantized rows)
    q_scale: Optional[torch.Tensor] = None,  # f32[B] or [B, 1] query scales (quantized rows)
) -> torch.Tensor:
    """f32[B, ceil(N/16)] per-bucket maxima of the masked scores.

    On a CUDA tensor this launches ``csrc/fused_topk.cu`` or raises; on a CPU
    tensor it runs :func:`bucket_maxima_plain`."""
    _check_rows(embeddings, query_vecs, scales, q_scale)
    args = (embeddings, query_vecs, valid, collection_of, coll_cid, scales, q_scale)
    if embeddings.device.type != "cuda":
        return bucket_maxima_plain(*args)
    return _launch_bucket_maxima(*args)


def fused_dense_topk(
    embeddings: torch.Tensor,  # bf16|f32|i8[N, D], or packed int4 u8[N, D/2]
    valid: torch.Tensor,  # bool[N]
    query_vecs: torch.Tensor,  # f32[B, D]
    k: int,
    collection_of: Optional[torch.Tensor] = None,
    coll_cid: Optional[torch.Tensor] = None,
    scales: Optional[torch.Tensor] = None,  # f32[N] row scales (quantized rows)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact batched dense top-k: (ids i64[B, k], scores f32[B, k]), -1 / -inf
    invalid slots. For bf16/f32 rows equal to the bucketed matmul path up to f32
    summation order; for quantized rows the scores are the bits of
    ``dense_scores_int8_batch`` / ``dense_scores_int4_batch``."""
    n = embeddings.shape[0]
    b = query_vecs.shape[0]
    is_int = _is_int(embeddings)
    if is_int:
        q_i8, q_scale = quantize_queries_int8(query_vecs)
        bmax = bucket_maxima(embeddings, q_i8, valid, collection_of, coll_cid, scales, q_scale)
    else:
        bmax = bucket_maxima(embeddings, query_vecs, valid, collection_of, coll_cid)

    # ---- stage 2: exact top-k buckets (ties -> lowest bucket id) ----
    kk = min(k, bmax.shape[1])
    _, bucket_ids = lax_top_k(bmax, kk)

    # ---- stage 3: rescore the k * 16 member rows, exact final selection ----
    member = (
        bucket_ids[:, :, None] * BUCKET
        + torch.arange(BUCKET, device=bmax.device)[None, None, :]
    ).reshape(b, kk * BUCKET)
    rows = member.clamp(max=n - 1)
    cand_valid = valid.bool()[rows] & (member < n)
    if collection_of is not None and coll_cid is not None:
        cid = coll_cid.long()[:, None]
        cand_valid = cand_valid & ((cid == -1) | (collection_of.long()[rows] == cid))
    if is_int:
        cand_scores = int_member_scores(embeddings, scales, rows, q_i8, q_scale)
    else:
        q = query_vecs.to(embeddings.dtype).float()
        cand_scores = torch.empty(rows.shape, dtype=torch.float32, device=bmax.device)
        for lo in range(0, b, RESCORE_QUERIES):  # bounds the [b, C, D] f32 gather
            hi = min(b, lo + RESCORE_QUERIES)
            cand = embeddings[rows[lo:hi]].float()
            cand_scores[lo:hi] = torch.bmm(cand, q[lo:hi, :, None])[..., 0]
    masked = cand_scores.masked_fill(
        ~(cand_valid & (cand_scores > INVALID_SCORE_FLOOR)), NEG_INF
    )
    return sort_topk_desc(masked, member, k)
