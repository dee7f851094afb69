"""Exact dense top-k without materialising the f32[B, N] score matrix.

The port of the JAX package's ``ops/pallas/fused_topk.py`` (bf16/f32 rows):

1. :func:`bucket_maxima` — the hand-written kernel ``csrc/fused_topk.cu`` on a CUDA
   tensor, :func:`bucket_maxima_plain` on a CPU tensor: scores ``q . e`` with f32
   sums, validity and per-query collection masks, and the max over each bucket of
   16 adjacent rows. Only f32[B, ceil(N/16)] is written.
2. the top-k buckets per query (ties to the lowest bucket id);
3. an exact rescore of the k * 16 member rows and the (score desc, id asc)
   selection.

Exactness: any bucket holding a top-k element has a maximum >= the k-th score, so
it is among the k highest-max buckets; the final sort reproduces ``masked_top_k``'s
lowest-index tie-break. int8/int4 rows are not ported: they raise.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..index.dense_index import dense_scores_batch
from .topk import NEG_INF, lax_top_k, sort_topk_desc

BUCKET = 16  # rows per bucket, fixed by the CUDA kernel's 16-row MMA tiles
INVALID_SCORE_FLOOR = -2.0  # below any unit-vector score: marks masked members
_RESCORE_QUERIES = 16  # queries per member-rescore block


def quantize_queries_int8(query_vecs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-query symmetric absmax int8 (the reference's int8 query quantizer)."""
    q = query_vecs.float()
    q_absmax = torch.clamp(q.abs().amax(dim=1, keepdim=True), min=1e-12)
    q_scale = q_absmax / 127.0  # [B, 1]
    q_i8 = torch.clamp(torch.round(q / q_scale), -127, 127).to(torch.int8)
    return q_i8, q_scale


def _check_rows(embeddings: torch.Tensor) -> None:
    if embeddings.dtype in (torch.int8, torch.uint8):
        raise NotImplementedError(
            "int8/int4 dense rows are not ported yet (ROADMAP.md, Queue 2); "
            "use embedding_dtype bfloat16 or float32"
        )
    if embeddings.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"unsupported row dtype {embeddings.dtype}")


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
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: f32[B, ceil(N/16)] bucket maxima."""
    _check_rows(embeddings)
    n = embeddings.shape[0]
    s = dense_scores_batch(embeddings, query_vecs)
    s = s.masked_fill(~_row_mask(valid, collection_of, coll_cid), NEG_INF)
    n_pad = -(-n // BUCKET) * BUCKET
    if n_pad != n:
        s = torch.cat([s, s.new_full((s.shape[0], n_pad - n), NEG_INF)], 1)
    return s.reshape(s.shape[0], n_pad // BUCKET, BUCKET).amax(dim=2)


def _launch_bucket_maxima(embeddings, query_vecs, valid, collection_of, coll_cid):
    from ..kernels.build import check, load

    n, d = embeddings.shape
    b = query_vecs.shape[0]
    if query_vecs.shape[1] != d or d % 8:
        raise ValueError(f"bad shapes: rows {tuple(embeddings.shape)}, queries {tuple(query_vecs.shape)}")
    emb = embeddings.contiguous()
    q = query_vecs.to(emb.dtype).contiguous()
    val = valid.to(torch.uint8).contiguous()
    scoped = collection_of is not None and coll_cid is not None
    coll = collection_of.to(torch.int32).contiguous() if scoped else None
    cid = coll_cid.to(torch.int32).contiguous() if scoped else None
    for t in (emb, q, val) + ((coll, cid) if scoped else ()):
        if t.device != emb.device:
            raise ValueError("all inputs must be on the rows' device")
    if emb.data_ptr() % 16 or q.data_ptr() % 16:
        raise ValueError("rows and queries must be 16-byte aligned")
    out = torch.empty((b, -(-n // BUCKET)), dtype=torch.float32, device=emb.device)
    fn = "fused_bucket_maxima_bf16" if emb.dtype == torch.bfloat16 else "fused_bucket_maxima_f32"
    err = getattr(load("fused_topk"), fn)(
        emb.data_ptr(), q.data_ptr(), val.data_ptr(),
        coll.data_ptr() if scoped else None, cid.data_ptr() if scoped else None,
        out.data_ptr(), n, d, b, torch.cuda.current_stream(emb.device).cuda_stream,
    )
    check(err, fn)
    bucket_maxima.launches += 1
    return out


def bucket_maxima(
    embeddings: torch.Tensor,  # bf16|f32[N, D]
    query_vecs: torch.Tensor,  # f32[B, D]
    valid: torch.Tensor,  # bool[N]
    collection_of: Optional[torch.Tensor] = None,  # i32[N]
    coll_cid: Optional[torch.Tensor] = None,  # i32[B]: -1 unscoped, -2 nothing
) -> torch.Tensor:
    """f32[B, ceil(N/16)] per-bucket maxima of the masked scores.

    On a CUDA tensor this launches ``csrc/fused_topk.cu`` or raises; on a CPU
    tensor it runs :func:`bucket_maxima_plain`."""
    _check_rows(embeddings)
    if embeddings.device.type != "cuda":
        return bucket_maxima_plain(embeddings, query_vecs, valid, collection_of, coll_cid)
    return _launch_bucket_maxima(embeddings, query_vecs, valid, collection_of, coll_cid)


bucket_maxima.launches = 0  # kernel launches (CUDA tensors only)


def fused_dense_topk(
    embeddings: torch.Tensor,  # bf16|f32[N, D]
    valid: torch.Tensor,  # bool[N]
    query_vecs: torch.Tensor,  # f32[B, D]
    k: int,
    collection_of: Optional[torch.Tensor] = None,
    coll_cid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact batched dense top-k: (ids i64[B, k], scores f32[B, k]), -1 / -inf
    invalid slots. Equal to the bucketed matmul path up to f32 summation order."""
    n = embeddings.shape[0]
    b = query_vecs.shape[0]
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
    q = query_vecs.to(embeddings.dtype).float()
    cand_scores = torch.empty(rows.shape, dtype=torch.float32, device=bmax.device)
    for lo in range(0, b, _RESCORE_QUERIES):  # bounds the [b, C, D] f32 gather
        hi = min(b, lo + _RESCORE_QUERIES)
        cand = embeddings[rows[lo:hi]].float()
        cand_scores[lo:hi] = torch.bmm(cand, q[lo:hi, :, None])[..., 0]
    masked = cand_scores.masked_fill(
        ~(cand_valid & (cand_scores > INVALID_SCORE_FLOOR)), NEG_INF
    )
    return sort_topk_desc(masked, member, k)
