"""Dense channel, query side: Matryoshka truncation, batched scores, the zero-vector
guard. The port of the query half of the JAX package's ``index/dense_index.py``."""

from __future__ import annotations

import numpy as np
import torch


def truncate_matryoshka(vectors: np.ndarray, dim: int) -> np.ndarray:
    """Prefix-truncate + re-L2-normalize (host numpy, as the reference does)."""
    v = np.asarray(vectors, dtype=np.float32)[..., :dim]
    norms = np.linalg.norm(v, axis=-1, keepdims=True)
    return v / np.maximum(norms, 1e-12)


def dense_scores_batch(embeddings: torch.Tensor, query_vecs: torch.Tensor) -> torch.Tensor:
    """Batched scores f32[B, N] = q . e, queries cast to the row dtype.

    The reference's dot with ``preferred_element_type=f32``: on CUDA a bf16 GEMM
    with f32 output. The CPU has no such GEMM, so there the rows widen to f32
    first, which gives the same exact products summed in f32."""
    q = query_vecs.to(embeddings.dtype)
    if embeddings.device.type == "cuda" and embeddings.dtype == torch.bfloat16:
        return torch.mm(q, embeddings.T, out_dtype=torch.float32)
    return q.float() @ embeddings.float().T


def zero_query_guard(
    q_vec: torch.Tensor, ids: torch.Tensor, scores: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Silence the dense channel for all-zero query vectors (a failed embed).

    A zero vector scores every row exactly 0.0 and would return rows 0..k-1 by the
    id tie-break; the guard empties the list instead (ids -1, scores 0), so fusion
    degrades to the lexical and graph channels."""
    q_ok = (q_vec != 0.0).any(dim=-1, keepdim=True)
    return (
        torch.where(q_ok, ids, torch.full_like(ids, -1)),
        torch.where(q_ok, scores, torch.zeros_like(scores)),
    )
