"""Helpers of the query path: MaxSim query-token weights, the parents' mean
embeddings of the dot rerank, and the decode of device rows into
:class:`~triple_hybrid_rag_tpu_torch.types.SearchResult` records. Ports of the JAX
package's ``retrieval.py`` helpers of the same names."""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from .analyzer import Analyzer
from .index.dense_index import unpack_int4
from .ops.fusion import GRAPH_BIT, LEXICAL_BIT, SEMANTIC_BIT
from .types import SearchResult

# Content-light "function" words (EN + PT) that rarely match a document token and
# would drag the MaxSim mean below the safety threshold on natural questions; they
# get a soft weight instead of full voice.
_FUNCTION_WORDS = frozenset(
    """get got make made take took tell told know knew want need find found
    explain say said see saw look give gave show list use used work help
    obter fazer feito dizer dito saber quis querer preciso precisa mostrar
    ajudar usar achar encontrar funciona funcionar""".split()
)
FUNCTION_WORD_WEIGHT = 0.25

_FW_PROCESSED: dict = {}


def _function_words(analyzer: Analyzer) -> frozenset:
    """The function-word list in the analyzer's token space (cached per analyzer
    setting): both the surface forms and their stemmed/folded tokens."""
    key = (
        analyzer.config.analyzer_stemming,
        analyzer.config.analyzer_strip_accents,
        analyzer.config.analyzer_min_token_len,
    )
    fw = _FW_PROCESSED.get(key)
    if fw is None:
        out = set(_FUNCTION_WORDS)
        for word in _FUNCTION_WORDS:
            out.update(analyzer.tokenize(word))
        fw = frozenset(out)
        _FW_PROCESSED[key] = fw
    return fw


def maxsim_query_weights(text: str, analyzer: Analyzer, max_tokens: int) -> np.ndarray:
    """f32[max_tokens] per-query-token MaxSim weights (0 = padding slot), aligned
    with the embedder's ``token_embeddings`` positions."""
    fw = _function_words(analyzer)
    w = np.zeros((max_tokens,), np.float32)
    for j, t in enumerate(analyzer.tokenize(text)[:max_tokens]):
        w[j] = FUNCTION_WORD_WEIGHT if t in fw else 1.0
    return w


_ROW_BLOCK = 1 << 17  # rows dequantized at once (bounds the f32 transient)


def dequant_f32(rows: torch.Tensor, scales: Optional[torch.Tensor]) -> torch.Tensor:
    """f32 view of dense rows (the reference's ``index/ivf._dequant_f32``): f32/bf16
    as they are, int8 times the row scale, packed int4 unpacked then scaled. The
    width is the logical dim (twice the stored width for int4)."""
    if rows.dtype == torch.uint8:
        r = torch.cat(unpack_int4(rows), dim=-1).float()
    else:
        r = rows.float()
    if scales is not None and rows.dtype in (torch.int8, torch.uint8):
        r = r * scales[:, None]
    return r


def build_parent_embeddings(
    embeddings: torch.Tensor,
    scales: Optional[torch.Tensor],
    parent_rows: Union[Sequence[int], torch.Tensor],
    p_pad: int,
) -> torch.Tensor:
    """f32[p_pad, D] parent embeddings on the rows' device: each parent is the
    L2-normalized mean of its chunks' dequantized rows (the reference's
    ``Retriever._build_parent_embeddings``). ``parent_rows`` maps the first
    chunk rows to their parent; rows past it (padding) fall into the last parent
    slot, as in the reference."""
    dev = embeddings.device
    n = embeddings.shape[0]
    seg = torch.full((n,), p_pad - 1, dtype=torch.long, device=dev)
    rows = torch.as_tensor(parent_rows, dtype=torch.long, device=dev)
    seg[: rows.shape[0]] = rows
    dim = embeddings.shape[1] * (2 if embeddings.dtype == torch.uint8 else 1)
    sums = torch.zeros((p_pad, dim), dtype=torch.float32, device=dev)
    for lo in range(0, n, _ROW_BLOCK):
        hi = lo + _ROW_BLOCK
        block_scales = None if scales is None else scales[lo:hi]
        sums.index_add_(0, seg[lo:hi], dequant_f32(embeddings[lo:hi], block_scales))
    norms = torch.linalg.vector_norm(sums, dim=1, keepdim=True)
    return sums / torch.clamp(norms, min=1e-12)


def decode_results(corpus, fused, rerank_scores, final_ids, final_scores) -> List[SearchResult]:
    """Host decode of one query: final rows -> SearchResult records. ``fused`` holds
    the query's candidate arrays (ids, rrf, lexical, semantic, graph, channels) as
    numpy; ``corpus`` is a view with ``child_by_row`` and ``parent``."""
    f_ids = np.asarray(fused.ids)
    slot_of = {int(cid): i for i, cid in enumerate(f_ids) if cid >= 0}
    rrf = np.asarray(fused.rrf)
    lex = np.asarray(fused.lexical)
    sem = np.asarray(fused.semantic)
    gr = np.asarray(fused.graph)
    chan = np.asarray(fused.channels)
    rk = np.asarray(rerank_scores)

    out: List[SearchResult] = []
    for cid, score in zip(np.asarray(final_ids), np.asarray(final_scores)):
        cid = int(cid)
        if cid < 0:
            continue
        child = corpus.child_by_row(cid)
        parent = corpus.parent(child.parent_id)
        slot = slot_of.get(cid)
        channels = []
        if slot is not None:
            bits = int(chan[slot])
            if bits & LEXICAL_BIT:
                channels.append("lexical")
            if bits & SEMANTIC_BIT:
                channels.append("semantic")
            if bits & GRAPH_BIT:
                channels.append("graph")
        out.append(
            SearchResult(
                chunk_id=child.chunk_id,
                parent_id=child.parent_id,
                doc_id=child.doc_id,
                text=child.text,
                parent_text=parent.text if parent else None,
                section_heading=child.section_heading,
                page_start=child.page_start,
                page_end=child.page_end,
                modality=child.modality,
                lexical_score=float(lex[slot]) if slot is not None else 0.0,
                semantic_score=float(sem[slot]) if slot is not None else 0.0,
                graph_score=float(gr[slot]) if slot is not None else 0.0,
                rrf_score=float(rrf[slot]) if slot is not None else 0.0,
                rerank_score=float(rk[slot]) if slot is not None else None,
                final_score=float(score),
                source_channels=tuple(channels),
            )
        )
    return out
