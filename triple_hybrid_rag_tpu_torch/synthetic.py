"""Synthetic serving-size corpus, built on the device from a seed.

The construction of the JAX package's ``bench.py`` (``build_synthetic`` and
``make_query_texts``), in PyTorch: documents are bags of ``L_DOC`` vocabulary terms
with u^4-skewed ids (a Zipf-like head); the BM25 postings are capped at ``df_cap``
per term with precomputed weights; the dense rows ARE the BowHash embeddings of the
documents' terms (summed from the same per-term directions the query embedder
uses); parent p holds the MaxSim token vectors of chunk 5p's first terms; the
graph has ``n_entities`` entities with random adjacency of mean degree deg/2 and
two mentions per chunk. Self-retrieval (a document's own terms as the query) is
therefore a real end-to-end check.

The configuration picks the layouts: ``embedding_dtype`` "float32" keeps the rows
unrounded (as the reference's dense index stores them under that dtype),
"bfloat16" rounds them, "int8" / "int4" quantizes the bf16 rows on the device and
stores the MaxSim tokens as int8 (as ``bench.py`` does), and ``lexical_backend``
"termtable" / "postings"
places the doc-major term table (:func:`build_term_table`) instead of the postings.

:func:`encode_rows` re-embeds chosen rows with the trained encoder: their dense
rows and their parents' MaxSim tokens become the encoder's, the other rows keep the
BowHash geometry, so queries drawn from those rows self-retrieve under the encoder
while the dense scan still reads every row.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from .analyzer import Vocabulary
from .config import RAGConfig
from .corpus import SyntheticCorpusView
from .device import resolve_device
from .index.dense_index import quantize_rows_int4, quantize_rows_int8, truncate_matryoshka
from .index.state import IndexState
from .models.embedder import BowHashEmbedder
from .models.entity_extractor import canonical_key
from .ops.bm25 import DOC_PAD
from .ops.maxsim import quantize_tokens
from .types import Entity

L_DOC = 64  # terms per document
VOCAB = 65536
CHILDREN_PER_PARENT = 5
_ROW_BLOCK = 1 << 17  # rows per embedding block (bounds the f32 accumulator)


def term_str(i: int) -> str:
    return f"t{i:06d}"


def entity_name(i: int) -> str:
    return f"Acme{i:05d}"


class SyntheticCorpus(NamedTuple):
    state: IndexState
    term_ids: np.ndarray  # i32[n_pad, L_DOC] host copy of each document's terms
    embedder: BowHashEmbedder  # the query embedder whose directions built the rows
    n: int
    n_entities: int


def posting_weight(idf: torch.Tensor, config: RAGConfig) -> torch.Tensor:
    """BM25 contribution of one occurrence (tf = 1) of each term, f32[V]. Every
    synthetic document has the average length, so the length term is 1."""
    k1, b = config.bm25_k1, config.bm25_b
    denom = k1 * (1.0 - b + b * 1.0)
    return (idf * (k1 + 1.0) / (1.0 + denom)).float()


def build_term_table(
    doc_terms: torch.Tensor,  # i[n_pad, L_DOC] the terms of each document, duplicates included
    n: int,  # live documents; the rows from n on stay empty
    idf: torch.Tensor,  # f32[V]
    config: RAGConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The doc-major term table of the synthetic corpus, built on ``doc_terms``'
    device: (term_ids i32[n_pad, L], term_weights f32[n_pad, L]) with
    L = ``config.doc_term_capacity``, a document's unique terms in ascending id
    order and ``DOC_PAD`` in the empty slots.

    A term that occurs c times in a document is merged into one slot weighted
    c times the one-occurrence contribution of :func:`posting_weight`. That is
    what the synthetic postings sum to (they hold one tf = 1 posting per
    occurrence), so the term table and the sorted postings score a document alike
    wherever ``bm25_df_cap`` cut none of the query's terms; it is not BM25's
    saturating tf formula."""
    width = config.doc_term_capacity
    n_pad, l_doc = doc_terms.shape
    if width < l_doc:
        raise ValueError(f"doc_term_capacity {width} is below the {l_doc} terms of a document")
    dev = doc_terms.device
    terms = torch.sort(doc_terms.long(), dim=1).values
    first = torch.ones_like(terms, dtype=torch.bool)
    first[:, 1:] = terms[:, 1:] != terms[:, :-1]
    slot = torch.cumsum(first, 1) - 1  # the slot of each occurrence's term
    term_ids = torch.full((n_pad, width), DOC_PAD, dtype=torch.int32, device=dev)
    term_ids.scatter_(1, slot, terms.to(torch.int32))
    counts = torch.zeros((n_pad, width), dtype=torch.float32, device=dev)
    counts.scatter_add_(1, slot, torch.ones_like(terms, dtype=torch.float32))
    term_ids[n:] = DOC_PAD
    live = term_ids >= 0
    weights = counts * posting_weight(idf, config)[term_ids.clamp(min=0).long()]
    return term_ids, torch.where(live, weights, torch.zeros_like(weights))


def document_rows(
    term_ids: torch.Tensor,  # i[n_pad, L_DOC] the terms of each document
    embedder: BowHashEmbedder,
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """The dense rows of the synthetic corpus on ``term_ids``' device: each
    document's BowHash embedding (the sum of its terms' f16 directions, as the
    query embedder makes them), normalized in f32 and stored as ``dtype``. The bf16
    rows are the f32 rows rounded."""
    dev = term_ids.device
    dirs = torch.from_numpy(np.stack([embedder._token_vec(term_str(i)) for i in range(VOCAB)]))
    dirs = dirs.to(torch.float16).to(dev)  # the reference ships the table as f16
    n_pad, dim = term_ids.shape[0], embedder.dim
    emb = torch.empty((n_pad, dim), dtype=dtype, device=dev)
    for lo in range(0, n_pad, _ROW_BLOCK):
        ids = term_ids[lo:lo + _ROW_BLOCK].long()
        acc = torch.zeros((ids.shape[0], dim), dtype=torch.float32, device=dev)
        for g in range(L_DOC):
            acc += dirs[ids[:, g]].float()
        acc /= torch.clamp(torch.linalg.vector_norm(acc, dim=1, keepdim=True), min=1e-12)
        emb[lo:lo + _ROW_BLOCK] = acc.to(dtype)
    return emb


def maxsim_store(
    term_ids: torch.Tensor,  # i[n_pad, L_DOC] the terms of each document
    n: int,
    embedder: BowHashEmbedder,
    config: RAGConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MaxSim token store on ``term_ids``' device: parent p holds the BowHash
    token vectors of chunk 5p's first ``maxsim_doc_tokens`` terms at width
    ``maxsim_dim``, int8 under int8/int4 rows (as the reference stores them), bf16
    otherwise. Returns (tokens [P_pad, Td, Dm], mask bool[P_pad, Td])."""
    cfg = config
    dev = term_ids.device
    m_dim, td = cfg.maxsim_dim, cfg.maxsim_doc_tokens
    terms = [term_str(i) for i in range(VOCAB)]
    mtok = embedder.token_embeddings(terms, max_tokens=1, dim=m_dim)[:, 0, :]
    mdirs = torch.from_numpy(mtok).to(torch.float16).to(dev)
    n_parents = n // CHILDREN_PER_PARENT
    p_pad = cfg.round_capacity(n_parents)
    parent_terms = torch.zeros((p_pad, td), dtype=torch.long, device=dev)
    parent_terms[:n_parents] = term_ids[: CHILDREN_PER_PARENT * n_parents : CHILDREN_PER_PARENT, :td].long()
    tokens = mdirs[parent_terms]
    if cfg.embedding_dtype in ("int8", "int4"):  # MaxSim tokens stay int8 under int4 dense
        tokens = quantize_tokens(tokens)
    else:
        tokens = tokens.to(torch.bfloat16)
    tok_mask = (torch.arange(p_pad, device=dev) < n_parents)[:, None].expand(p_pad, td).contiguous()
    return tokens, tok_mask


def encode_rows(
    state: IndexState,
    rows: Sequence[int],
    embedder,
    text_of: Callable[[int], str],
) -> None:
    """Overwrite, in place and in the state's dtypes, the dense rows of ``rows``
    with ``embedder.embed_texts`` of their texts (Matryoshka-truncated to the
    state's width) and the MaxSim tokens of their parents with
    ``embedder.token_embeddings`` of each parent's text, its first chunk's (as
    :func:`build_synthetic` lays parents out), truncated and renormalized to the
    store's width; the parents' token masks become the occupied slots."""
    dev = state.device
    rows = sorted({int(r) for r in rows})
    idx = torch.tensor(rows, dtype=torch.long, device=dev)
    vec = truncate_matryoshka(embedder.embed_texts([text_of(r) for r in rows]), state.dim)
    vec = torch.from_numpy(vec).to(dev)
    emb = state.embeddings
    if emb.dtype in (torch.int8, torch.uint8):
        quantize = quantize_rows_int8 if emb.dtype == torch.int8 else quantize_rows_int4
        emb[idx], state.dense_scales[idx] = quantize(vec)
    else:
        emb[idx] = vec.to(emb.dtype)
    if state.maxsim_tokens is None:
        return
    parents = torch.unique(state.parent_of[idx].long())
    first = (parents * CHILDREN_PER_PARENT).tolist()
    td, m_dim = state.maxsim_tokens.shape[1:]
    tok = embedder.token_embeddings([text_of(r) for r in first], max_tokens=td, dim=m_dim)
    full = torch.zeros((len(first), td, m_dim), dtype=torch.float32, device=dev)
    full[:, : tok.shape[1]] = torch.from_numpy(tok).to(dev)
    store = state.maxsim_tokens
    store[parents] = quantize_tokens(full) if store.dtype == torch.int8 else full.to(store.dtype)
    state.maxsim_mask[parents] = (full != 0).any(dim=-1)


def build_synthetic(
    config: RAGConfig,
    n: int,
    dim: int,
    n_entities: int,
    seed: int = 0,
    device=None,
) -> SyntheticCorpus:
    """Build the synthetic index on ``device`` (CUDA unless ``device="cpu"``).

    ``config`` fixes the capacity rounding, the lexical layout (``lexical_backend``;
    ``bm25_df_cap`` for the postings, ``doc_term_capacity`` for the term table), the
    BM25 constants, the row dtype (``embedding_dtype``), the MaxSim token shape and
    the graph widths; ``dim`` must equal ``config.embedding_dim``."""
    dev = resolve_device(device)
    cfg = config
    if dim != cfg.embedding_dim:
        raise ValueError("dim must equal config.embedding_dim")
    gen = torch.Generator(device=dev).manual_seed(seed)
    n_pad = cfg.round_capacity(n)
    df_cap = cfg.bm25_df_cap or n

    # ---- documents: u^4-skewed term ids ----
    u = torch.rand((n_pad, L_DOC), generator=gen, device=dev)
    term_ids = torch.floor(VOCAB * u**4).to(torch.int32).clamp_(max=VOCAB - 1)
    term_ids[n:] = 0
    del u

    # ---- CSR postings (term-major, doc-ascending), capped at df_cap ----
    flat_terms = term_ids[:n].reshape(-1).long()
    key = flat_terms * n + torch.arange(n, device=dev).repeat_interleave(L_DOC)
    key = torch.sort(key).values
    st, sd = key // n, key % n
    del key, flat_terms
    df = torch.bincount(st, minlength=VOCAB)
    offsets_full = torch.zeros(VOCAB + 1, dtype=torch.long, device=dev)
    offsets_full[1:] = torch.cumsum(df, 0)
    pos_in_term = torch.arange(st.shape[0], device=dev) - torch.repeat_interleave(offsets_full[:-1], df)
    keep = pos_in_term < df_cap
    st, sd = st[keep], sd[keep]
    del pos_in_term, keep
    stored_df = torch.clamp(df, max=df_cap)
    offsets = torch.zeros(VOCAB + 1, dtype=torch.long, device=dev)
    offsets[1:] = torch.cumsum(stored_df, 0)
    nnz = int(offsets[-1])
    l_max = int(stored_df.max())
    idf64 = torch.log1p((n - df.double() + 0.5) / (df.double() + 0.5))
    idf = idf64.float()
    postings_doc = torch.full((nnz + l_max,), -1, dtype=torch.int32, device=dev)
    postings_doc[:nnz] = sd.to(torch.int32)
    postings_weight = torch.zeros(nnz + l_max, dtype=torch.float32, device=dev)
    postings_weight[:nnz] = posting_weight(idf, cfg)[st]
    del st, sd
    if cfg.lexical_backend in ("sorted", "auto"):
        lexical = {
            "bm25_offsets": offsets.to(torch.int32), "bm25_lengths": stored_df.to(torch.int32),
            "bm25_postings_doc": postings_doc, "bm25_postings_weight": postings_weight,
        }
    else:
        table_ids, table_weights = build_term_table(term_ids, n, idf, cfg)
        lexical = {"bm25_term_ids": table_ids, "bm25_term_weights": table_weights}
    del postings_doc, postings_weight

    # ---- dense rows = BowHash of each document's terms ----
    embedder = BowHashEmbedder(dim=dim, config=cfg)
    row_dtype = torch.float32 if cfg.embedding_dtype == "float32" else torch.bfloat16
    emb = document_rows(term_ids, embedder, row_dtype)
    valid = torch.arange(n_pad, device=dev) < n
    dense = {"embeddings": emb, "valid": valid}
    if cfg.embedding_dtype in ("int8", "int4"):
        quantize = quantize_rows_int4 if cfg.embedding_dtype == "int4" else quantize_rows_int8
        dense["embeddings"], dense["dense_scales"] = quantize(emb)
    del emb

    tokens, tok_mask = maxsim_store(term_ids, n, embedder, cfg)
    parent_of = (torch.arange(n_pad, device=dev) // CHILDREN_PER_PARENT).to(torch.int32)

    # ---- graph: random adjacency (mean degree deg/2) + two mentions per chunk ----
    e_pad = cfg.round_capacity(n_entities)
    deg = cfg.graph_max_degree
    nbr = torch.randint(0, n_entities, (e_pad, deg), generator=gen, device=dev, dtype=torch.int32)
    nbr[n_entities:] = -1
    nbr[:, deg // 2:] = -1
    m_ent = cfg.graph_max_entities_per_chunk
    chunk_entities = torch.randint(0, n_entities, (n_pad, m_ent), generator=gen, device=dev, dtype=torch.int32)
    chunk_entities[:, m_ent // 2:] = -1
    chunk_entities[n:] = -1
    entities = [Entity(entity_id=f"e{i}", canonical_name=entity_name(i), row=i) for i in range(n_entities)]

    term_ids_host = term_ids.cpu().numpy()
    del term_ids

    def text_of(row: int) -> str:
        return " ".join(term_str(int(t)) for t in term_ids_host[row])

    state = IndexState.from_tensors(
        {
            "parent_of": parent_of, **lexical, **dense,
            "nbr": nbr, "chunk_entities": chunk_entities,
            "maxsim_tokens": tokens, "maxsim_mask": tok_mask,
        },
        {
            "bm25_l_max": l_max,
            "stored_df": stored_df.cpu().numpy(),
            "idf": idf.cpu().numpy(),
            "vocab": Vocabulary.from_list([term_str(i) for i in range(VOCAB)]),
            "chunk_entities_host": chunk_entities.cpu().numpy(),
            "entity_keys": [canonical_key(e.canonical_name) for e in entities],
            "entities": entities,
            "row_of": {e.entity_id: e.row for e in entities},
            "corpus": SyntheticCorpusView(n, text_of, CHILDREN_PER_PARENT),
        },
        cfg,
        dev,
    )
    return SyntheticCorpus(state, term_ids_host, embedder, n, n_entities)


def make_query_texts(
    rows: Sequence[int],
    term_ids: np.ndarray,
    rng: np.random.Generator,
    graph_frac: float,
    n_entities: int,
) -> Tuple[List[str], np.ndarray]:
    """Query text for each target row: its first 8 distinct terms; a fraction
    ``graph_frac`` get a relation question over two entity names, which the rule
    planner turns into a graph-seeded plan. Returns (texts, is_graph)."""
    texts, is_graph = [], []
    for r in rows:
        seen, terms = set(), []
        for t in term_ids[r]:
            if t not in seen:
                seen.add(t)
                terms.append(term_str(int(t)))
            if len(terms) >= 8:
                break
        text = " ".join(terms)
        g = rng.random() < graph_frac
        if g:
            e1, e2 = rng.integers(0, n_entities, size=2)
            text = f"How is {entity_name(e1)} related to {entity_name(e2)}? " + text
        texts.append(text)
        is_graph.append(g)
    return texts, np.asarray(is_graph)
