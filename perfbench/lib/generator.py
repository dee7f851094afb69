"""The benchmark's inputs, made on the device from a seed: a synthetic corpus as an
ingest hands it to the index, and the query texts.

A frozen copy of the construction of ``triple_hybrid_rag_tpu_torch/synthetic.py``
(``build_synthetic`` and ``make_query_texts``), kept here so that a change to the
program cannot change the yardstick. Documents are bags of ``terms_per_doc``
vocabulary terms with u^4-skewed ids (a Zipf-like head). The dense rows are the
BowHash embeddings of the documents' terms: each term's direction drawn
``embedding_dim_full`` wide, cut to ``embedding_dim`` and rounded to f16, summed,
normalized and rounded to bf16, as an ingest truncates a full-width embedding.
The entity graph has random adjacency of mean degree ``graph_max_degree / 2``, and
every chunk mentions ``graph_live_mentions`` entities in a table of
``graph_max_entities_per_chunk`` slots.

Departures from the copied construction:

* a term that occurs c times in a document is one posting of weight
  ``c * w(term)``, as a real index folds term frequency into one posting per
  (term, document); the copy kept one posting per occurrence, which lets a
  document's run of postings outgrow the query slots that the program's
  segmented reduction adds up. Scores are the same sums. ``df`` counts
  documents; a ``bm25_df_cap`` above 0 keeps each term's first postings in
  document order.
* parent p's MaxSim tokens are each of its children's first
  ``maxsim_doc_tokens // children_per_parent`` terms, child after child, and
  the slots left over are masked; the copy gave parent p its first child's
  terms alone, so a question about any other child scored low against its own
  parent and the safety gate refused it.
* relation questions name two entities that their target chunk mentions (the
  copy drew the names apart from the row), and a share of the texts has no
  target (``make_texts``).

Nothing here imports the program: the hash directions follow the BowHash spec,
written out in ``hashing.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

from .hashing import direction_table, term_str

ROW_BLOCK = 1 << 17  # rows embedded at once (bounds the f32 accumulator)


def entity_name(i: int) -> str:
    return f"Acme{i:05d}"


def round_capacity(n: int, r: int) -> int:
    return max(r, ((n + r - 1) // r) * r)


def posting_weight(idf: torch.Tensor, k1: float, b: float) -> torch.Tensor:
    """BM25 contribution of one occurrence of each term, f32[V]. Every synthetic
    document has the average length, so the length term is 1."""
    denom = k1 * (1.0 - b + b * 1.0)
    return (idf * (k1 + 1.0) / (1.0 + denom)).float()


@dataclass
class Corpus:
    """The inputs on the device (and the few host tables an ingest keeps)."""

    n: int
    n_pad: int
    n_entities: int
    children_per_parent: int
    term_ids: np.ndarray  # i32[n_pad, L] host copy (texts and decode)
    offsets: torch.Tensor  # i32[V + 1] CSR offsets, term-major, documents ascending
    lengths: torch.Tensor  # i32[V] stored df (after the cap)
    postings_doc: torch.Tensor  # i32[nnz + l_max] (padded with -1)
    postings_weight: torch.Tensor  # f32[nnz + l_max]
    l_max: int
    idf: torch.Tensor  # f32[V]
    rows: torch.Tensor  # bf16[n_pad, D] (rows past n are the zero document's)
    valid: torch.Tensor  # bool[n_pad]
    tokens: torch.Tensor  # bf16[p_pad, Td, Dm]
    tok_mask: torch.Tensor  # bool[p_pad, Td]
    parent_of: torch.Tensor  # i32[n_pad]
    nbr: torch.Tensor  # i32[e_pad, deg] (-1 pads)
    chunk_entities: torch.Tensor  # i32[n_pad, M] (-1 pads)
    vocab: List[str]

    def text_of(self, row: int) -> str:
        return " ".join(term_str(int(t)) for t in self.term_ids[row])

    def entity_names(self) -> List[str]:
        return [entity_name(i) for i in range(self.n_entities)]


def build_corpus(spec: dict, seed: int, device) -> Corpus:
    """The corpus of a configuration's ``corpus`` block, on ``device``, from ``seed``."""
    dev = torch.device(device)
    n, n_ent = int(spec["n_chunks"]), int(spec["n_entities"])
    l_doc, vocab = int(spec["terms_per_doc"]), int(spec["vocab"])
    per_parent = int(spec["children_per_parent"])
    r = int(spec["capacity_round"])
    df_cap = int(spec["bm25_df_cap"]) or n
    n_pad = round_capacity(n, r)
    gen = torch.Generator(device=dev).manual_seed(seed)

    # ---- documents: u^4-skewed term ids ----
    u = torch.rand((n_pad, l_doc), generator=gen, device=dev)
    term_ids = torch.floor(vocab * u**4).to(torch.int32).clamp_(max=vocab - 1)
    term_ids[n:] = 0
    del u

    # ---- CSR postings: one per (term, document), tf folded into the weight ----
    key = term_ids[:n].reshape(-1).long() * n + torch.arange(n, device=dev).repeat_interleave(l_doc)
    key = torch.sort(key).values
    key, tf = torch.unique_consecutive(key, return_counts=True)
    st, sd = key // n, key % n
    del key
    df = torch.bincount(st, minlength=vocab)
    first = torch.zeros(vocab + 1, dtype=torch.long, device=dev)
    first[1:] = torch.cumsum(df, 0)
    keep = torch.arange(st.shape[0], device=dev) - first[st] < df_cap
    st, sd, tf = st[keep], sd[keep], tf[keep]
    del keep
    stored_df = torch.clamp(df, max=df_cap)
    offsets = torch.zeros(vocab + 1, dtype=torch.long, device=dev)
    offsets[1:] = torch.cumsum(stored_df, 0)
    nnz, l_max = int(offsets[-1]), int(stored_df.max())
    idf = torch.log1p((n - df.double() + 0.5) / (df.double() + 0.5)).float()
    w1 = posting_weight(idf, float(spec["bm25_k1"]), float(spec["bm25_b"]))
    postings_doc = torch.full((nnz + l_max,), -1, dtype=torch.int32, device=dev)
    postings_doc[:nnz] = sd.to(torch.int32)
    postings_weight = torch.zeros(nnz + l_max, dtype=torch.float32, device=dev)
    postings_weight[:nnz] = tf.float() * w1[st]
    del st, sd, tf

    # ---- dense rows: the BowHash embedding of each document's terms, drawn
    # ``embedding_dim_full`` wide and cut to ``embedding_dim`` (Matryoshka) ----
    dim, dim_full = int(spec["embedding_dim"]), int(spec["embedding_dim_full"])
    terms = [term_str(i) for i in range(vocab)]
    dirs = torch.from_numpy(direction_table("tok", vocab, dim_full, dim)).to(dev)
    rows = torch.empty((n_pad, dim), dtype=torch.bfloat16, device=dev)
    for lo in range(0, n_pad, ROW_BLOCK):
        ids = term_ids[lo:lo + ROW_BLOCK].long()
        acc = torch.zeros((ids.shape[0], dim), dtype=torch.float32, device=dev)
        for g in range(l_doc):
            acc += dirs[ids[:, g]].float()
        acc /= torch.clamp(torch.linalg.vector_norm(acc, dim=1, keepdim=True), min=1e-12)
        rows[lo:lo + ROW_BLOCK] = acc.to(torch.bfloat16)
    del dirs
    valid = torch.arange(n_pad, device=dev) < n

    # ---- MaxSim store: parent p holds each child's first Td // children terms,
    # child after child; the Td % children slots left over are masked ----
    m_dim, td = int(spec["maxsim_dim"]), int(spec["maxsim_doc_tokens"])
    mdirs = torch.from_numpy(direction_table("mtok", vocab, m_dim, m_dim)).to(dev)
    n_parents = n // per_parent
    p_pad = round_capacity(n_parents, r)
    each = td // per_parent
    parent_terms = torch.zeros((p_pad, td), dtype=torch.long, device=dev)
    kids = term_ids[: per_parent * n_parents, :each].long().reshape(n_parents, per_parent * each)
    parent_terms[:n_parents, : per_parent * each] = kids
    tokens = mdirs[parent_terms].to(torch.bfloat16)
    del mdirs, parent_terms, kids
    tok_mask = torch.zeros((p_pad, td), dtype=torch.bool, device=dev)
    tok_mask[:n_parents, : per_parent * each] = True
    parent_of = (torch.arange(n_pad, device=dev) // per_parent).to(torch.int32)

    # ---- graph: random adjacency and the chunks' entity mentions ----
    e_pad = round_capacity(n_ent, r)
    deg, live_deg = int(spec["graph_max_degree"]), int(spec["graph_live_degree"])
    nbr = torch.randint(0, n_ent, (e_pad, deg), generator=gen, device=dev, dtype=torch.int32)
    nbr[n_ent:] = -1
    nbr[:, live_deg:] = -1
    m_ent, live_m = int(spec["graph_max_entities_per_chunk"]), int(spec["graph_live_mentions"])
    chunk_entities = torch.randint(0, n_ent, (n_pad, m_ent), generator=gen, device=dev,
                                   dtype=torch.int32)
    chunk_entities[:, live_m:] = -1
    chunk_entities[n:] = -1

    return Corpus(
        n=n, n_pad=n_pad, n_entities=n_ent, children_per_parent=per_parent,
        term_ids=term_ids.cpu().numpy(), offsets=offsets.to(torch.int32),
        lengths=stored_df.to(torch.int32), postings_doc=postings_doc,
        postings_weight=postings_weight, l_max=l_max, idf=idf, rows=rows, valid=valid,
        tokens=tokens, tok_mask=tok_mask, parent_of=parent_of, nbr=nbr,
        chunk_entities=chunk_entities, vocab=terms,
    )


def query_text(terms: Sequence[int], n_terms: int) -> str:
    """A row's first ``n_terms`` distinct terms, in order."""
    seen, out = set(), []
    for t in terms:
        t = int(t)
        if t not in seen:
            seen.add(t)
            out.append(term_str(t))
        if len(out) >= n_terms:
            break
    return " ".join(out)


def make_texts(corpus: Corpus, traffic: dict, seed: int) -> Tuple[List[str], np.ndarray]:
    """The traffic's query texts. ``texts`` target rows are drawn uniformly from the
    corpus without replacement, and each text is its row's first ``query_terms``
    distinct terms. A share ``relation_share`` of the texts (drawn apart from the
    rows) get a relation question over the two entities their row mentions first,
    as a comparison question names what its evidence mentions. Another share
    ``null_share`` has no target: ``query_terms`` distinct terms drawn uniformly from the vocabulary,
    which no one chunk holds. No text repeats. Returns (texts, target rows, -1
    where there is none)."""
    rng = np.random.default_rng([seed, 1])
    count = int(traffic["texts"])
    n_terms = int(traffic["query_terms"])
    rows = rng.choice(corpus.n, size=count, replace=False)
    kind = rng.random(count)
    relation = kind < float(traffic["relation_share"])
    null = ~relation & (kind < float(traffic["relation_share"]) + float(traffic["null_share"]))
    live = corpus.chunk_entities[torch.from_numpy(rows).to(corpus.chunk_entities.device), :2]
    pairs = live.cpu().numpy()  # the live mentions are the first slots
    vocab = len(corpus.vocab)
    texts = []
    for i, r in enumerate(rows):
        if null[i]:
            text = query_text(rng.choice(vocab, size=n_terms, replace=False), n_terms)
        else:
            text = query_text(corpus.term_ids[r], n_terms)
        if relation[i]:
            a, b = pairs[i]
            text = f"How is {entity_name(a)} related to {entity_name(b)}? " + text
        texts.append(text)
    return texts, np.where(null, -1, rows)
