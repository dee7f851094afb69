"""The inputs made from a seed: the hash tables drawn in worker processes equal the
ones drawn in one, each parent's MaxSim tokens are its children's terms, postings
are uncapped, and the traffic's shares of relation and unanswerable texts."""

from __future__ import annotations

import numpy as np
import torch

from perfbench.lib import hashing
from perfbench.lib.generator import build_corpus, make_texts

SPEC = {"n_chunks": 2000, "n_entities": 100, "terms_per_doc": 16, "vocab": 512,
        "children_per_parent": 5, "capacity_round": 64, "bm25_df_cap": 0, "bm25_k1": 1.5,
        "bm25_b": 0.75, "embedding_dim": 32, "embedding_dim_full": 64, "maxsim_dim": 16,
        "maxsim_doc_tokens": 12, "graph_max_degree": 8, "graph_live_degree": 4,
        "graph_max_entities_per_chunk": 16, "graph_live_mentions": 2}


def test_pool_draws_the_same_table(monkeypatch):
    serial = hashing.direction_table("tok", 300, 64, 32)
    monkeypatch.setattr(hashing, "POOL_MIN_TERMS", 64)
    assert np.array_equal(hashing.direction_table("tok", 300, 64, 32), serial)
    # a row of the table is the full-width unit direction, cut
    full = hashing.token_direction(hashing.term_str(7), 64)
    assert np.array_equal(serial[7], full[:32].astype(np.float16))


def test_corpus_layout():
    c = build_corpus(SPEC, 2147483901, "cpu")
    mdirs = hashing.direction_table("mtok", SPEC["vocab"], 16, 16)
    each = 12 // 5  # two terms of each child, two slots masked
    for p in (0, 7, 399):
        want = np.concatenate([c.term_ids[5 * p + k, :each] for k in range(5)])
        got = c.tokens[p, :10].float().numpy()
        assert np.array_equal(got, torch.from_numpy(mdirs[want]).to(torch.bfloat16).float().numpy())
        assert c.tok_mask[p].tolist() == [True] * 10 + [False] * 2
    df = np.bincount(np.concatenate([np.unique(r) for r in c.term_ids[:c.n]]), minlength=512)
    assert np.array_equal(c.lengths.numpy(), df)  # uncapped: every document's posting kept
    norms = torch.linalg.vector_norm(c.rows[:c.n].float(), dim=1)
    assert torch.allclose(norms, torch.ones_like(norms), atol=1e-2)
    assert (c.chunk_entities[:c.n, :2] >= 0).all() and (c.chunk_entities[:, 2:] == -1).all()


def test_traffic_shares():
    c = build_corpus(SPEC, 2147483902, "cpu")
    texts, rows = make_texts(c, {"texts": 1500, "query_terms": 6, "relation_share": 0.3349,
                                 "null_share": 0.1178}, 2147483902)
    relation = np.array([t.startswith("How is ") for t in texts])
    null = rows < 0
    assert len(set(texts)) == len(texts)
    assert abs(relation.mean() - 0.3349) < 0.04 and abs(null.mean() - 0.1178) < 0.03
    assert not (relation & null).any()
    for t, r in zip(texts, rows):
        if r >= 0:
            terms = t.split("? ")[-1].split()
            assert len(terms) == 6 and set(terms) <= {hashing.term_str(i) for i in c.term_ids[r]}
