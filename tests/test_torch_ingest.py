"""The port's ingest side against the JAX reference, module by module, on the same
inputs (texts and files written from fixed strings; vectors from a numpy seed).

Tolerance: none. Every record and array must be equal: chunks (ids, texts,
offsets, pages, hashes), loaded pages, entity and relation ids (``uuid5``), the
BM25 arrays (the reference's build is NumPy, so the port's are bit-equal), the dense
rows of all four storage dtypes after build and append (bf16 rounds to nearest even
on both sides; the quantizers round half to even), the graph tables, the MaxSim
token stores, and the ingestor's corpus rows and results.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from triple_hybrid_rag_tpu import chunker as ref_chunker
from triple_hybrid_rag_tpu import loader as ref_loader
from triple_hybrid_rag_tpu.index import bm25_index as ref_bm25
from triple_hybrid_rag_tpu.index import dense_index as ref_dense
from triple_hybrid_rag_tpu.index import graph_index as ref_graph
from triple_hybrid_rag_tpu.index import maxsim_index as ref_maxsim
from triple_hybrid_rag_tpu.ingest import Ingestor as RefIngestor
from triple_hybrid_rag_tpu.models import entity_extractor as ref_ee
from triple_hybrid_rag_tpu.models.embedder import BowHashEmbedder as RefBow

from torch_port_helpers import torch_config
from triple_hybrid_rag_tpu_torch import chunker, loader
from triple_hybrid_rag_tpu_torch.corpus import CorpusStore
from triple_hybrid_rag_tpu_torch.index import bm25_index, dense_index, graph_index, maxsim_index
from triple_hybrid_rag_tpu_torch.index.state import IndexState, _to_tensor
from triple_hybrid_rag_tpu_torch.ingest import Ingestor
from triple_hybrid_rag_tpu_torch.models import entity_extractor as ee
from triple_hybrid_rag_tpu_torch.models.embedder import BowHashEmbedder
from triple_hybrid_rag_tpu_torch.types import IngestionStatus

DOC_HASH = "ab" * 32

TEXT = """# Contrato de Prestação de Serviços

A Acme Consultoria, sediada em São Paulo, faz parte de Grupo Vértice Holdings. O
contrato foi assinado por João Silva em 14 de maio de 2019 e custa R$ 12.500,00.

## Payment Terms

Acme Corp works for Globex Inc and provides consulting to Initech Software.
Invoices are settled within thirty days; see the module payments.settlement and
the package numpy.linalg for details. Dr. Maria Souza signed by Beta Logistics.

| Item | Preço | Prazo |
|------|-------|-------|
| Consultoria | R$ 5.000 | 30 dias |
| Auditoria | R$ 7.500 | 45 dias |

### Anexo

""" + " ".join(
    f"Cláusula {i} trata da cobrança e da rescisão do serviço número {i} em Recife."
    for i in range(90)
)

DOCS = [
    "# Billing\n\nAcme Corp requires settlement within thirty days. Invoices route "
    "through Beta Logistics. " + " ".join(f"Clause {i} covers billing case {i}." for i in range(40)),
    "# Shipping\n\nGlobex Inc ships from Recife. Beta Logistics is part of Globex Inc. "
    + " ".join(f"Route {i} leaves the depot on day {i}." for i in range(30)),
    "# Notes\n\nA short note about Acme Corp and Initech Software in São Paulo.",
]


@pytest.fixture
def cfg(small_config):
    return small_config.replace(
        graph_enabled=True, embedding_dtype="float32", safety_threshold=0.2, use_native=False,
        capacity_round=16,
    )


def _records(items):
    out = []
    for x in items:
        d = dataclasses.asdict(x)
        for k, v in d.items():
            if hasattr(v, "value"):
                d[k] = v.value
        out.append(d)
    return out


def _chunks(cfg, text, mod, page_map=None):
    return mod.HierarchicalChunker(cfg).chunk_document(text, DOC_HASH, page_map)


@pytest.mark.parametrize("sizes", [(1000, 200), (120, 40)])
def test_chunker_matches_reference(cfg, sizes):
    c = cfg.replace(parent_chunk_tokens=sizes[0], child_chunk_tokens=sizes[1])
    page_map = [(0, 900, 1), (900, 2600, 2), (2600, 10**6, 3)]
    for pm in (None, page_map):
        ref_p, ref_c = _chunks(c, TEXT, ref_chunker, pm)
        got_p, got_c = _chunks(torch_config(c), TEXT, chunker, pm)
        assert _records(got_p) == _records(ref_p)
        assert _records(got_c) == _records(ref_c)
    assert any(x.modality.value == "table" for x in got_c) and len(got_p) >= 1
    assert any("Preço" in x.text and "Auditoria" in x.text for x in got_c)  # table kept whole


def _write(tmp_path, name, data):
    p = tmp_path / name
    p.write_bytes(data.encode() if isinstance(data, str) else data)
    return p


LOADER_FILES = {
    "notes.txt": "Plain text.\n\n" + "\n\n".join(f"Paragraph {i} " * 40 for i in range(12)),
    "guide.md": TEXT,
    "page.html": "<html><head><style>p{}</style><script>x()</script></head><body><h1>Title</h1>"
                 "<p>First <b>para</b>.</p><table><tr><th>A</th><th>B</th></tr><tr><td>1</td>"
                 "<td>2</td></tr><tr><td>3</td></tr></table><h2>Sub</h2><div>Más texto</div></body></html>",
    "rows.csv": "name,amount,city\n" + "\n".join(f"item{i},{i * 10},Recife" for i in range(300)),
    "rows.tsv": "a\tb\n1\t2\n3\t4\n",
    "data.json": json.dumps({"a": {"b": [1, 2, {"c": "São"}]}, "d": "text"}),
    "blob.bin": "plain words without an extension type",
}


def test_text_loaders_match_reference(tmp_path):
    ref, got = ref_loader.DocumentLoader(), loader.DocumentLoader()
    for name, data in LOADER_FILES.items():
        p = _write(tmp_path, name, data)
        a, b = ref.load(p), got.load(p)
        assert (b.filename, b.file_type.value) == (a.filename, a.file_type.value), name
        assert _records(b.pages) == _records(a.pages), name
        assert b.full_text == a.full_text
    bad = _write(tmp_path, "junk.bin", bytes(range(256)) * 8)
    for ld in (ref, got):
        with pytest.raises(ref_loader.UnsupportedFormatError if ld is ref else loader.UnsupportedFormatError):
            ld.load(bad)
    pdf = _write(tmp_path, "scan.pdf", b"%PDF-1.4 not really")
    with pytest.raises(ref_loader.UnsupportedFormatError) as want:
        ref.load(pdf)
    with pytest.raises(loader.UnsupportedFormatError, match="no text extractable") as err:
        got.load(pdf)  # the PDF loader is ported (tests/test_torch_formats.py)
    assert str(err.value) == str(want.value)
    assert loader.detect_file_type("x.png", b"\x89PNG\r\n\x1a\n") == ref_loader.detect_file_type(
        "x.png", b"\x89PNG\r\n\x1a\n"
    )


def _extract_all(cfg, mod, chunk_mod, texts):
    store = mod.EntityStore()
    ext = mod.RuleBasedExtractor(cfg)
    kids_all = []
    results = []
    for i, text in enumerate(texts):
        parents, children = chunk_mod.HierarchicalChunker(cfg).chunk_document(text, f"{i:02d}" * 32)
        kids_all += children
        for p in parents:
            kids = [c for c in children if c.parent_id == p.parent_id]
            r = ext.extract(p, kids)
            results.append(r)
            store.store_extraction(r)
    return store, results, kids_all


def test_rule_extractor_and_entity_store_match_reference(cfg):
    texts = [TEXT] + DOCS
    ref_store, ref_res, ref_kids = _extract_all(cfg, ref_ee, ref_chunker, texts)
    store, res, kids = _extract_all(torch_config(cfg), ee, chunker, texts)
    for a, b in zip(ref_res, res):
        assert _records(b.entities) == _records(a.entities)
        assert _records(b.relations) == _records(a.relations)
        assert _records(b.mentions) == _records(a.mentions)
    assert list(store.entities) == list(ref_store.entities)
    assert _records(store.relations) == _records(ref_store.relations)
    assert _records(store.mentions) == _records(ref_store.mentions)
    assert store.stats() == ref_store.stats() and store.stats()["relations"] > 0
    assert store.link_mentions(kids) == ref_store.link_mentions(ref_kids)
    assert _records(store.mentions) == _records(ref_store.mentions)
    for name in ("acme corp", "Globex", "Acme Consultoria", "nothing like it"):
        assert [e.entity_id for e in store.lookup(name)] == [
            e.entity_id for e in ref_store.lookup(name)
        ]


def _bm25_texts():
    parents, children = ref_chunker.HierarchicalChunker(
        ref_chunker.RAGConfig(parent_chunk_tokens=120, child_chunk_tokens=30)
    ).chunk_document(TEXT + "\n\n" + "\n\n".join(DOCS), DOC_HASH)
    return [c.text for c in children]


@pytest.mark.parametrize("df_cap", [0, 3])
@pytest.mark.parametrize("backend", ["sorted", "termtable"])
def test_bm25_build_bit_equal(cfg, df_cap, backend):
    texts = _bm25_texts()
    c = cfg.replace(bm25_df_cap=df_cap, lexical_backend=backend, doc_term_capacity=16)
    ref = ref_bm25.build_bm25_index(texts, c)
    got = bm25_index.build_bm25_index(texts, torch_config(c))
    offs, lens, pd, pt = ref.host_csr
    pairs = [
        (got.offsets, offs), (got.lengths, lens), (got.postings_doc, pd),
        (got.postings_weight, ref.host_weights), (got.term_ids, ref.term_ids),
        (got.term_weights, ref.term_weights), (got.idf, ref.idf),
    ]
    for a, b in pairs:
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert (got.n_docs, got.n_pad, got.l_max, got.overflow_docs) == (
        ref.n_docs, ref.n_pad, ref.l_max, ref.overflow_docs
    )
    assert got.vocab.to_list() == ref.vocab.to_list()
    if df_cap:
        assert int(np.max(got.lengths)) == df_cap and got.overflow_docs > 0  # the cap cuts
    # placed under the backend, the port's arrays give the reference's placed tensors
    host = {"vocab": got.vocab}
    st = IndexState.from_numpy(
        {"parent_of": np.zeros(got.n_pad, np.int32), **got.arrays()}, host, torch_config(c), "cpu"
    )
    assert st.lexical_mode == backend
    ref_arrays = {
        "parent_of": np.zeros(got.n_pad, np.int32), "bm25_offsets": offs, "bm25_lengths": lens,
        "bm25_postings_doc": pd, "bm25_postings_weight": ref.host_weights, "bm25_idf": ref.idf,
        "bm25_term_ids": ref.term_ids, "bm25_term_weights": ref.term_weights,
    }
    st_ref = IndexState.from_numpy(
        {k: np.asarray(v) for k, v in ref_arrays.items()}, {"vocab": ref.vocab.to_list()},
        torch_config(c), "cpu",
    )
    for key in ("lex_offsets", "lex_lengths", "lex_pd", "lex_pt", "term_ids", "term_weights"):
        a, b = getattr(st, key), getattr(st_ref, key)
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b), key


def _bits(t):
    t = torch.as_tensor(t) if not torch.is_tensor(t) else t
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _ref_bits(x):
    return _bits(_to_tensor(np.asarray(x), "cpu"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "int4"])
def test_dense_build_and_append_bit_equal(cfg, dtype):
    rng = np.random.default_rng(7)
    vecs = rng.standard_normal((21, cfg.embedding_dim_full)).astype(np.float32)
    more = rng.standard_normal((13, cfg.embedding_dim_full)).astype(np.float32)
    c = cfg.replace(embedding_dtype=dtype)
    ref = ref_dense.build_dense_index(vecs, c)
    got = dense_index.build_dense_index(vecs, torch_config(c), "cpu")
    for step in range(3):
        assert (got.n_docs, got.n_pad, got.dim) == (ref.n_docs, ref.n_pad, ref.dim)
        np.testing.assert_array_equal(_bits(got.embeddings), _ref_bits(ref.embeddings))
        np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
        assert (got.scales is None) == (ref.scales is None) == (dtype not in ("int8", "int4"))
        if got.scales is not None:
            np.testing.assert_array_equal(got.scales.numpy(), np.asarray(ref.scales))
        # first into spare capacity, then past it (the index grows)
        block = more[: 5 if step == 0 else 13]
        ref, got = ref.append(block), got.append(block)
    assert got.n_pad > 32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_maxsim_build_and_append_equal(cfg, dtype):
    c = cfg.replace(embedding_dtype=dtype)
    texts = _bm25_texts()
    first, later = texts[:19], texts[19:40]
    ref_emb, emb = RefBow(dim=64, config=c), BowHashEmbedder(dim=64, config=torch_config(c))
    ref = ref_maxsim.build_maxsim_index(first + [""], ref_emb, c, batch_size=8)
    got = maxsim_index.build_maxsim_index(first + [""], emb, torch_config(c), batch_size=8,
                                          device="cpu")
    for step in range(2):
        assert got.n_parents == ref.n_parents and got.tokens.shape == tuple(ref.tokens.shape)
        np.testing.assert_array_equal(_bits(got.tokens), _ref_bits(ref.tokens))
        np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
        toks = ref_emb.token_embeddings(later, dim=c.maxsim_dim)
        np.testing.assert_array_equal(toks, emb.token_embeddings(later, dim=c.maxsim_dim))
        ref, got = ref.append(toks), got.append(toks)
    assert not got.mask.numpy()[19].any()  # the empty text has no tokens


def _ingest_both(cfg, tmp_path, **kw):
    ref = RefIngestor(config=cfg, **kw)
    got = Ingestor(config=torch_config(cfg), device="cpu", **kw)
    return ref, got


def test_graph_build_equal(cfg, tmp_path):
    c = cfg.replace(graph_max_degree=3, graph_max_entities_per_chunk=2, graph_seed_stop_min=1,
                    graph_seed_stop_df=0.3)
    ref_ing, ing = _ingest_both(c, tmp_path)
    for i, text in enumerate([TEXT] + DOCS):
        ref_ing.ingest_text(text, name=f"d{i}.md")
        ing.ingest_text(text, name=f"d{i}.md")
    ref = ref_graph.build_graph_index(ref_ing.entity_store, ref_ing.corpus, c)
    got = graph_index.build_graph_index(ing.entity_store, ing.corpus, torch_config(c))
    np.testing.assert_array_equal(got.nbr, np.asarray(ref.nbr))
    np.testing.assert_array_equal(got.chunk_entities, ref.host_chunk_entities)
    np.testing.assert_array_equal(got.seed_stop, ref.seed_stop)
    assert got.seed_stop.any() and got.overflow_entities == ref.overflow_entities > 0
    assert got.row_of == ref.row_of and (got.n_entities, got.e_pad) == (ref.n_entities, ref.e_pad)


def test_ingestor_matches_reference(cfg, tmp_path):
    ref, got = _ingest_both(cfg, tmp_path)
    outs = []
    for i, text in enumerate(DOCS):
        p = _write(tmp_path, f"doc{i}.md", text)
        outs.append((ref.ingest_file(p, collection="a"), got.ingest_file(p, collection="a")))
    p0 = tmp_path / "doc0.md"
    outs.append((ref.ingest_file(p0, collection="a"), got.ingest_file(p0, collection="a")))  # skip
    outs.append((ref.ingest_file(p0, collection="b"), got.ingest_file(p0, collection="b")))
    outs.append((ref.ingest_file(p0, collection="a", force=True),
                 got.ingest_file(p0, collection="a", force=True)))  # everything deduped
    outs.append((ref.ingest_text(DOCS[2], name="inline.md"), got.ingest_text(DOCS[2], name="inline.md")))
    bad = _write(tmp_path, "broken.json", "{not json")
    outs.append((ref.ingest_file(bad), got.ingest_file(bad)))
    keys = ("doc_id", "filename", "status", "n_pages", "n_parents", "n_children", "n_entities",
            "n_relations", "n_mentions", "n_deduped", "skipped", "error")
    for a, b in outs:
        assert {k: getattr(b, k) for k in keys} == {k: getattr(a, k) for k in keys}
    assert outs[3][1].skipped and outs[4][1].doc_id != outs[0][1].doc_id
    assert outs[5][1].n_deduped > 0 and outs[-1][1].status == IngestionStatus.FAILED
    assert _records(got.corpus.children) == _records(ref.corpus.children)
    assert _records(got.corpus.parents) == _records(ref.corpus.parents)
    assert got.corpus.collection_ids() == ref.corpus.collection_ids() == {"a": 0, "b": 1, "default": 2}
    assert got.corpus.child_collection_rows() == ref.corpus.child_collection_rows()
    assert got.corpus.parent_rows() == ref.corpus.parent_rows()
    assert got.corpus.dirty and ref.corpus.dirty
    # the indexes built from both corpora are equal too (one build, then an append)
    for step in range(2):
        (rb, rd, rg), (gb, gd, gg) = ref.build_indexes(), got.build_indexes()
        np.testing.assert_array_equal(gb.postings_weight, rb.host_weights)
        np.testing.assert_array_equal(_bits(gd.embeddings), _ref_bits(rd.embeddings))
        np.testing.assert_array_equal(gg.chunk_entities, rg.host_chunk_entities)
        assert not got.corpus.dirty
        if step == 0:
            p = _write(tmp_path, "late.md", "# Late\n\nInitech Software moved to Recife in 2021.")
            ref.ingest_file(p), got.ingest_file(p)
    assert gd.n_docs == len(got.corpus)


def test_ner_retry_then_skip_and_failing_loader(cfg, tmp_path):
    class Flaky:
        def __init__(self):
            self.calls = 0

        def extract(self, parent, children):
            self.calls += 1
            raise RuntimeError("NER down")

    class BrokenLoader:
        def load(self, path):
            raise OSError("disk gone")

    p = _write(tmp_path, "doc.md", DOCS[0])
    exts = (Flaky(), Flaky())
    ref = RefIngestor(config=cfg, extractor=exts[0])
    got = Ingestor(config=torch_config(cfg), extractor=exts[1], device="cpu")
    a, b = ref.ingest_file(p), got.ingest_file(p)
    assert b.status == a.status == IngestionStatus.COMPLETED
    assert b.error == a.error and "NER failed" in b.error and b.n_entities == 0
    assert exts[1].calls == exts[0].calls == 3 * b.n_parents
    for ing in (RefIngestor(config=cfg, loader=BrokenLoader()),
                Ingestor(config=torch_config(cfg), loader=BrokenLoader(), device="cpu")):
        res = ing.ingest_file(p)
        assert res.status == IngestionStatus.FAILED and res.error == "OSError: disk gone"
        assert ing.corpus.documents[res.doc_id].status == IngestionStatus.FAILED


def test_fail_soft_embedder_reports_failed_items(cfg):
    from triple_hybrid_rag_tpu_torch.models.embedder import FailSoftEmbedder

    class Flaky:
        dim = 4

        def embed_texts(self, texts):
            raise RuntimeError("device lost")

        def embed_query(self, text):
            if "bad" in text:
                raise RuntimeError("device lost")
            return np.ones(4, np.float32)

    emb = FailSoftEmbedder(Flaky())
    out = emb.embed_texts(["ok", "bad", "ok again"])
    assert emb.last_errors == [1] and not out[1].any() and out[0].all()
    emb.inner.embed_texts = lambda texts: np.ones((len(texts), 4), np.float32)
    emb.embed_texts(["x"])
    assert emb.last_errors == []


def test_corpus_store_matches_reference(cfg):
    from triple_hybrid_rag_tpu.corpus import CorpusStore as RefStore
    from triple_hybrid_rag_tpu.types import Document as RefDocument
    from triple_hybrid_rag_tpu_torch.types import Document

    ref, got = RefStore(), CorpusStore()
    for store, mod, doc_t in ((ref, ref_chunker, RefDocument), (got, chunker, Document)):
        for i, text in enumerate(DOCS + [DOCS[0]]):
            doc_id = f"{i:02d}" * 32
            store.register_document(doc_t(doc_id=doc_id, filename=f"{i}.md", collection="ab"[i % 2]))
            p, c = mod.HierarchicalChunker(cfg).chunk_document(text, doc_id)
            store.add_chunks(p, c)
    assert _records(got.children) == _records(ref.children)
    assert got.stats() == ref.stats() and got.collection_ids() == ref.collection_ids()
    assert got.child(got.children[3].chunk_id).row == 3 and got.parent_by_row(0).row == 0
    with pytest.raises(KeyError):
        got.add_chunks([], [dataclasses.replace(got.children[0], chunk_id="x", parent_id="nope")])


def test_retriever_from_indexes_places_the_same_state(cfg):
    """``Retriever.from_indexes`` over an ingestor's prebuilt indexes places what
    ``make_retriever`` places, deriving nothing again."""
    from triple_hybrid_rag_tpu_torch.retrieval import Retriever

    ing = Ingestor(config=torch_config(cfg), device="cpu")
    for i, text in enumerate(DOCS):
        ing.ingest_text(text, name=f"d{i}.md")
    built = ing.make_retriever()
    again = Retriever.from_indexes(
        ing.corpus, ing.config, bm25_index=built.bm25_index, dense_index=built.dense_index,
        graph_index=built.graph_index, maxsim_index=built.maxsim_index,
        embedder=ing.embedder.inner, device="cpu",
    )
    for key in ("lex_pd", "lex_pt", "embeddings", "nbr", "maxsim_tokens", "parent_of",
                "collection_of"):
        a, b = getattr(again.state, key), getattr(built.state, key)
        assert a is not None and torch.equal(a, b), key
    assert again.state.n_pad == built.state.n_pad and again.parent_emb is None
