"""The port's native BM25 build (``native.py``) against the JAX reference, on the CPU.

The library is built once, from the repository's ``native/thr_native.cpp``, into a
temporary directory under the build's file lock. Its tokenizer and vocabulary must
match the port's Python ``Analyzer`` and ``Vocabulary``, and the BM25 arrays it
builds over ``tests/test_native.py``'s EN/PT corpus must equal the reference's
pure-Python build bit for bit (offsets, stored df, postings, per-posting weights,
idf, term table). The module's load state is restored after the tests, so the rest
of the worker's tests see the library as they found it.
"""

import numpy as np
import pytest

from triple_hybrid_rag_tpu.config import RAGConfig
from triple_hybrid_rag_tpu.index.bm25_index import build_bm25_index as ref_build_bm25

from torch_port_helpers import torch_config
from triple_hybrid_rag_tpu_torch import native
from triple_hybrid_rag_tpu_torch.analyzer import Analyzer
from triple_hybrid_rag_tpu_torch.index import bm25_index as port_bm25

CORPUS = [
    "The quick brown foxes jump over the lazy dogs near the river banks.",
    "A renovação do contrato não será automática; as cláusulas exigem aviso prévio.",
    "Payment schedules, invoices and receipts are processed quarterly (Q1-Q4).",
    "Os preços das ações subiram 3,5% após o anúncio das fusões e aquisições.",
    "Mixed língua text with naïve café-style wörds and UPPERCASE TERMS.",
    "",
    "short",
    "repetition repetition repetition repetition unique",
]


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """The library built into a temporary directory and loaded; the module's load
    state restored afterwards."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "_lib", None)
        mp.setattr(native, "_load_error", None)
        build_dir = tmp_path_factory.mktemp("native")
        assert native.build_library(build_dir), native.load_error()
        yield build_dir


def test_build_library_into_its_directory(built):
    lib = native.library_path(built)
    assert lib.exists() and lib.parent == built and (built / "lock").exists()
    assert lib.name.startswith("libthr_native-") and lib.suffix == ".so"
    assert native.available() and native.load_error() is None
    # a second call finds the build and loads it again without compiling
    mtime = lib.stat().st_mtime_ns
    assert native.build_library(built) and lib.stat().st_mtime_ns == mtime
    assert not any(p.suffix == ".so" for p in native.SOURCE.parent.iterdir() if p != native.MAKE_LIB)


def test_available_loads_but_never_builds(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_error", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "empty")
    monkeypatch.setattr(native, "MAKE_LIB", tmp_path / "absent.so")
    assert not native.available()
    assert "not built" in native.load_error()
    assert not (tmp_path / "empty").exists()
    with pytest.raises(RuntimeError, match="unavailable"):
        native.NativeAnalyzer(torch_config(RAGConfig()))


def test_failed_build_reports_the_compiler(monkeypatch, tmp_path):
    bad = tmp_path / "thr_native.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "_load_error", None)
    assert native.build_library(tmp_path / "out") is False
    assert "exit" in native.load_error()
    assert not list((tmp_path / "out").glob("*.so")) and not list((tmp_path / "out").glob("*.tmp"))


def test_tokenization_and_vocab_parity(built):
    cfg = torch_config(RAGConfig())
    py = Analyzer(cfg)
    na = native.NativeAnalyzer(cfg)
    lists = na.token_lists(CORPUS)
    terms = na.vocab_terms()
    assert na.vocab_size == len(terms)
    for text, ids in zip(CORPUS, lists):
        assert [terms[t] for t in ids] == py.tokenize(text), text
    py_tokens, py_vocab = port_bm25.tokenize_corpus(CORPUS, py)
    assert terms == list(py_vocab.terms) and lists == py_tokens


@pytest.mark.parametrize("df_cap", [0, 2])
@pytest.mark.parametrize("term_capacity", [32, 3])
def test_native_arrays_bit_equal_to_reference(built, df_cap, term_capacity):
    """Overflow of the term table (capacity 3) and the df cap's top-tf selection
    (cap 2) included."""
    cfg = RAGConfig(capacity_round=8, doc_term_capacity=term_capacity, max_query_terms=8,
                    bm25_df_cap=df_cap)
    ref = ref_build_bm25(CORPUS, cfg.replace(use_native=False))
    got = port_bm25.build_bm25_index(CORPUS, torch_config(cfg))
    offs, lens, pd, _ = ref.host_csr
    want = {"offsets": offs, "lengths": lens, "postings_doc": pd,
            "postings_weight": ref.host_weights, "idf": np.asarray(ref.idf),
            "term_ids": np.asarray(ref.term_ids), "term_weights": np.asarray(ref.term_weights)}
    for name, arr in want.items():
        mine = getattr(got, name)
        assert mine.dtype == arr.dtype and mine.shape == arr.shape, name
        np.testing.assert_array_equal(mine.view(np.uint8), np.ascontiguousarray(arr).view(np.uint8),
                                      err_msg=name)
    assert got.vocab.to_list() == ref.vocab.to_list()
    assert (got.n_docs, got.n_pad, got.l_max, got.overflow_docs) == (
        ref.n_docs, ref.n_pad, ref.l_max, ref.overflow_docs)
    assert (got.overflow_docs > 0) == (term_capacity == 3)


def test_native_build_conditions(built, monkeypatch):
    """The native build is taken only under the reference's conditions: the stock
    analyzer, ``use_native`` and accent folding, and no given tokens or vocabulary."""
    calls = []
    real = port_bm25._build_native
    monkeypatch.setattr(port_bm25, "_build_native", lambda t, c: calls.append(1) or real(t, c))
    cfg = torch_config(RAGConfig(capacity_round=8, max_query_terms=8))

    class MyAnalyzer(Analyzer):
        pass

    port_bm25.build_bm25_index(CORPUS, cfg)
    port_bm25.build_bm25_index(CORPUS, cfg, Analyzer(cfg))
    assert len(calls) == 2
    port_bm25.build_bm25_index(CORPUS, cfg, MyAnalyzer(cfg))
    port_bm25.build_bm25_index(CORPUS, cfg.replace(use_native=False))
    port_bm25.build_bm25_index(CORPUS, cfg.replace(analyzer_strip_accents=False))
    assert len(calls) == 2


def test_native_search_matches_reference(built):
    import jax.numpy as jnp

    cfg = RAGConfig(capacity_round=8, doc_term_capacity=16, max_query_terms=8)
    ref = ref_build_bm25(CORPUS, cfg.replace(use_native=False))
    got = port_bm25.build_bm25_index(CORPUS, torch_config(cfg))
    for q in (["contrato", "aviso"], ["quick", "fox", "river"], ["repetition"], ["nothing"]):
        keywords = Analyzer(torch_config(cfg)).tokenize(" ".join(q))
        want_ids, want_vals = ref.search(keywords, 5)
        ids, vals = got.search(keywords, 5, device="cpu")
        np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
        np.testing.assert_array_equal(vals.numpy().view(np.int32),
                                      np.asarray(want_vals).view(np.int32))
        np.testing.assert_array_equal(
            got.score(ref.encode_query(keywords), device="cpu").numpy(),
            np.asarray(ref.score(jnp.asarray(ref.encode_query(keywords)))))
