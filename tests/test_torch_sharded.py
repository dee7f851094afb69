"""The port's multi-device execution (``parallel/``) against the JAX package's, on
the CPU.

The reference runs its 8-shard programs over the suite's 8 virtual CPU devices
(``tests/conftest.py``); the port runs the same folds over ``devices=["cpu"] * 8``
in one process. On ``tests/test_sharded.py``'s fixture, carried over with
``IndexState.from_numpy``. The tolerances:

- port against the reference's 8-shard engine: chunk ids and refusals equal; the
  sorted lexical channel's scores bit-equal, the term table's within 1e-5; final
  scores within 1e-5, and 1e-4 for the f32-row near tie that
  ``tests/test_torch_engine.py`` documents (the same query and tenant);
- the port's 8 shards against its own 1 shard: final ids and refusals equal; the
  lexical and graph channels' lists, the int8 / int4 dense channel's and every
  final score under int8 / int4 rows bit for bit (their scores are exact integer
  sums and the merge selects, never adds); bf16 / f32 dense scores within 1e-6
  (a shard's matrix product has another shape than the whole corpus's) and final
  scores within ``tests/test_torch_engine.py``'s 1e-5 (1e-4 at the f32 near tie);
- IVF at 8 shards: each shard clusters its own rows, so the port's 8-shard IVF is
  held against the reference's 8-shard IVF (ids equal), not against 1 shard;
- the mesh folds (2 x 4, multislice 2 x 4 and 4 x 2) against 1 x 8: ids equal.
"""

import hashlib

import numpy as np
import pytest
import torch

from triple_hybrid_rag_tpu.chunker import HierarchicalChunker
from triple_hybrid_rag_tpu.parallel import ShardedEngine as RefEngine
from triple_hybrid_rag_tpu.parallel import corpus_mesh as ref_corpus_mesh
from triple_hybrid_rag_tpu.parallel import multislice_mesh as ref_multislice_mesh
from triple_hybrid_rag_tpu.retrieval import Retriever as RefRetriever
from triple_hybrid_rag_tpu.types import Document

from test_sharded import build_fixture
from test_torch_engine import QUERIES, _compare
from torch_port_helpers import small_config, state_from_retriever
from triple_hybrid_rag_tpu_torch import parallel
from triple_hybrid_rag_tpu_torch.engine import Engine
from triple_hybrid_rag_tpu_torch.parallel import (
    ShardedEngine,
    corpus_mesh,
    default_mesh,
    multislice_mesh,
    single_device_mesh,
)

CPU8 = ["cpu"] * 8
ATOL = 1e-5
NEAR_TIE_ATOL = 1e-4
DENSE_ATOL = 1e-6
SCOPES = ["a", "b", None, "nope", "a", "b"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's small tensors, so the suite's parallel
    workers do not oversubscribe the cores; restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def base_config():
    return small_config().replace(embedding_dtype="float32", safety_threshold=0.2, capacity_round=8)


def retriever(cfg, with_graph=True, n_docs=12):
    corpus, gidx = build_fixture(cfg, n_docs=n_docs, with_graph=with_graph)
    for i in range(n_docs):  # two tenants, so scoped batches mask real rows
        doc_id = hashlib.sha256(f"doc{i}".encode()).hexdigest()
        corpus.register_document(
            Document(doc_id=doc_id, filename=f"d{i}.md", collection=("a", "b")[i % 2])
        )
    return RefRetriever(corpus, cfg, graph_index=gidx)


# name -> (config changes, with_graph, documents). "bf16": 4 activated-entity slots
# are below the fixture graph's worst-case reach, so wide batches take the dense
# chunk_entities scan and batches of <= graph_sparse_max_batch the sparse mention
# walk (the small-batch override); "graph_sparse": the exact sparse walk at every
# width. The dense scan pads each shard to one 524,288-row block (ops/graph.py, as
# the reference), which is most of this file's time: the other row dtypes run
# without the graph channel.
CASES = {
    "bf16": (dict(embedding_dtype="bfloat16", graph_active_slots=4), True, 12),
    "f32": (dict(graph_enabled=False), False, 12),
    "int8": (dict(embedding_dtype="int8", graph_enabled=False), False, 12),
    "int4": (dict(embedding_dtype="int4", graph_enabled=False), False, 12),
    "untiered": (dict(embedding_dtype="bfloat16", lexical_tiering=False), False, 12),
    "termtable": (dict(embedding_dtype="bfloat16", lexical_backend="termtable"), True, 12),
    "graph_sparse": (dict(embedding_dtype="bfloat16"), True, 12),
    # 3 blocks of 2 rows a shard, 2 probed: a real approximation
    "ivf": (dict(embedding_dtype="bfloat16", semantic_backend="ivf", ivf_block_rows=2,
                 ivf_probes=2), False, 40),
}


@pytest.fixture(scope="module")
def built():
    """Per case (built once for the module, on first use): the reference retriever,
    its 8-shard engine, the port's state and the port's 8- and 1-shard engines."""
    cache = {}

    def get(name):
        if name not in cache:
            changes, with_graph, n_docs = CASES[name]
            ret = retriever(base_config().replace(**changes), with_graph, n_docs)
            st = state_from_retriever(ret)
            cache[name] = (
                ret, RefEngine(ret, ref_corpus_mesh()), st,
                Engine(st, device="cpu", mesh=corpus_mesh(devices=CPU8)),
                Engine(st, device="cpu"),
            )
        return cache[name]

    return get


def _batches(name="bf16"):
    """(queries, collections) of each comparison: the wide batch unscoped and
    scoped per query, one query scoped batch-wide, and for the graph cases a plain
    and a graph-shaped query alone (the graph-skip program and the small-batch
    sparse walk). Each other width costs the reference an 8-device compile."""
    out = [(QUERIES, None), (QUERIES, SCOPES), ([QUERIES[5]], ["a"])]
    if name in ("bf16", "graph_sparse"):
        out += [([QUERIES[0]], None), ([QUERIES[5]], None)]
    return out


# ------------------------------------------------------------------ meshes


def test_mesh_helpers_match_the_reference():
    m = corpus_mesh(devices=CPU8)
    assert m.shape == dict(ref_corpus_mesh().shape) == {"data": 1, "shard": 8}
    assert m.devices() == [torch.device("cpu")] * 8 and m.size == 8
    m2 = corpus_mesh(n_shards=4, data_parallel=2, devices=CPU8)
    assert m2.shape == dict(ref_corpus_mesh(n_shards=4, data_parallel=2).shape)
    assert single_device_mesh("cpu").shape == {"data": 1, "shard": 1}
    for args in ((2, 4, 1), (2, 2, 2), (1, 8, 1)):
        assert multislice_mesh(*args, devices=CPU8).shape == dict(ref_multislice_mesh(*args).shape)
    assert default_mesh("cpu").shape == {"data": 1, "shard": 1}


@pytest.mark.parametrize("fn, kwargs", [
    ("corpus", dict(data_parallel=0)),
    ("corpus", dict(n_shards=16)),
    ("corpus", dict(data_parallel=9)),  # the N x 0 guard
    ("corpus", dict(n_shards=0)),
    ("multislice", dict(n_slices=0, shards_per_slice=4)),
    ("multislice", dict(n_slices=2, shards_per_slice=8)),
])
def test_mesh_errors_match_the_reference(fn, kwargs):
    ref = {"corpus": ref_corpus_mesh, "multislice": ref_multislice_mesh}[fn]
    port = {"corpus": corpus_mesh, "multislice": multislice_mesh}[fn]
    with pytest.raises(ValueError):
        ref(**kwargs)
    with pytest.raises(ValueError):
        port(devices=CPU8, **kwargs)


def test_mesh_naming_cuda_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        corpus_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        corpus_mesh(devices=["cuda:0"] * 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        default_mesh("cuda")


def test_parallel_exports_the_reference_names():
    import triple_hybrid_rag_tpu.parallel as ref

    assert set(ref.__all__) <= set(parallel.__all__)
    assert all(getattr(parallel, n) is not None for n in parallel.__all__)
    assert issubclass(parallel.ShardedEngine, Engine)


# ------------------------------------------------------------------ placement


def test_placement_splits_rows_like_the_reference(built):
    ret, ref, st, eng, _ = built("bf16")
    pl = eng.placement
    assert pl.n_pad == ref.n_pad and pl.n_pad % 8 == 0 and pl.n_loc == ref.n_loc
    assert (pl.lex_l_max, pl.g_l_max) == (ref.lex_l_max, ref.g_l_max)
    ref_rows = np.asarray(ref.embeddings.astype(np.float32))
    for si, sh in enumerate(pl.shards[0]):
        assert sh.n_pad == pl.n_pad // 8 and sh.embeddings.shape[0] == pl.n_loc
        np.testing.assert_array_equal(sh.embeddings.float().numpy(),
                                      ref_rows[si * pl.n_loc:(si + 1) * pl.n_loc])
        # on the state's own device a shard aliases the unsharded rows
        assert sh.embeddings.data_ptr() == st.embeddings[si * pl.n_loc].data_ptr()
    # per-shard CSR: the reference's stacked slices, tail padding aside
    for si, sh in enumerate(pl.shards[0]):
        offs = np.asarray(ref.lex_offsets)[si]
        assert sh.lex_offsets.tolist() == offs.tolist()
        total = int(offs[-1])
        assert sh.lex_pd[:total].tolist() == np.asarray(ref.lex_pd)[si][:total].tolist()
        assert sh.lex_pt[:total].tolist() == np.asarray(ref.lex_pt)[si][:total].tolist()
    assert eng.n_shards == 8 and pl.rows[0].maxsim_tokens is st.maxsim_tokens


def test_placement_rounds_capacity_to_the_mesh(built):
    """A 3-shard mesh rounds the capacity up to a multiple of 3 (the reference's
    rule) and still serves the same ids."""
    ret, _, st, eng8, _ = built("bf16")
    eng3 = Engine(st, device="cpu", mesh=corpus_mesh(devices=["cpu"] * 3))
    assert eng3.placement.n_pad == -(-st.n_pad // 3) * 3
    ids = [[x.chunk_id for x in r.results] for r in eng3.retrieve_batch(QUERIES)]
    assert ids == [[x.chunk_id for x in r.results] for r in eng8.retrieve_batch(QUERIES)]


# ------------------------------------------------------------------ serving


@pytest.mark.parametrize("name", list(CASES))
def test_eight_shards_match_the_reference(built, name):
    ret, ref, st, eng8, _ = built(name)
    assert (st.lexical_mode, st.graph_mode, st.graph_small_sparse) == (
        ref.lexical_mode, ref.graph_mode, ref.graph_small_sparse)
    check = dict(lexical_atol=ATOL) if name == "termtable" else {}
    for queries, colls in _batches(name):
        # the f32 rows' near tie of tests/test_torch_engine.py (query 5, tenant a)
        atol = NEAR_TIE_ATOL if name == "f32" and colls is not None else ATOL
        _compare(ref.retrieve_batch(queries, collections=colls),
                 eng8.retrieve_batch(queries, collections=colls), atol=atol, **check)


@pytest.mark.parametrize("name", [n for n in CASES if n != "ivf"])
def test_eight_shards_match_one_shard(built, name):
    _, _, _, eng8, eng1 = built(name)
    exact = name in ("int8", "int4")
    for queries, colls in _batches():
        got, want = eng8.retrieve_batch(queries, collections=colls), \
            eng1.retrieve_batch(queries, collections=colls)
        atol = NEAR_TIE_ATOL if name == "f32" and colls is not None else ATOL
        _compare(want, got, atol=0.0 if exact else atol,
                 **(dict(lexical_atol=0.0) if name == "termtable" else {}))
        if colls is not None and len(queries) > 1:
            continue
        # the channels' merged lists of the same prepared batch
        _, args = eng1.prepare_queries(queries, colls)
        scoped = colls is not None
        for channel in ("_lexical", "_graph", "_dense"):
            i8, v8 = getattr(eng8, channel)(args, scoped)
            i1, v1 = getattr(eng1, channel)(args, scoped)
            assert torch.equal(i8, i1), (name, channel)
            if channel == "_dense" and not exact:
                torch.testing.assert_close(v8, v1, atol=DENSE_ATOL, rtol=0)
            else:
                assert torch.equal(v8, v1), (name, channel)


def test_sharded_refusal_matches_the_reference():
    c = base_config().replace(graph_enabled=False, safety_threshold=0.99, rerank_backend="dot")
    ret = retriever(c, with_graph=False, n_docs=4)
    ref = RefEngine(ret, ref_corpus_mesh()).retrieve("zzz qqq xyzzy nonsense")
    got = Engine(state_from_retriever(ret), device="cpu",
                 mesh=corpus_mesh(devices=CPU8)).retrieve("zzz qqq xyzzy nonsense")
    assert ref.refused and got.refused and got.results == []


@pytest.mark.parametrize("fold", ["data2x4", "multislice2x4", "multislice2x2x2"])
def test_mesh_folds_match_one_by_eight(built, fold):
    """The batch splits over the data rows (each a whole replica); a batch the data
    axis does not divide pads with copies of the first query and returns only its
    own results."""
    ret, ref, st, eng8, _ = built("bf16")
    mesh = {
        "data2x4": lambda: corpus_mesh(n_shards=4, data_parallel=2, devices=CPU8),
        "multislice2x4": lambda: multislice_mesh(2, 4, devices=CPU8),
        "multislice2x2x2": lambda: multislice_mesh(2, 2, 2, devices=CPU8),
    }[fold]()
    eng = Engine(st, device="cpu", mesh=mesh)
    assert len(eng.placement.rows) == mesh.shape["data"]
    for queries in (QUERIES[:4], QUERIES[:3], QUERIES):
        got = eng.retrieve_batch(queries)
        assert len(got) == len(queries)
        _compare(eng8.retrieve_batch(queries), got)
        _compare(ref.retrieve_batch(queries), got)
    with pytest.raises(ValueError, match="data axis"):
        eng.run(eng.prepare_queries(QUERIES[:3])[1])


def test_refresh_keeps_the_reference_rule():
    """Placement-only refresh after growth within the padded capacity; a config
    change, or a larger largest per-shard postings block, declines."""
    c = base_config().replace(graph_enabled=False)
    corpus, _ = build_fixture(c, n_docs=4, with_graph=False)
    ret = RefRetriever(corpus, c)
    ref = RefEngine(ret, ref_corpus_mesh())
    eng = Engine(state_from_retriever(ret), device="cpu", mesh=corpus_mesh(devices=CPU8))
    p, ch = HierarchicalChunker(c).chunk_document(
        "Fresh quantum qubit document content.", hashlib.sha256(b"new").hexdigest()
    )
    corpus.add_chunks(p, ch)
    ret2 = RefRetriever(corpus, c)
    assert ref.refresh(ret2) is True
    assert eng.refresh(state_from_retriever(ret2)) is True
    got = eng.retrieve("quantum qubit")
    assert any("quantum" in x.text.lower() for x in got.results)
    _compare([ref.retrieve("quantum qubit")], [got])
    ret3 = RefRetriever(corpus, c.replace(final_top_k=4))
    assert ref.refresh(ret3) is False
    assert eng.refresh(state_from_retriever(ret3)) is False


def _refresh_pair():
    """The reference's refresh fixture (``tests/test_sharded.py``): its engine over
    its 8 virtual devices, and the port's ``ShardedEngine`` over a port retriever of
    the same placed state on 8 CPU shards."""
    from triple_hybrid_rag_tpu_torch.retrieval import Retriever

    c = base_config().replace(graph_enabled=False)
    corpus, _ = build_fixture(c, n_docs=4, with_graph=False)
    ret = RefRetriever(corpus, c)
    ref = RefEngine(ret, ref_corpus_mesh())
    port_ret = Retriever.from_state(state_from_retriever(ret))
    eng = ShardedEngine(port_ret, corpus_mesh(devices=CPU8))
    return c, corpus, ref, eng, Retriever


def test_sharded_refresh_takes_a_retriever_as_the_reference():
    """``tests/test_sharded.py``'s refresh sequence through the port's
    ``ShardedEngine``: growth within the padded capacity refreshes (True, the new
    document retrieved, the engine keeps the new retriever), a config change
    declines (False); both as the reference's engine answers."""
    c, corpus, ref, eng, Retriever = _refresh_pair()
    assert eng.last_refresh_error is None
    p, ch = HierarchicalChunker(c).chunk_document(
        "Fresh quantum qubit document content.", hashlib.sha256(b"new").hexdigest()
    )
    corpus.add_chunks(p, ch)
    ret2 = RefRetriever(corpus, c)
    port2 = Retriever.from_state(state_from_retriever(ret2))
    assert ref.refresh(ret2) is True
    assert eng.refresh(port2) is True
    assert eng.retriever is port2 and eng.state is port2.state
    assert eng.last_refresh_error is None and ref.last_refresh_error is None
    got = eng.retrieve("quantum qubit")
    assert any("quantum" in x.text.lower() for x in got.results)
    _compare([ref.retrieve("quantum qubit")], [got])
    ret3 = RefRetriever(corpus, c.replace(final_top_k=4))
    port3 = Retriever.from_state(state_from_retriever(ret3))
    assert ref.refresh(ret3) is False
    assert eng.refresh(port3) is False
    assert eng.retriever is port2  # a declined refresh keeps the engine's retriever
    assert eng.last_refresh_error is None and ref.last_refresh_error is None


def test_sharded_refresh_without_an_argument():
    """``refresh()`` re-places the engine's own retriever, as the reference's does."""
    _, _, ref, eng, _ = _refresh_pair()
    ret = eng.retriever
    assert ref.refresh() is True
    assert eng.refresh() is True
    assert eng.retriever is ret and eng.last_refresh_error is None
    _compare(ref.retrieve_batch(QUERIES[:3]), eng.retrieve_batch(QUERIES[:3]))


def test_sharded_refresh_placement_failure(monkeypatch):
    """A placement that raises is no "shapes changed": both engines return False,
    keep the error in ``last_refresh_error`` and count it in their registry's
    ``engine_refresh_errors_total``; the next good refresh clears it. (The
    reference's ``parallel/engine.py`` counts through a ``rag_metrics`` it never
    imports, so its branch raises NameError as shipped: the test lends the module
    its registry.)"""
    from triple_hybrid_rag_tpu.observability import rag_metrics as ref_metrics
    from triple_hybrid_rag_tpu.parallel import engine as ref_engine_module
    from triple_hybrid_rag_tpu_torch import engine as port_engine
    from triple_hybrid_rag_tpu_torch.observability import rag_metrics

    _, _, ref, eng, _ = _refresh_pair()
    counters = (ref_metrics.counter("engine_refresh_errors_total"),
                rag_metrics.counter("engine_refresh_errors_total"))
    before = [ctr.value() for ctr in counters]

    def broken(*args, **kwargs):
        raise MemoryError("placement failed")

    with monkeypatch.context() as m:
        m.setattr(ref_engine_module, "rag_metrics", ref_metrics, raising=False)
        m.setattr(RefEngine, "__init__", broken)
        m.setattr(port_engine, "place", broken)
        assert ref.refresh() is False
        assert eng.refresh() is False
    assert isinstance(ref.last_refresh_error, MemoryError)
    assert isinstance(eng.last_refresh_error, MemoryError)
    assert [ctr.value() for ctr in counters] == [b + 1 for b in before]
    assert ref.refresh() is True and eng.refresh() is True
    assert ref.last_refresh_error is None and eng.last_refresh_error is None
    _compare(ref.retrieve_batch(QUERIES[:3]), eng.retrieve_batch(QUERIES[:3]))


def test_sharded_engine_over_a_port_retriever():
    """``parallel.ShardedEngine(retriever, mesh)`` over the port's own retriever
    (a CPU RAG) serves what the one-device engine serves."""
    from triple_hybrid_rag_tpu_torch.config import RAGConfig
    from triple_hybrid_rag_tpu_torch.facade import RAG

    rag = RAG(RAGConfig(embedder_backend="bowhash", capacity_round=8), device="cpu")
    rag.ingest_text("Acme Corp settles invoices within thirty days. Maria Silva works for "
                    "Acme Corp.", name="a.md")
    rag.ingest_text("Red foxes live in the northern forest and hunt at night.", name="b.md")
    queries = ["When does Acme Corp settle invoices?", "Where do red foxes live?"]
    one = rag.query_batch(queries)
    assert rag._get_engine().mesh.shape == {"data": 1, "shard": 1}
    eng = ShardedEngine(rag.retriever, corpus_mesh(n_shards=2, data_parallel=2, devices=["cpu"] * 4))
    _compare(one, eng.retrieve_batch(queries))
    assert rag.stats()["engine_n_shards"] == 1
