"""The port's HTTP server against the JAX reference's, over real sockets on the CPU.

Two pairs of servers, each started once for the module: a staged pair (the
reference's ``tests/test_server.py`` corpus: ``RAG`` with the staged query) and a
micro-batched pair (``use_sharded_engine=True``; the reference's engine on one
device, as the port's). The same requests go to both servers of a pair: status
codes must be equal, and every answer's JSON too, ids, texts, refusals, channel
counts and timing keys exactly and scores within 1e-5 (the staged path's and the
engine's tolerance against the reference, ``tests/test_torch_staged.py`` and
``tests/test_torch_engine.py``). ``/rerank`` scores must be within 1e-5 of the
reference's einsum (bf16 products, f32 sums in another order), in the same order.
Then the cases of ``tests/test_server.py`` against the port's server.
"""

import concurrent.futures
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from triple_hybrid_rag_tpu.facade import RAG as RefRAG
from triple_hybrid_rag_tpu.parallel import ShardedEngine, single_device_mesh
from triple_hybrid_rag_tpu.server import serve as ref_serve

from torch_port_helpers import small_config, torch_config
from triple_hybrid_rag_tpu_torch.facade import RAG
from triple_hybrid_rag_tpu_torch.observability import rag_metrics
from triple_hybrid_rag_tpu_torch.server import RAGServer, serve

ATOL = 1e-5
SEED_DOCS = [("# Payments\n\nInvoices settle within thirty days of billing.", "pay.md"),
             ("# Wildlife\n\nRed foxes inhabit the northern forest.", "wild.md")]
TOPICS = ["payments invoices billing", "wildlife foxes forest", "quantum computing qubits"]
RERANK_DOCS = ["Stationery reorder minutes and parking assignments.",
               "Invoices settle within thirty days of billing.",
               "Red foxes inhabit the northern forest."]


def _cfg():
    return small_config().replace(graph_enabled=False, embedding_dtype="float32",
                                  safety_threshold=0.2, use_native=False)


def _start(httpd):
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture(scope="module")
def pair():
    """(reference url, port url) of the staged servers."""
    cfg = _cfg()
    ref, port = RefRAG(config=cfg), RAG(config=torch_config(cfg), device="cpu")
    for text, name in SEED_DOCS:
        ref.ingest_text(text, name=name)
        port.ingest_text(text, name=name)
    servers = [ref_serve(host="127.0.0.1", port=0, rag=ref), serve(host="127.0.0.1", port=0, rag=port)]
    yield tuple(_start(s) for s in servers)
    for s in servers:
        s.shutdown()


@pytest.fixture(scope="module")
def engine_pair():
    """(reference url, port url, port server) of the micro-batched servers over 24
    documents, with a generous coalescing window (requests trickle in tens of ms
    apart on a loaded CPU)."""
    cfg = _cfg()
    ref = RefRAG(config=cfg, use_sharded_engine=True)
    port = RAG(config=torch_config(cfg), use_sharded_engine=True, device="cpu")
    for i in range(24):
        text = f"# Doc {i}\n\nDocument {i} covers {TOPICS[i % 3]} with detail {i}."
        ref.ingest_text(text, name=f"d{i}.md")
        port.ingest_text(text, name=f"d{i}.md")
    ref._engine = ShardedEngine(ref.retriever, single_device_mesh())
    servers = [ref_serve(host="127.0.0.1", port=0, rag=ref, batch_window_s=0.25),
               serve(host="127.0.0.1", port=0, rag=port, batch_window_s=0.25)]
    yield _start(servers[0]), _start(servers[1]), servers[1]
    for s in servers:
        s.shutdown()


def _get(url, headers=None):
    req = urllib.request.Request(url, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _post(url, payload, headers=None, raw=None):
    data = raw if raw is not None else json.dumps(payload).encode()
    req = urllib.request.Request(
        url, data=data, headers={"Content-Type": "application/json", **(headers or {})}
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


def _same_answer(want, got, atol=ATOL):
    assert got.keys() == want.keys()
    for key in ("query", "refused", "refusal_reason", "channel_counts"):
        assert got[key] == want[key], key
    assert got["timings_ms"].keys() == want["timings_ms"].keys()
    np.testing.assert_allclose(got["max_score"], want["max_score"], atol=atol)
    assert len(got["results"]) == len(want["results"])
    for g, w in zip(got["results"], want["results"]):
        for key in ("chunk_id", "parent_id", "doc_id", "text", "parent_text", "section_heading",
                    "pages", "source_channels"):
            assert g[key] == w[key], key
        assert g["scores"].keys() == w["scores"].keys()
        for key, v in w["scores"].items():
            if v is None:
                assert g["scores"][key] is None, key
            else:
                np.testing.assert_allclose(g["scores"][key], v, atol=atol, err_msg=key)


def _both(urls, route, payload, **kw):
    (s_ref, b_ref), (s_port, b_port) = (_post(u + route, payload, **kw) for u in urls)
    assert s_port == s_ref, (payload, b_ref, b_port)
    return s_port, b_ref, b_port


# ------------------------------------------------------------------ the two servers


@pytest.mark.parametrize("payload", [
    {"query": "invoice settlement", "top_k": 2}, {"query": "foxes forest"},
    {"query": "billing days", "top_k": 1}, {"query": "zzz qqq nothing"},
    {"query": "invoice settlement", "collection": "default"},
    {"query": "invoice settlement", "collection": "nonexistent"},
], ids=range(6))
def test_query_answers_match_reference(pair, payload):
    status, want, got = _both(pair, "/query", payload)
    assert status == 200
    _same_answer(want, got)


def test_stats_and_health_match_reference(pair):
    (s_ref, t_ref), (s_port, t_port) = (_get(u + "/stats") for u in pair)
    assert s_ref == s_port == 200 and json.loads(t_port) == json.loads(t_ref)
    (s_ref, t_ref), (s_port, t_port) = (_get(u + "/healthz") for u in pair)
    h_ref, h_port = json.loads(t_ref), json.loads(t_port)
    assert s_port == 200 and h_port["status"] == "ok" and h_port["children"] >= 2
    h_ref.pop("uptime_s"), h_port.pop("uptime_s")
    assert h_port == h_ref


@pytest.mark.parametrize("payload", [
    {"query": "invoice settlement billing", "documents": RERANK_DOCS},
    {"query": "invoice settlement billing", "documents": RERANK_DOCS, "top_n": 1},
    {"query": "northern forest animals", "documents": RERANK_DOCS + ["", "the of and"], "top_n": 4},
    # many documents at one query (the kernel's K in the hundreds on the card)
    {"query": "payments invoices detail", "documents": [
        f"Document {i} covers {TOPICS[i % 3]} with detail {i}." for i in range(300)]},
], ids=["three", "top_n", "empty_docs", "k300"])
def test_rerank_matches_reference(pair, payload):
    status, want, got = _both(pair, "/rerank", payload)
    assert status == 200 and got["scorer"] == want["scorer"] == "maxsim"
    assert len(got["results"]) == len(want["results"])
    scores = {r["index"]: r["relevance_score"] for r in got["results"]}
    want_scores = np.array([r["relevance_score"] for r in want["results"]])
    np.testing.assert_allclose([scores.get(r["index"], np.nan) for r in want["results"]],
                               want_scores, atol=ATOL, rtol=0)
    got_scores = [r["relevance_score"] for r in got["results"]]
    assert got_scores == sorted(got_scores, reverse=True)
    gaps = np.abs(np.diff(want_scores))
    if len(gaps) == 0 or gaps.min() > 2 * ATOL:  # no near tie: the same order
        assert [r["index"] for r in got["results"]] == [r["index"] for r in want["results"]]


@pytest.mark.parametrize("payload", [
    {}, {"query": "   "}, {"query": 42}, {"query": None}, {"query": ["a", "b"]},
    {"query": "x", "top_k": "ten"}, {"query": "x", "top_k": -3}, {"query": "x", "top_k": True},
    {"query": "x", "collection": 7}, {"query": "\x00\x01\x02"}, {"query": "a" * 100_000},
    {"unexpected": {"deeply": {"nested": [1, 2, 3]}}}, [1, 2, 3], "just a string",
    {"query": "ok", "extra": 1e308},
], ids=range(15))
def test_malformed_query_payloads_match_reference(pair, payload):
    _both(pair, "/query", payload)


@pytest.mark.parametrize("route,payload", [
    ("/ingest", {}), ("/ingest", {"path": "/etc/hostname"}),
    ("/rerank", {"documents": ["a"]}), ("/rerank", {"query": "x"}),
    ("/rerank", {"query": "x", "documents": []}), ("/rerank", {"query": "x", "documents": ["a", 3]}),
    ("/rerank", {"query": "x", "documents": ["a"], "top_n": 0}), ("/nope", {"query": "x"}),
], ids=range(8))
def test_rejected_requests_match_reference(pair, route, payload):
    status, want, got = _both(pair, route, payload)
    # the one message that names the CLI names the port's (thr-torch)
    assert status in (400, 404) and json.loads(json.dumps(got).replace("thr-torch ", "thr ")) == want


def test_top_k_past_the_rerank_list_is_a_400(pair):
    """``top_k`` above ``rerank_top_k`` (8): ValueError in both packages, so 400
    from both staged servers, and no server error counted."""
    from triple_hybrid_rag_tpu.observability import rag_metrics as ref_metrics

    counters = (ref_metrics.counter("server_errors_total"), rag_metrics.counter("server_errors_total"))
    before = [c.value() for c in counters]
    status, b_ref, b_port = _both(pair, "/query", {"query": "invoice settlement", "top_k": 9})
    assert status == 400 and "top_k" in b_ref["error"] and "top_k" in b_port["error"]
    assert [c.value() for c in counters] == before


def test_non_json_bodies_match_reference(pair):
    for raw in (b"\x89PNG\r\n not json", b"{", "ç".encode("latin-1")):
        status, _, got = _both(pair, "/query", None, raw=raw)
        assert status == 400 and got == {"error": "invalid JSON body"}


def test_ingest_then_query_matches_reference(pair):
    status, want, got = _both(pair, "/ingest", {"text": "Quantum processors need cryogenic cooling.",
                                                 "name": "q.md"})
    assert status == 200 and got == want and got["status"] == "completed"
    for q in ("invoice settlement", "quantum cryogenic cooling"):
        _, want, got = _both(pair, "/query", {"query": q})
        _same_answer(want, got)
    assert any("Quantum" in r["text"] for r in got["results"])
    status, want, got = _both(pair, "/ingest", {"text": "Tenant Z special handling rules.", "name": "z.md"})
    assert got == want
    for coll in ("default", "nonexistent"):
        _, want, got = _both(pair, "/query", {"query": "special handling rules", "collection": coll})
        _same_answer(want, got)
    assert got["refused"] or got["results"] == []


def test_micro_batched_answers_match_reference(engine_pair):
    """Concurrent requests coalesce into fewer engine calls on the port's server; the
    answers equal the reference server's and the port's own query_batch."""
    ref_url, url, httpd = engine_pair
    queries = [f"payments invoices detail {i % 7}" for i in range(32)]
    batches0 = rag_metrics.counter("server_engine_batches_total").value()
    with concurrent.futures.ThreadPoolExecutor(max_workers=16) as ex:
        got = list(ex.map(lambda q: _post(url + "/query", {"query": q}), queries))
    batches = rag_metrics.counter("server_engine_batches_total").value() - batches0
    assert all(status == 200 and body["results"] for status, body in got)
    assert 1 <= batches <= 16 and 32 / batches >= 2.0, batches
    with concurrent.futures.ThreadPoolExecutor(max_workers=16) as ex:
        want = list(ex.map(lambda q: _post(ref_url + "/query", {"query": q}), queries))
    for (_, w), (_, g) in zip(want, got):
        _same_answer(w, g)
    rag = httpd.rag_state.rag
    for q, (_, g), r in zip(queries, got, rag.query_batch(queries)):
        assert [x["chunk_id"] for x in g["results"]] == [x.chunk_id for x in r.results], q


@pytest.mark.parametrize("payload", [
    {"query": "wildlife foxes", "top_k": 1, "collection": "default"},
    {"query": "wildlife foxes", "collection": "missing"},
    {"query": "quantum qubits", "top_k": 3},
], ids=range(3))
def test_micro_batched_collection_and_top_k_match_reference(engine_pair, payload):
    ref_url, url, _ = engine_pair
    status, want, got = _both((ref_url, url), "/query", payload)
    assert status == 200
    _same_answer(want, got)
    if "top_k" in payload:
        assert len(got["results"]) <= payload["top_k"]


# ------------------------------------------------------------------ the reference's cases


def test_metrics_endpoint(pair):
    _post(pair[1] + "/query", {"query": "foxes forest"})
    status, text = _get(pair[1] + "/metrics")
    assert status == 200
    for name in ("server_queries_total", "retrieval_latency_ms_bucket", "server_query_ms_bucket",
                 "server_reranks_total", "server_prewarm_seconds"):
        assert name in text, name


def test_unknown_route(pair):
    assert _get(pair[1] + "/nope")[0] == 404


def test_concurrent_staged_queries(pair):
    queries = ["invoice settlement", "foxes forest", "billing days", "northern forest"] * 3
    with concurrent.futures.ThreadPoolExecutor(max_workers=4) as ex:
        results = list(ex.map(lambda q: _post(pair[1] + "/query", {"query": q, "top_k": 1}), queries))
    assert all(status == 200 and "results" in body for status, body in results)


def test_ingest_path_allowlisted_root(tmp_path):
    root = tmp_path / "docs"
    root.mkdir()
    (root / "ok.md").write_text("# Shipping\n\nParcels arrive within five days.")
    outside = tmp_path / "outside.md"
    outside.write_text("# Outside\n\nNot under the allowed root.")
    rag = RAG(config=torch_config(_cfg()), device="cpu")
    rag.ingest_text("seed corpus text for prewarm", name="seed.md")
    httpd = serve(host="127.0.0.1", port=0, rag=rag, ingest_root=str(root))
    base = _start(httpd)
    try:
        status, body = _post(base + "/ingest", {"path": str(root / "ok.md")})
        assert status == 200 and body["children"] >= 1
        status, body = _post(base + "/ingest", {"path": str(outside)})
        assert status == 400 and "outside" in body["error"].lower()
        status, _ = _post(base + "/ingest", {"path": str(root / ".." / "outside.md")})
        assert status == 400
    finally:
        httpd.shutdown()


def test_auth_token_gate():
    rag = RAG(config=torch_config(_cfg()), device="cpu")
    rag.ingest_text("# Pay\n\nInvoices settle in thirty days.", name="p.md")
    httpd = serve(host="127.0.0.1", port=0, rag=rag, auth_token="s3cret")
    base = _start(httpd)
    try:
        assert _get(base + "/healthz")[0] == 401
        assert _post(base + "/query", {"query": "invoices"})[0] == 401
        for headers in ({"Authorization": "Bearer s3cret"}, {"X-API-Key": "s3cret"}):
            assert _get(base + "/healthz", headers)[0] == 200
            status, out = _post(base + "/query", {"query": "invoices settle"}, headers)
            assert status == 200 and "results" in out
        assert _get(base + "/healthz", {"Authorization": "Bearer nope"})[0] == 401
    finally:
        httpd.shutdown()


def test_index_dir_loads_and_saves_after_ingest(tmp_path):
    """A server started on a checkpoint directory loads it onto the given device and
    checkpoints every /ingest."""
    d = tmp_path / "index"
    rag = RAG(config=torch_config(_cfg()), device="cpu")
    rag.ingest_text(*SEED_DOCS[0])
    rag.save(d)
    httpd = serve(host="127.0.0.1", port=0, index_dir=str(d), device="cpu")
    base = _start(httpd)
    try:
        assert httpd.rag_state.rag.device.type == "cpu"
        assert json.loads(_get(base + "/stats")[1])["documents"] == 1
        status, body = _post(base + "/ingest", {"text": SEED_DOCS[1][0], "name": SEED_DOCS[1][1]})
        assert status == 200 and body["status"] == "completed"
    finally:
        httpd.shutdown()
    assert RAG.load(d, device="cpu").stats()["documents"] == 2


def test_engine_failure_is_a_500():
    """An exception in the micro-batcher's engine call reaches the waiting request
    as a 500 and counts as a server error."""
    rag = RAG(config=torch_config(_cfg()), use_sharded_engine=True, device="cpu")
    rag.ingest_text(*SEED_DOCS[0])

    def broken(*a, **k):
        raise RuntimeError("the engine is down")

    rag.query_batch = broken
    errors0 = rag_metrics.counter("server_errors_total").value()
    httpd = serve(host="127.0.0.1", port=0, rag=rag, prewarm=False)
    base = _start(httpd)
    try:
        status, body = _post(base + "/query", {"query": "invoices"})
        assert status == 500 and "the engine is down" in body["error"]
        assert rag_metrics.counter("server_errors_total").value() == errors0 + 1
    finally:
        httpd.shutdown()


def test_server_without_a_device_needs_the_card(monkeypatch):
    """Without CUDA and without device="cpu" the server builds no RAG on the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        RAGServer(config=torch_config(_cfg()))
    assert RAGServer(config=torch_config(_cfg()), device="cpu").rag.device.type == "cpu"
