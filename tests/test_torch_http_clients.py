"""The port's HTTP model clients against the JAX reference's, on the CPU.

Both packages' clients talk to one stub OpenAI-compatible server on 127.0.0.1
(``tests/test_http_clients.py``'s ``StubModelServer``; no network). Every case runs
once with the reference's module and once with the port's, the stub's state set
the same way before each: the outputs (vectors bit for bit), the errors, the
requests the server received (paths and JSON bodies, in order; as a multiset where
the chat rerank fans out over threads) and the ``rag_metrics`` counters and timers
the call moved must be equal. Then both facades ingest and answer through the stub
with every ``*_api_base`` set, and with a dead server: equal ids, equal requests.
An HTTP embedder gives the engine no device encode and no token embeddings, so the
queries embed on the host and the rerank falls to ``dot``, as in the reference.
"""

import json

import numpy as np
import pytest

from triple_hybrid_rag_tpu.config import RAGConfig as RefConfig
from triple_hybrid_rag_tpu.facade import RAG as RefRAG
from triple_hybrid_rag_tpu.models import entity_extractor as ref_extractor
from triple_hybrid_rag_tpu.models import http_clients as ref_http
from triple_hybrid_rag_tpu.models import planner as ref_planner
from triple_hybrid_rag_tpu.observability import rag_metrics as ref_metrics
from triple_hybrid_rag_tpu.ocr import OCRProcessor as RefOCRProcessor
from triple_hybrid_rag_tpu.types import ParentChunk as RefParent

from test_http_clients import DIM, StubModelServer
from test_torch_engine import _compare as engine_compare
from test_torch_facade import DOCS as FACADE_DOCS
from test_torch_facade import _ingest as facade_ingest
from test_torch_facade import _pair as facade_pair
from test_torch_staged import _compare
from torch_port_helpers import torch_config
from triple_hybrid_rag_tpu_torch.config import RAGConfig
from triple_hybrid_rag_tpu_torch.facade import RAG
from triple_hybrid_rag_tpu_torch.models import entity_extractor, http_clients, planner
from triple_hybrid_rag_tpu_torch.observability import rag_metrics
from triple_hybrid_rag_tpu_torch.ocr import OCRProcessor
from triple_hybrid_rag_tpu_torch.types import ParentChunk

COUNTERS = ("http_model_retries_total", "http_embed_failed_batches_total",
            "http_embed_dim_mismatch_total", "http_rerank_native_failures_total")
TIMERS = ("http_rerank_native_ms", "http_rerank_chat_ms")
REF = dict(http=ref_http, planner=ref_planner, extractor=ref_extractor, config=RefConfig,
           parent=RefParent, ocr=RefOCRProcessor, metrics=ref_metrics)
PORT = dict(http=http_clients, planner=planner, extractor=entity_extractor, config=RAGConfig,
            parent=ParentChunk, ocr=OCRProcessor, metrics=rag_metrics)


@pytest.fixture(scope="module")
def stub():
    s = StubModelServer()
    yield s
    s.close()


def _reset(stub):
    stub.requests.clear()
    stub.fail_next = 0
    stub.fail_status = 500
    stub.native_rerank = True
    stub.embed_dim = DIM
    stub.chat_text_mode = False
    stub.drop_embed_indices = set()


def _metrics(reg) -> dict:
    out = {name: reg.counter(name).value() for name in COUNTERS}
    out.update({name: reg.histogram(name).count() for name in TIMERS})
    return out


def _plain(x):
    """A comparable form of a client's output."""
    if isinstance(x, np.ndarray):
        return ("array", x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, (list, tuple)):
        return type(x).__name__, [_plain(v) for v in x]
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if hasattr(x, "__dataclass_fields__"):
        d = {k: _plain(getattr(x, k)) for k in x.__dataclass_fields__ if k != "relation_id"}
        return type(x).__name__, d
    return getattr(x, "value", x)


def _run(stub, case, mods, ordered):
    _reset(stub)
    m0 = _metrics(mods["metrics"])
    try:
        out = ("ok", _plain(case(mods, stub)))
    except Exception as e:  # the error's type and status, as the ladders read them
        out = ("raised", type(e).__name__, getattr(e, "status", None))
    reqs = [(p, json.dumps(b, sort_keys=True)) for p, b in stub.requests]
    m1 = _metrics(mods["metrics"])
    return out, reqs if ordered else sorted(reqs), {k: m1[k] - m0[k] for k in m0}


def _post(status, fails, retries, payload=None):
    def case(m, stub):
        stub.fail_next, stub.fail_status = fails, status
        return m["http"].post_json(stub.base + "/embeddings", payload or {"model": "m", "input": ["hi"]},
                                   retries=retries, backoff_s=0.0)
    return case


def _embedder(**kw):
    def make(m, stub):
        return m["http"].HTTPEmbedder(stub.base, model="m", dim=DIM, retries=0, **kw)
    return make


def _embed_texts(n, batch, fails=0, dim=DIM, drop=()):
    def case(m, stub):
        emb = _embedder(batch_size=batch)(m, stub)
        stub.fail_next, stub.embed_dim, stub.drop_embed_indices = fails, dim, set(drop)
        return emb.embed_texts([f"text number {i}" for i in range(n)])
    return case


def _embed_query(fails):
    def case(m, stub):
        emb = _embedder()(m, stub)
        stub.fail_next = fails
        return emb.embed_query("text number 3")
    return case


def _embed_images(m, stub):
    emb = _embedder()(m, stub)
    stub.fail_next = 1  # the first image's request dies: a zero row
    return emb.embed_images([b"\x89PNG\r\n\x1a\nfakepng", b"\xff\xd8\xffjpeg", b"GIF89a..",
                             b"RIFF\x00\x00\x00\x00WEBPVP8 "])


def _embed_mixed(m, stub):
    return _embedder()(m, stub).embed_mixed([("text", "alpha"), ("image", b"\x89PNG\r\n\x1a\nx"),
                                              ("text", 42)])


def _rerank(native=True, text_mode=False, fails=0, twice=False):
    def case(m, stub):
        stub.native_rerank, stub.chat_text_mode, stub.fail_next = native, text_mode, fails
        fn = m["http"].HTTPRerankerFn(stub.base, model="r", retries=0)
        docs = ["relevant-marker document alpha beta", "irrelevant document", "alpha"]
        out = [fn("alpha beta", docs)]
        if twice:  # the 404 is sticky: the second call skips /rerank
            out.append(fn("q", ["relevant-marker again"]))
        out.append(fn("q", []))
        return out
    return case


def _planner_fn(m, stub):
    return m["http"].make_planner_fn(stub.base, model="p", retries=0)("how is ACME related to Zenith?")


def _callable_planner(fails):
    def case(m, stub):
        p = m["planner"].CallablePlanner(
            m["http"].make_planner_fn(stub.base, model="p", retries=0), m["config"]())
        stub.fail_next = fails
        return [p.plan("how is ACME related to Zenith?"), p.plan("payment deadline for invoices")]
    return case


def _get_planner(m, stub):
    fn = m["http"].make_planner_fn(stub.base, model="p", retries=0)
    picked = [type(m["planner"].get_planner(m["config"](planner_backend=b), llm_fn=f)).__name__
              for b in ("rules", "llm") for f in (None, fn)]
    return picked, m["planner"].get_planner(m["config"](planner_backend="llm"), fn).plan("ACME Zenith")


def _extractor(fails):
    def case(m, stub):
        ext = m["extractor"].CallableExtractor(
            m["http"].make_extractor_fn(stub.base, model="n", retries=0), m["config"]())
        stub.fail_next = fails
        parent = m["parent"](parent_id="p:0", doc_id="d" * 64, parent_idx=0,
                             text="ACME Corp participates in the Zenith project.")
        return ext.extract(parent, [])
    return case


def _vision(m, stub):
    fn = m["http"].HTTPVisionOCR(stub.base, model="v", retries=0)
    return [fn(b"\xff\xd8\xff" + b"fakejpeg", "base"), fn(b"GIF87a", "tiny"), fn(b"x", "gundam"),
            m["ocr"](fn).process_image(b"\x89PNG\r\n\x1a\nfake")]


def _wire(m, stub):
    cfg = m["config"](embed_api_base=stub.base, llm_api_base=stub.base + "/", ocr_api_base=stub.base,
                      rerank_api_base=stub.base + "/v1", embedding_batch_size=7, api_key="k")
    wired = m["http"].wire_http_models(cfg)
    return ({k: (type(v).__name__, sorted(vars(v).items())) for k, v in wired.items()},
            m["http"].wire_http_models(m["config"]()))


CASES = {
    "retry-5xx": (_post(500, 2, 2), True),
    "retry-429": (_post(429, 1, 1), True),
    "no-retry-4xx": (_post(400, 1, 3), True),
    "retries-exhausted": (_post(503, 10, 2), True),
    "embed-batches": (_embed_texts(10, 4), True),
    "embed-failed-batch": (_embed_texts(4, 2, fails=1), True),
    "embed-dim-mismatch": (_embed_texts(3, 20, dim=DIM // 2), True),
    "embed-dropped-row": (_embed_texts(3, 20, drop=(1,)), True),
    "embed-query": (_embed_query(0), True),
    "embed-query-raises": (_embed_query(1), True),
    "embed-images": (_embed_images, True),
    "embed-mixed": (_embed_mixed, True),
    "rerank-native": (_rerank(), True),
    "rerank-404-logprobs": (_rerank(native=False, twice=True), False),
    "rerank-text-parse": (_rerank(native=False, text_mode=True), False),
    "rerank-native-500-then-chat": (_rerank(fails=1), False),
    "rerank-total-failure": (_rerank(fails=100), False),
    "planner-fn": (_planner_fn, True),
    "callable-planner": (_callable_planner(0), True),
    "callable-planner-fallback": (_callable_planner(10), True),
    "get-planner": (_get_planner, True),
    "callable-extractor": (_extractor(0), True),
    "callable-extractor-fallback": (_extractor(10), True),
    "vision-ocr": (_vision, True),
    "wire": (_wire, True),
}


@pytest.mark.parametrize("name", list(CASES))
def test_client_matches_reference(stub, name):
    case, ordered = CASES[name]
    want = _run(stub, case, REF, ordered)
    got = _run(stub, case, PORT, ordered)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert want[1] or name == "wire"  # the case reached the server


def test_parse_json_content_matches_reference():
    for raw in ('```json\n{"keywords": ["a"]}\n```', 'noise {"k": 1} trailing', '{"a": [1, 2]}'):
        assert http_clients.HTTPChatJSON.parse_json_content(raw) == \
            ref_http.HTTPChatJSON.parse_json_content(raw)
    for raw in ("no json here", "[1, 2]", "```\n```"):
        with pytest.raises(Exception) as want:
            ref_http.HTTPChatJSON.parse_json_content(raw)
        with pytest.raises(want.type):
            http_clients.HTTPChatJSON.parse_json_content(raw)
    assert http_clients.PLANNER_SYSTEM_PROMPT == ref_http.PLANNER_SYSTEM_PROMPT
    assert http_clients.NER_SYSTEM_PROMPT == ref_http.NER_SYSTEM_PROMPT
    assert http_clients.OCR_SYSTEM_PROMPT == ref_http.OCR_SYSTEM_PROMPT


def _facade_config(small_config, base, **kw):
    return small_config.replace(
        embed_api_base=base, embed_api_model="emb", llm_api_base=base, llm_api_model="llm",
        rerank_api_base=base, rerank_api_model="rr", embedding_dim_full=DIM,
        embedding_dim=DIM // 2, embedding_dtype="float32", api_retries=0, safety_threshold=0.0,
        **kw,
    )


DOC = ("# Contracts\n\nACME Corp signed the Zenith project contract. "
       "Invoices settle within thirty days.")
QUERIES = ["ACME Zenith contract", "invoice settlement thirty days", "Zenith"]


@pytest.mark.parametrize("rerank_backend", ["dot", "maxsim"])
def test_facade_through_stub_matches_reference(stub, small_config, rerank_backend):
    """``test_http_clients.py``'s facade end to end: HTTP embedder, planner, NER and
    reranker. The same chunk ids and scores, the same requests in the same order,
    and no MaxSim store (an HTTP embedder has no token embeddings)."""
    cfg = _facade_config(small_config, stub.base, rerank_backend=rerank_backend)
    logs, out = [], []
    for make in (lambda: RefRAG(config=cfg), lambda: RAG(torch_config(cfg), device="cpu")):
        _reset(stub)
        rag = make()
        res = rag.ingest_text(DOC, name="contract.md")
        assert res.n_children >= 1 and rag.ingestor.entity_store.stats()["entities"] >= 2
        out.append([rag.query(q) for q in QUERIES])
        logs.append([(p, json.dumps(b, sort_keys=True)) for p, b in stub.requests])
        assert rag.retriever.maxsim_index is None
    for want, got in zip(*out):
        _compare(want, got)
        assert not got.refused and got.results
    assert logs[1] == logs[0]
    paths = {p for p, _ in logs[1]}
    assert {"/v1/embeddings", "/v1/chat/completions", "/rerank"} <= paths
    emb = rag.ingestor.embedder
    assert type(emb.inner).__name__ == "HTTPEmbedder"
    assert not hasattr(emb, "token_embeddings") and not hasattr(emb, "encode_queries_device")
    assert type(rag.retriever.planner).__name__ == "CallablePlanner"
    assert type(rag.ingestor.extractor).__name__ == "CallableExtractor"


@pytest.mark.parametrize("http_rerank", [False, True], ids=["dot-rerank", "rerank-fn"])
def test_engine_encodes_http_queries_on_the_host(stub, small_config, http_rerank):
    """The batched engine over an HTTP embedder, against the reference's engine on
    one device: one /embeddings request a batch (the host encode) and no MaxSim
    store; the dot rerank over parent means, or, under an HTTP ``rerank_fn`` (which
    the engine leaves out), none, as the reference's engine reads the parents'
    embeddings only from a reranker that holds them. Equal ids, scores, requests."""
    cfg = _facade_config(small_config, stub.base, rerank_backend="maxsim", ner_enabled=False,
                         capacity_round=8, use_native=False)
    if not http_rerank:
        cfg = cfg.replace(rerank_api_base="")
    _reset(stub)
    ref, port = facade_pair(cfg)
    facade_ingest((ref, port), FACADE_DOCS[:4])
    eng = port._get_engine()
    assert eng.state.maxsim_tokens is None and eng.state.parent_emb is not None
    assert eng.dot_rerank is not http_rerank
    logs, out = [], []
    for rag in (ref, port):
        stub.requests.clear()
        out.append(rag.query_batch(QUERIES))
        logs.append([(p, json.dumps(b, sort_keys=True)) for p, b in stub.requests])
    engine_compare(*out)
    assert logs[1] == logs[0]
    embeds = [json.loads(b) for p, b in logs[1] if p == "/v1/embeddings"]
    assert len(embeds) == 1 and len(embeds[0]["input"]) == len(QUERIES)  # one host encode
    assert any(r.results for r in out[1])


def test_facade_survives_dead_model_server_as_reference(small_config):
    """Every HTTP rung degrades (zero vectors, rule planner and NER, the device
    rerank); the query still answers through the lexical channel, as in the
    reference's ``test_rag_facade_survives_dead_model_server``."""
    cfg = _facade_config(small_config, "http://127.0.0.1:9", api_timeout_s=0.5, rerank_backend="dot")
    out = []
    for rag in (RefRAG(config=cfg), RAG(torch_config(cfg), device="cpu")):
        res = rag.ingest_text("# Payments\n\nInvoices settle within thirty days of billing.",
                              name="pay.md")
        assert res.n_children >= 1 and res.status.value == "completed"
        assert not any(np.any(v) for v in rag.ingestor.embeddings.values())  # zero vectors
        out.append(rag.query("invoice settlement deadline"))
    _compare(*out)
    assert not out[1].refused and "Invoices" in out[1].results[0].text


def test_checkpoint_config_wires_http_when_trusted(stub, small_config, tmp_path):
    """``RAG.load(trust_config=True)`` keeps a checkpoint's ``*_api_base`` and wires
    the clients, as the reference does; untrusted, the fields are stripped."""
    cfg = _facade_config(small_config, stub.base, rerank_backend="dot")
    rag = RAG(torch_config(cfg), device="cpu")
    rag.ingest_text(DOC, name="contract.md")
    rag.save(tmp_path / "idx")
    trusted = RAG.load(tmp_path / "idx", trust_config=True, device="cpu")
    assert type(trusted.ingestor.embedder.inner).__name__ == "HTTPEmbedder"
    assert trusted._rerank_fn is not None
    stripped = RAG.load(tmp_path / "idx", device="cpu")
    assert not stripped.config.embed_api_base and stripped._rerank_fn is None
    _compare(rag.query(QUERIES[0]), trusted.query(QUERIES[0]))
