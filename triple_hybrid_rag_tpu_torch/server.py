"""HTTP serving host: the query, ingest, rerank and metrics surface.

The port of the JAX package's ``server.py``: a dependency-free stdlib server over a
:class:`~triple_hybrid_rag_tpu_torch.facade.RAG` on one device, with the same
routes, status codes, validation and metric names:

    POST /query    {"query": str, "top_k"?: int, "collection"?: str} -> RetrievalResult JSON
    POST /ingest   {"text": str, "name"?: str} | {"path": str}
                   (the "path" variant reads server-local files and is DISABLED unless
                   the server is started with an ``ingest_root`` allowlist directory)
    POST /rerank   {"query": str, "documents": [str], "top_n"?: int}
                   -> {"results": [{"index", "relevance_score"}], "scorer"}
    GET  /metrics  Prometheus text exposition
    GET  /healthz  liveness + corpus stats
    GET  /stats    corpus + graph stats

With ``RAG(use_sharded_engine=True)`` concurrent ``/query`` requests coalesce in a
:class:`MicroBatcher` into one ``query_batch`` of the batched engine; otherwise each
request runs the staged path. Startup pre-warms with a dummy query: that builds the
CUDA kernels (``nvcc``) and makes their first launches before the first request.

Every device call goes through the server's one lock (``RAGServer._lock``): the
micro-batcher's dispatcher thread runs the engine's kernels under it, and the
request handler threads run staged queries, ``/ingest`` and ``/rerank`` under it.
Besides keeping one stream of work on the card, this matters for the kernels: their
host code keeps process-wide state between launches (``csrc/maxsim.cu`` encodes the
tensor map of the last token store it saw, and ``/rerank`` scores a store of its
own), so two launches from two threads must not interleave.

Trust model: NO authentication by default; auth is the deployment's job (reverse
proxy / network policy). Bind to 127.0.0.1 (the default) unless the network path is
trusted, or pass ``auth_token`` (``thr-torch serve --auth-token`` /
RAG_SERVER_TOKEN) to require ``Authorization: Bearer <token>`` (or ``X-API-Key``)
on every request. Filesystem ingestion via ``{"path": ...}`` is disabled by
default; pass ``ingest_root`` to allow paths under one directory only.
"""

from __future__ import annotations

import hmac
import itertools
import json
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from .config import RAGConfig, get_settings
from .facade import RAG
from .observability import rag_metrics
from .observability.trace import tracer
from .types import RetrievalResult


def result_to_dict(result: RetrievalResult) -> dict:
    return {
        "query": result.query,
        "refused": result.refused,
        "refusal_reason": result.refusal_reason,
        "max_score": result.max_score,
        "timings_ms": {k: round(v, 3) for k, v in result.timings.items()},
        "channel_counts": result.channel_counts,
        "results": [
            {
                "chunk_id": r.chunk_id,
                "parent_id": r.parent_id,
                "doc_id": r.doc_id,
                "text": r.text,
                "parent_text": r.parent_text,
                "section_heading": r.section_heading,
                "pages": [r.page_start, r.page_end],
                "scores": {
                    "final": r.final_score,
                    "rrf": r.rrf_score,
                    "rerank": r.rerank_score,
                    "lexical": r.lexical_score,
                    "semantic": r.semantic_score,
                    "graph": r.graph_score,
                },
                "source_channels": list(r.source_channels),
            }
            for r in result.results
        ],
    }


# monotone per-process trace ids: time.time()*1e6 alone collides for concurrent
# requests in the same clock tick, interleaving their begin/end trace events
_QID_COUNTER = itertools.count(int(time.time() * 1e6))


class _Pending:
    __slots__ = ("query", "top_k", "collection", "event", "result", "error")

    def __init__(self, query: str, top_k, collection) -> None:
        self.query = query
        self.top_k = top_k
        self.collection = collection
        self.event = threading.Event()
        self.result = None
        self.error: Optional[Exception] = None


class MicroBatcher:
    """Dynamic micro-batching: coalesce concurrent /query requests into ONE engine
    call.

    The batched engine amortizes the per-call host work and launches across the
    batch, but a lock-serialized server would pay a full call per request. Here
    request threads enqueue and block; a dispatcher thread drains the queue —
    waiting at most ``window_s`` after the first request for stragglers — pads the
    batch to the next power-of-two width (as the JAX package does, where it bounds
    the count of compiled programs; results and metrics stay the same), runs ONE
    ``query_batch`` and hands each request its result, decoded on the host.
    """

    def __init__(
        self,
        state: "RAGServer",
        window_s: float = 0.002,
        max_batch: int = 128,
        timeout_s: float = 120.0,
    ) -> None:
        self.state = state
        self.window_s = window_s
        self.max_batch = max_batch
        self.timeout_s = timeout_s
        self._queue: deque = deque()
        self._cond = threading.Condition()
        self._closed = False
        self._thread = threading.Thread(
            target=self._run, name="thr-microbatcher", daemon=True
        )
        self._thread.start()

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def submit(self, query: str, top_k, collection):
        p = _Pending(query, top_k, collection)
        with self._cond:
            self._queue.append(p)
            self._cond.notify()
        if not p.event.wait(self.timeout_s):
            raise TimeoutError("query timed out waiting for the engine")
        if p.error is not None:
            raise p.error
        return p.result

    # -- dispatcher --

    def _drain(self) -> List[_Pending]:
        with self._cond:
            while not self._queue and not self._closed:
                self._cond.wait(timeout=1.0)
            if self._closed:
                return []
        # straggler window: let concurrent requests coalesce into this call
        deadline = time.monotonic() + self.window_s
        while time.monotonic() < deadline:
            with self._cond:
                if len(self._queue) >= self.max_batch:
                    break
            time.sleep(self.window_s / 8)
        with self._cond:
            n = min(len(self._queue), self.max_batch)
            return [self._queue.popleft() for _ in range(n)]

    def _run(self) -> None:
        while True:
            batch = self._drain()
            if not batch:
                if self._closed:
                    # fail pending requests now: abandoning them would leave their
                    # handler threads blocked for the full submit timeout
                    with self._cond:
                        leftover = list(self._queue)
                        self._queue.clear()
                    for p in leftover:
                        p.error = RuntimeError("server shutting down")
                        p.event.set()
                    return
                continue
            queries = [p.query for p in batch]
            colls = [p.collection for p in batch]
            # pad to the next power-of-two width (the JAX package's policy)
            width = 1 << (len(batch) - 1).bit_length()
            while len(queries) < width:
                queries.append(queries[-1])
                colls.append(None)
            scoped = any(c is not None for c in colls)
            try:
                with self.state._lock:
                    results = self.state.rag.query_batch(
                        queries, collections=colls if scoped else None
                    )
                rag_metrics.counter("server_engine_batches_total").inc()
                rag_metrics.histogram("server_batch_size").observe(len(batch))
                for p, r in zip(batch, results):
                    if p.top_k is not None:
                        r.results = r.results[: p.top_k]
                    p.result = r
                    p.event.set()
            except Exception as e:  # each waiting request re-raises it (a 500)
                for p in batch:
                    p.error = e
                    p.event.set()


class RAGServer:
    """Server state: a RAG facade, the device lock and the pre-warm. Builds (or
    loads from ``index_dir``) a RAG on ``device`` when none is given: the card,
    unless the caller asks for the CPU."""

    def __init__(
        self,
        rag: Optional[RAG] = None,
        config: Optional[RAGConfig] = None,
        index_dir: Optional[str] = None,
        ingest_root: Optional[str] = None,
        batch_window_s: float = 0.002,
        max_batch: int = 128,
        auth_token: Optional[str] = None,
        device=None,
    ) -> None:
        if rag is not None:
            self.rag = rag
        elif index_dir and (Path(index_dir) / "manifest.json").exists():
            self.rag = RAG.load(index_dir, device=device)
        else:
            self.rag = RAG(config=config or get_settings(), device=device)
        self.index_dir = index_dir
        # allowlist root for {"path": ...} ingestion; None = path ingestion disabled
        # (an unauthenticated /ingest {"path"} would otherwise let any caller index —
        # and then read back via /query — any file readable by the process)
        self.ingest_root = Path(ingest_root).resolve() if ingest_root else None
        # optional shared-secret auth: every request must carry
        # "Authorization: Bearer <token>" (or X-API-Key); required before binding a
        # non-loopback host
        self.auth_token = auth_token
        self._lock = threading.Lock()
        self.started_at = time.time()
        # micro-batching needs the batched engine path; the staged retriever
        # serializes through the lock
        self.batcher: Optional[MicroBatcher] = None
        if getattr(self.rag, "use_sharded_engine", False) and batch_window_s > 0:
            self.batcher = MicroBatcher(
                self, window_s=batch_window_s, max_batch=max_batch
            )

    def prewarm(self) -> float:
        """One dummy query before traffic: builds the kernels and the indexes and
        makes the first launches."""
        t0 = time.time()
        if len(self.rag.ingestor.corpus):
            with self._lock:
                self.rag.query("warmup query", top_k=1)
        return time.time() - t0

    # -- handlers --

    def handle_query(self, payload: dict) -> dict:
        query = payload.get("query", "")
        if not isinstance(query, str) or not query.strip():
            raise ValueError("missing 'query'")
        top_k = payload.get("top_k")
        if top_k is not None:
            if not isinstance(top_k, int) or isinstance(top_k, bool) or top_k <= 0:
                raise ValueError("'top_k' must be a positive integer")
        collection = payload.get("collection")
        if collection is not None and not isinstance(collection, str):
            raise ValueError("'collection' must be a string")
        qid = f"q{next(_QID_COUNTER):x}"
        tracer.query_begin(qid, query)
        with rag_metrics.time("server_query_ms"):
            if self.batcher is not None:
                # coalesced: the MicroBatcher owns the lock for the whole batch
                result = self.batcher.submit(query, top_k, collection)
            else:
                with self._lock:
                    result = self.rag.query(query, top_k=top_k, collection=collection)
        rag_metrics.counter("server_queries_total").inc()
        if result.refused:
            rag_metrics.counter("server_refusals_total").inc()
        tracer.query_end(qid, len(result.results), result.refused)
        return result_to_dict(result)

    def handle_ingest(self, payload: dict) -> dict:
        with self._lock:
            if "text" in payload:
                res = self.rag.ingest_text(
                    payload["text"], name=payload.get("name", "inline.txt"),
                    force=bool(payload.get("force")),
                )
            elif "path" in payload:
                if self.ingest_root is None:
                    raise ValueError(
                        "filesystem ingestion is disabled; start the server with "
                        "ingest_root=<dir> (thr-torch serve --ingest-root) to allow it"
                    )
                candidate = Path(str(payload["path"])).resolve()
                if not candidate.is_relative_to(self.ingest_root):
                    raise ValueError(f"path outside the allowed ingest root: {candidate}")
                res = self.rag.ingest(str(candidate), force=bool(payload.get("force")))
            else:
                raise ValueError("ingest needs 'text' or 'path'")
            if self.index_dir:
                self.rag.save(self.index_dir)
        return {
            "doc_id": res.doc_id,
            "status": res.status.value,
            "skipped": res.skipped,
            "parents": res.n_parents,
            "children": res.n_children,
            "entities": res.n_entities,
            "error": res.error,
        }

    def handle_rerank(self, payload: dict) -> dict:
        """Standalone rerank: score (query, documents) pairs, sorted by score
        descending (the vLLM ``/rerank`` response shape). MaxSim late interaction
        when the embedder has token embeddings: the documents' tokens go into a
        one-off token store on the RAG's device and :func:`ops.maxsim.maxsim_scores
        <triple_hybrid_rag_tpu_torch.ops.maxsim.maxsim_scores>` scores them as one
        query's candidates (the MaxSim kernel on the card), calibrated as the
        retriever's rerank is; the pooled cosine otherwise."""
        query = payload.get("query", "")
        docs = payload.get("documents")
        if not isinstance(query, str) or not query.strip():
            raise ValueError("missing 'query'")
        if (
            not isinstance(docs, list)
            or not docs
            or not all(isinstance(d, str) for d in docs)
        ):
            raise ValueError("missing 'documents' (non-empty list of strings)")
        top_n = payload.get("top_n")
        if top_n is not None and (not isinstance(top_n, int) or top_n < 1):
            raise ValueError("'top_n' must be a positive integer")
        # unwrap FailSoftEmbedder: token_embeddings lives on the inner embedder
        emb = self.rag.ingestor.embedder
        emb = getattr(emb, "inner", emb)
        with self._lock, rag_metrics.time("server_rerank_ms"):
            if hasattr(emb, "token_embeddings"):
                scores = self._maxsim_rerank(emb, query, docs)
                scorer = "maxsim"
            else:
                dv = np.asarray(emb.embed_texts(docs), np.float32)
                qv = np.asarray(emb.embed_query(query), np.float32)
                scores = np.clip(dv @ qv, 0.0, 1.0)
                scorer = "cosine"
        rag_metrics.counter("server_reranks_total").inc()
        order = np.argsort(-scores, kind="stable")
        if top_n is not None:
            order = order[:top_n]
        return {
            "results": [
                {"index": int(i), "relevance_score": float(scores[i])} for i in order
            ],
            "scorer": scorer,
        }

    def _maxsim_rerank(self, emb, query: str, docs: List[str]) -> np.ndarray:
        """f32[len(docs)] calibrated MaxSim scores of ``docs`` for ``query``."""
        from .ops.maxsim import calibrate_maxsim, maxsim_scores
        from .retrieval import maxsim_query_weights

        cfg = self.rag.config
        dev = self.rag.device
        dt = np.asarray(emb.token_embeddings(
            docs, max_tokens=cfg.maxsim_doc_tokens, dim=cfg.maxsim_dim), np.float32)
        qt = np.asarray(emb.token_embeddings(
            [query], max_tokens=cfg.maxsim_query_tokens, dim=cfg.maxsim_dim), np.float32)[0]
        dmask = np.linalg.norm(dt, axis=-1) > 0
        qw = (np.linalg.norm(qt, axis=-1) > 0).astype(np.float32)
        qw *= maxsim_query_weights(query, self.rag.retriever.analyzer, cfg.maxsim_query_tokens)
        scores = maxsim_scores(
            torch.from_numpy(dt).to(dev, torch.bfloat16),
            torch.from_numpy(dmask).to(dev),
            torch.arange(len(docs), device=dev)[None],
            torch.from_numpy(qt).to(dev)[None],
            torch.from_numpy(qw).to(dev)[None],
        )[0]
        return calibrate_maxsim(scores, getattr(emb, "maxsim_calibration", 1.0)).cpu().numpy()

    def handle_stats(self) -> dict:
        return self.rag.stats()

    def handle_health(self) -> dict:
        return {
            "status": "ok",
            "uptime_s": round(time.time() - self.started_at, 1),
            **self.rag.stats(),
        }


def make_handler(server_state: RAGServer):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _authorized(self) -> bool:
            tok = server_state.auth_token
            if not tok:
                return True
            # constant-time compare: str == leaks the matching prefix via timing
            auth = self.headers.get("Authorization", "")
            if hmac.compare_digest(auth, f"Bearer {tok}"):
                return True
            return hmac.compare_digest(self.headers.get("X-API-Key", ""), tok)

        def _send(self, code: int, payload, content_type="application/json"):
            body = (
                payload.encode()
                if isinstance(payload, str)
                else json.dumps(payload).encode()
            )
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if not self._authorized():
                self._send(401, {"error": "unauthorized"})
                return
            try:
                if self.path == "/metrics":
                    self._send(200, rag_metrics.prometheus_text(), "text/plain; version=0.0.4")
                elif self.path == "/healthz":
                    self._send(200, server_state.handle_health())
                elif self.path == "/stats":
                    self._send(200, server_state.handle_stats())
                else:
                    self._send(404, {"error": "not found"})
            except Exception as e:
                self._send(500, {"error": str(e)})

        def do_POST(self):
            if not self._authorized():
                self._send(401, {"error": "unauthorized"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                if length < 0 or length > 64 * 1024 * 1024:
                    # a negative length reads to EOF (blocking the handler thread
                    # until the client hangs up); a huge one buffers the whole body
                    self._send(400, {"error": "invalid Content-Length"})
                    return
                payload = json.loads(self.rfile.read(length) or b"{}")
            except (ValueError, UnicodeDecodeError):
                # a JSON error, a bogus Content-Length or non-UTF-8 bytes: a clean
                # 400, not a dropped connection
                self._send(400, {"error": "invalid JSON body"})
                return
            if not isinstance(payload, dict):
                self._send(400, {"error": "body must be a JSON object"})
                return
            try:
                if self.path == "/query":
                    self._send(200, server_state.handle_query(payload))
                elif self.path == "/ingest":
                    self._send(200, server_state.handle_ingest(payload))
                elif self.path == "/rerank":
                    self._send(200, server_state.handle_rerank(payload))
                else:
                    self._send(404, {"error": "not found"})
            except ValueError as e:
                self._send(400, {"error": str(e)})
            except Exception as e:
                rag_metrics.counter("server_errors_total").inc()
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def serve(
    host: str = "127.0.0.1",
    port: int = 8400,
    rag: Optional[RAG] = None,
    index_dir: Optional[str] = None,
    prewarm: bool = True,
    ingest_root: Optional[str] = None,
    batch_window_s: float = 0.002,
    max_batch: int = 128,
    auth_token: Optional[str] = None,
    device=None,
) -> ThreadingHTTPServer:
    """Create (and return) the HTTP server; the caller runs serve_forever().
    ``device`` is where a RAG built (or loaded) here runs: the card, unless the
    caller asks for the CPU."""
    state = RAGServer(
        rag=rag, index_dir=index_dir, ingest_root=ingest_root,
        batch_window_s=batch_window_s, max_batch=max_batch,
        auth_token=auth_token, device=device,
    )
    if prewarm:
        warm_s = state.prewarm()
        rag_metrics.gauge("server_prewarm_seconds").set(warm_s)

    class _Server(ThreadingHTTPServer):
        # the stdlib default backlog (5) resets concurrent connects while the
        # micro-batcher holds requests open for its coalescing window
        request_queue_size = 128
        daemon_threads = True

    httpd = _Server((host, port), make_handler(state))
    httpd.rag_state = state  # type: ignore[attr-defined]

    orig_shutdown = httpd.shutdown

    def shutdown() -> None:
        if state.batcher is not None:
            state.batcher.close()
        orig_shutdown()

    httpd.shutdown = shutdown  # type: ignore[method-assign]
    return httpd
