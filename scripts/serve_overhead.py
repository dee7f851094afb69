"""Where a served request's time goes: the HTTP server against the RAG alone, and a
client in the server's process against one in a process of its own.

    python3 scripts/serve_overhead.py [--docs 300] [--device cuda]

Ingests ``--docs`` of this Python's standard-library docstrings (every eighth of
``chip_smoke.stdlib_docstrings``) into a default ``RAGConfig`` RAG and times, with
host clocks:

- ``RAG.query`` for 32 queries (a chunk's first 12 analyzer tokens each): in this
  thread, and each in a new thread (a request handler's cost);
- the staged server (``server.serve``): the 32 queries as POST /query one after
  another from ``chip_smoke.LOAD_CLIENT`` (a process of its own), from a urllib
  client in this process, with the server's ``TCP_NODELAY`` off and on; and GET
  /healthz from the in-process client;
- the micro-batched server: 128 concurrent POST /query from the load client, and
  from 128 threads of this process, each with the engine calls' widths and
  seconds; and 128 concurrent GET /healthz from 128 threads.

Prints one line per measurement and the card. Needs one CUDA card unless
``--device cpu``.
"""

import argparse
import concurrent.futures
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def p50(seconds) -> str:
    return f"{np.median(seconds) * 1e3:.2f} ms"


def threaded(base: str, route: str, payloads):
    """(status, seconds) of each request sent at once from a thread of this process."""
    barrier = threading.Barrier(len(payloads))

    def one(payload):
        barrier.wait()
        t = time.perf_counter()
        status, _ = cs.http(base, route, payload)
        return status, time.perf_counter() - t

    with concurrent.futures.ThreadPoolExecutor(max_workers=len(payloads)) as ex:
        return list(ex.map(one, payloads))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--docs", type=int, default=300)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    from triple_hybrid_rag_tpu_torch import RAG, RAGConfig
    from triple_hybrid_rag_tpu_torch.analyzer import Analyzer

    card = cs.card_line() if args.device in (None, "cuda") else args.device
    mods, defs = cs.stdlib_docstrings()
    rag = RAG(RAGConfig(), device=args.device, use_sharded_engine=True)
    cs.ingest_all(rag, (mods + defs)[::8][: args.docs], "serve_overhead")
    corpus = rag.ingestor.corpus
    an = Analyzer(rag.config)
    rows = np.linspace(0, len(corpus) - 1, 128).astype(int)
    queries = [" ".join(an.tokenize(corpus.children[r].text)[:12]) for r in rows]
    sync = torch.cuda.synchronize if rag.device.type == "cuda" else (lambda: None)
    rag.query_batch(queries)

    rag.use_sharded_engine = False
    staged = queries[:32]

    def timed(q):
        t = time.perf_counter()
        rag.query(q)
        sync()
        return time.perf_counter() - t

    for q in staged[:4]:
        timed(q)
    here = [timed(q) for q in staged]
    fresh = []
    for q in staged:
        th = threading.Thread(target=lambda q=q: fresh.append(timed(q)))
        th.start()
        th.join()
    print(f"RAG.query, {len(staged)} queries: in this thread p50 {p50(here)}; each in a new "
          f"thread p50 {p50(fresh)}; card {card}", flush=True)
    httpd, base = cs.start_server(rag)
    for nodelay in (False, True):
        httpd.RequestHandlerClass.disable_nagle_algorithm = nodelay
        other = [t for _, t, _ in cs.load_client(httpd.server_address[1], "/query",
                                                 [{"query": q} for q in staged], sequential=True)]
        inproc = []
        for q in staged:
            t = time.perf_counter()
            cs.http(base, "/query", {"query": q})
            inproc.append(time.perf_counter() - t)
        health = []
        for _ in staged:
            t = time.perf_counter()
            cs.http(base, "/healthz")
            health.append(time.perf_counter() - t)
        print(f"staged server, TCP_NODELAY {nodelay}: POST /query one after another from "
              f"another process p50 {p50(other)}, from urllib in this process p50 {p50(inproc)}; "
              f"GET /healthz from urllib in this process p50 {p50(health)}; card {card}", flush=True)
    cs.stop_server(httpd)

    rag.use_sharded_engine = True
    calls = []
    query_batch = rag.query_batch

    def counted(qs, **kw):
        t = time.perf_counter()
        out = query_batch(qs, **kw)
        sync()
        calls.append((len(qs), round(time.perf_counter() - t, 4)))
        return out

    rag.query_batch = counted
    httpd, base = cs.start_server(rag)
    payloads = [{"query": q} for q in queries]
    for rnd in range(2):
        calls.clear()
        lat = [t for _, t, _ in cs.load_client(httpd.server_address[1], "/query", payloads)]
        print(f"micro-batched, round {rnd + 1}: 128 concurrent POST /query from another process: "
              f"p50 {p50(lat)}, max {max(lat) * 1e3:.1f} ms; engine calls (width, s) {calls}; "
              f"card {card}", flush=True)
        calls.clear()
        out = threaded(base, "/query", payloads)
        print(f"micro-batched, round {rnd + 1}: 128 concurrent POST /query from 128 threads of "
              f"this process: p50 {p50([t for _, t in out])}, max "
              f"{max(t for _, t in out) * 1e3:.1f} ms; engine calls (width, s) {calls}", flush=True)
    out = threaded(base, "/healthz", [None] * 128)
    print(f"128 concurrent GET /healthz from 128 threads of this process: p50 "
          f"{p50([t for _, t in out])}, max {max(t for _, t in out) * 1e3:.1f} ms; card {card}")
    cs.stop_server(httpd)
    return 0


if __name__ == "__main__":
    sys.exit(main())
