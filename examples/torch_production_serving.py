"""Production serving with the PyTorch port, step for step as
``examples/production_serving.py``: the batched engine, multi-tenancy, the HTTP
surface (/query /rerank) and checkpoint migration.

Run:  python examples/torch_production_serving.py [--device cpu]
Runs on the CUDA card unless ``--device cpu`` is given; without a card and without
that flag it stops with an error, as every entry point of the port does. Offline:
the packaged encoder (or the hash embedders without it). It imports the port and
the standard library only, and ends by printing whether a JAX module was loaded
and how often the kernels of the batched engine launched.
"""

import argparse
import json
import sys
import tempfile
import threading
import urllib.request
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from triple_hybrid_rag_tpu_torch import RAG, RAGConfig
from triple_hybrid_rag_tpu_torch.kernels.build import launch_counts


def main(device=None) -> None:
    config = RAGConfig(graph_enabled=True, safety_threshold=0.35)

    # --- ingest two tenants' corpora into separate collections ---------------
    rag = RAG(config=config, use_sharded_engine=True, device=device)
    rag.ingest_text(
        "# Billing policy\n\nInvoices must be settled within thirty days; the billing "
        "cycle is quarterly and late settlement incurs a penalty fee.",
        name="billing.md", collection="tenant_a",
    )
    rag.ingest_text(
        "# Shipping\n\nFreight shipments clear customs before warehouse intake. "
        "Delivery windows are confirmed forty-eight hours ahead.",
        name="shipping.md", collection="tenant_b",
    )

    # --- batched serving through the engine -----------------------------------
    # One batched program answers the whole batch: every query's lexical, dense
    # and graph channels, fusion, expansion, rerank and safety gate.
    before = launch_counts()
    results = rag.query_batch(
        ["invoice settlement penalty", "customs delivery window"],
        collections=["tenant_a", "tenant_b"],
        top_k=2,
    )
    grew = {k: v - before.get(k, 0) for k, v in launch_counts().items()}
    launches = {"bucket_maxima": grew.get("fused_bucket_maxima_bf16", 0),
                "maxsim": grew.get("maxsim_scores_bf16", 0) + grew.get("maxsim_scores_int8", 0)}
    for q, r in zip(["invoice...", "customs..."], results):
        top = r.results[0].text.splitlines()[0] if r.results else "(refused)"
        print(f"batched [{q}] -> {top}")

    # --- tenancy isolation: tenant_a's question against tenant_b's collection
    leak = rag.query("invoice settlement penalty", collection="tenant_b")
    print(f"cross-tenant query refused={leak.refused} results={len(leak.results)}")
    print("cross-tenant top ->", leak.results[0].text.splitlines()[0] if leak.results else "(none)")

    # --- the HTTP surface -----------------------------------------------------
    from triple_hybrid_rag_tpu_torch.server import serve

    httpd = serve(host="127.0.0.1", port=0, rag=rag)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def post(path, payload):
        req = urllib.request.Request(
            base + path, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=60) as resp:
            return json.loads(resp.read().decode())

    body = post("/query", {"query": "billing cycle penalty", "collection": "tenant_a"})
    print(f"HTTP /query -> {len(body['results'])} results, "
          f"total {body['timings_ms']['total_ms']:.1f} ms")

    # the standalone rerank service (vLLM /rerank response shape)
    body = post("/rerank", {
        "query": "invoice settlement",
        "documents": [
            "Parking assignments and stationery reorders.",
            "Invoices must be settled within thirty days.",
        ],
    })
    print(f"HTTP /rerank -> winner index {body['results'][0]['index']} "
          f"({body['scorer']}, score {body['results'][0]['relevance_score']:.2f})")
    httpd.shutdown()
    httpd.server_close()

    # --- checkpoint + migration (the backfill path) ---------------------------
    from triple_hybrid_rag_tpu_torch.index.checkpoint import load_ingestor, save_ingestor

    with tempfile.TemporaryDirectory() as d:
        src, dst = Path(d) / "src", Path(d) / "int8"
        rag.save(src)
        # derive the device indexes again under int8 rows (thr-torch migrate SRC DST --dtype int8)
        ing = load_ingestor(src, config=config.replace(embedding_dtype="int8"), device=device)
        save_ingestor(ing, dst)
        moved = RAG.load(dst, device=device)
        r = moved.query("invoice settlement penalty", collection="tenant_a", top_k=1)
        print(f"migrated int8 checkpoint answers: refused={r.refused}, "
              f"top='{r.results[0].text.splitlines()[0] if r.results else ''}'")

    print("\njax loaded:", any(m.split(".")[0] in ("jax", "jaxlib", "flax") for m in sys.modules))
    print("kernel launches:", json.dumps(launches))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cpu, or a CUDA device (default: the card)")
    main(ap.parse_args().device)
