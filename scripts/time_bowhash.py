"""Time the BowHash query encode of a batch on the card (``csrc/bowhash.cu``).

Batches of texts shaped as the benchmark's batch traffic (six terms of a 65,536-term
vocabulary, a third of them relation questions over two entity names), at the
default widths (dense 2,048 cut to 1,024, MaxSim 32 x 128). Prints, a batch:

* the streams drawn (distinct tokens of each kind);
* the kernel's device ms (CUDA events around ``bowhash_encode`` on inputs already
  on the card, warm L2);
* host ms of ``BowHashEmbedder.encode_queries_device`` (tokenize, hash, one copy,
  launch; synchronized) and of the host path it replaces (``embed_texts`` +
  ``token_embeddings`` with their caches emptied before each batch: every token
  drawn anew, as on a first touch).

Run on the card from the root of the checkout:

    python3 scripts/time_bowhash.py [--batches 20] [--batch 128]
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from triple_hybrid_rag_tpu_torch.config import RAGConfig  # noqa: E402
from triple_hybrid_rag_tpu_torch.kernels import build  # noqa: E402
from triple_hybrid_rag_tpu_torch.models.embedder import BowHashEmbedder  # noqa: E402
from triple_hybrid_rag_tpu_torch.ops.bowhash import bowhash_encode  # noqa: E402


def texts_of(rng, n: int):
    out = []
    for i in range(n):
        terms = " ".join(f"t{int(t):06d}" for t in rng.integers(0, 65536, size=6))
        if rng.random() < 1 / 3:
            a, b = rng.integers(0, 20000, size=2)
            terms = f"How is entity{a:05d} related to entity{b:05d}? {terms}"
        out.append(terms)
    return out


def kernel_inputs(emb, texts, t_q, d_m, dev):
    """The wrapper's inputs for ``texts``, on the card."""
    seeds, n_tok, tok_idx, mtok_idx, _ = emb.query_streams(texts, t_q, d_m)
    return (torch.from_numpy(seeds.view(np.int64)).to(dev), n_tok,
            torch.from_numpy(tok_idx).to(dev), torch.from_numpy(mtok_idx).to(dev))


def event_ms(fn, reps: int = 10) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", type=int, default=20)
    ap.add_argument("--batch", type=int, default=128)
    args = ap.parse_args()
    dev = torch.device("cuda")
    build.build(["bowhash"])
    for line in build.BUILD_LOGS.get("bowhash", "").splitlines():
        if "registers" in line or "spill" in line or "warning" in line.lower():
            print("ptxas:", line.strip(), file=sys.stderr)
    cfg = RAGConfig()
    emb = BowHashEmbedder(dim=cfg.embedding_dim_full, config=cfg)
    d, t_q, d_m = cfg.embedding_dim, cfg.maxsim_query_tokens, cfg.maxsim_dim
    rng = np.random.default_rng(2147483647)
    rows = []
    for _ in range(args.batches):
        texts = texts_of(rng, args.batch)
        seeds, n_tok, tok_idx, mtok_idx = kernel_inputs(emb, texts, t_q, d_m, dev)
        enc_ms = event_ms(lambda: bowhash_encode(seeds, n_tok, cfg.embedding_dim_full, d_m,
                                                  tok_idx, mtok_idx, d))
        emb._tok_cache.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        emb.encode_queries_device(texts, out_dim=d, max_tokens=t_q, token_dim=d_m, device=dev)
        torch.cuda.synchronize()
        dev_host_ms = 1e3 * (time.perf_counter() - t0)
        emb._tok_cache.clear()
        emb._token_cache.clear()
        emb._mtok_cache.clear()
        t0 = time.perf_counter()
        emb.embed_texts(texts)
        emb.token_embeddings(texts, max_tokens=t_q, dim=d_m)
        host_ms = 1e3 * (time.perf_counter() - t0)
        rows.append({"streams": int(seeds.shape[0]), "dense_streams": n_tok, "kernel_ms": enc_ms,
                     "device_encode_host_ms": dev_host_ms,
                     "host_path_ms": host_ms})
    med = {k: statistics.median(r[k] for r in rows) for k in rows[0]}
    print(json.dumps({"card": torch.cuda.get_device_name(0), "batch": args.batch,
                      "batches": args.batches, "median": med, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
