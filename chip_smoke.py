"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It

1. prints the card and its power limit, and builds the CUDA kernels
   (``triple_hybrid_rag_tpu_torch/csrc/*.cu``, one ``nvcc`` each, in parallel);
2. holds each kernel against its plain PyTorch version at the serving shapes
   (fused dense bucket maxima: N = 1,000,448 rows of width 1024 in bf16, int8 and
   packed int4, B = 128, scoped and unscoped; dense scores on the same rows, at
   B = 128 and at B = 1 (the staged path's width); both
   f32-row bodies (bucket maxima and dense scores) on random f32 unit rows of the
   same shape, at B = 128 and B = 1; MaxSim, its bf16 and its int8 token-store
   bodies: B = 128 x K = 50 candidates over 200,704 parents at the smoke run's
   shape (32 doc tokens of width 64, 16 query tokens) and at the default
   RAGConfig's (64 x 128, 32); term-table BM25: a 1,000,448 x 128 table, 128
   queries of 16 slots) and times kernel, plain version and, where one exists, the
   library call; every kernel body but the bf16 bucket maxima is also held against
   its plain version over a list of small and ragged shapes, the quantized bucket
   maxima bit for bit;
3. drives the port's main path: the batched three-channel query program over a
   synthetic 1M-chunk corpus built on the card (the construction of ``bench.py``),
   through ``Engine.search_arrays`` and ``Engine.retrieve_batch``; checks
   self-retrieval, that both kernels were launched, the B=1 programs, and the
   bucketed matmul path against the kernel path. Then, on the same corpus, the
   further configurations: float32 rows (the documents' rows unrounded; kernel
   path and unfused path must return equal ids up to near ties, and a dense
   channel through the f32 dense scores), int8 rows and packed-int4 rows
   (quantized on the card, with the int8 MaxSim token store the reference keeps
   under both; kernel path and unfused path must return equal ids), the term-table
   lexical backend, and a dense channel through the dense-scores kernel. Each must
   self-retrieve, must have launched its kernel and only its configuration's
   bucket-maxima and MaxSim bodies, and prints its MaxSim store's device GB;
4. the trained query encoder: loads the packaged weights onto the card and holds
   its bf16 forward against the port's own f32 forward on the CPU over 64 texts;
   then serves the default RAGConfig (``embedder_backend="auto"``, MaxSim 64 x 128
   with 32 query tokens, the safety gate at 0.6) on the same corpus, with the rows
   of the queries and their parents' MaxSim tokens re-embedded by the encoder
   (``synthetic.encode_rows``): self-retrieval at B = 128 and B = 1 with the device
   encode on and off (both must agree up to near ties), the encoder's device and
   host ms, program wall, device busy and e2e ms per query; and one batch with
   ``rerank_backend="dot"`` over the parents' mean embeddings;
5. ``semantic_backend="ivf"`` at the reference's defaults (512-row blocks, 1,954
   clusters, 8 k-means iterations, 32 probes) on the same corpus, bf16 rows and
   then int8 rows with the int8 MaxSim store: the layout's build time and peak
   memory, self-retrieval, the semantic channel's recall against the exact scan, no
   bucket-maxima launch and the MaxSim body launched, program wall, device busy and
   ``engine.dense`` beside the exact kernel path at B = 128 and B = 1; and with every
   block probed on a 65,536-row cut, the exact f32 scan's ids up to near ties;
6. ingestion: the default ``RAGConfig`` through ``RAG(device="cuda")`` ingests the
   docstrings of this Python's standard library (``ingest_text``, one collection per
   top-level module), failing on a FAILED result, on an embed that fell back to zero
   vectors and on an all-zero dense row; then ``query_batch`` at B = 128 and B = 1
   with queries made of chunks' own first twelve analyzer tokens (self-retrieval,
   both kernels launched, e2e, program wall, device busy), a repeated ingest that
   must be skipped, a new document that must go through ``Engine.refresh`` and be
   found, and a 200-document subset ingested on the card and on the CPU (equal
   chunk ids, BM25 and graph arrays; dense rows within ``ENCODER_ATOL``);
7. the staged single-query path (``Retriever.retrieve``): (a) phase 6's corpus
   through ``RAG.query`` (``use_sharded_engine=False``) for phase 6's queries:
   self-retrieval, the bf16 dense scores and the bf16 MaxSim body once per query,
   no swallowed embed failure, the ids against ``Engine.retrieve_batch`` at B = 128
   and B = 1 (printed), then a host ``rerank_fn`` and a raising one (MaxSim must
   take over); (b) ``Retriever.from_state`` over phase 3's placed 1M-chunk bf16
   state, 32 of its queries: no device memory added, self-retrieval, launches,
   device busy per query under the profiler; (c) 8 queries each over phase 3's
   term-table and int8 states (the term-table kernel, the int8 MaxSim body).
   Every part prints the median of each ``timings`` key and its e2e ms/query;
8. the serving surface over phase 6's RAG: (a) ``RAG.save`` (seconds, each
   artifact's MB), ``RAG.load`` onto the card and its first query (the MaxSim
   store's rebuild timed apart); the loaded RAG's ``query_batch`` must give the saved
   one's ids up to near ties and its placed dense rows must equal the saved RAG's
   bit for bit; (b) the HTTP server (``server.serve``) with the micro-batcher over
   the loaded RAG (``use_sharded_engine=True``): two rounds of 128 concurrent
   ``POST /query``, each answered 200 with ``query_batch``'s ids, in fewer engine
   batches than requests, each batch one bf16 bucket-maxima and one bf16 MaxSim
   launch (requests/s, p50 and p99 ms, batches and mean width); (c) the staged
   server: 32 sequential ``POST /query``, one dense-scores (B = 1) and one MaxSim
   launch each, the ids of ``RAG.query``; (d) ``/rerank`` of one query over 50 and
   over 400 parent texts (one MaxSim launch, within ``FUSED_ATOL`` of the plain
   version), ``/ingest`` then a ``/query`` that finds the new text, ``/healthz``,
   ``/stats``, ``/metrics``, and the agent tools (``search_knowledge_base``,
   ``lookup_entity`` of the most mentioned entity with relations); (e) the CLI,
   ``python -m triple_hybrid_rag_tpu_torch query --json`` over the checkpoint in a
   new process on the card, with the loaded RAG's ids.

Each phase prints its wall time. Any failed check exits non-zero. The second-to-last line is a JSON object with
each kernel's launches (``launches`` on phase 3's main path, ``staged_launches``
over phase 7, ``serve_launches`` over phase 8's served requests, and per further
path), error and times; the last line is
``{"ok": true, "device": {...}}``. Without CUDA it exits non-zero before printing
any result.
"""

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

N_ROWS = 1_000_000  # chunks
N_PAD = 1_000_448  # N_ROWS after capacity rounding: the rows of every kernel check
DIM = 1024
BATCH = 128
N_ENTITIES = 20_000
DF_CAP = 2048
GRAPH_FRAC = 0.3
RERANK_K = 50  # rerank_top_k: MaxSim candidates per query
MAXSIM_TOKENS, MAXSIM_DIM, QUERY_TOKENS = 32, 64, 16
N_PARENTS = 200_704  # the synthetic corpus's parents (N_ROWS / 5, capacity-rounded)
# (Td, D, Tq) of the MaxSim checks: the smoke run's corpus (bench.py's reduced
# shape) and the default RAGConfig (maxsim_doc_tokens, maxsim_dim, maxsim_query_tokens)
MAXSIM_SHAPES = {"smoke": (MAXSIM_TOKENS, MAXSIM_DIM, QUERY_TOKENS), "default": (64, 128, 32)}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet, at 700 W
BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, same source
INT8_OPS = 1979e12  # dense int8 tensor-core peak, same source
F32_FLOPS = 67e12  # f32 outside the tensor cores, same source
FUSED_ATOL = 1e-4  # unit rows, f32 sums in another order than the plain matmul
# f32 rows: f32 sums of D products of unit vectors in another order than the plain
# f32 matmul's, a few 1e-6 at D = 1024; held to FUSED_ATOL as well
F32_ATOL = FUSED_ATOL
# (n, d, b) of the f32-row edge sweep (bucket maxima scoped and unscoped, dense
# scores): one row, rows short of a bucket, short of a 256-row tile, odd n, more
# tiles than the card has SMs; one query, 5, 16 (the 16-query tile), 17, 128, 129
# and 257 (the 128-query tile, one and more tiles of 128); widths of 8, 72, 1024
# and 1028 (not a multiple of the 16-column stage)
F32_EDGE_SHAPES = [(1, 8, 1), (15, 72, 5), (255, 1028, 16), (257, 1024, 17), (999, 72, 128),
                   (4097, 1024, 129), (40001, 8, 257), (20005, 1028, 1), (70000, 1024, 5)]
# (n, d, b) of the dense-scores edge sweep: rows and queries short of a tile, odd n
# (scalar stores), more than one query tile, widths short of and across a stage
DENSE_EDGE_SHAPES = [(1, 64, 1), (77, 64, 3), (127, 64, 1), (999, 1024, 128), (1000, 1024, 130),
                     (257, 72, 5), (4097, 128, 257), (300, 8, 5)]
# (n, table width, b, query slots) of the term-table edge sweep: widths short of a
# chunk of 32 slots, not a multiple of it, and beyond the 128 a warp loads at once; rows short
# of a tile; one query, and more than one block of 128 queries; 1 and 32 query slots
TERM_EDGE_SHAPES = [(31, 1, 2, 2), (64, 8, 4, 4), (999, 40, 1, 16), (333, 128, 130, 16),
                    (70, 800, 3, 32), (2048, 128, 128, 1)]
# (n, d, b) of the int8 / packed-int4 bucket-maxima edge sweep, each scoped and
# unscoped, bit-equal: one row, rows short of a bucket, a bucket plus one, short of a
# 64-row tile, a tile plus one, an odd count of tiles over more pairs than the card
# has SMs; one query, a few, more than one launch of 128; rows narrower than a
# 128-byte stage, ragged against it (int4: D/2 = 80), the serving width (queries
# resident in shared memory) and 4096 (queries streamed through the ring)
INT_EDGE_SHAPES = [(1, 32, 1), (15, 32, 5), (17, 160, 1), (63, 160, 5), (65, 1024, 130),
                   (127, 1024, 1), (129, 160, 257), (1000, 1024, 128), (300, 4096, 5),
                   (2049, 4096, 130), (40000, 160, 5), (20005, 1024, 257)]
MAXSIM_ATOL = 1e-5
# (B, K, parents, Td, D, Tq) of the MaxSim edge sweep: one query and one candidate
# (every candidate invalid), Td of one token, one past a 32-token stage, past 128
# and 4096 (128 stages streamed through a warp's ring); D of 32 (the 8M
# configuration), 40 and 36 (not a multiple of 32; int8 rows TMA cannot address),
# 33 (odd), 128, and 520 (a padded row wider than a TMA box: plain loads); Tq of 1,
# 17, 32 and 128
MAXSIM_EDGE_SHAPES = [(1, 1, 7, 1, 32, 1), (1, 50, 64, 33, 40, 32), (3, 1, 50, 130, 128, 128),
                      (2, 5, 9, 4096, 32, 32), (128, 50, 1000, 33, 128, 1),
                      (5, 7, 20, 130, 40, 128), (2, 9, 30, 40, 33, 16), (4, 6, 25, 65, 36, 17),
                      (1, 50, 100, 64, 128, 32), (2, 3, 10, 5, 520, 1)]
TERM_ATOL = 1e-5  # f32 sums of at most 16 weights below 1, in another slot order
LEXICAL_ATOL = 1e-4  # BM25 sums of up to 16 weights of ~10, in another order
TABLE_WIDTH, QUERY_TERMS = 128, 16  # doc_term_capacity, max_query_terms
# substrings of the hand-written kernels' names, by the engine stage that launches them
OWN_KERNELS = {"engine.dense": ("bucket_max",), "engine.lexical": ("termtable_kernel",),
               "engine.tail": ("maxsim_kernel",)}
# the encoder's bf16 forward against its f32 forward: unit vectors, two bf16 ulps at
# 1.0 (the tolerance tests/test_torch_encoder.py states, BF16_VS_F32_ATOL)
ENCODER_ATOL = 2e-2
N_ENCODER_TEXTS = 64
T_START = time.time()
STAGE_MS: dict = {}  # engine stage -> device ms per batch of the last stage_profile


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "nvidia-smi unavailable"


def time_ms(fn, iters: int = 10, warmup: int = 2, cold_l2: bool = False,
            run_ahead: bool = True) -> float:
    """Median device time of ``fn`` over ``iters`` calls (CUDA events). With
    ``run_ahead`` the stream is first kept busy for about half a millisecond, so
    the host has enqueued the call's kernels before the device reaches the first
    event: the time is the device's. Without it the device waits at the first event
    for the host, and a call's launch work (Python, tensor-map encoding: tens of
    microseconds) counts as its time. With ``cold_l2`` a 64 MB buffer is read before
    each timed call, so the call finds its inputs outside the 50 MB L2 cache, as the
    serving path does. (Overwriting the buffer instead leaves up to 50 MB of dirty
    lines that the timed call pays to write back: 10 us at MaxSim's default shape.)"""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda") if cold_l2 else None
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush.sum(dtype=torch.int64)
        if run_ahead:
            torch.cuda._sleep(1_000_000)  # device clocks
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound(bytes_: float, ops: float, peak: float = BF16_FLOPS):
    """Least ms for the work: bytes at the memory rate against ``ops`` at ``peak``."""
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def near_ties_only(ids_a: torch.Tensor, ids_b: torch.Tensor, s_ref: torch.Tensor, atol: float) -> int:
    """Number of slots where two [B, k] id lists differ. Each such slot's score in
    ``s_ref`` must lie within ``atol`` of a neighbour's, else the script fails."""
    diff = ids_a != ids_b
    if bool(diff.any()):
        inf = torch.full_like(s_ref[:, :1], float("inf"))
        step = (s_ref[:, 1:] - s_ref[:, :-1]).abs()
        gap = torch.minimum(torch.cat([inf, step], 1), torch.cat([step, inf], 1))
        if not bool((gap[diff] <= atol).all()):
            return -1
    return int(diff.sum())


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Max |a - b| over finite entries; -inf entries must agree exactly."""
    if not torch.equal(torch.isinf(a), torch.isinf(b)):
        return float("inf")
    fin = torch.isfinite(a)
    return float((a[fin] - b[fin]).abs().max()) if bool(fin.any()) else 0.0


# ---------------------------------------------------------------- phase 2


class DenseInputs:
    """Rows, queries and masks of the dense-channel checks, at the serving shape."""

    def __init__(self, dev, gen):
        n = self.n = N_PAD
        emb = torch.randn((n, DIM), generator=gen, device=dev)
        self.emb = (emb / emb.norm(dim=1, keepdim=True)).to(torch.bfloat16)
        q = torch.randn((BATCH, DIM), generator=gen, device=dev)
        self.q = q / q.norm(dim=1, keepdim=True)
        self.valid = torch.rand(n, generator=gen, device=dev) > 0.01
        self.coll = torch.randint(0, 3, (n,), generator=gen, device=dev, dtype=torch.int32)
        self.cid = torch.tensor([-1, 0, 1, 2, -2], dtype=torch.int32, device=dev).repeat(
            BATCH // 5 + 1)[:BATCH]

    def row_mask(self, scoped: bool) -> torch.Tensor:
        if not scoped:
            return self.valid[None, :]
        k = self.cid[:, None]
        return self.valid[None, :] & ((k == -1) | (self.coll[None, :] == k))


def check_fused(data):
    from triple_hybrid_rag_tpu_torch.index.dense_index import dense_scores_batch
    from triple_hybrid_rag_tpu_torch.ops import fused_topk as ft
    from triple_hybrid_rag_tpu_torch.ops.topk import bucketed_masked_top_k_batch

    def bucketed_topk(m):  # the use_fused_topk=False path: bf16 GEMM, f32 out
        return bucketed_masked_top_k_batch(dense_scores_batch(emb, q), 100, valid=m,
                                           invalid_score_floor=-2.0)

    n, emb, q, valid, coll, cid = data.n, data.emb, data.q, data.valid, data.coll, data.cid

    err = 0.0
    for scoped in (False, True):
        c, k = (coll, cid) if scoped else (None, None)
        got = ft.bucket_maxima(emb, q, valid, c, k)
        want = ft.bucket_maxima_plain(emb, q, valid, c, k)
        torch.cuda.synchronize()
        e = max_err(got, want)
        log(f"fused_bucket_maxima {'scoped' if scoped else 'unscoped'}: max |kernel - plain| = {e:.3g}")
        if not e <= FUSED_ATOL:
            fail(f"fused_bucket_maxima disagrees with its plain version ({e})")
        err = max(err, e)
        # ids of the fused top-k vs the bucketed matmul path, up to near ties
        ids_k, _ = ft.fused_dense_topk(emb, valid, q, 100, c, k)
        ids_p, s_p = bucketed_topk(data.row_mask(scoped))
        n_diff = near_ties_only(ids_k, ids_p, s_p, FUSED_ATOL)
        if n_diff < 0:
            fail("fused_dense_topk ids differ from the bucketed matmul path beyond near ties")
        log(f"fused_dense_topk ids vs bucketed matmul path: {n_diff} of {ids_k.numel()} "
            f"slots differ, all at near ties (atol {FUSED_ATOL})")

    ms = time_ms(lambda: ft.bucket_maxima(emb, q, valid))
    plain_ms = time_ms(lambda: ft.bucket_maxima_plain(emb, q, valid), iters=3, warmup=1)
    matmul_ms = time_ms(lambda: dense_scores_batch(emb, q))
    nb = -(-n // 16)
    b_ms, b_by = bound(n * DIM * 2 + BATCH * DIM * 4 + n + BATCH * nb * 4, 2.0 * BATCH * n * DIM)
    log(f"fused_bucket_maxima N={n} D={DIM} B={BATCH}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bf16 GEMM with f32 out alone {matmul_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    # the whole dense channel (top-100) both ways: the use_fused_topk decision
    topk_ms = time_ms(lambda: ft.fused_dense_topk(emb, valid, q, 100))
    bucketed_ms = time_ms(lambda: bucketed_topk(valid[None, :]))
    log(f"dense top-100 N={n} B={BATCH}: fused kernel path {topk_ms:.4f} ms, "
        f"bucketed GEMM path {bucketed_ms:.4f} ms")
    return {
        "name": "fused_bucket_maxima", "route": "cuda",
        "source": "triple_hybrid_rag_tpu_torch/csrc/fused_topk.cu",
        "replaces": "triple_hybrid_rag_tpu/ops/pallas/fused_topk.py:252",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": None, "matmul_ms": matmul_ms,
        "topk_ms": topk_ms, "bucketed_topk_ms": bucketed_ms,
    }


def check_int(data, kind: str):
    """The int8 or packed-int4 bucket maxima: the kernel must equal its plain version
    bit for bit (exact int32 sums, the same two multiplies in the same order)."""
    from triple_hybrid_rag_tpu_torch.index import dense_index as di
    from triple_hybrid_rag_tpu_torch.ops import fused_topk as ft
    from triple_hybrid_rag_tpu_torch.ops.topk import bucketed_masked_top_k_batch

    n, q, valid = data.n, data.q, data.valid
    quantize = di.quantize_rows_int8 if kind == "int8" else di.quantize_rows_int4
    rows, scales = quantize(data.emb)
    q_i8, q_scale = di.quantize_queries_int8(q)

    def unfused_topk(scoped):  # the use_fused_topk=False path of this row type
        if kind == "int4":
            c, k = (data.coll, data.cid) if scoped else (None, None)
            return di.int4_topk_blocked(rows, scales, valid, q, 100, c, k)
        return bucketed_masked_top_k_batch(
            di.dense_scores_int8_batch(rows, scales, q), 100, valid=data.row_mask(scoped),
            invalid_score_floor=-2.0)

    name = f"fused_bucket_maxima_{kind}"
    for scoped in (False, True):
        c, k = (data.coll, data.cid) if scoped else (None, None)
        got = ft.bucket_maxima(rows, q_i8, valid, c, k, scales, q_scale)
        want = ft.bucket_maxima_plain(rows, q_i8, valid, c, k, scales, q_scale)
        torch.cuda.synchronize()
        e = max_err(got, want)
        log(f"{name} {'scoped' if scoped else 'unscoped'}: max |kernel - plain| = {e:.3g}")
        if e != 0.0:
            fail(f"{name} differs from its plain version ({e}); it must be bit-equal")
        del got, want
        ids_k, s_k = ft.fused_dense_topk(rows, valid, q, 100, c, k, scales=scales)
        ids_p, s_p = unfused_topk(scoped)
        if not (torch.equal(ids_k, ids_p) and torch.equal(s_k, s_p)):
            fail(f"fused_dense_topk ({kind} rows) differs from the unfused path")
        log(f"fused_dense_topk ({kind} rows) ids and scores equal the unfused path "
            f"({ids_k.numel()} slots)")

    ms = time_ms(lambda: ft.bucket_maxima(rows, q_i8, valid, None, None, scales, q_scale))
    launch_ms = time_ms(lambda: ft.bucket_maxima(rows, q_i8, valid, None, None, scales, q_scale),
                        run_ahead=False)
    plain_ms = time_ms(
        lambda: ft.bucket_maxima_plain(rows, q_i8, valid, None, None, scales, q_scale),
        iters=3, warmup=1)
    # the library's int8 GEMM alone (no unpack, no dequantization, no mask, no max):
    # for int4 rows over the unpacked int8 codes, twice the bytes the kernel reads
    codes = rows if kind == "int8" else torch.cat(di.unpack_int4(rows), 1)
    matmul_ms = time_ms(lambda: torch._int_mm(q_i8, codes.T))
    del codes
    nb = -(-n // 16)
    b_ms, b_by = bound(rows.numel() + n * 4 + BATCH * (DIM + 4) + n + BATCH * nb * 4,
                       2.0 * BATCH * n * DIM, INT8_OPS)
    ops_ms = 2.0 * BATCH * n * DIM / INT8_OPS * 1e3
    log(f"{name} N={n} D={DIM} B={BATCH}: kernel {ms:.4f} ms ({launch_ms:.4f} ms when the device "
        f"waits for the host to launch each call), plain {plain_ms:.4f} ms, int8 GEMM "
        f"(torch._int_mm) alone {matmul_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; operations alone "
        f"{ops_ms:.4f} ms)")
    topk_ms = time_ms(lambda: ft.fused_dense_topk(rows, valid, q, 100, scales=scales))
    unfused_ms = time_ms(lambda: unfused_topk(False), iters=5)
    log(f"dense top-100 ({kind} rows) N={n} B={BATCH}: fused kernel path {topk_ms:.4f} ms, "
        f"unfused path {unfused_ms:.4f} ms")
    del rows, scales
    torch.cuda.empty_cache()
    return {
        "name": name, "route": "cuda",
        "source": "triple_hybrid_rag_tpu_torch/csrc/fused_topk.cu",
        "replaces": "triple_hybrid_rag_tpu/ops/pallas/fused_topk.py:"
                    + ("89" if kind == "int8" else "132"),
        "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": None, "matmul_ms": matmul_ms,
        "topk_ms": topk_ms, "unfused_topk_ms": unfused_ms, "host_launched_ms": launch_ms,
    }


def bucket_maxima_edge_sweep(dev, gen):
    """The int8 and packed-int4 bucket maxima against their plain versions at
    INT_EDGE_SHAPES, unscoped and scoped (collection ids -1, 0, 1, 2 and -2, which
    matches nothing), and once with every row invalid. All must be bit-equal."""
    from triple_hybrid_rag_tpu_torch.index import dense_index as di
    from triple_hybrid_rag_tpu_torch.ops import fused_topk as ft

    cases = 0
    for kind, quantize in (("int8", di.quantize_rows_int8), ("int4", di.quantize_rows_int4)):
        for n, d, b in INT_EDGE_SHAPES:
            rows, scales = quantize(torch.randn((n, d), generator=gen, device=dev))
            q_i8, q_scale = di.quantize_queries_int8(torch.randn((b, d), generator=gen, device=dev))
            valid = torch.rand(n, generator=gen, device=dev) > 0.1
            coll = torch.randint(0, 3, (n,), generator=gen, device=dev, dtype=torch.int32)
            cid = torch.tensor([-1, 0, 1, 2, -2], dtype=torch.int32, device=dev).repeat(b // 5 + 1)[:b]
            masks = [(valid, None, None), (valid, coll, cid)]
            if (n, d, b) == INT_EDGE_SHAPES[4]:
                masks.append((torch.zeros_like(valid), coll, cid))
            for v, c, k in masks:
                got = ft.bucket_maxima(rows, q_i8, v, c, k, scales, q_scale)
                torch.cuda.synchronize()
                want = ft.bucket_maxima_plain(rows, q_i8, v, c, k, scales, q_scale)
                e = max_err(got, want)
                if got.shape != (b, -(-n // 16)) or e != 0.0:
                    fail(f"fused_bucket_maxima_{kind} N={n} D={d} B={b} "
                         f"{'scoped' if c is not None else 'unscoped'}"
                         f"{'' if bool(v.any()) else ', all rows invalid'} differs from its plain "
                         f"version ({e}); it must be bit-equal")
                if not bool(v.any()) and not bool(torch.isinf(got).all()):
                    fail(f"fused_bucket_maxima_{kind}: invalid rows must give -inf")
                cases += 1
    log(f"fused_bucket_maxima int8 / int4 edge sweep: {len(INT_EDGE_SHAPES)} shapes (N, D, B) "
        f"{INT_EDGE_SHAPES}, unscoped, scoped and all rows invalid: {cases} cases equal the plain "
        f"version bit for bit")


def check_dense(data):
    from triple_hybrid_rag_tpu_torch.ops import dense_kernel as dk

    n, emb, q = data.n, data.emb, data.q
    gen = torch.Generator(device=emb.device).manual_seed(77)
    worst = 0.0
    for en, ed, eb in DENSE_EDGE_SHAPES:
        e_rows = torch.randn((en, ed), generator=gen, device=emb.device)
        e_rows = (e_rows / e_rows.norm(dim=1, keepdim=True)).to(torch.bfloat16)
        e_q = torch.randn((eb, ed), generator=gen, device=emb.device)
        e_q = e_q / e_q.norm(dim=1, keepdim=True)
        got = dk.dense_scores(e_rows, e_q)
        torch.cuda.synchronize()
        e = max_err(got, dk.dense_scores_plain(e_rows, e_q))
        if got.shape != (eb, en) or not e <= FUSED_ATOL:
            fail(f"dense_scores N={en} D={ed} B={eb} disagrees with its plain version ({e})")
        worst = max(worst, e)
    log(f"dense_scores edge sweep: {len(DENSE_EDGE_SHAPES)} shapes (N, D, B) {DENSE_EDGE_SHAPES} "
        f"agree with the plain version within {FUSED_ATOL} (worst {worst:.3g})")
    # the kernel sums in wgmma's order, the plain version in the library GEMM's:
    # equal to rounding on unit rows (FUSED_ATOL), not bit for bit
    got = dk.dense_scores(emb, q)
    want = dk.dense_scores_plain(emb, q)
    torch.cuda.synchronize()
    err = max_err(got, want)
    log(f"dense_scores: max |kernel - plain| = {err:.3g}")
    if not err <= FUSED_ATOL:
        fail(f"dense_scores disagrees with its plain version ({err})")
    del got, want
    ms = time_ms(lambda: dk.dense_scores(emb, q))
    plain_ms = time_ms(lambda: dk.dense_scores_plain(emb, q))
    q16 = q.to(torch.bfloat16)
    library_ms = time_ms(lambda: torch.mm(q16, emb.T, out_dtype=torch.float32))
    b_ms, b_by = bound(n * DIM * 2 + BATCH * DIM * 4 + BATCH * n * 4, 2.0 * BATCH * n * DIM)
    log(f"dense_scores N={n} D={DIM} B={BATCH}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bf16 GEMM with f32 out (torch.mm) {library_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    # B = 1, the staged semantic channel's shape (phase 7): one query in the
    # kernel's 128-query tile
    q1 = q[:1]
    got = dk.dense_scores(emb, q1)
    want = dk.dense_scores_plain(emb, q1)
    torch.cuda.synchronize()
    err1 = max_err(got, want)
    if got.shape != (1, n) or not err1 <= FUSED_ATOL:
        fail(f"dense_scores at B=1 disagrees with its plain version ({err1})")
    del got, want
    b1_ms = time_ms(lambda: dk.dense_scores(emb, q1))
    b1_plain = time_ms(lambda: dk.dense_scores_plain(emb, q1))
    b1_library = time_ms(lambda: torch.mm(q16[:1], emb.T, out_dtype=torch.float32))
    b1_bound, b1_by = bound(n * DIM * 2 + DIM * 4 + n * 4, 2.0 * n * DIM)
    log(f"dense_scores N={n} D={DIM} B=1: kernel {b1_ms:.4f} ms, plain {b1_plain:.4f} ms, "
        f"torch.mm with f32 out {b1_library:.4f} ms, bound {b1_bound:.4f} ms ({b1_by}, "
        f"{b1_bound / b1_ms:.3f} of it); max |kernel - plain| = {err1:.3g}")
    return {
        "name": "dense_scores", "route": "cuda",
        "source": "triple_hybrid_rag_tpu_torch/csrc/dense_scores.cu",
        "replaces": "triple_hybrid_rag_tpu/ops/pallas/dense_kernel.py:47",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": library_ms,
        "b1_ms": b1_ms, "b1_plain_ms": b1_plain, "b1_library_ms": b1_library,
        "b1_bound_ms": b1_bound, "b1_bound_by": b1_by, "b1_max_abs_err": err1,
    }


def termtable_edge_sweep(dev, gen):
    """The term-table kernel against its plain version at TERM_EDGE_SHAPES, with
    f32 and bf16 weights. Every case holds a table id of -1, a term repeated inside
    a query, one term held by every query and a query of only pads; the vocabulary
    grows with the table width so that a score stays a sum of about ten weights."""
    from triple_hybrid_rag_tpu_torch.ops import bm25

    worst = 0.0
    for n, width, b, q in TERM_EDGE_SHAPES:
        vocab = max(50, 4 * width)
        ids = torch.randint(0, vocab, (n, width), generator=gen, device=dev, dtype=torch.int32)
        ids[:, width // 2 + 1:] = bm25.DOC_PAD
        ids[::7, 0] = bm25.QUERY_PAD
        w = torch.rand((n, width), generator=gen, device=dev)
        queries = torch.randint(0, vocab, (b, q), generator=gen, device=dev, dtype=torch.int32)
        queries[:, q // 2 + 1:] = bm25.QUERY_PAD
        queries[:, 0] = 7  # one term in every query
        if q > 1:
            queries[0, 1] = queries[0, 0]  # a repeated term counts once
        if b > 1:
            queries[1] = bm25.QUERY_PAD  # a query of only pads
        for weights in (w, w.to(torch.bfloat16)):
            got = bm25.score_termtable_batch(ids, weights, queries)
            torch.cuda.synchronize()
            want = bm25.score_termtable_batch_plain(ids, weights, queries)
            e = max_err(got, want)
            if got.shape != (b, n) or not e <= TERM_ATOL or not bool((want > 0).any()):
                fail(f"termtable_scores N={n} L={width} B={b} Q={q} {weights.dtype} disagrees "
                     f"with its plain version ({e})")
            worst = max(worst, e)
    log(f"termtable_scores edge sweep: {len(TERM_EDGE_SHAPES)} shapes (N, L, B, Q) {TERM_EDGE_SHAPES} "
        f"with f32 and bf16 weights agree with the plain version within {TERM_ATOL} (worst {worst:.3g})")


def check_termtable(dev, gen):
    from triple_hybrid_rag_tpu_torch.ops import bm25

    termtable_edge_sweep(dev, gen)
    n, live_slots, live_terms, vocab = N_PAD, 64, 8, 4096
    ids = torch.randint(0, vocab, (n, TABLE_WIDTH), generator=gen, device=dev, dtype=torch.int32)
    ids[:, live_slots:] = bm25.DOC_PAD  # half of each row is empty, as in the synthetic corpus
    ids[::1001, 3] = bm25.QUERY_PAD  # rows padded with -1 match a query's empty slots
    w = torch.rand((n, TABLE_WIDTH), generator=gen, device=dev)
    queries = torch.randint(0, vocab, (BATCH, QUERY_TERMS), generator=gen, device=dev,
                            dtype=torch.int32)
    queries[:, live_terms:] = bm25.QUERY_PAD
    queries[1] = bm25.QUERY_PAD  # an empty query
    queries[2, 2] = bm25.QUERY_PAD  # a pad between live terms
    queries[3] = torch.randint(0, vocab, (QUERY_TERMS,), generator=gen, device=dev)  # no pad

    got = bm25.score_termtable_batch(ids, w, queries)
    torch.cuda.synchronize()
    want = bm25.score_termtable_batch_plain(ids, w, queries)
    err = max_err(got, want)
    log(f"termtable_scores: max |kernel - plain| = {err:.3g} "
        f"({int((want > 0).sum())} of {want.numel()} scores non-zero)")
    if not err <= TERM_ATOL or not bool((want > 0).any()):
        fail(f"termtable_scores disagrees with its plain version ({err})")
    del got, want
    wb = w[:65536].to(torch.bfloat16)
    e = max_err(bm25.score_termtable_batch(ids[:65536], wb, queries),
                bm25.score_termtable_batch_plain(ids[:65536], wb, queries))
    log(f"termtable_scores bf16 weights (N=65536): max |kernel - plain| = {e:.3g}")
    if not e <= TERM_ATOL:
        fail(f"termtable_scores (bf16 weights) disagrees with its plain version ({e})")
    ms = time_ms(lambda: bm25.score_termtable_batch(ids, w, queries), iters=5, warmup=1)
    plain_ms = time_ms(lambda: bm25.score_termtable_batch_plain(ids, w, queries), iters=1, warmup=0)
    # one membership test and one add per (row, live slot, query), at the f32 ALU rate
    b_ms, b_by = bound(n * TABLE_WIDTH * 8 + BATCH * QUERY_TERMS * 4 + BATCH * n * 4,
                       2.0 * n * live_slots * BATCH, F32_FLOPS)
    # a yardstick for the byte bound, not a library call for the function: a device
    # copy that moves as many bytes as the kernel must (half read, half written)
    moved = n * TABLE_WIDTH * 8 + BATCH * n * 4
    src = torch.empty(moved // 2, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    copy_ms = time_ms(lambda: dst.copy_(src))
    del src, dst
    # the kernel probes its membership table once per live slot; a hit is a slot
    # whose term some query of the block holds
    live = ids != bm25.DOC_PAD
    probes = int(live.sum())
    hits = int((torch.isin(ids, queries.unique()) & live).sum())
    log(f"termtable_scores N={n} L={TABLE_WIDTH} ({live_slots} live) Q={QUERY_TERMS} ({live_terms} "
        f"live) B={BATCH}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by}), a device copy of the same {moved / 1e9:.2f} GB {copy_ms:.4f} ms; the kernel "
        f"makes {probes:.3g} probes ({probes / ms / 1e6:.1f} G/s), {hits:.3g} of them hits "
        f"({hits / n:.1f} a row)")
    del live, ids, w
    torch.cuda.empty_cache()
    return {
        "name": "termtable_scores", "route": "cuda",
        "source": "triple_hybrid_rag_tpu_torch/csrc/termtable.cu",
        "replaces": "triple_hybrid_rag_tpu/ops/pallas/lexical_kernel.py:55",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": None, "copy_ms": copy_ms,
    }


def maxsim_inputs(dev, gen, b, k, p_rows, td, d, tq):
    """Unit bf16 tokens with random mask holes, parents with no token, f16-wire
    queries with zero and fractional weights; candidate parents at random, with
    invalid ones (-1) and one past the store (clamped to its last row)."""
    tokens = torch.randn((p_rows, td, d), generator=gen, device=dev)
    tokens = (tokens / tokens.norm(dim=-1, keepdim=True)).to(torch.bfloat16)
    tok_mask = torch.rand((p_rows, td), generator=gen, device=dev) > 0.2
    tok_mask[::97] = False  # parents without any token score 0
    parent = torch.randint(0, p_rows, (b, k), generator=gen, device=dev)
    flat = parent.view(-1)
    flat[0] = p_rows + 3  # past the store
    if flat.numel() > 2:
        flat[1] = 0  # parent 0 has no token
    if k // 10:
        parent[:, -(k // 10):] = -1  # invalid candidates
    elif flat.numel() > 2:
        flat[2] = -1
    q = torch.randn((b, tq, d), generator=gen, device=dev)
    q = (q / q.norm(dim=-1, keepdim=True)).half().float()  # the f16 query wire
    w = torch.ones((b, tq), device=dev)
    w[:, tq * 5 // 8:tq * 3 // 4] = 0.25
    w[:, tq * 3 // 4:] = 0.0
    return tokens, tok_mask, parent, q, w


def maxsim_edge_sweep(dev, gen):
    """Both MaxSim bodies against the plain version at MAXSIM_EDGE_SHAPES, and once
    with every candidate invalid, within MAXSIM_ATOL."""
    from triple_hybrid_rag_tpu_torch.ops import maxsim as mx

    worst, cases = 0.0, 0
    for i, (b, k, p_rows, td, d, tq) in enumerate(MAXSIM_EDGE_SHAPES):
        tokens, tok_mask, parent, q, w = maxsim_inputs(dev, gen, b, k, p_rows, td, d, tq)
        if i == 0:
            parent[:] = -1  # all candidates invalid
        for store in (tokens, mx.quantize_tokens(tokens)):
            got = mx.maxsim_scores(store, tok_mask, parent, q, w)
            torch.cuda.synchronize()
            e = max_err(got, mx.maxsim_scores_plain(store, tok_mask, parent, q, w))
            if got.shape != (b, k) or not e <= MAXSIM_ATOL:
                fail(f"maxsim_scores {store.dtype} B={b} K={k} P={p_rows} Td={td} D={d} Tq={tq} "
                     f"disagrees with its plain version ({e})")
            if i == 0 and bool((got != 0).any()):
                fail("maxsim_scores: invalid candidates must score 0")
            worst, cases = max(worst, e), cases + 1
    log(f"maxsim_scores edge sweep: {len(MAXSIM_EDGE_SHAPES)} shapes (B, K, P, Td, D, Tq) "
        f"{MAXSIM_EDGE_SHAPES}, bf16 and int8 stores, one with every candidate invalid: {cases} "
        f"cases agree with the plain version within {MAXSIM_ATOL} (worst {worst:.3g})")


def check_maxsim(dev, gen):
    """Both bodies (bf16 and int8 token stores) at the smoke shape and at the
    default RAGConfig shape, 1M chunks' parents, cold L2. Returns one kernels-line
    entry per body; the smoke shape's numbers are its main ones."""
    from triple_hybrid_rag_tpu_torch.ops import maxsim as mx

    maxsim_edge_sweep(dev, gen)
    entries = {body: {
        "name": "maxsim_scores" if body == "bf16" else "maxsim_scores_int8", "route": "cuda",
        "source": "triple_hybrid_rag_tpu_torch/csrc/maxsim.cu",
        "replaces": "triple_hybrid_rag_tpu/ops/pallas/maxsim_kernel.py:67", "library_ms": None,
        "max_abs_err": 0.0} for body in ("bf16", "int8")}
    for label, (td, d, tq) in MAXSIM_SHAPES.items():
        tokens, tok_mask, parent, q, w = maxsim_inputs(dev, gen, BATCH, RERANK_K, N_PARENTS, td, d, tq)
        ok = parent >= 0
        n_valid = int(ok.sum())
        live_tokens = int(tok_mask[parent.clamp(0, N_PARENTS - 1)][ok].sum())
        for store in (tokens, mx.quantize_tokens(tokens)):
            body = "int8" if store.dtype == torch.int8 else "bf16"
            got = mx.maxsim_scores(store, tok_mask, parent, q, w)
            want = mx.maxsim_scores_plain(store, tok_mask, parent, q, w)
            torch.cuda.synchronize()
            err = max_err(got, want)
            if not err <= MAXSIM_ATOL:
                fail(f"maxsim_scores ({body} tokens, {label} shape) disagrees with its plain "
                     f"version ({err})")
            ms = time_ms(lambda: mx.maxsim_scores(store, tok_mask, parent, q, w), iters=50,
                         cold_l2=True)
            plain_ms = time_ms(lambda: mx.maxsim_scores_plain(store, tok_mask, parent, q, w),
                               iters=20, cold_l2=True)
            # each valid candidate's token block and mask once, the candidates' ids and
            # scores, the queries and weights; one product per live doc token and query token
            b_ms, b_by = bound(
                n_valid * td * (d * store.element_size() + 1) + BATCH * RERANK_K * (8 + 4)
                + BATCH * tq * (d + 1) * 4,
                2.0 * live_tokens * tq * d,
            )
            log(f"maxsim_scores {body} tokens, {label} shape B={BATCH} K={RERANK_K} Td={td} D={d} "
                f"Tq={tq}: max |kernel - plain| = {err:.3g}; kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
            e = entries[body]
            e["max_abs_err"] = max(e["max_abs_err"], err)
            keys = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
            e.update(keys if label == "smoke" else {f"{key}_{label}": v for key, v in keys.items()})
            del store, got, want
        del tokens, tok_mask
        torch.cuda.empty_cache()
    return list(entries.values())


def unit_rows(n: int, d: int, gen, dev, dtype=torch.float32) -> torch.Tensor:
    """Random unit rows with full f32 mantissas (then cast to ``dtype``)."""
    x = torch.randn((n, d), generator=gen, device=dev)
    return (x / x.norm(dim=1, keepdim=True)).to(dtype)


def f32_edge_sweep(dev, gen):
    """Both f32-row bodies against their plain versions at F32_EDGE_SHAPES (the
    bucket maxima unscoped and scoped, and once with every row invalid)."""
    from triple_hybrid_rag_tpu_torch.ops import dense_kernel as dk
    from triple_hybrid_rag_tpu_torch.ops import fused_topk as ft

    worst, cases = 0.0, 0
    for n, d, b in F32_EDGE_SHAPES:
        rows, q = unit_rows(n, d, gen, dev), unit_rows(b, d, gen, dev)
        valid = torch.rand(n, generator=gen, device=dev) > 0.1
        coll = torch.randint(0, 3, (n,), generator=gen, device=dev, dtype=torch.int32)
        cid = torch.tensor([-1, 0, 1, 2, -2], dtype=torch.int32, device=dev).repeat(b // 5 + 1)[:b]
        masks = [(valid, None, None), (valid, coll, cid)]
        if (n, d, b) == F32_EDGE_SHAPES[3]:
            masks.append((torch.zeros_like(valid), coll, cid))
        for v, c, k in masks:
            got = ft.bucket_maxima(rows, q, v, c, k)
            torch.cuda.synchronize()
            e = max_err(got, ft.bucket_maxima_plain(rows, q, v, c, k))
            if got.shape != (b, -(-n // 16)) or not e <= F32_ATOL:
                fail(f"fused_bucket_maxima f32 rows N={n} D={d} B={b} "
                     f"{'scoped' if c is not None else 'unscoped'} disagrees with its plain "
                     f"version ({e})")
            if not bool(v.any()) and not bool(torch.isinf(got).all()):
                fail("fused_bucket_maxima f32 rows: invalid rows must give -inf")
            worst, cases = max(worst, e), cases + 1
        got = dk.dense_scores(rows, q)
        torch.cuda.synchronize()
        e = max_err(got, dk.dense_scores_plain(rows, q))
        if got.shape != (b, n) or not e <= F32_ATOL:
            fail(f"dense_scores f32 rows N={n} D={d} B={b} disagrees with its plain version ({e})")
        worst, cases = max(worst, e), cases + 1
    log(f"f32-row edge sweep: {len(F32_EDGE_SHAPES)} shapes (N, D, B) {F32_EDGE_SHAPES}, bucket "
        f"maxima unscoped, scoped and all rows invalid, and dense scores: {cases} cases agree "
        f"with the plain versions within {F32_ATOL} (worst {worst:.3g})")


def check_f32(data, dev, gen):
    """The f32-row bodies of the bucket maxima and of the dense scores on random f32
    unit rows at N = 1,000,448: held against their plain versions, timed at
    B = 128 (with the plain version and, for the dense scores, f32 ``torch.mm``) and
    at B = 1 (the 16-query tile) against their bounds. The rows are freed at once."""
    from triple_hybrid_rag_tpu_torch.ops import dense_kernel as dk
    from triple_hybrid_rag_tpu_torch.ops import fused_topk as ft

    f32_edge_sweep(dev, gen)
    n, q, valid = data.n, data.q, data.valid
    e32 = unit_rows(n, DIM, gen, dev)
    nb = -(-n // 16)
    out = {}
    for scoped in (False, True):
        c, k = (data.coll, data.cid) if scoped else (None, None)
        got = ft.bucket_maxima(e32, q, valid, c, k)
        torch.cuda.synchronize()
        e = max_err(got, ft.bucket_maxima_plain(e32, q, valid, c, k))
        log(f"fused_bucket_maxima f32 rows {'scoped' if scoped else 'unscoped'} N={n}: "
            f"max |kernel - plain| = {e:.3g}")
        if not e <= F32_ATOL:
            fail(f"fused_bucket_maxima (f32 rows) disagrees with its plain version ({e})")
        out["fused_bucket_maxima"] = max(out.get("fused_bucket_maxima", 0.0), e)
        del got
    got = dk.dense_scores(e32, q)
    torch.cuda.synchronize()
    e = max_err(got, dk.dense_scores_plain(e32, q))
    log(f"dense_scores f32 rows N={n}: max |kernel - plain| = {e:.3g}")
    if not e <= F32_ATOL:
        fail(f"dense_scores (f32 rows) disagrees with its plain version ({e})")
    out["dense_scores"] = e
    del got
    torch.cuda.empty_cache()

    entries = {}
    q1 = q[:1]
    for name, fn, plain, library, out_bytes in (
        ("fused_bucket_maxima", lambda x: ft.bucket_maxima(e32, x, valid),
         lambda x: ft.bucket_maxima_plain(e32, x, valid), None, lambda b: n + b * nb * 4),
        ("dense_scores", lambda x: dk.dense_scores(e32, x), lambda x: dk.dense_scores_plain(e32, x),
         lambda x: torch.mm(x, e32.T), lambda b: b * n * 4),
    ):
        ms = time_ms(lambda: fn(q), iters=5, warmup=1)
        plain_ms = time_ms(lambda: plain(q), iters=3, warmup=1)
        library_ms = time_ms(lambda: library(q), iters=5, warmup=1) if library else None
        b1_ms = time_ms(lambda: fn(q1), iters=5, warmup=1)
        moved = n * DIM * 4 + BATCH * DIM * 4 + out_bytes(BATCH)
        b_ms, b_by = bound(moved, 2.0 * BATCH * n * DIM, F32_FLOPS)
        b1_bound, b1_by = bound(n * DIM * 4 + DIM * 4 + out_bytes(1), 2.0 * n * DIM, F32_FLOPS)
        lib = f", f32 torch.mm {library_ms:.4f} ms" if library else ""
        log(f"{name} f32 rows N={n} D={DIM} B={BATCH}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
            f"{lib}, bound {b_ms:.4f} ms ({b_by}; bytes alone {moved / HBM_BYTES_PER_S * 1e3:.4f} ms,"
            f" {b_ms / ms:.3f} of the bound); B=1: kernel {b1_ms:.4f} ms, bound {b1_bound:.4f} ms "
            f"({b1_by}, {b1_bound / b1_ms:.3f} of it)")
        entries[name] = {"f32_rows_ms": ms, "f32_rows_plain_ms": plain_ms,
                         "f32_rows_library_ms": library_ms, "f32_rows_bound_ms": b_ms,
                         "f32_rows_bound_by": b_by, "f32_rows_b1_ms": b1_ms,
                         "f32_rows_b1_bound_ms": b1_bound, "f32_rows_max_abs_err": out[name]}
    del e32
    torch.cuda.empty_cache()
    return entries


# ---------------------------------------------------------------- phase 3


def main_path(dev, card):
    from triple_hybrid_rag_tpu_torch.config import RAGConfig
    from triple_hybrid_rag_tpu_torch.engine import Engine
    from triple_hybrid_rag_tpu_torch.ops.fused_topk import bucket_maxima
    from triple_hybrid_rag_tpu_torch.synthetic import build_synthetic, make_query_texts

    cfg = RAGConfig(
        capacity_round=1024, embedding_dim=DIM, embedding_dim_full=DIM,
        embedding_dtype="bfloat16", use_fused_topk=None,
        maxsim_doc_tokens=MAXSIM_TOKENS, maxsim_dim=MAXSIM_DIM,
        maxsim_query_tokens=QUERY_TOKENS, safety_threshold=0.0, graph_enabled=True,
        graph_max_entities_per_chunk=4, lexical_backend="sorted", bm25_df_cap=DF_CAP,
        embedder_backend="bowhash",
    )
    t0 = t_phase = time.time()
    syn = build_synthetic(cfg, N_ROWS, DIM, N_ENTITIES, seed=0, device=dev)
    torch.cuda.synchronize()
    st = syn.state
    sizes = {k: round(v / 1e9, 3) for k, v in st.nbytes().items()}
    log(f"synthetic corpus: {N_ROWS} chunks ({st.n_pad} rows), built in {time.time() - t0:.1f} s; "
        f"device GB {sizes}; graph mode {st.graph_mode} (small-batch sparse {st.graph_small_sparse})")
    eng = Engine(st, embedder=syn.embedder, device=dev)
    if not eng.use_fused():
        fail("use_fused_topk=None must resolve to the kernel on CUDA")

    rng = np.random.default_rng(42)
    rows = rng.integers(0, N_ROWS // 5, size=6 * BATCH) * 5
    texts, is_graph = make_query_texts(rows, syn.term_ids, rng, GRAPH_FRAC, N_ENTITIES)
    eng.search_arrays(texts[:BATCH])  # warm-up (kernel libraries load)
    torch.cuda.synchronize()

    # ---- the main path: counts set to 0 just before, read just after ----
    bucket_maxima.launches_by_rows = dict.fromkeys(bucket_maxima.launches_by_rows, 0)
    maxsim_counts_reset()
    hits = n_plain = n_graph = 0
    for lo in range(0, 2 * BATCH, BATCH):
        plans, out = eng.search_arrays(texts[lo:lo + BATCH])
        ids = out[0].cpu().numpy()
        if not bool(torch.isfinite(out[1]).all()):
            fail("non-finite final scores")
        n_graph += sum(p.requires_graph for p in plans)
        for i in range(BATCH):
            if not is_graph[lo + i]:
                n_plain += 1
                hits += int(rows[lo + i] in ids[i].tolist())
    res = eng.retrieve_batch(texts[2 * BATCH:3 * BATCH])
    torch.cuda.synchronize()
    launches = {"fused_bucket_maxima": bucket_maxima.launches_by_rows["bf16"],
                "maxsim_scores": maxsim_body_launches("bf16", "bf16 rows", st)}
    frac = hits / max(n_plain, 1)
    log(f"self-retrieval: {hits}/{n_plain} plain queries have their row in the final "
        f"top-{cfg.final_top_k} ({frac:.4f}); {n_graph} of {2 * BATCH} queries used the graph")
    log(f"kernel launches on the main path: {launches}")
    if frac < 0.95:
        fail(f"self-retrieval {frac} < 0.95")
    if min(launches.values()) < 1:
        fail(f"a kernel of the main path was not launched: {launches}")
    decoded = sum(len(r.results) for r in res)
    if decoded == 0 or any(not np.isfinite(x.final_score) for r in res for x in r.results):
        fail("retrieve_batch decoded no results or non-finite scores")
    log(f"retrieve_batch: {decoded} results decoded for {BATCH} queries, "
        f"e.g. {res[0].results[0].chunk_id if res[0].results else None}")

    # ---- B = 1: graph-skip program (plain) and the sparse graph override ----
    one_hits = 0
    plain_idx = [i for i in range(len(texts)) if not is_graph[i]][:4]
    graph_idx = [i for i in range(len(texts)) if is_graph[i]][:4]
    for i in plain_idx + graph_idx:
        _, out = eng.search_arrays([texts[i]])
        ids = out[0].cpu().numpy()[0]
        one_hits += int(rows[i] in ids.tolist()) if not is_graph[i] else 0
    log(f"B=1: {one_hits}/{len(plain_idx)} plain queries self-retrieved; "
        f"{len(graph_idx)} graph queries took the sparse path")
    if one_hits < len(plain_idx) - 1:
        fail("B=1 self-retrieval")

    # ---- the bucketed matmul path (use_fused_topk=False) against the kernel path ----
    eng_x = Engine(st, config=cfg.replace(use_fused_topk=False), embedder=syn.embedder, device=dev)
    batch = texts[3 * BATCH:4 * BATCH]
    _, out_k = eng.search_arrays(batch)
    _, out_x = eng_x.search_arrays(batch)
    n_diff = near_ties_only(out_k[0], out_x[0], out_x[1], FUSED_ATOL)
    if n_diff < 0:
        fail("bucketed path and kernel path differ beyond near ties")
    log(f"use_fused_topk=False vs kernel path: {n_diff} of {out_k[0].numel()} final slots differ, "
        f"all at near ties (atol {FUSED_ATOL}); max final-score gap "
        f"{float((out_k[1] - out_x[1]).abs().max()):.3g}")

    # ---- timing ----
    batches = [texts[i * BATCH:(i + 1) * BATCH] for i in range(2, 6)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for tb in batches:
        eng.search_arrays(tb)[1][0].cpu()
    e2e = (time.perf_counter() - t0) / (len(batches) * BATCH) * 1e3
    args = [eng.prepare_queries(tb)[1] for tb in batches]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for a in args:
        eng.run(a)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / (len(batches) * BATCH) * 1e3
    t0 = time.perf_counter()
    for a in args:
        eng_x.run(a)
    torch.cuda.synchronize()
    wall_x_ms = (time.perf_counter() - t0) / (len(batches) * BATCH) * 1e3
    log(f"batched B={BATCH}: {e2e:.4f} ms/query with host prep; program wall ms/query (prepared "
        f"args, host dispatch included) {wall_ms:.4f} kernel dense path, {wall_x_ms:.4f} bucketed "
        f"matmul path; peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; card {card}")
    busy = stage_profile(eng, args, "kernel dense path")
    busy_x = stage_profile(eng_x, args, "bucketed matmul path")
    log(f"device busy ms/query (profiler): {busy / BATCH:.4f} kernel dense path, "
        f"{busy_x / BATCH:.4f} bucketed matmul path")
    del eng_x, args

    # ---- the further configurations, on the same corpus ----
    run = Drive(syn, texts, rows, is_graph, dev)
    launches["dense_scores"] = dense_kernel_path(run, eng)
    launches["f32_rows"] = dict(zip(("fused_bucket_maxima", "dense_scores"), f32_path(run, cfg)))
    launches["termtable_scores"] = termtable_path(run, eng, cfg)
    launches["maxsim_scores_int8"] = 0
    for kind in ("int8", "int4"):
        launches[f"fused_bucket_maxima_{kind}"], n_int8 = quantized_path(run, cfg, kind)
        launches["maxsim_scores_int8"] += n_int8
    log(f"phase 3 wall time {time.time() - t_phase:.1f} s")
    t_phase = time.time()
    launches["default_config"] = encoder_path(run, card)
    log(f"phase 4 wall time {time.time() - t_phase:.1f} s")
    t_phase = time.time()
    launches["ivf"] = ivf_path(run, eng, cfg, card)
    log(f"phase 5 wall time {time.time() - t_phase:.1f} s")
    log(f"peak device memory over phases 3-5 {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return launches, run


class Drive:
    """The synthetic corpus and its query texts, shared by the configurations."""

    def __init__(self, syn, texts, rows, is_graph, dev):
        self.syn, self.texts, self.rows, self.is_graph, self.dev = syn, texts, rows, is_graph, dev
        self.staged_states = {}  # configuration -> (state, config), kept for phase 7

    def engine(self, state, cfg):
        from triple_hybrid_rag_tpu_torch.engine import Engine

        return Engine(dataclasses.replace(state, config=cfg), embedder=self.syn.embedder,
                      device=self.dev)

    def self_retrieval(self, eng, label: str):
        """One B=128 batch and a few B=1 programs through ``search_arrays``; fails
        below 0.95. Returns the batch's device outputs."""
        texts, rows, is_graph = self.texts, self.rows, self.is_graph
        _, out = eng.search_arrays(texts[:BATCH])
        if not bool(torch.isfinite(out[1]).all()):
            fail(f"{label}: non-finite final scores")
        ids = out[0].cpu().numpy()
        plain = [i for i in range(BATCH) if not is_graph[i]]
        frac = sum(int(rows[i] in ids[i].tolist()) for i in plain) / len(plain)
        ones = [i for i in range(len(texts)) if not is_graph[i]][:3] + \
               [i for i in range(len(texts)) if is_graph[i]][:2]
        one_hits = 0
        for i in ones:
            one_ids = eng.search_arrays([texts[i]])[1][0].cpu().numpy()[0]
            one_hits += int(rows[i] in one_ids.tolist()) if not is_graph[i] else 0
        log(f"{label}: self-retrieval {frac:.4f} of {len(plain)} plain queries at B={BATCH}; "
            f"B=1: {one_hits}/3 plain self-retrieved, 2 graph queries ran")
        if frac < 0.95 or one_hits < 2:
            fail(f"{label}: self-retrieval {frac} at B={BATCH}, {one_hits}/3 at B=1")
        return out

    def timing(self, engines, label: str):
        """Program wall on prepared args and the device-busy split under the profiler,
        for each engine over the same two batches."""
        batches = [self.texts[i * BATCH:(i + 1) * BATCH] for i in range(2, 4)]
        walls, busy = [], []
        for name, eng in engines:
            args = [eng.prepare_queries(tb)[1] for tb in batches]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for a in args:
                eng.run(a)
            torch.cuda.synchronize()
            walls.append(f"{(time.perf_counter() - t0) / (len(args) * BATCH) * 1e3:.4f} {name}")
            busy.append(f"{stage_profile(eng, args, f'{label}, {name}') / BATCH:.4f} {name}")
        log(f"{label}: program wall ms/query (prepared args, host dispatch included) "
            + ", ".join(walls) + "; device busy ms/query (profiler) " + ", ".join(busy))


def dense_kernel_path(run, eng) -> int:
    """A dense channel through the dense-scores kernel: kernel scores -> bucketed
    top-k, its ids held against the engine's dense channel by the near-tie rule."""
    from triple_hybrid_rag_tpu_torch.ops.dense_kernel import dense_scores
    from triple_hybrid_rag_tpu_torch.ops.topk import bucketed_masked_top_k_batch

    st = eng.state
    args = eng.prepare_queries(run.texts[:BATCH])[1]
    dense_scores.launches = 0
    scores = dense_scores(st.embeddings, args.q_vec.float())
    ids, _ = bucketed_masked_top_k_batch(scores, eng.config.semantic_top_k, valid=st.valid[None, :],
                                         invalid_score_floor=-2.0)
    torch.cuda.synchronize()
    launches = dense_scores.launches
    ids_e, vals_e = eng._dense(args, None, False)
    n_diff = near_ties_only(ids, ids_e, vals_e, FUSED_ATOL)
    if n_diff < 0:
        fail("the dense-scores kernel's top-k differs from the engine's dense channel beyond near ties")
    plain = [i for i in range(BATCH) if not run.is_graph[i]]
    found = ids.cpu().numpy()
    hits = sum(int(run.rows[i] in found[i]) for i in plain)
    log(f"dense channel through dense_scores ({str(st.embeddings.dtype)[6:]} rows): {n_diff} of "
        f"{ids.numel()} slots differ from the "
        f"engine's dense channel, all at near ties (atol {FUSED_ATOL}); {hits}/{len(plain)} plain "
        f"queries have their row in the dense top-{ids.shape[1]}; launches {launches}")
    if launches < 1 or hits < 0.95 * len(plain):
        fail("dense-scores path: kernel not launched or rows not retrieved")
    return launches


def f32_path(run, cfg):
    """The float32 configuration on the same corpus: the documents' rows kept in
    f32 (synthetic.document_rows, unrounded, as the reference's dense index stores
    them), served by the f32 bucket maxima (use_fused_topk=None) and by the f32
    matmul and bucketed top-k (False); then a dense channel through the f32
    dense-scores body. Returns the launches of both f32 bodies on this path."""
    from triple_hybrid_rag_tpu_torch.ops.fused_topk import bucket_maxima
    from triple_hybrid_rag_tpu_torch.synthetic import document_rows

    st = run.syn.state
    t0 = time.time()
    rows = document_rows(torch.from_numpy(run.syn.term_ids).to(run.dev), run.syn.embedder,
                         torch.float32)
    torch.cuda.synchronize()
    if not torch.equal(rows.to(torch.bfloat16), st.embeddings):
        fail("the f32 rows do not round to the bf16 configuration's rows")
    st_f = dataclasses.replace(st, embeddings=rows)
    cfg_f = cfg.replace(embedding_dtype="float32")
    eng = run.engine(st_f, cfg_f)  # use_fused_topk=None: the kernel
    eng_x = run.engine(st_f, cfg_f.replace(use_fused_topk=False))
    log(f"f32 rows {tuple(rows.shape)} built on the card in {time.time() - t0:.1f} s; device GB "
        f"{round(st_f.nbytes()['embeddings'] / 1e9, 3)}")
    if not eng.use_fused() or eng_x.use_fused():
        fail("use_fused_topk=None must resolve to the kernel on CUDA, False to the unfused path")
    bucket_maxima.launches_by_rows = dict.fromkeys(bucket_maxima.launches_by_rows, 0)
    maxsim_counts_reset()
    out_k = run.self_retrieval(eng, "f32 rows, kernel path")
    torch.cuda.synchronize()
    by_rows = dict(bucket_maxima.launches_by_rows)
    maxsim_body_launches("bf16", "f32 rows, kernel path", st_f)
    log(f"f32 rows: kernel launches by row type {by_rows}")
    if by_rows["f32"] < 1 or sum(by_rows.values()) != by_rows["f32"]:
        fail(f"the f32 kernel was not the one launched: {by_rows}")
    out_x = run.self_retrieval(eng_x, "f32 rows, use_fused_topk=False")
    if bucket_maxima.launches_by_rows != by_rows:
        fail("the use_fused_topk=False path launched the fused kernel")
    # f32 sums in two orders: the ids may differ only where scores nearly tie
    n_diff = near_ties_only(out_k[0], out_x[0], out_x[1], F32_ATOL)
    if n_diff < 0:
        fail("f32 rows: the kernel path and the unfused path differ beyond near ties")
    log(f"f32 rows: {n_diff} of {out_k[0].numel()} final slots differ between the dense paths, "
        f"all at near ties (atol {F32_ATOL}); max final-score gap "
        f"{float((out_k[1] - out_x[1]).abs().max()):.3g}")
    run.timing([("kernel dense path", eng), ("unfused dense path", eng_x)], "f32 rows")
    dense_launches = dense_kernel_path(run, eng)
    del eng, eng_x, st_f, rows
    torch.cuda.empty_cache()
    return by_rows["f32"], dense_launches


def termtable_path(run, eng_sorted, cfg) -> int:
    from triple_hybrid_rag_tpu_torch.ops.bm25 import score_termtable_batch
    from triple_hybrid_rag_tpu_torch.synthetic import build_term_table, term_str

    syn, st, dev = run.syn, run.syn.state, run.dev
    cfg_t = cfg.replace(lexical_backend="termtable")
    t0 = time.time()
    table_ids, table_w = build_term_table(
        torch.from_numpy(syn.term_ids).to(dev), syn.n, torch.from_numpy(st.idf).to(dev), cfg_t)
    torch.cuda.synchronize()
    st_t = dataclasses.replace(
        st, lexical_mode="termtable", term_ids=table_ids, term_weights=table_w,
        lex_offsets=None, lex_lengths=None, lex_pd=None, lex_pt=None, lex_l_max=1)
    eng = run.engine(st_t, cfg_t)
    log(f"term table {tuple(table_ids.shape)} built on the card in {time.time() - t0:.1f} s; "
        f"device GB {round(st_t.nbytes()['term_table'] / 1e9, 3)}")
    score_termtable_batch.launches = 0
    maxsim_counts_reset()
    run.self_retrieval(eng, "termtable lexical backend")
    torch.cuda.synchronize()
    launches = score_termtable_batch.launches
    maxsim_body_launches("bf16", "termtable lexical backend", st_t)
    log(f"termtable lexical backend: kernel launches {launches}")
    if launches < 1:
        fail("the term-table kernel was not launched")

    # the lexical channel against the sorted postings. The postings are cut at
    # bm25_df_cap and their large tier keeps bm25_large_slots terms; the table keeps
    # everything. So compare on queries of that many terms, none of them cut.
    uncut = st.stored_df < DF_CAP
    texts = []
    for r in run.rows[:BATCH]:
        terms = [int(t) for t in dict.fromkeys(syn.term_ids[r].tolist()) if uncut[t]]
        texts.append(" ".join(term_str(t) for t in terms[:cfg.bm25_large_slots]))
    ids_s, vals_s = eng_sorted._lexical(eng_sorted.prepare_queries(texts)[1], None)
    ids_t, vals_t = eng._lexical(eng.prepare_queries(texts)[1], None)
    n_diff = near_ties_only(ids_t, ids_s, vals_s, LEXICAL_ATOL)
    gap = max_err(vals_t, vals_s)
    log(f"termtable vs sorted lexical channel on {BATCH} queries of uncut terms: {n_diff} of "
        f"{ids_t.numel()} slots differ (near ties, atol {LEXICAL_ATOL}); max score gap {gap:.3g}")
    if n_diff < 0 or not gap <= LEXICAL_ATOL:
        fail("the term-table lexical channel differs from the sorted postings")
    run.timing([("termtable", eng), ("sorted postings", eng_sorted)], "termtable lexical backend")
    run.staged_states["termtable"] = (st_t, cfg_t)
    return launches


def quantized_path(run, cfg, kind: str):
    """The int8 or packed-int4 rows with the int8 MaxSim token store, as the reference
    stores it under both dtypes. Returns the launches of the bucket-maxima body and
    of the int8 MaxSim body over this path."""
    from triple_hybrid_rag_tpu_torch.index import dense_index as di
    from triple_hybrid_rag_tpu_torch.ops.fused_topk import bucket_maxima
    from triple_hybrid_rag_tpu_torch.ops.maxsim import quantize_tokens

    st = run.syn.state
    quantize = di.quantize_rows_int8 if kind == "int8" else di.quantize_rows_int4
    t0 = time.time()
    rows_q, scales = quantize(st.embeddings)
    tokens_q = quantize_tokens(st.maxsim_tokens)
    torch.cuda.synchronize()
    st_q = dataclasses.replace(st, embeddings=rows_q, dense_scales=scales, maxsim_tokens=tokens_q)
    cfg_q = cfg.replace(embedding_dtype=kind)
    eng = run.engine(st_q, cfg_q)  # use_fused_topk=None: the kernel
    eng_x = run.engine(st_q, cfg_q.replace(use_fused_topk=False))
    log(f"{kind} rows {tuple(rows_q.shape)} quantized on the card in {time.time() - t0:.1f} s; "
        f"device GB {round(st_q.nbytes()['embeddings'] / 1e9, 3)}")
    if not eng.use_fused() or eng_x.use_fused():
        fail("use_fused_topk=None must resolve to the kernel on CUDA, False to the unfused path")
    bucket_maxima.launches_by_rows = dict.fromkeys(bucket_maxima.launches_by_rows, 0)
    maxsim_counts_reset()
    out_k = run.self_retrieval(eng, f"{kind} rows, kernel path")
    torch.cuda.synchronize()
    by_rows = dict(bucket_maxima.launches_by_rows)
    n_int8 = maxsim_body_launches("int8", f"{kind} rows, kernel path", st_q)
    log(f"{kind} rows: kernel launches by row type {by_rows}")
    if by_rows[kind] < 1 or sum(by_rows.values()) != by_rows[kind]:
        fail(f"the {kind} kernel was not the one launched: {by_rows}")
    maxsim_counts_reset()
    out_x = run.self_retrieval(eng_x, f"{kind} rows, use_fused_topk=False")
    n_int8 += maxsim_body_launches("int8", f"{kind} rows, use_fused_topk=False", st_q)
    if bucket_maxima.launches_by_rows != by_rows:
        fail("the use_fused_topk=False path launched the fused kernel")
    # both dense paths give the same bits, so the whole program's ids must be equal
    if not torch.equal(out_k[0], out_x[0]):
        fail(f"{kind} rows: final ids of the kernel path and the unfused path differ")
    log(f"{kind} rows: final ids equal on both dense paths ({out_k[0].numel()} slots); max "
        f"final-score gap {float((out_k[1] - out_x[1]).abs().max()):.3g}")
    run.timing([("kernel dense path", eng), ("unfused dense path", eng_x)], f"{kind} rows")
    if kind == "int8":
        run.staged_states["int8"] = (st_q, cfg_q)
    return by_rows[kind], n_int8


def encoder_forward_check(texts, dev):
    """The packaged encoder on the card (bf16) against the port's f32 forward of the
    same weights on the CPU, over ``texts``. Returns the card's embedder."""
    from triple_hybrid_rag_tpu_torch.config import RAGConfig
    from triple_hybrid_rag_tpu_torch.models.encoder import EncoderEmbedder, encoder_params_from_flax
    from triple_hybrid_rag_tpu_torch.models.pretrain import DEFAULT_PARAMS, load_default_encoder

    cfg = RAGConfig()
    t0 = time.time()
    card = load_default_encoder(cfg, device=dev)
    if card is None:
        fail(f"the packaged encoder weights were not found at {DEFAULT_PARAMS}")
    torch.cuda.synchronize()
    load_s = time.time() - t0
    with np.load(DEFAULT_PARAMS) as npz:
        flat = {name: npz[name] for name in npz.files if name != "__meta__"}
    f32 = EncoderEmbedder(dataclasses.replace(card.enc_cfg, dtype="float32"), cfg,
                          params=encoder_params_from_flax(flat), device="cpu")
    ids, mask = card.hasher.encode(texts)
    errs = {}
    for name, got, want in (
        ("raw heads", card.forward(ids, mask), f32.forward(ids, mask)),
        ("embed_texts / token_embeddings", (card.embed_texts(texts), card.token_embeddings(texts)),
         (f32.embed_texts(texts), f32.token_embeddings(texts))),
    ):
        e = max(float((torch.as_tensor(g).cpu() - torch.as_tensor(w)).abs().max())
                for g, w in zip(got, want))
        errs[name] = e
        if not e <= ENCODER_ATOL:
            fail(f"encoder on the card ({name}) disagrees with its f32 CPU forward ({e})")
    c = card.enc_cfg
    n_params = sum(p.numel() for p in card.model.parameters())
    log(f"encoder {c.n_layers} layers x d {c.d_model}, {c.n_heads} heads, MLP {c.d_mlp}, "
        f"{c.vocab_buckets} buckets, {c.max_tokens} tokens, heads {c.out_dim} / {c.token_dim} "
        f"({n_params / 1e6:.1f} M parameters, {c.dtype}), loaded onto the card in {load_s:.1f} s; "
        f"over {len(texts)} texts max |card bf16 - CPU f32| = {errs} (atol {ENCODER_ATOL})")
    return card


def encoder_path(run, card_name):
    """The default RAGConfig with the trained encoder on the 1M-chunk corpus, then
    one batch of the dot rerank. Returns the launches of the bf16 bucket maxima and
    the bf16 MaxSim body over the default configuration's drive."""
    from triple_hybrid_rag_tpu_torch.config import RAGConfig
    from triple_hybrid_rag_tpu_torch.engine import Engine
    from triple_hybrid_rag_tpu_torch.models.encoder import EncoderEmbedder
    from triple_hybrid_rag_tpu_torch.ops.fused_topk import bucket_maxima
    from triple_hybrid_rag_tpu_torch.ops.maxsim import maxsim_scores
    from triple_hybrid_rag_tpu_torch.retrieval import build_parent_embeddings
    from triple_hybrid_rag_tpu_torch.synthetic import CHILDREN_PER_PARENT, encode_rows, maxsim_store

    syn, dev, texts, rows, is_graph = run.syn, run.dev, run.texts, run.rows, run.is_graph
    sample = texts[:N_ENCODER_TEXTS // 2] + [syn.state.corpus.text_of(int(r))
                                             for r in rows[:N_ENCODER_TEXTS // 2]]
    encoder_forward_check(sample, dev)

    # defaults, but for what the corpus fixes: capacity rounding, entities a chunk,
    # the postings' df cap (the corpus's rows are 1024 wide, the default embedding_dim)
    cfg = RAGConfig(capacity_round=1024, graph_max_entities_per_chunk=4, bm25_df_cap=DF_CAP)
    if cfg.embedder_backend != "auto" or cfg.embedding_dim != DIM:
        fail("the default RAGConfig changed under the encoder phase")
    t0 = time.time()
    term_ids = torch.from_numpy(syn.term_ids).to(dev)
    tokens, tok_mask = maxsim_store(term_ids, syn.n, syn.embedder, cfg)
    del term_ids
    st = dataclasses.replace(syn.state, config=cfg, embeddings=syn.state.embeddings.clone(),
                             maxsim_tokens=tokens, maxsim_mask=tok_mask)
    eng = Engine(st, device=dev)
    if not isinstance(eng.embedder, EncoderEmbedder) or eng.maxsim_calibration != 0.6:
        fail(f"embedder_backend='auto' built {type(eng.embedder).__name__}, not the encoder")
    # every chunk of the queries' parents, so the dot rerank's parent means are the encoder's
    enc_rows = sorted({int(r) - int(r) % CHILDREN_PER_PARENT + j for r in rows
                       for j in range(CHILDREN_PER_PARENT)})
    torch.cuda.synchronize()
    t1 = time.time()
    encode_rows(st, enc_rows, eng.embedder, st.corpus.text_of)
    torch.cuda.synchronize()
    enc_s = time.time() - t1
    sizes = {k: round(v / 1e9, 4) for k, v in st.nbytes().items()}
    log(f"default config: MaxSim store {tuple(tokens.shape)} built in {t1 - t0:.1f} s; "
        f"{len(enc_rows)} rows and their {len(enc_rows) // CHILDREN_PER_PARENT} parents re-embedded "
        f"by the encoder in {enc_s:.1f} s ({len(enc_rows) / enc_s:.0f} rows/s on the host and "
        f"card: {syn.n / (len(enc_rows) / enc_s) / 60:.0f} min for all {syn.n} rows); device GB "
        f"{sizes}")

    # which encode path served each batch
    calls = {"device": 0, "host": 0}
    emb = eng.embedder
    encode, embed_texts = emb.encode_queries_device, emb.embed_texts

    def counted(fn, key):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    emb.encode_queries_device = counted(encode, "device")
    emb.embed_texts = counted(embed_texts, "host")
    plain = [i for i in range(2 * BATCH) if not is_graph[i]]
    ones = [i for i in range(len(texts)) if not is_graph[i]][:6] + \
           [i for i in range(len(texts)) if is_graph[i]][:2]
    outs = {}
    bucket_maxima.launches_by_rows = dict.fromkeys(bucket_maxima.launches_by_rows, 0)
    maxsim_counts_reset()
    for device_encode in (True, False):
        eng.device_query_encode = device_encode
        before = dict(calls)
        ids, out0 = [], None
        for lo in range(0, 2 * BATCH, BATCH):
            _, out = eng.search_arrays(texts[lo:lo + BATCH])
            if not bool(torch.isfinite(out[1]).all()):
                fail("default config: non-finite final scores")
            if out0 is None:
                out0 = out
            ids.append(out[0].cpu().numpy())
        ids = np.concatenate(ids)
        frac = sum(int(rows[i] in ids[i].tolist()) for i in plain) / len(plain)
        one_hits = 0
        for i in ones:
            one_ids = eng.search_arrays([texts[i]])[1][0].cpu().numpy()[0]
            one_hits += int(rows[i] in one_ids.tolist()) if not is_graph[i] else 0
        path = "device" if device_encode else "host"
        used = {k: calls[k] - before[k] for k in calls}
        label = f"default config, {path} encode"
        log(f"{label}: self-retrieval {frac:.4f} of {len(plain)} plain queries at B={BATCH}; B=1: "
            f"{one_hits}/6 plain self-retrieved, 2 graph queries ran; encode calls {used}")
        if used[path] < 1 or used["device" if path == "host" else "host"] != 0:
            fail(f"{label}: the {path} encode path was not the one taken ({used})")
        if frac < 0.95 or one_hits < 5:
            fail(f"{label}: self-retrieval {frac} at B={BATCH}, {one_hits}/6 at B=1")
        outs[device_encode] = out0
    torch.cuda.synchronize()
    launches = {"fused_bucket_maxima": bucket_maxima.launches_by_rows["bf16"],
                "maxsim_scores": maxsim_body_launches("bf16", "default config", st)}
    log(f"default config: kernel launches {launches} (bucket maxima by row type "
        f"{bucket_maxima.launches_by_rows})")
    if min(launches.values()) < 1 or sum(bucket_maxima.launches_by_rows.values()) != launches[
            "fused_bucket_maxima"]:
        fail(f"default config: the bf16 bucket maxima and MaxSim bodies were not the ones launched")
    # f16 wires of vectors equal within the forward's rounding: ids may differ at near ties
    n_diff = near_ties_only(outs[True][0], outs[False][0], outs[False][1], 1e-3)
    if n_diff < 0:
        fail("default config: device encode and host encode differ beyond near ties")
    log(f"default config: device encode vs host encode: {n_diff} of {outs[True][0].numel()} "
        f"final slots differ, all at near ties (atol 1e-3); max final-score gap "
        f"{float((outs[True][1] - outs[False][1]).abs().max()):.3g}")
    emb.encode_queries_device, emb.embed_texts = encode, embed_texts
    eng.device_query_encode = True
    encoder_timing(run, eng, card_name)

    # ---- the dot rerank: cosine against the parents' mean embeddings ----
    t0 = time.time()
    parent_emb = build_parent_embeddings(st.embeddings, st.dense_scales,
                                         st.parent_of[:syn.n], tokens.shape[0])
    torch.cuda.synchronize()
    st_dot = dataclasses.replace(st, config=cfg.replace(rerank_backend="dot"), maxsim_tokens=None,
                                 maxsim_mask=None, parent_emb=parent_emb)
    del tokens, tok_mask
    eng_dot = Engine(st_dot, device=dev)
    bucket_maxima.launches_by_rows = dict.fromkeys(bucket_maxima.launches_by_rows, 0)
    maxsim_counts_reset()
    _, out = eng_dot.search_arrays(texts[:BATCH])
    ids = out[0].cpu().numpy()
    plain1 = [i for i in range(BATCH) if not is_graph[i]]
    frac = sum(int(rows[i] in ids[i].tolist()) for i in plain1) / len(plain1)
    n_maxsim = sum(maxsim_scores.launches_by_tokens.values())
    log(f"dot rerank: parent_emb {tuple(parent_emb.shape)} built in {time.time() - t0:.1f} s, "
        f"device GB {st_dot.nbytes()['parent_emb'] / 1e9:.4f}; self-retrieval {frac:.4f} of "
        f"{len(plain1)} plain queries at B={BATCH}; refused {int(out[2].sum())}; bucket maxima "
        f"launches {bucket_maxima.launches_by_rows['bf16']}, MaxSim launches {n_maxsim}")
    if frac < 0.95 or n_maxsim != 0 or not bool(torch.isfinite(out[1]).all()):
        fail(f"dot rerank: self-retrieval {frac}, MaxSim launches {n_maxsim}")
    del eng_dot, st_dot, parent_emb, st, eng
    torch.cuda.empty_cache()
    return launches


def encoder_timing(run, eng, card_name):
    """The encoder's device ms and host ms per batch at B = 128 and B = 1, host prep
    against the BowHash engine's, program wall, device busy and e2e ms per query."""
    from torch.profiler import ProfilerActivity, profile
    from torch.autograd import DeviceType
    from triple_hybrid_rag_tpu_torch.engine import Engine

    def dev_ms(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0)) / 1e3

    cfg, emb = eng.config, eng.embedder
    texts = run.texts
    kw = dict(out_dim=cfg.embedding_dim, max_tokens=cfg.maxsim_query_tokens,
              token_dim=cfg.maxsim_dim)
    bow = Engine(dataclasses.replace(eng.state, config=cfg.replace(embedder_backend="bowhash")),
                 embedder=run.syn.embedder, device=run.dev)
    for b in (BATCH, 1):
        batches = [texts[i * b:(i + 1) * b] for i in range(2, 6)]
        t0 = time.perf_counter()
        inputs = [emb.query_inputs(tb) for tb in batches]
        host_ms = (time.perf_counter() - t0) / len(batches) * 1e3
        for x in inputs:
            emb.encode_device(*x, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for x in inputs:
            emb.encode_device(*x, **kw)
        torch.cuda.synchronize()
        enc_wall = (time.perf_counter() - t0) / len(inputs) * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for x in inputs:
                emb.encode_device(*x, **kw)
            torch.cuda.synchronize()
        kernels = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                         key=dev_ms, reverse=True)
        busy = sum(dev_ms(e) for e in kernels) / len(inputs)
        gemm = sum(dev_ms(e) for e in kernels
                   if any(w in e.key.lower() for w in ("gemm", "nvjet", "xmma", "cutlass")))
        log(f"encoder B={b} kernels: {sum(e.count for e in kernels) // len(inputs)} launches a "
            f"batch, matrix products {gemm / len(inputs):.4f} of {busy:.4f} ms; longest: "
            + "; ".join(f"{dev_ms(e) / len(inputs):.3f} ms x{e.count // len(inputs)} "
                        f"{e.key[:70]}" for e in kernels[:6]))
        prep, e2e = {}, {}
        for name, e, dev_encode in (("BowHash", bow, False), ("encoder, device encode", eng, True),
                                    ("encoder, host encode", eng, False)):
            e.device_query_encode = dev_encode
            for tb in batches:  # warm the embedders' per-token caches on these texts
                e.prepare_queries(tb)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for tb in batches:
                e.prepare_queries(tb)
            torch.cuda.synchronize()
            prep[name] = (time.perf_counter() - t0) / len(batches) * 1e3
            t0 = time.perf_counter()
            for tb in batches:
                e.search_arrays(tb)[1][0].cpu()
            e2e[name] = (time.perf_counter() - t0) / (len(batches) * b) * 1e3
        eng.device_query_encode = True
        log(f"encoder B={b}: device busy {busy:.4f} ms/batch (profiler, kernels of the forward, "
            f"blend and cast), wall {enc_wall:.4f} ms/batch (host launches included); host inputs "
            f"(analyzer, hash, anchors) {host_ms:.4f} ms/batch; prepare_queries (synchronized) "
            + ", ".join(f"{k} {v:.4f}" for k, v in prep.items()) + " ms/batch; e2e "
            + ", ".join(f"{k} {v:.4f}" for k, v in e2e.items()) + f" ms/query; card {card_name}")
    run.timing([("encoder default config", eng)], "default config")
    batches = [texts[i * BATCH:(i + 1) * BATCH] for i in range(2, 4)]
    stage_profile(eng, batches, "default config, prepare_queries + run", texts=True)


# ---------------------------------------------------------------- phase 5


def program_times(eng, batches, label: str):
    """(program wall ms/batch on prepared args, device busy ms/batch, engine.dense
    device ms/batch) of ``eng`` over ``batches`` of query texts."""
    args = [eng.prepare_queries(tb)[1] for tb in batches]
    eng.run(args[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for a in args:
        eng.run(a)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / len(args) * 1e3
    busy = stage_profile(eng, args, label)
    return wall, busy, STAGE_MS.get("engine.dense", float("nan"))


def ivf_path(run, eng_exact, cfg, card):
    """semantic_backend="ivf" at the reference's defaults (512-row blocks, 32 probes,
    8 k-means iterations, one cluster per block) over the 1M-chunk corpus: bf16
    rows, then int8 rows with the int8 MaxSim store; then full probes on a cut of
    the rows against the exact f32 scan. Returns the MaxSim launches by body."""
    from triple_hybrid_rag_tpu_torch.index import dense_index as di
    from triple_hybrid_rag_tpu_torch.index.ivf import dequant_f32, ivf_build_local, ivf_topk_local
    from triple_hybrid_rag_tpu_torch.index.state import ivf_layout
    from triple_hybrid_rag_tpu_torch.ops.fused_topk import bucket_maxima
    from triple_hybrid_rag_tpu_torch.ops.maxsim import maxsim_scores, quantize_tokens
    from triple_hybrid_rag_tpu_torch.ops.topk import sort_topk_desc

    from triple_hybrid_rag_tpu_torch.config import RAGConfig

    st, texts = run.syn.state, run.texts
    cfg_i = cfg.replace(semantic_backend="ivf")

    def ivf_settings(c):
        return c.ivf_block_rows, c.ivf_probes, c.ivf_kmeans_iters, c.ivf_clusters

    if ivf_settings(cfg_i) != ivf_settings(RAGConfig()):
        fail(f"IVF settings {ivf_settings(cfg_i)} are not the defaults")
    launches = {}
    for kind in ("bf16", "int8"):
        label = f"IVF {kind} rows"
        base = st
        if kind == "int8":
            rows_q, scales = di.quantize_rows_int8(st.embeddings)
            base = dataclasses.replace(st, embeddings=rows_q, dense_scales=scales,
                                       maxsim_tokens=quantize_tokens(st.maxsim_tokens))
        cfg_k = cfg_i.replace(embedding_dtype="int8" if kind == "int8" else "bfloat16")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.time()
        st_i = ivf_layout(base, cfg_k)
        torch.cuda.synchronize()
        build_s = time.time() - t0
        build_peak = (torch.cuda.max_memory_allocated() - held) / 1e9
        n_blocks = st_i.ivf_centroids.shape[0]
        ivf_gb = (st_i.nbytes()["ivf"] + st_i.embeddings.numel() * st_i.embeddings.element_size()
                  + (0 if st_i.dense_scales is None else st_i.dense_scales.numel() * 4)) / 1e9
        alive = st_i.ivf_perm < st_i.n_pad
        src = st_i.ivf_perm[alive]
        if not (torch.equal(st_i.embeddings[alive], base.embeddings[src])
                and (kind == "bf16" or torch.equal(st_i.dense_scales[alive], base.dense_scales[src]))
                and int(alive.sum()) == int(base.valid.sum())):
            fail(f"{label}: the reordered rows or scales are not the placed rows of their slots")
        log(f"{label}: IVF layout of {st_i.n_pad} rows in {n_blocks} blocks of {cfg_k.ivf_block_rows}, "
            f"{n_blocks} clusters, built on the card in {build_s:.2f} s; peak device memory of the "
            f"build {build_peak:.3f} GB above the {held / 1e9:.2f} GB held; IVF arrays "
            f"(reordered rows and scales, perm, centroids) {ivf_gb:.3f} GB; card {card}")
        eng = run.engine(st_i, cfg_k)
        bucket_maxima.launches_by_rows = dict.fromkeys(bucket_maxima.launches_by_rows, 0)
        maxsim_counts_reset()
        run.self_retrieval(eng, label)
        torch.cuda.synchronize()
        if sum(bucket_maxima.launches_by_rows.values()):
            fail(f"{label}: bucket maxima launched under IVF: {bucket_maxima.launches_by_rows}")
        launches[kind] = maxsim_body_launches(kind, label, st_i)
        # the semantic channel against the exact scan of the same rows
        eng_x = run.engine(base, cfg_k.replace(semantic_backend="exact"))
        a = eng.prepare_queries(texts[:BATCH])[1]
        ids_i, _ = eng._dense(a, None, False)
        ids_e, _ = eng_x._dense(a, None, False)
        found = [len(set(x.tolist()) & set(y[y >= 0].tolist())) / max(int((y >= 0).sum()), 1)
                 for x, y in zip(ids_i.cpu(), ids_e.cpu())]
        log(f"{label}: semantic channel recall@{cfg.semantic_top_k} against the exact scan "
            f"{float(np.mean(found)):.4f} (min {min(found):.4f}) over {BATCH} queries")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        eng.run(a)
        torch.cuda.synchronize()
        log(f"{label}: peak device memory of a B={BATCH} batch {(torch.cuda.max_memory_allocated() - held) / 1e9:.3f} GB "
            f"above the {held / 1e9:.2f} GB held")
        for b in (BATCH, 1):
            batches = [texts[i * b:(i + 1) * b] for i in range(2, 2 + (2 if b == BATCH else 8))]
            got = {name: program_times(e, batches, f"{label}, {name}, B={b}")
                   for name, e in (("IVF", eng), ("exact kernel path", eng_x))}
            log(f"{label} B={b}: program wall / device busy / engine.dense device ms per batch: "
                + "; ".join(f"{k} {w:.4f} / {bz:.4f} / {dn:.4f}" for k, (w, bz, dn) in got.items())
                + f"; card {card}")
        del eng, eng_x, st_i, base
        torch.cuda.empty_cache()

    # full probes on a cut of the rows: the exact f32 scan's ids up to near ties
    rows, valid = st.embeddings[:65_536], st.valid[:65_536]
    n_cut = rows.shape[0]
    layout = ivf_build_local(rows, None, valid, block_rows=cfg.ivf_block_rows)
    q = eng_exact.prepare_queries(texts[:BATCH])[1].q_vec.float()
    ids, vals = ivf_topk_local(*layout, q, probes=layout[3].shape[0], top_k=cfg.semantic_top_k)
    exact = (q @ dequant_f32(rows, None).T).masked_fill(~valid[None, :], float("-inf"))
    ids_e, vals_e = sort_topk_desc(exact, torch.arange(n_cut, device=q.device).expand_as(exact),
                                   cfg.semantic_top_k)
    n_diff = near_ties_only(ids, ids_e, vals_e, 1e-5)
    gap = max_err(torch.sort(vals, 1).values, torch.sort(vals_e, 1).values)
    log(f"IVF full probes ({layout[3].shape[0]} blocks of {n_cut} rows): {n_diff} of {ids.numel()} "
        f"slots differ from the exact f32 scan (near ties, atol 1e-5); max score gap {gap:.3g}")
    if n_diff < 0 or not gap <= 1e-5:
        fail("IVF with every block probed differs from the exact scan")
    return launches


# ---------------------------------------------------------------- phase 6


def stdlib_docstrings(min_chars: int = 200):
    """(name, docstring) of every module of this Python's standard library and of
    every class and function whose docstring has at least ``min_chars`` characters,
    parsed with ``ast``; test packages, idlelib and site-packages left out."""
    import ast
    import sysconfig
    from pathlib import Path

    root = Path(sysconfig.get_paths()["stdlib"])
    skip = {"test", "tests", "idlelib", "site-packages"}
    mods, defs = [], []
    for path in sorted(root.rglob("*.py")):
        rel = path.relative_to(root)
        if skip & set(rel.parts[:-1]):
            continue
        try:
            tree = ast.parse(path.read_text(encoding="utf-8"))
        except (SyntaxError, UnicodeDecodeError, ValueError):
            continue
        module = ".".join(rel.with_suffix("").parts)
        doc = ast.get_docstring(tree)
        if doc:
            mods.append((module, doc))
        for node in ast.walk(tree):
            if isinstance(node, (ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
                text = ast.get_docstring(node)
                if text and len(text) >= min_chars:
                    defs.append((f"{module}.{node.name}", text))
    return mods, defs


def ingest_all(rag, docs, label: str):
    """``ingest_text`` of every (name, text), collection = the top-level module.
    Fails on a FAILED result or on an embed that fell back to zero vectors.
    Returns the summed stage ms."""
    from triple_hybrid_rag_tpu_torch.types import IngestionStatus

    stages = dict.fromkeys(("load_ms", "chunk_ms", "embed_ms", "store_ms", "ner_ms"), 0.0)
    for name, text in docs:
        res = rag.ingest_text(text, name=f"{name}.txt", collection=name.split(".")[0])
        if res.status == IngestionStatus.FAILED:
            fail(f"{label}: ingesting {name} failed: {res.error}")
        if rag.ingestor.embedder.last_errors:
            fail(f"{label}: {name}: the embedder fell back to zero vectors for items "
                 f"{rag.ingestor.embedder.last_errors}")
        for k in stages:
            stages[k] += res.timings.get(k, 0.0)
    return stages


def ingest_path(dev, card):
    """The default RAGConfig ingests the standard library's docstrings through the
    facade on the card and serves them. Returns the launches of the bf16 bucket
    maxima and the bf16 MaxSim body over the queries."""
    from triple_hybrid_rag_tpu_torch import RAG, RAGConfig
    from triple_hybrid_rag_tpu_torch.analyzer import Analyzer
    from triple_hybrid_rag_tpu_torch.models.encoder import EncoderEmbedder
    from triple_hybrid_rag_tpu_torch.ops.fused_topk import bucket_maxima

    t0 = time.time()
    mods, defs = stdlib_docstrings()
    docs = mods + defs
    log(f"stdlib docstrings: {len(mods)} modules + {len(defs)} classes and functions = "
        f"{len(docs)} documents, {sum(len(t) for _, t in docs) / 1e6:.3f} MB, parsed in "
        f"{time.time() - t0:.1f} s")
    cfg = RAGConfig()
    rag = RAG(cfg, device=dev)  # query_batch serves through the engine; phase 7 queries staged
    emb = rag.ingestor.embedder.inner
    if not isinstance(emb, EncoderEmbedder) or emb.maxsim_calibration != 0.6:
        fail(f"the default RAGConfig built {type(emb).__name__}, not the encoder")
    t0 = time.time()
    stages = ingest_all(rag, docs, "stdlib ingest")
    torch.cuda.synchronize()
    ingest_s = time.time() - t0
    t0 = time.time()
    retriever = rag.retriever
    st = retriever.state
    torch.cuda.synchronize()
    build_s = time.time() - t0
    stats = rag.stats()
    corpus = rag.ingestor.corpus
    n = len(corpus)
    zero = int((~(st.embeddings[:n] != 0).any(dim=1)).sum())
    log(f"stdlib ingest: {stats['documents']} documents, {stats['parents']} parents, "
        f"{stats['children']} children, {stats['graph_entities']} entities, "
        f"{stats['graph_relations']} relations, {stats['graph_mentions']} mentions in "
        f"{ingest_s:.1f} s (stage sums, s: "
        + ", ".join(f"{k[:-3]} {v / 1e3:.2f}" for k, v in stages.items())
        + f"); index build and placement {build_s:.2f} s; device GB "
        + str({k: round(v / 1e9, 4) for k, v in st.nbytes().items()})
        + f"; n_pad {st.n_pad}, lexical {st.lexical_mode}, graph {st.graph_mode}; documents past "
        f"the term table's {cfg.doc_term_capacity} slots {retriever.bm25_index.overflow_docs}, "
        f"entities past {cfg.graph_max_degree} neighbours {retriever.graph_index.overflow_entities}"
        f"; card {card}")
    if zero:
        fail(f"stdlib ingest: {zero} stored chunks have an all-zero dense row")

    analyzer = Analyzer(cfg)
    rows = np.linspace(0, n - 1, BATCH).astype(int)
    queries = [" ".join(analyzer.tokenize(corpus.children[r].text)[:12]) for r in rows]
    same_text = {}
    for c in corpus.children:
        same_text.setdefault(c.text, set()).add(c.chunk_id)

    def hits(results, idx):
        return sum(any(x.chunk_id in same_text[corpus.children[rows[i]].text] for x in r.results)
                   for i, r in zip(idx, results))

    rag.query_batch(queries[:8])  # warm-up
    torch.cuda.synchronize()
    bucket_maxima.launches_by_rows = dict.fromkeys(bucket_maxima.launches_by_rows, 0)
    maxsim_counts_reset()
    res = rag.query_batch(queries)
    ones = [rag.query_batch([queries[i]])[0] for i in range(8)]
    torch.cuda.synchronize()
    launches = {"fused_bucket_maxima": bucket_maxima.launches_by_rows["bf16"],
                "maxsim_scores": maxsim_body_launches("bf16", "stdlib queries", st)}
    frac = hits(res, range(BATCH)) / BATCH
    one_frac = hits(ones, range(8)) / 8
    log(f"stdlib queries: self-retrieval {frac:.4f} of {BATCH} at B={BATCH} (refused "
        f"{sum(r.refused for r in res)}), {one_frac:.4f} of 8 at B=1; kernel launches {launches} "
        f"(bucket maxima by row type {bucket_maxima.launches_by_rows})")
    if frac < 0.95 or one_frac < 0.75:
        fail(f"stdlib queries: self-retrieval {frac} at B={BATCH}, {one_frac} at B=1")
    if min(launches.values()) < 1 or sum(bucket_maxima.launches_by_rows.values()) != launches[
            "fused_bucket_maxima"]:
        fail("stdlib queries: the bf16 bucket maxima and MaxSim bodies were not the ones launched")
    eng = rag._engine
    for b in (BATCH, 1):
        batches = [queries, queries] if b == BATCH else [[q] for q in queries[:8]]
        t0 = time.perf_counter()
        for tb in batches:
            rag.query_batch(tb)
        e2e = (time.perf_counter() - t0) / (len(batches) * b) * 1e3
        wall, busy, dense = program_times(eng, batches, f"stdlib queries, B={b}")
        log(f"stdlib queries B={b}: e2e {e2e:.4f} ms/query (query_batch, host prep and decode "
            f"included); program wall {wall / b:.4f} ms/query, device busy {busy / b:.4f} "
            f"ms/query, engine.dense {dense:.4f} ms/batch; card {card}")

    # the same text again is skipped; a new document refreshes the engine and is found
    name, text = docs[0]
    if not rag.ingest_text(text, name=f"{name}.txt", collection=name.split(".")[0]).skipped:
        fail("ingesting the same text again was not skipped")
    new = ("Zorblax quintessors recalibrate the flumbering of vexillary gaskets whenever "
           "the quorple threshold drifts. A quintessor keeps its gasket ledger in moss.")
    res_new = rag.ingest_text(new, name="zorblax.txt", collection="zorblax")
    t0 = time.time()
    rag.retriever  # rebuilt: the corpus changed
    refreshed = rag._engine is eng
    log(f"new document ({res_new.n_children} chunks): retriever rebuilt in {time.time() - t0:.2f} s, "
        f"engine refreshed in place: {refreshed}")
    if not refreshed:
        fail("the new document did not go through Engine.refresh")
    found = rag.query_batch(["zorblax quintessors recalibrate vexillary gaskets"])[0]
    if not found.results or found.results[0].doc_id != res_new.doc_id:
        fail("the new document was not retrieved by its own text")
    del eng, st, retriever

    # the same subset on the card and on the CPU: equal ids and arrays
    subset = docs[::max(1, len(docs) // 200)][:200]
    built = []
    for where in (dev, "cpu"):
        t0 = time.time()
        r = RAG(cfg, device=where, use_sharded_engine=True)
        ingest_all(r, subset, f"subset on {where}")
        built.append((r.ingestor.corpus, r.retriever.state))
        log(f"subset of {len(subset)} documents ingested and placed on {where} in "
            f"{time.time() - t0:.1f} s")
    (c_gpu, s_gpu), (c_cpu, s_cpu) = built
    if [c.chunk_id for c in c_gpu.children] != [c.chunk_id for c in c_cpu.children]:
        fail("card and CPU ingests gave different chunk ids")
    for key in ("lex_offsets", "lex_lengths", "lex_pd", "lex_pt", "nbr", "chunk_entities",
                "g_offsets", "g_lengths", "g_docs", "parent_of", "collection_of"):
        a, b = getattr(s_gpu, key), getattr(s_cpu, key)
        if (a is None) != (b is None) or (a is not None and not torch.equal(a.cpu(), b)):
            fail(f"card and CPU ingests placed different {key}")
    gap = float((s_gpu.embeddings.float().cpu() - s_cpu.embeddings.float()).abs().max())
    log(f"subset: chunk ids, BM25 and graph arrays equal on card and CPU; dense rows within "
        f"{gap:.3g} (atol {ENCODER_ATOL}, the card's bf16 encoder against the CPU's)")
    if not gap <= ENCODER_ATOL:
        fail(f"card and CPU dense rows differ by {gap}")
    return launches, (rag, queries, hits)


# ---------------------------------------------------------------- phase 7


def staged_counts_reset() -> None:
    """Every kernel counter to 0 (the staged paths' windows)."""
    from triple_hybrid_rag_tpu_torch.ops.bm25 import score_termtable_batch
    from triple_hybrid_rag_tpu_torch.ops.dense_kernel import dense_scores
    from triple_hybrid_rag_tpu_torch.ops.fused_topk import bucket_maxima

    dense_scores.launches = 0
    score_termtable_batch.launches = 0
    bucket_maxima.launches_by_rows = dict.fromkeys(bucket_maxima.launches_by_rows, 0)
    maxsim_counts_reset()


def staged_counts() -> dict:
    """Kernel launches since :func:`staged_counts_reset`, by the kernels line's names."""
    from triple_hybrid_rag_tpu_torch.ops.bm25 import score_termtable_batch
    from triple_hybrid_rag_tpu_torch.ops.dense_kernel import dense_scores
    from triple_hybrid_rag_tpu_torch.ops.fused_topk import bucket_maxima
    from triple_hybrid_rag_tpu_torch.ops.maxsim import maxsim_scores

    by_rows = bucket_maxima.launches_by_rows
    return {
        "dense_scores": dense_scores.launches,
        "termtable_scores": score_termtable_batch.launches,
        "maxsim_scores": maxsim_scores.launches_by_tokens["bf16"],
        "maxsim_scores_int8": maxsim_scores.launches_by_tokens["int8"],
        "fused_bucket_maxima": by_rows["bf16"] + by_rows["f32"],
        "fused_bucket_maxima_int8": by_rows["int8"],
        "fused_bucket_maxima_int4": by_rows["int4"],
    }


def semantic_failures() -> float:
    from triple_hybrid_rag_tpu_torch.observability import rag_metrics

    return rag_metrics.counter("semantic_channel_failures_total").value()


def drive_staged(query, texts, label: str, card: str, expect: dict):
    """``query(text)`` for every text (a staged entry point), the kernel counters set
    to 0 just before and read just after. Fails on a swallowed embed failure (every
    text has tokens), on a non-finite score, and unless the launches equal
    ``expect`` (kernels not named there must not launch). Prints the median of
    every ``timings`` key and the e2e ms/query. Returns (results, launches)."""
    fails0 = semantic_failures()
    torch.cuda.synchronize()
    staged_counts_reset()
    t0 = time.perf_counter()
    res = [query(t) for t in texts]
    torch.cuda.synchronize()
    e2e = (time.perf_counter() - t0) / len(texts) * 1e3
    launches = staged_counts()
    swallowed = semantic_failures() - fails0
    med = {k: float(np.median([r.timings[k] for r in res])) for k in res[0].timings}
    log(f"{label}: {len(texts)} staged queries, e2e {e2e:.4f} ms/query (host clock, decode "
        f"included); median timings ms: " + ", ".join(f"{k} {v:.3f}" for k, v in med.items())
        + f"; refused {sum(r.refused for r in res)}; kernel launches {launches}; semantic "
        f"channel failures {swallowed:g}; card {card}")
    if swallowed:
        fail(f"{label}: the semantic channel swallowed {swallowed:g} embed failures")
    if any(not np.isfinite(x.final_score) for r in res for x in r.results):
        fail(f"{label}: non-finite final scores")
    want = {k: expect.get(k, 0) for k in launches}
    if launches != want:
        fail(f"{label}: kernel launches {launches}, expected {want}")
    return res, launches


def staged_profile(query, texts, label: str) -> float:
    """Device busy ms per staged query under torch.profiler (the sum of the kernels'
    device times), the idle share and the longest kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in texts:
            query(t)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(device_self_ms(e) for e in kernels)
    n = len(texts)
    if busy <= 0:
        log(f"profile ({label}): the profiler recorded no device time (not measured)")
        return float("nan")
    log(f"profile ({label}) over {n} staged queries: wall {wall_ms / n:.3f} ms/query, device busy "
        f"{busy / n:.3f} ms/query ({100 * busy / wall_ms:.1f} % of wall, idle "
        f"{100 * max(0.0, 1 - busy / wall_ms):.1f} %), {sum(e.count for e in kernels) // n} "
        f"kernels a query")
    for e in sorted(kernels, key=device_self_ms, reverse=True)[:8]:
        log(f"  kernel {device_self_ms(e) / n:8.3f} ms/query x{e.count // n:<4d} {e.key[:110]}")
    return busy / n


def add_counts(total: dict, part: dict) -> None:
    for k, v in part.items():
        total[k] = total.get(k, 0) + v


def staged_stdlib(ctx, card) -> dict:
    """Phase 7(a): phase 6's stdlib corpus through ``RAG.query`` (the staged path,
    ``use_sharded_engine=False``, default RAGConfig) for phase 6's queries; against
    ``Engine.retrieve_batch`` (printed); a host ``rerank_fn`` and a raising one."""
    from triple_hybrid_rag_tpu_torch import RAG
    from triple_hybrid_rag_tpu_torch.analyzer import Analyzer

    rag, queries, hits = ctx
    if rag.use_sharded_engine:
        fail("phase 7(a) must query through the staged path")
    analyzer = Analyzer(rag.config)
    idx = [i for i, q in enumerate(queries) if analyzer.tokenize(q)]
    texts = [queries[i] for i in idx]
    n = len(texts)
    rag.query(texts[0])  # warm-up
    label = "stdlib staged (RAG.query, default RAGConfig)"
    res, launches = drive_staged(rag.query, texts, label, card,
                                 {"dense_scores": n, "maxsim_scores": n})
    frac = hits(res, idx) / n
    misses = [i for i, r in zip(idx, res) if not hits([r], [i])]
    log(f"{label}: self-retrieval {frac:.4f} of {n} queries (missed: queries {misses})")
    if frac < 0.95:
        fail(f"{label}: self-retrieval {frac} < 0.95")
    engine = rag._get_engine()
    for width, other in ((n, engine.retrieve_batch(texts)), (1, [engine.retrieve(q) for q in texts])):
        differ = same_set = same_text = 0
        gap = 0.0
        for a, b in zip(res, other):
            ids_a, ids_b = ([x.chunk_id for x in r.results] for r in (a, b))
            if ids_a != ids_b:
                differ += 1
                same_set += set(ids_a) == set(ids_b)
                same_text += [x.text for x in a.results] == [x.text for x in b.results]
            else:
                gap = max([gap, abs(a.max_score - b.max_score)]
                          + [abs(x.final_score - y.final_score) for x, y in zip(a.results, b.results)])
        log(f"{label}: against Engine.retrieve_batch at B={width} on the same queries, {differ} "
            f"differ in their final ids ({same_set} of them only in order, {same_text} with equal "
            f"texts: duplicate chunks); largest final-score gap where they agree {gap:.3g}; the "
            f"engine misses queries {[i for i, r in zip(idx, other) if not hits([r], [i])]} (it "
            f"encodes a batch and sends f16 query vectors and tokens, seeds the graph its own way, "
            f"and its lexical and graph channels sum in other orders)")

    seen = []

    def overlap(query, parent_texts):
        words = set(analyzer.tokenize(query))
        out = [len(words & set(analyzer.tokenize(t))) / max(len(words), 1) for t in parent_texts]
        seen.append(out)
        return out

    def broken(query, parent_texts):
        raise RuntimeError("the reranker is down")

    for fn, what, expect in ((overlap, "a host rerank_fn", {}), (broken, "a raising rerank_fn",
                                                                  {"maxsim_scores": 8})):
        r = RAG(rag.config, device=rag.device, rerank_fn=fn)
        r.ingestor = rag.ingestor
        r.retriever  # built and placed outside the counted window
        out, part = drive_staged(r.query, texts[:8], f"stdlib staged with {what}", card,
                                 {"dense_scores": 8, **expect})
        add_counts(launches, part)
        if fn is overlap:
            # the callable's scores, clipped to [0, 1] in f32, are the results' rerank scores
            ok = len(seen) == 8 and all(
                {x.rerank_score for x in o.results}
                <= set(np.clip(np.asarray(s, np.float32), 0, 1).tolist()) | {0.0}
                for o, s in zip(out, seen))
            if not ok:
                fail("the host rerank_fn was not the reranker of the staged queries")
        elif [[x.chunk_id for x in o.results] for o in out] != \
                [[x.chunk_id for x in o.results] for o in res[:8]]:
            fail("a raising rerank_fn did not fall back to the MaxSim rerank")
        del r
    return launches


def staged_synthetic(run, card) -> dict:
    """Phase 7(b): the staged path over phase 3's placed 1M-chunk state (bf16 rows),
    32 queries of phase 3's mix; no second copy of the rows."""
    from triple_hybrid_rag_tpu_torch.retrieval import Retriever

    st = run.syn.state
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    ret = Retriever.from_state(st, embedder=run.syn.embedder)
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    rows_gb = st.nbytes()["embeddings"] / 1e9
    log(f"staged retriever over the placed 1M-chunk state: torch.cuda.memory_allocated() "
        f"{before / 1e9:.4f} GB before, {after / 1e9:.4f} GB after ({(after - before) / 1e6:.3f} MB "
        f"added; the placed rows alone are {rows_gb:.3f} GB)")
    if after - before > 1e-3 * rows_gb * 1e9:
        fail("the staged retriever placed a second copy of the index")
    texts, rows, is_graph = run.texts[:32], run.rows[:32], run.is_graph[:32]
    ret.retrieve(texts[0])  # warm-up
    label = "1M-chunk staged (Retriever.retrieve, bf16 rows)"
    res, launches = drive_staged(ret.retrieve, texts, label, card,
                                 {"dense_scores": 32, "maxsim_scores": 32})
    plain = [i for i in range(len(texts)) if not is_graph[i]]
    hits = sum(f"c{rows[i]}" in [x.chunk_id for x in res[i].results] for i in plain)
    n_graph = sum(r.channel_counts["graph"] > 0 for r in res)
    log(f"{label}: self-retrieval {hits}/{len(plain)} plain queries; {n_graph} of "
        f"{len(texts)} queries had graph candidates")
    if hits < 0.95 * len(plain):
        fail(f"{label}: self-retrieval {hits}/{len(plain)}")
    staged_profile(ret.retrieve, texts[:8], label)
    return launches


def staged_configs(run, card) -> dict:
    """Phase 7(c): 8 staged queries each over phase 3's term-table and int8 states."""
    from triple_hybrid_rag_tpu_torch.retrieval import Retriever

    launches = {}
    texts, rows, is_graph = run.texts[:8], run.rows[:8], run.is_graph[:8]
    expect = {"termtable": {"termtable_scores": 8, "dense_scores": 8, "maxsim_scores": 8},
              "int8": {"maxsim_scores_int8": 8}}
    for kind, (state, cfg) in run.staged_states.items():
        ret = Retriever.from_state(dataclasses.replace(state, config=cfg), embedder=run.syn.embedder)
        ret.retrieve(texts[0])  # warm-up
        label = f"1M-chunk staged, {kind} configuration"
        res, part = drive_staged(ret.retrieve, texts, label, card, expect[kind])
        plain = [i for i in range(len(texts)) if not is_graph[i]]
        hits = sum(f"c{rows[i]}" in [x.chunk_id for x in res[i].results] for i in plain)
        log(f"{label}: self-retrieval {hits}/{len(plain)} plain queries")
        if hits < len(plain) - 1:
            fail(f"{label}: self-retrieval {hits}/{len(plain)}")
        add_counts(launches, part)
    if set(run.staged_states) != set(expect):
        fail(f"phase 7(c) ran {sorted(run.staged_states)}, not {sorted(expect)}")
    return launches


# ---------------------------------------------------------------- phase 8


def http(base: str, route: str, payload=None, timeout: float = 300.0):
    """(status, decoded JSON or text) of one request to the server at ``base``
    (``127.0.0.1``; proxies from the environment are not used)."""
    import urllib.error
    import urllib.request

    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(base + route, data=data,
                                 headers={"Content-Type": "application/json"} if data else {})
    try:
        with opener.open(req, timeout=timeout) as r:
            status, body = r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        status, body = e.code, e.read().decode()
    try:
        return status, json.loads(body)
    except ValueError:
        return status, body


# A load generator run in a process of its own (``python -c``), so that its client
# work does not share the server's interpreter lock (a urllib client in the server's
# process added some 40 ms to each request on the card, a GET /healthz included):
# one asyncio loop opens a connection per request, all at once (or one after another
# with "sequential"), sends each as one write and reads the answer to EOF (HTTP/1.0).
# Reads {"port", "route", "payloads", "sequential"} as JSON on stdin and prints one
# JSON list of [status, seconds from connect to EOF, body].
LOAD_CLIENT = r"""
import asyncio, json, sys, time

async def one(port, route, payload):
    body = json.dumps(payload).encode()
    head = (f"POST {route} HTTP/1.0\r\nHost: 127.0.0.1\r\nContent-Type: application/json\r\n"
            f"Content-Length: {len(body)}\r\n\r\n").encode()
    t = time.perf_counter()
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(head + body)
    await writer.drain()
    data = await reader.read()
    dt = time.perf_counter() - t
    writer.close()
    status_line, _, rest = data.partition(b"\r\n")
    return [int(status_line.split()[1]), dt, json.loads(rest.partition(b"\r\n\r\n")[2])]

async def main(job):
    if job["sequential"]:
        return [await one(job["port"], job["route"], p) for p in job["payloads"]]
    return await asyncio.gather(*(one(job["port"], job["route"], p) for p in job["payloads"]))

print(json.dumps(asyncio.run(main(json.load(sys.stdin)))))
"""


def load_client(port: int, route: str, payloads, sequential: bool = False) -> list:
    """[status, seconds, body] of every payload POSTed by :data:`LOAD_CLIENT` in a new
    process: all at once, or one after another."""
    job = {"port": port, "route": route, "payloads": payloads, "sequential": sequential}
    out = subprocess.run([sys.executable, "-c", LOAD_CLIENT], capture_output=True, text=True,
                         input=json.dumps(job), timeout=600)
    if out.returncode != 0:
        fail(f"the load client failed: {out.stderr[-2000:]}")
    return json.loads(out.stdout)


def start_server(rag, **kw):
    """``server.serve`` on 127.0.0.1 at a free port, run in a thread; returns
    (server, base url)."""
    import threading

    from triple_hybrid_rag_tpu_torch.server import serve

    httpd = serve(host="127.0.0.1", port=0, rag=rag, **kw)
    threading.Thread(target=httpd.serve_forever, name="smoke-http", daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def stop_server(httpd) -> None:
    httpd.shutdown()
    httpd.server_close()


def answer_ids(answers, names: dict, k: int):
    """[B, k] ids (-1 padded) and final scores (-inf padded) of ``answers``, each a
    list of (chunk_id, final score); ``names`` numbers the chunk ids as it meets them."""
    ids = torch.full((len(answers), k), -1, dtype=torch.long)
    scores = torch.full((len(answers), k), float("-inf"))
    for i, ans in enumerate(answers):
        for j, (cid, s) in enumerate(ans[:k]):
            ids[i, j] = names.setdefault(cid, len(names))
            scores[i, j] = s
    return ids, scores


def same_ids(label: str, want, got, atol: float) -> int:
    """Fails unless two lists of answers ((chunk_id, final score) lists) have the
    same ids up to near ties of ``atol`` in ``want``'s scores; returns the slots that
    differ. Prints the largest final-score gap where the ids agree."""
    names: dict = {}
    k = max([len(a) for a in want + got] + [1])
    ids_w, s_w = answer_ids(want, names, k)
    ids_g, s_g = answer_ids(got, names, k)
    n_diff = near_ties_only(ids_g, ids_w, s_w, atol)
    same = (ids_g == ids_w) & (ids_w >= 0)
    gap = float((s_g - s_w)[same].abs().max()) if bool(same.any()) else 0.0
    log(f"{label}: {n_diff} of {int((ids_w >= 0).sum())} result slots differ (near ties within "
        f"{atol:g} allowed); largest final-score gap where the ids agree {gap:.3g}")
    if n_diff < 0:
        fail(f"{label}: the ids differ beyond near ties")
    return n_diff


def pairs(results) -> list:
    """(chunk_id, final score) lists of RetrievalResults."""
    return [[(x.chunk_id, x.final_score) for x in r.results] for r in results]


def http_pairs(bodies) -> list:
    """(chunk_id, final score) lists of /query answers."""
    return [[(x["chunk_id"], x["scores"]["final"]) for x in b["results"]] for b in bodies]


def percentile_ms(values, q: float) -> float:
    return float(np.percentile(np.asarray(values) * 1e3, q))


def serve_checkpoint(ctx, tmp: str, card: str):
    """Phase 8(a): ``RAG.save`` of phase 6's RAG, ``RAG.load`` onto the card, the
    first query with the MaxSim store's rebuild timed apart. Returns the loaded RAG
    (``use_sharded_engine=True``)."""
    import os

    from triple_hybrid_rag_tpu_torch import RAG

    rag, queries, _ = ctx
    dev = rag.device
    before = rag.query_batch(queries)
    t0 = time.perf_counter()
    rag.save(tmp)
    save_s = time.perf_counter() - t0
    sizes = {n: os.path.getsize(os.path.join(tmp, n)) / 1e6 for n in sorted(os.listdir(tmp))}
    log(f"checkpoint: RAG.save in {save_s:.3f} s; artifacts MB "
        + ", ".join(f"{n} {mb:.3f}" for n, mb in sizes.items()))
    t0 = time.perf_counter()
    loaded = RAG.load(tmp, device=dev, use_sharded_engine=True)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    ing = loaded.ingestor
    rebuild = []
    build_maxsim = ing._maxsim_index

    def timed_maxsim():
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = build_maxsim()
        torch.cuda.synchronize()
        rebuild.append(time.perf_counter() - t)
        return out

    ing._maxsim_index = timed_maxsim  # the first retriever build rebuilds the store
    t0 = time.perf_counter()
    first = loaded.query(queries[0])
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    del ing._maxsim_index
    log(f"checkpoint: RAG.load(device={dev.type!r}) in {load_s:.3f} s (the encoder onto the card, "
        f"the artifacts read and verified); first query {first_s:.3f} s, of which the MaxSim "
        f"store's rebuild (token_embeddings over {loaded.ingestor.corpus.n_parents} parents) "
        f"{rebuild[0] if rebuild else float('nan'):.3f} s; {len(first.results)} results; card {card}")
    if len(rebuild) != 1:
        fail("checkpoint: the first query did not rebuild the MaxSim store once")
    n = len(rag.ingestor.corpus)
    rows_a = rag.retriever.state.embeddings[:n]
    rows_b = loaded.retriever.state.embeddings[:n]
    if rows_a.shape != rows_b.shape or not torch.equal(rows_a, rows_b):
        fail("checkpoint: the dense rows placed from the checkpoint differ from the saved RAG's")
    tok_a, tok_b = rag.retriever.state.maxsim_tokens, loaded.retriever.state.maxsim_tokens
    p = min(tok_a.shape[0], tok_b.shape[0])
    tok_gap = float((tok_a[:p].float() - tok_b[:p].float()).abs().max())
    log(f"checkpoint: dense rows equal bit for bit ({n} rows); MaxSim tokens rebuilt within "
        f"{tok_gap:.3g} of the saved RAG's (built in other encoder batches)")
    after = loaded.query_batch(queries)
    same_ids("checkpoint: loaded query_batch against the saved RAG's", pairs(before), pairs(after),
             1e-3)
    return loaded


def serve_batched(loaded, queries, card: str, rounds: int = 2) -> dict:
    """Phase 8(b): the micro-batched server, ``len(queries)`` concurrent POST /query
    per round from a load client in another process; fails unless every request
    answers 200 with ``query_batch``'s ids (up to near ties), the requests were
    coalesced into fewer engine calls, and each engine call launched the bf16 bucket
    maxima and the bf16 MaxSim body once."""
    from triple_hybrid_rag_tpu_torch.observability import rag_metrics

    want = pairs(loaded.query_batch(queries))
    httpd, _ = start_server(loaded)
    if httpd.rag_state.batcher is None:
        fail("the server over use_sharded_engine=True has no micro-batcher")
    total: dict = {}
    n = len(queries)
    try:
        for rnd in range(rounds):
            batches = rag_metrics.counter("server_engine_batches_total")
            width = rag_metrics.histogram("server_batch_size")
            errors = rag_metrics.counter("server_errors_total")
            b0, w0, c0, e0 = batches.value(), width.sum(), width.count(), errors.value()
            torch.cuda.synchronize()
            staged_counts_reset()
            t0 = time.perf_counter()
            out = load_client(httpd.server_address[1], "/query", [{"query": q} for q in queries])
            wall = time.perf_counter() - t0
            launches = staged_counts()
            n_batches = int(batches.value() - b0)
            mean_width = (width.sum() - w0) / max(width.count() - c0, 1)
            lat = [t for _, t, _ in out]
            bad = [(s, b) for s, _, b in out if s != 200]
            label = f"micro-batched server, round {rnd + 1}"
            log(f"{label}: {n} concurrent POST /query from another process: {n / max(lat):.1f} "
                f"requests/s (first send to last answer {max(lat):.3f} s; the client process "
                f"{wall:.3f} s); per request p50 {percentile_ms(lat, 50):.2f} ms, p99 "
                f"{percentile_ms(lat, 99):.2f} ms; {n_batches} engine batches, mean width "
                f"{mean_width:.2f}; kernel launches {launches}; card {card}")
            if bad or errors.value() != e0:
                fail(f"{label}: {len(bad)} requests failed, e.g. {bad[:2]}")
            if not 1 <= n_batches < n:
                fail(f"{label}: {n_batches} engine batches for {n} requests: not coalesced")
            if launches["fused_bucket_maxima"] != n_batches or launches["maxsim_scores"] != n_batches \
                    or sum(launches.values()) != 2 * n_batches:
                fail(f"{label}: expected one bf16 bucket-maxima and one bf16 MaxSim launch per "
                     f"engine batch, got {launches}")
            same_ids(f"{label} against query_batch", want, http_pairs([b for _, _, b in out]), 1e-3)
            add_counts(total, launches)
    finally:
        stop_server(httpd)
    return total


def serve_staged(loaded, queries, card: str):
    """Phase 8(c): the staged server (no micro-batcher), POST /query one after
    another from the load client: one bf16 dense-scores (B = 1) and one bf16 MaxSim
    launch each, the ids of ``RAG.query``. Returns (server, launches, answers); the
    server stays up for phase 8(d)."""
    loaded.use_sharded_engine = False
    httpd, _ = start_server(loaded)
    if httpd.rag_state.batcher is not None:
        fail("the staged server has a micro-batcher")
    n = len(queries)
    torch.cuda.synchronize()
    staged_counts_reset()
    out = load_client(httpd.server_address[1], "/query", [{"query": q} for q in queries],
                      sequential=True)
    launches = staged_counts()
    bad = [(s, b) for s, _, b in out if s != 200]
    if bad:
        fail(f"staged server: {len(bad)} requests failed, e.g. {bad[:2]}")
    lat = [t for _, t, _ in out]
    t0 = time.perf_counter()
    direct = [loaded.query(q) for q in queries]
    torch.cuda.synchronize()
    direct_ms = (time.perf_counter() - t0) / n * 1e3
    log(f"staged server: {n} POST /query one after another from another process, p50 "
        f"{percentile_ms(lat, 50):.2f} ms, p99 {percentile_ms(lat, 99):.2f} ms (RAG.query "
        f"alone {direct_ms:.2f} ms a query); kernel launches {launches}; card {card}")
    want = {k: 0 for k in launches}
    want.update(dense_scores=n, maxsim_scores=n)
    if launches != want:
        fail(f"staged server: kernel launches {launches}, expected {want}")
    if [[c for c, _ in a] for a in pairs(direct)] != \
            [[c for c, _ in a] for a in http_pairs([b for _, _, b in out])]:
        fail("staged server: the answers' ids differ from RAG.query's")
    log(f"staged server: the ids of all {n} answers equal RAG.query's")
    return httpd, launches, direct


def rerank_check(port: int, loaded, query: str, docs, card: str) -> dict:
    """One POST /rerank from the load client: the MaxSim bf16 body launched once,
    every score within FUSED_ATOL of the plain version on the same tokens on the
    card."""
    from triple_hybrid_rag_tpu_torch.ops.maxsim import (
        calibrate_maxsim,
        maxsim_scores,
        maxsim_scores_plain,
    )
    from triple_hybrid_rag_tpu_torch.retrieval import maxsim_query_weights

    torch.cuda.synchronize()
    staged_counts_reset()
    [(status, secs, body)] = load_client(port, "/rerank", [{"query": query, "documents": docs}])
    ms = secs * 1e3
    launches = staged_counts()
    if status != 200 or body.get("scorer") != "maxsim" or len(body["results"]) != len(docs):
        fail(f"/rerank answered {status}: {str(body)[:300]}")
    want = {k: 0 for k in launches}
    want["maxsim_scores"] = 1
    if launches != want:
        fail(f"/rerank with {len(docs)} documents: kernel launches {launches}, expected {want}")
    cfg, dev = loaded.config, loaded.device
    emb = loaded.ingestor.embedder.inner
    dt = np.asarray(emb.token_embeddings(docs, max_tokens=cfg.maxsim_doc_tokens, dim=cfg.maxsim_dim),
                    np.float32)
    qt = np.asarray(emb.token_embeddings([query], max_tokens=cfg.maxsim_query_tokens,
                                         dim=cfg.maxsim_dim), np.float32)[0]
    qw = (np.linalg.norm(qt, axis=-1) > 0).astype(np.float32)
    qw *= maxsim_query_weights(query, loaded.retriever.analyzer, cfg.maxsim_query_tokens)
    args = (torch.from_numpy(dt).to(dev, torch.bfloat16),
            torch.from_numpy(np.linalg.norm(dt, axis=-1) > 0).to(dev),
            torch.arange(len(docs), device=dev)[None],
            torch.from_numpy(qt).to(dev)[None], torch.from_numpy(qw).to(dev)[None])
    plain = calibrate_maxsim(maxsim_scores_plain(*args)[0], emb.maxsim_calibration).cpu().numpy()
    got = np.zeros(len(docs), np.float32)
    for r in body["results"]:
        got[r["index"]] = r["relevance_score"]
    err = float(np.abs(got - plain).max())
    # the kernel alone at this shape (launches after the counters were read)
    k_ms, p_ms = time_ms(lambda: maxsim_scores(*args)), time_ms(lambda: maxsim_scores_plain(*args))
    log(f"/rerank, 1 query x {len(docs)} documents (K = {len(docs)} at B = 1, Td {dt.shape[1]}, "
        f"D {dt.shape[2]}, Tq {qt.shape[0]}): {ms:.2f} ms a request; the MaxSim kernel "
        f"{k_ms:.4f} ms, its plain version {p_ms:.4f} ms; max abs err {err:.3g} (atol {FUSED_ATOL}); "
        f"top score {body['results'][0]['relevance_score']:.4f}; card {card}")
    if not err <= FUSED_ATOL:
        fail(f"/rerank: the MaxSim kernel's scores differ from the plain version's by {err}")
    return launches


def serve_routes(httpd, loaded, queries, direct, card: str) -> dict:
    """Phase 8(d): /rerank at K = 50 and K = 400, /ingest then a /query that finds
    the new text, /healthz, /stats, /metrics, and the agent tools (a search with
    the first query that ``direct``, its answers, did not refuse)."""
    from collections import Counter

    from triple_hybrid_rag_tpu_torch.tools import make_knowledge_tools

    port = httpd.server_address[1]
    base = f"http://127.0.0.1:{port}"
    texts = loaded.ingestor.corpus.parent_texts()
    launches: dict = {}
    for k in (50, 400):
        docs = [texts[i] for i in np.linspace(0, len(texts) - 1, k).astype(int)]
        add_counts(launches, rerank_check(port, loaded, queries[0], docs, card))
    new = ("Quarkwise lumbervanes tabulate the hexfold drizzlecounts of every pelmanic "
           "archive twice a fortnight.")
    status, body = http(base, "/ingest", {"text": new, "name": "quarkwise.txt"})
    if status != 200 or body.get("status") != "completed":
        fail(f"/ingest answered {status}: {body}")
    status, found = http(base, "/query", {"query": "quarkwise lumbervanes tabulate drizzlecounts"})
    if status != 200 or not found["results"] or found["results"][0]["doc_id"] != body["doc_id"]:
        fail(f"/query after /ingest did not find the new text: {status} {str(found)[:300]}")
    for route in ("/healthz", "/stats", "/metrics"):
        status, out = http(base, route)
        if status != 200:
            fail(f"GET {route} answered {status}")
    if "server_engine_batches_total" not in out or "server_rerank_ms_bucket" not in out:
        fail("/metrics lacks the server's metrics")
    tools = make_knowledge_tools(loaded)
    search = tools.call("search_knowledge_base",
                        query=next(q for q, r in zip(queries, direct) if not r.refused))
    if not search.get("success") or not search.get("sources"):
        fail(f"search_knowledge_base: {str(search)[:300]}")
    store = loaded.ingestor.entity_store
    related = {r.subject_id for r in store.relations} | {r.object_id for r in store.relations}
    counts = Counter(m.entity_id for m in store.mentions if m.entity_id in related)
    top_id, n_mentions = counts.most_common(1)[0]
    name = next(e.canonical_name for e in store.entities.values() if e.entity_id == top_id)
    look = tools.call("lookup_entity", name=name)
    if not look.get("success") or not look["entities"] or not look["entities"][0]["related"]:
        fail(f"lookup_entity({name!r}): {str(look)[:300]}")
    log(f"routes: /ingest then /query found the new text; /healthz, /stats, /metrics 200; "
        f"search_knowledge_base {len(search['sources'])} sources; lookup_entity({name!r}, "
        f"{n_mentions} mentions, the most mentioned entity with relations): "
        f"{len(look['entities'][0]['related'])} related, e.g. {look['entities'][0]['related'][:3]}")
    return launches


def serve_cli(tmp: str, query: str, want, device, card: str) -> None:
    """Phase 8(e): ``python -m triple_hybrid_rag_tpu_torch query --json`` over the
    checkpoint, in a process of its own on the card (its default device): exit 0 and
    the loaded RAG's ids."""
    import os

    t0 = time.perf_counter()
    on = [] if device.type == "cuda" else ["--device", str(device)]
    out = subprocess.run(
        [sys.executable, "-m", "triple_hybrid_rag_tpu_torch", "query", "--json", "--index", tmp,
         *on, query], cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=600,
    )
    wall = time.perf_counter() - t0
    if out.returncode != 0:
        fail(f"the CLI query exited {out.returncode}: {out.stderr[-2000:]}")
    got = json.loads(out.stdout)
    log(f"CLI: python -m triple_hybrid_rag_tpu_torch query --json (a new process: the encoder "
        f"loaded, the checkpoint read, the indexes built on the card) in {wall:.2f} s wall; "
        f"{len(got['results'])} results; card {card}")
    same_ids("CLI query against the loaded RAG's", [want],
             [[(x["chunk_id"], x["score"]) for x in got["results"]]], 1e-3)


def serving_path(ctx, card: str) -> dict:
    """Phase 8: the serving surface on phase 6's RAG. Returns the launches of the
    served paths (8b, 8c, 8d) by kernel."""
    import tempfile

    _, queries, _ = ctx
    launches: dict = {}
    with tempfile.TemporaryDirectory(prefix="thr-ckpt-") as tmp:
        loaded = serve_checkpoint(ctx, tmp, card)
        add_counts(launches, serve_batched(loaded, queries, card))
        httpd, part, direct = serve_staged(loaded, queries[:32], card)
        add_counts(launches, part)
        try:
            add_counts(launches, serve_routes(httpd, loaded, queries, direct, card))
        finally:
            stop_server(httpd)
        serve_cli(tmp, queries[0], pairs(direct)[0], loaded.device, card)
    return launches


def maxsim_counts_reset() -> None:
    from triple_hybrid_rag_tpu_torch.ops.maxsim import maxsim_scores

    maxsim_scores.launches_by_tokens = dict.fromkeys(maxsim_scores.launches_by_tokens, 0)


def maxsim_body_launches(body: str, label: str, state) -> int:
    """The MaxSim launches by token dtype since the last reset: the configuration's
    body must have run, and no other. Prints the token store's device GB."""
    from triple_hybrid_rag_tpu_torch.ops.maxsim import maxsim_scores

    by_tokens = dict(maxsim_scores.launches_by_tokens)
    log(f"{label}: MaxSim launches by token store {by_tokens}; store {state.maxsim_tokens.dtype} "
        f"{tuple(state.maxsim_tokens.shape)}, device GB {state.nbytes()['maxsim'] / 1e9:.4f} "
        f"with the mask")
    if by_tokens[body] < 1 or sum(by_tokens.values()) != by_tokens[body]:
        fail(f"{label}: the {body} MaxSim body was not the one launched: {by_tokens}")
    return by_tokens[body]


def device_self_ms(e) -> float:
    """A profiler event's own device time in ms."""
    return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0)) / 1e3


def stage_profile(eng, args, label: str, texts: bool = False) -> float:
    """Device time per engine stage and per kernel over a few batches
    (torch.profiler; the profiler's own cost is in the wall time). ``args`` are
    prepared batches, or with ``texts`` batches of query texts that
    ``prepare_queries`` prepares inside the window (its ``engine.encode`` stage
    included). Returns the device busy ms per batch (the sum of the kernels' times)
    and leaves each stage's kernel ms per batch in ``STAGE_MS``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for a in args:
            eng.run(eng.prepare_queries(a)[1] if texts else a)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    from torch.autograd import DeviceType

    events = prof.key_averages()

    def dev_total(e):
        return getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0)) / 1e3

    dev_self = device_self_ms
    # device-side events are the kernels and memory ops, plus one span per stage
    # range (first kernel start to last kernel end, gaps included)
    on_dev = [e for e in events if e.device_type == DeviceType.CUDA]
    kernels = [e for e in on_dev if not e.key.startswith("engine.")]
    busy = sum(dev_self(e) for e in kernels)
    if busy <= 0:
        log(f"profile ({label}): the profiler recorded no device time (not measured)")
        return float("nan")
    n = len(args)
    width = (len(args[0]) if texts else args[0].q_vec.shape[0]) if args else 0
    log(f"profile ({label}) over {n} batches of {width}: wall {wall_ms / n:.3f} ms/batch, device busy "
        f"{busy / n:.3f} ms/batch ({100 * busy / wall_ms:.1f} % of wall, idle "
        f"{100 * max(0.0, 1 - busy / wall_ms):.1f} %)")
    # the profiler attributes to a stage's range the kernels that PyTorch's own ops
    # launch inside it; a kernel launched through ctypes is in the kernel list but in
    # no range, so the package's kernels are added to their stage by name
    own_ms = {stage: sum(dev_self(e) for e in kernels if any(w in e.key for w in words))
              for stage, words in OWN_KERNELS.items()}
    STAGE_MS.clear()
    for e in events:
        if not e.key.startswith("engine."):
            continue
        if e.device_type == DeviceType.CUDA:
            log(f"  stage {e.key}: device span {dev_self(e) / n:.3f} ms/batch")
        else:
            ops, mine = dev_total(e) / n, own_ms.get(e.key, 0.0) / n
            STAGE_MS[e.key] = ops + mine
            log(f"  stage {e.key}: kernels {ops + mine:.3f} ms/batch ({ops:.3f} of PyTorch's ops + "
                f"{mine:.3f} hand-written), host {e.cpu_time_total / 1e3 / n:.3f} ms/batch")
    # the twelve longest, and the package's own kernels wherever they stand
    ranked = sorted(kernels, key=dev_self, reverse=True)
    own = [e for e in ranked[12:]
           if e.key.removeprefix("void ").startswith("(anonymous namespace)::")]
    for e in ranked[:12] + own:
        log(f"  kernel {dev_self(e) / n:8.3f} ms/batch x{e.count // n:<4d} {e.key[:110]}")
    return busy / n


def main() -> int:
    if not torch.cuda.is_available():
        print("CUDA is not available: this smoke test needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from triple_hybrid_rag_tpu_torch.kernels import build

    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    t0 = time.time()
    build.build()
    log(f"kernels built in {time.time() - t0:.1f} s (one nvcc per source, in parallel; phase 1)")
    for name, text in build.BUILD_LOGS.items():
        for line in text.splitlines():
            # registers, spills, and any warning (ptxas says so when it serializes
            # wgmma, which breaks the pipeline though results stay right)
            if any(word in line for word in ("registers", "spill", "arning", "serializ")):
                log(f"  ptxas {name}: {line.strip()}")

    t_phase = time.time()
    gen = torch.Generator(device=dev).manual_seed(1234)
    data = DenseInputs(dev, gen)
    bucket_maxima_edge_sweep(dev, gen)
    kernels = [check_fused(data), check_int(data, "int8"), check_int(data, "int4")]
    dense = check_dense(data)
    f32_bodies = check_f32(data, dev, gen)
    del data
    torch.cuda.empty_cache()
    kernels += [*check_maxsim(dev, gen), check_termtable(dev, gen), dense]
    for k in kernels:
        k.update(f32_bodies.get(k["name"], {}))
    log(f"phase 2 wall time {time.time() - t_phase:.1f} s")
    launches, run = main_path(dev, card)
    torch.cuda.empty_cache()
    t_phase = time.time()
    launches["ingest"], stdlib = ingest_path(dev, card)
    log(f"phase 6 wall time {time.time() - t_phase:.1f} s")
    t_phase = time.time()
    staged = staged_stdlib(stdlib, card)
    add_counts(staged, staged_synthetic(run, card))
    add_counts(staged, staged_configs(run, card))
    del run
    torch.cuda.empty_cache()
    log(f"phase 7 wall time {time.time() - t_phase:.1f} s; staged launches {staged}")
    t_phase = time.time()
    served = serving_path(stdlib, card)
    del stdlib
    log(f"phase 8 wall time {time.time() - t_phase:.1f} s; serve launches {served}")
    ivf_bodies = {"maxsim_scores": "bf16", "maxsim_scores_int8": "int8"}
    for k in kernels:
        k["launches"] = launches[k["name"]]
        for path in ("default_config", "f32_rows", "ingest"):
            if k["name"] in launches[path]:
                k[f"{path}_launches"] = launches[path][k["name"]]
        if k["name"] in ivf_bodies:
            k["ivf_launches"] = launches["ivf"][ivf_bodies[k["name"]]]
        k["staged_launches"] = staged.get(k["name"], 0)
        k["serve_launches"] = served.get(k["name"], 0)
    log(f"total wall time {time.time() - T_START:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
