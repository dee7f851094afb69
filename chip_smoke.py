"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It

1. prints the card and its power limit, and builds the CUDA kernels
   (``triple_hybrid_rag_tpu_torch/csrc/*.cu``, one ``nvcc`` each, in parallel);
2. holds each kernel against its plain PyTorch version at the serving shapes
   (fused dense bucket maxima: N = 1,000,448 rows of width 1024 in bf16, B = 128;
   MaxSim: B = 128 x K = 50 candidates, 32 doc tokens of width 64, 16 query
   tokens) and times both;
3. drives the port's main path: the batched three-channel query program over a
   synthetic 1M-chunk corpus built on the card (the construction of ``bench.py``),
   through ``Engine.search_arrays`` and ``Engine.retrieve_batch``; checks
   self-retrieval, that both kernels were launched, the B=1 programs, and the
   bucketed matmul path against the kernel path.

Any failed check exits non-zero. The second-to-last line is a JSON object with
each kernel's launches, error and times; the last line is
``{"ok": true, "device": {...}}``. Without CUDA it exits non-zero before printing
any result.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

N_ROWS = 1_000_000  # chunks; capacity rounds to 1,000,448 rows
DIM = 1024
BATCH = 128
N_ENTITIES = 20_000
DF_CAP = 2048
GRAPH_FRAC = 0.3
RERANK_K = 50  # rerank_top_k: MaxSim candidates per query
MAXSIM_TOKENS, MAXSIM_DIM, QUERY_TOKENS = 32, 64, 16
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet, at 700 W
BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, same source
FUSED_ATOL = 1e-4  # unit rows, f32 sums in another order than the plain matmul
MAXSIM_ATOL = 1e-5


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


def time_ms(fn, iters: int = 10, warmup: int = 2, cold_l2: bool = False) -> float:
    """Median device time of ``fn`` over ``iters`` calls (CUDA events). With
    ``cold_l2`` a 64 MB buffer is overwritten before each timed call, so the call
    finds its inputs outside the 50 MB L2 cache, as the serving path does."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda") if cold_l2 else None
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound(bytes_: float, flops: float):
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
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


def check_fused(dev, gen):
    from triple_hybrid_rag_tpu_torch.index.dense_index import dense_scores_batch
    from triple_hybrid_rag_tpu_torch.ops import fused_topk as ft
    from triple_hybrid_rag_tpu_torch.ops.topk import bucketed_masked_top_k_batch

    def bucketed_topk(m):  # the use_fused_topk=False path: bf16 GEMM, f32 out
        return bucketed_masked_top_k_batch(dense_scores_batch(emb, q), 100, valid=m,
                                           invalid_score_floor=-2.0)

    n = 1_000_448
    emb = torch.randn((n, DIM), generator=gen, device=dev)
    emb = (emb / emb.norm(dim=1, keepdim=True)).to(torch.bfloat16)
    q = torch.randn((BATCH, DIM), generator=gen, device=dev)
    q = q / q.norm(dim=1, keepdim=True)
    valid = torch.rand(n, generator=gen, device=dev) > 0.01
    coll = torch.randint(0, 3, (n,), generator=gen, device=dev, dtype=torch.int32)
    cid = torch.tensor([-1, 0, 1, 2, -2], dtype=torch.int32, device=dev).repeat(BATCH // 5 + 1)[:BATCH]

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
        m = valid[None, :] if not scoped else valid[None, :] & ((k[:, None] == -1) | (coll[None, :] == k[:, None]))
        ids_p, s_p = bucketed_topk(m)
        n_diff = near_ties_only(ids_k, ids_p, s_p, FUSED_ATOL)
        if n_diff < 0:
            fail("fused_dense_topk ids differ from the bucketed matmul path beyond near ties")
        log(f"fused_dense_topk ids vs bucketed matmul path: {n_diff} of {ids_k.numel()} "
            f"slots differ, all at near ties (atol {FUSED_ATOL})")

    # the float32-row variant (not on the serving path), on a slice of the rows
    e32 = emb[:65536].float()
    e = max_err(ft.bucket_maxima(e32, q, valid[:65536], coll[:65536], cid),
                ft.bucket_maxima_plain(e32, q, valid[:65536], coll[:65536], cid))
    log(f"fused_bucket_maxima f32 rows (N=65536, scoped): max |kernel - plain| = {e:.3g}")
    if not e <= FUSED_ATOL:
        fail(f"fused_bucket_maxima (f32 rows) disagrees with its plain version ({e})")
    del e32

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
    del emb, valid, coll
    torch.cuda.empty_cache()
    return {
        "name": "fused_bucket_maxima", "route": "cuda",
        "source": "triple_hybrid_rag_tpu_torch/csrc/fused_topk.cu",
        "replaces": "triple_hybrid_rag_tpu/ops/pallas/fused_topk.py:252",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": None, "matmul_ms": matmul_ms,
        "topk_ms": topk_ms, "bucketed_topk_ms": bucketed_ms,
    }


def check_maxsim(dev, gen):
    from triple_hybrid_rag_tpu_torch.ops import maxsim as mx

    p_rows = 200_704
    tokens = torch.randn((p_rows, MAXSIM_TOKENS, MAXSIM_DIM), generator=gen, device=dev)
    tokens = (tokens / tokens.norm(dim=-1, keepdim=True)).to(torch.bfloat16)
    tok_mask = torch.rand((p_rows, MAXSIM_TOKENS), generator=gen, device=dev) > 0.2
    tok_mask[::97] = False  # parents without any token score 0
    parent = torch.randint(0, p_rows, (BATCH, RERANK_K), generator=gen, device=dev)
    parent[:, -5:] = -1  # invalid candidates
    q = torch.randn((BATCH, QUERY_TOKENS, MAXSIM_DIM), generator=gen, device=dev)
    q = (q / q.norm(dim=-1, keepdim=True)).half().float()  # the f16 query wire
    w = torch.ones((BATCH, QUERY_TOKENS), device=dev)
    w[:, 10:12] = 0.25
    w[:, 12:] = 0.0

    got = mx.maxsim_scores(tokens, tok_mask, parent, q, w)
    want = mx.maxsim_scores_plain(tokens, tok_mask, parent, q, w)
    torch.cuda.synchronize()
    err = max_err(got, want)
    log(f"maxsim_scores: max |kernel - plain| = {err:.3g}")
    if not err <= MAXSIM_ATOL:
        fail(f"maxsim_scores disagrees with its plain version ({err})")
    ms = time_ms(lambda: mx.maxsim_scores(tokens, tok_mask, parent, q, w), iters=50, cold_l2=True)
    plain_ms = time_ms(lambda: mx.maxsim_scores_plain(tokens, tok_mask, parent, q, w), iters=20,
                       cold_l2=True)
    ok = parent >= 0
    n_valid = int(ok.sum())
    live_tokens = int(tok_mask[parent.clamp(min=0)][ok].sum())
    b_ms, b_by = bound(
        n_valid * MAXSIM_TOKENS * (MAXSIM_DIM * 2 + 1) + BATCH * RERANK_K * (8 + 4)
        + BATCH * QUERY_TOKENS * (MAXSIM_DIM + 1) * 4,
        2.0 * live_tokens * QUERY_TOKENS * MAXSIM_DIM,
    )
    log(f"maxsim_scores B={BATCH} K={RERANK_K} Td={MAXSIM_TOKENS} D={MAXSIM_DIM} Tq={QUERY_TOKENS}: "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    del tokens, tok_mask
    torch.cuda.empty_cache()
    return {
        "name": "maxsim_scores", "route": "cuda",
        "source": "triple_hybrid_rag_tpu_torch/csrc/maxsim.cu",
        "replaces": "triple_hybrid_rag_tpu/ops/pallas/maxsim_kernel.py:67",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": None,
    }


# ---------------------------------------------------------------- phase 3


def main_path(dev, card):
    from triple_hybrid_rag_tpu_torch.config import RAGConfig
    from triple_hybrid_rag_tpu_torch.engine import Engine
    from triple_hybrid_rag_tpu_torch.ops.fused_topk import bucket_maxima
    from triple_hybrid_rag_tpu_torch.ops.maxsim import maxsim_scores
    from triple_hybrid_rag_tpu_torch.synthetic import build_synthetic, make_query_texts

    cfg = RAGConfig(
        capacity_round=1024, embedding_dim=DIM, embedding_dim_full=DIM,
        embedding_dtype="bfloat16", use_fused_topk=None,
        maxsim_doc_tokens=MAXSIM_TOKENS, maxsim_dim=MAXSIM_DIM,
        maxsim_query_tokens=QUERY_TOKENS, safety_threshold=0.0, graph_enabled=True,
        graph_max_entities_per_chunk=4, lexical_backend="sorted", bm25_df_cap=DF_CAP,
        embedder_backend="bowhash",
    )
    t0 = time.time()
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
    bucket_maxima.launches = 0
    maxsim_scores.launches = 0
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
    launches = {"fused_bucket_maxima": bucket_maxima.launches, "maxsim_scores": maxsim_scores.launches}
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
    return launches


def stage_profile(eng, args, label: str) -> float:
    """Device time per engine stage and per kernel over a few batches
    (torch.profiler; the profiler's own cost is in the wall time). Returns the
    device busy ms per batch (the sum of the kernels' times)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for a in args:
            eng.run(a)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    from torch.autograd import DeviceType

    events = prof.key_averages()

    def dev_total(e):
        return getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0)) / 1e3

    def dev_self(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0)) / 1e3

    # device-side events are the kernels and memory ops, plus one span per stage
    # range (first kernel start to last kernel end, gaps included)
    on_dev = [e for e in events if e.device_type == DeviceType.CUDA]
    kernels = [e for e in on_dev if not e.key.startswith("engine.")]
    busy = sum(dev_self(e) for e in kernels)
    if busy <= 0:
        log(f"profile ({label}): the profiler recorded no device time (not measured)")
        return float("nan")
    n = len(args)
    log(f"profile ({label}) over {n} batches of {BATCH}: wall {wall_ms / n:.3f} ms/batch, device busy "
        f"{busy / n:.3f} ms/batch ({100 * busy / wall_ms:.1f} % of wall, idle "
        f"{100 * max(0.0, 1 - busy / wall_ms):.1f} %)")
    for e in events:
        if not e.key.startswith("engine."):
            continue
        if e.device_type == DeviceType.CUDA:
            log(f"  stage {e.key}: device span {dev_self(e) / n:.3f} ms/batch")
        else:
            log(f"  stage {e.key}: kernels {dev_total(e) / n:.3f} ms/batch, "
                f"host {e.cpu_time_total / 1e3 / n:.3f} ms/batch")
    for e in sorted(kernels, key=dev_self, reverse=True)[:12]:
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
    log(f"kernels built in {time.time() - t0:.1f} s (one nvcc per source, in parallel)")
    for name, text in build.BUILD_LOGS.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    gen = torch.Generator(device=dev).manual_seed(1234)
    kernels = [check_fused(dev, gen), check_maxsim(dev, gen)]
    launches = main_path(dev, card)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
