"""The flat BM25 gather against its windowed formulation, at a benchmark cell's size.

    python3 scripts/check_tiered_bm25.py --workload rag1m-bf16.batch128 --seed 7 --batches 12
    python3 scripts/check_tiered_bm25.py --workload rag1m-int8.staged --seed 7 --queries 300

builds the cell's inputs and index as ``perfbench/run.py`` does, prepares
``--batches`` batches of the cell's texts through ``Engine.prepare_queries``, and
runs the df-tiered BM25 top-k of each batch two ways: ``score_postings_topk_tiered``
(each slot's valid postings gathered exactly into one flat array) and the windowed
formulation it replaced (``gather_windows`` of ``l_small`` / ``l_max`` per slot, then
``sparse_topk_from_windows``). Ids must be equal and scores equal bit for bit. It
prints, per batch, the flat entries (``rag_metrics``' ``bm25_tiered_entries_total``), the
windowed op's entries, and each op's device milliseconds (CUDA events), then the
medians.

A cell whose traffic drives the staged path (``"driver": "staged"``) checks the staged
lexical channel instead: ``--queries`` of the cell's texts, each planned by the
``Retriever`` the benchmark builds, its keywords encoded into the query's padded term
vector, then ``lexical_search_sorted`` (every slot's stored postings gathered exactly)
against the windowed op it replaced (``score_postings_topk_pre``, ``l_max`` a slot) at
the plan's ``lexical_top_k``. It prints each query's flat entries (the
``path="staged"`` series of ``bm25_tiered_entries_total``) and both paths' device
milliseconds (CUDA events; the flat path's one host read of its size falls inside),
then the entries' mean, p95 and max and each path's mean and median ms. Queries
without a keyword take no lexical channel and are skipped.

Exits 1 on any difference. It needs a CUDA card.
"""

from __future__ import annotations

import argparse
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def windowed(st, a, l_small: int, top_k: int, row_mask=None):
    """The windowed formulation: an ``l_small`` window a small-tier slot, ``l_max``
    a large-tier slot, the (doc, original slot) sort over all of them."""
    import torch

    from triple_hybrid_rag_tpu_torch.ops.bm25 import gather_windows, sparse_topk_from_windows

    csr = (st.lex_offsets, st.lex_lengths, st.lex_pd, st.lex_pt)
    b = a.qs_terms.shape[0]
    parts = []
    for terms, slots, w in ((a.qs_terms, a.qs_slots, l_small), (a.ql_terms, a.ql_slots, st.lex_l_max)):
        d, c = gather_windows(*csr, terms, w, st.n_pad)
        s = slots.long()[:, :, None].expand(-1, -1, w)
        parts.append((d.reshape(b, -1), s.reshape(b, -1), c.reshape(b, -1)))
    docs, slots, contribs = (torch.cat(x, 1) for x in zip(*parts))
    q_slots = a.qs_terms.shape[1] + a.ql_terms.shape[1]
    return sparse_topk_from_windows(docs, slots, contribs, q_slots, st.n_pad, top_k, row_mask)


def timed(fn):
    """(fn's result, device ms) with CUDA events around it."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--batches", type=int, default=12)
    ap.add_argument("--queries", type=int, default=300, help="staged cells: queries checked")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from perfbench.lib.cell import load_benchmark, resolve
    from perfbench.lib.generator import build_corpus, make_texts
    from perfbench.lib.system import build_system
    from triple_hybrid_rag_tpu_torch.observability import rag_metrics
    from triple_hybrid_rag_tpu_torch.ops.bm25 import score_postings_topk_tiered

    entries_total = rag_metrics.counter("bm25_tiered_entries_total")
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    cell = resolve(load_benchmark(), args.workload)
    corpus = build_corpus(cell.config["corpus"], args.seed, "cuda")
    texts, _ = make_texts(corpus, cell.traffic, args.seed)
    system = build_system(corpus, cell.config, "cuda")
    if cell.traffic["driver"] == "staged":
        return staged(system, texts, args)
    eng = system.engine()
    st, cfg = system.state, eng.config
    l_small = min(cfg.bm25_small_window, st.lex_l_max)
    width = int(cell.traffic["batch"])
    print(f"{args.workload} seed {args.seed} on {torch.cuda.get_device_name(0)}: "
          f"n_pad {st.n_pad}, l_max {st.lex_l_max}, l_small {l_small}, top_k {cfg.lexical_top_k}")
    bad, rows = 0, []
    for i in range(args.batches + 1):  # batch 0 warms both up and is not counted
        _, a = eng.prepare_queries(texts[i * width:(i + 1) * width])
        before = entries_total.value()
        (ids, vals), flat_ms = timed(lambda: score_postings_topk_tiered(
            st.lex_offsets, st.lex_lengths, st.lex_pd, st.lex_pt,
            a.qs_terms, a.qs_slots, a.ql_terms, a.ql_slots, None,
            l_small=l_small, l_max=st.lex_l_max, n_pad=st.n_pad, top_k=cfg.lexical_top_k))
        entries = int(entries_total.value() - before)
        (w_ids, w_vals), win_ms = timed(lambda: windowed(st, a, l_small, cfg.lexical_top_k))
        torch.cuda.empty_cache()
        same = bool(torch.equal(ids, w_ids)) and bool(torch.equal(
            vals.contiguous().view(torch.int32), w_vals.contiguous().view(torch.int32)))
        bad += not same
        window_entries = a.qs_terms.numel() * l_small + a.ql_terms.numel() * st.lex_l_max
        print(f"batch {i}: flat entries {entries}, windowed entries {window_entries}, "
              f"flat {flat_ms:.3f} ms, windowed {win_ms:.3f} ms, "
              f"found {int((ids >= 0).sum())}, equal {same}")
        if i:
            rows.append((entries, flat_ms, win_ms))
    ent, fl, wi = zip(*rows)
    print(f"median over {len(rows)} batches: flat entries {statistics.median(ent):.0f} "
          f"(min {min(ent)}, max {max(ent)}), flat {statistics.median(fl):.3f} ms, "
          f"windowed {statistics.median(wi):.3f} ms; batches that differ: {bad}")
    return 1 if bad else 0


def staged(system, texts, args) -> int:
    """The staged mode: one query at a time, flat against windowed."""
    import numpy as np
    import torch

    from triple_hybrid_rag_tpu_torch.index.bm25_index import lexical_search_sorted
    from triple_hybrid_rag_tpu_torch.observability import rag_metrics
    from triple_hybrid_rag_tpu_torch.ops.bm25 import score_postings_topk_pre

    st = system.state
    planner = system.retriever().planner
    entries_total = rag_metrics.counter("bm25_tiered_entries_total")
    staged_series = {"path": "staged"}
    print(f"{args.workload} seed {args.seed} on {torch.cuda.get_device_name(0)}: n_pad "
          f"{st.n_pad}, l_max {st.lex_l_max}, {st.config.max_query_terms} query slots "
          f"({st.config.max_query_terms * st.lex_l_max} windowed entries a query)")
    bad, rows, skipped = 0, [], 0
    for i, text in enumerate(texts[:args.queries + 1]):  # query 0 warms both up
        plan = planner.plan(text)
        if not plan.keywords:
            skipped += 1
            continue
        qt = torch.from_numpy(st.encode_query(plan.keywords)).to(st.device)
        k = plan.lexical_top_k
        before = entries_total.value(staged_series)
        (ids, vals), flat_ms = timed(lambda: lexical_search_sorted(st, qt, k))
        entries = int(entries_total.value(staged_series) - before)
        (w_ids, w_vals), win_ms = timed(lambda: score_postings_topk_pre(
            st.lex_offsets, st.lex_lengths, st.lex_pd, st.lex_pt, qt,
            l_max=st.lex_l_max, n_pad=st.n_pad, top_k=k))
        same = bool(torch.equal(ids, w_ids)) and bool(torch.equal(
            vals.contiguous().view(torch.int32), w_vals.contiguous().view(torch.int32)))
        bad += not same
        print(f"query {i}: terms {int((qt >= 0).sum())}, flat entries {entries}, flat "
              f"{flat_ms:.3f} ms, windowed {win_ms:.3f} ms, found {int((ids >= 0).sum())}, "
              f"equal {same}")
        if i:
            rows.append((entries, flat_ms, win_ms))
    torch.cuda.empty_cache()
    ent, fl, wi = (np.array(x) for x in zip(*rows))
    print(f"over {len(rows)} queries ({skipped} without a keyword skipped): flat entries "
          f"mean {ent.mean():.0f}, p95 {np.percentile(ent, 95):.0f}, max {ent.max()}; flat "
          f"mean {fl.mean():.3f} ms, median {np.median(fl):.3f}; windowed mean "
          f"{wi.mean():.3f} ms, median {np.median(wi):.3f}; queries that differ: {bad}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
