"""``thr-torch`` command-line interface: ingest / query / stats / metrics / eval /
migrate / serve / train-encoder, on the card.

The port of the JAX package's ``cli.py``, with its arguments, output and exit codes::

    thr-torch ingest path/ --index ./index          # ingest files, checkpoint the index
    thr-torch query "payment terms" --index ./index # one-shot query
    thr-torch query --interactive --index ./index   # REPL
    thr-torch stats --index ./index
    thr-torch serve --port 8400 --index ./index     # HTTP server (--engine: micro-batched)
    thr-torch eval [--stdlib] [--json]              # retrieval-quality ladder
    thr-torch train-encoder --steps 2000            # -> build/models/encoder.npz

(``python -m triple_hybrid_rag_tpu_torch ...`` is the same.) Every subcommand that
builds a RAG or a retriever runs it on the card; ``--device cpu`` runs the plain
PyTorch path on the CPU instead. ``bench`` drives a module that is not ported
yet: it exits 2 and says so.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--index", default="./thr_index", help="checkpoint directory")
    p.add_argument("--json", action="store_true", help="machine-readable output")
    _add_device(p)


def _add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: the first CUDA card; "
                        "'cpu' for the CPU)")


def cmd_ingest(args: argparse.Namespace) -> int:
    from .facade import RAG

    index_dir = Path(args.index).resolve()
    rag = (
        RAG.load(index_dir, device=args.device)
        if (index_dir / "manifest.json").exists()
        else RAG(device=args.device)
    )
    results = []
    for target in args.paths:
        t = Path(target)
        if t.is_dir():
            # never re-ingest the index's own checkpoint artifacts
            files = [
                p for p in sorted(t.rglob("*"))
                if p.is_file() and index_dir not in p.resolve().parents
            ]
        else:
            files = [t]
        for p in files:
            # per-file guard: one missing/broken path must not discard the
            # whole run's already-ingested work before rag.save() below
            try:
                results.append(rag.ingest(p, force=args.force))
            except Exception as e:
                from .types import IngestionResult, IngestionStatus

                results.append(IngestionResult(
                    doc_id="", filename=str(p),
                    status=IngestionStatus.FAILED, error=f"{type(e).__name__}: {e}",
                ))
    rag.save(index_dir)
    for r in results:
        if args.json:
            print(json.dumps({
                "file": r.filename, "status": r.status.value, "skipped": r.skipped,
                "parents": r.n_parents, "children": r.n_children,
                "entities": r.n_entities, "error": r.error,
            }))
        else:
            flag = "SKIP" if r.skipped else r.status.value.upper()
            print(f"[{flag}] {r.filename}: {r.n_parents} parents, "
                  f"{r.n_children} children, {r.n_entities} entities"
                  + (f" ({r.error})" if r.error else ""))
    failed = sum(1 for r in results if r.status.value == "failed")
    # the human summary goes to stderr under --json: stdout stays pure JSONL
    print(
        f"ingested {len(results)} file(s), {failed} failed -> {index_dir}",
        file=sys.stderr if args.json else sys.stdout,
    )
    return 1 if failed else 0


def _print_result(result, as_json: bool, verbose: bool = False) -> None:
    if as_json:
        print(json.dumps({
            "query": result.query,
            "refused": result.refused,
            "refusal_reason": result.refusal_reason,
            "max_score": result.max_score,
            "timings_ms": result.timings,
            "results": [
                {
                    "chunk_id": r.chunk_id, "score": r.final_score,
                    "channels": list(r.source_channels),
                    "heading": r.section_heading, "text": r.text,
                }
                for r in result.results
            ],
        }))
        return
    if result.refused:
        print(f"REFUSED: {result.refusal_reason}")
        return
    if verbose:
        from .observability.latency_viz import render_waterfall

        print(render_waterfall(result.timings))
    for i, r in enumerate(result.results, 1):
        chans = "+".join(r.source_channels) or "-"
        head = f" [{r.section_heading}]" if r.section_heading else ""
        print(f"{i}. ({r.final_score:.3f}) [{chans}]{head}")
        print("   " + r.text[:300].replace("\n", " "))
    t = result.timings.get("total_ms")
    if t is not None:
        print(f"-- {len(result.results)} results in {t:.1f} ms")


def cmd_query(args: argparse.Namespace) -> int:
    from .facade import RAG

    rag = RAG.load(Path(args.index), device=args.device)
    if args.interactive or not args.query:
        print("thr interactive query (empty line to exit)")
        while True:
            try:
                q = input("query> ").strip()
            except (EOFError, KeyboardInterrupt):
                break
            if not q:
                break
            _print_result(rag.query(q, top_k=args.top_k), args.json, args.verbose)
        return 0
    _print_result(
        rag.query(" ".join(args.query), top_k=args.top_k), args.json, args.verbose
    )
    return 0


def cmd_stats(args: argparse.Namespace) -> int:
    from .facade import RAG

    rag = RAG.load(Path(args.index), device=args.device)
    stats = rag.stats()
    if args.json:
        print(json.dumps(stats))
    else:
        for k, v in stats.items():
            print(f"{k}: {v}")
    return 0


def cmd_metrics(args: argparse.Namespace) -> int:
    from .observability import rag_metrics

    print(rag_metrics.prometheus_text())
    return 0


def cmd_eval(args: argparse.Namespace) -> int:
    """Quality ladder over the five BASELINE configs; ``--stdlib`` switches to the
    independent inverse-cloze corpus of docstrings (``--sources``: the standard
    library and/or installed package names)."""
    if args.stdlib:
        from .eval import evaluate_stdlib

        sources = tuple(s.strip() for s in args.sources.split(",") if s.strip())
        results = evaluate_stdlib(
            k=args.k, n_docs=args.stdlib_docs, sources=sources, device=args.device
        )
    else:
        from .eval import evaluate_baseline_configs

        results = evaluate_baseline_configs(
            k=args.k, distractors=args.distractors, hard_negatives=args.hard_negatives,
            device=args.device,
        )
    if args.json:
        print(json.dumps(results))
        return 0
    for name, m in results.items():
        print(f"{name}: recall@{args.k}={m[f'recall@{args.k}']:.3f} "
              f"ndcg@{args.k}={m[f'ndcg@{args.k}']:.3f} mrr={m['mrr']:.3f}")
    return 0


def cmd_not_ported(args: argparse.Namespace) -> int:
    """``bench``: its module (the TPU's ``bench.py``) is not ported yet."""
    print(f"thr-torch {args.command}: not ported yet (ROADMAP.md, Queue 1)", file=sys.stderr)
    return 2


def cmd_train_encoder(args: argparse.Namespace) -> int:
    """Train the default encoder configuration cold and save it to ``--out``
    (``build/models/encoder.npz`` in the checkout by default, never the packaged
    file); then print the saved file's held-out paraphrase recall@10."""
    from .models.pretrain import (
        TRAINED_PARAMS,
        load_default_encoder,
        paraphrase_recall_at_k,
        train_default_encoder,
    )

    out = args.out or TRAINED_PARAMS
    path, metrics = train_default_encoder(
        out_path=out, steps=args.steps, batch_size=args.batch_size, seed=args.seed,
        overlap_frac=args.overlap_frac, realtext_frac=args.realtext_frac,
        log_every=args.log_every, device=args.device,
    )
    print(f"saved {path} (final loss {metrics['loss']:.4f}, acc {metrics['accuracy']:.3f})")
    emb = load_default_encoder(path=path, device=args.device)
    if emb is not None:
        r = paraphrase_recall_at_k(emb, k=10)
        print(f"held-out paraphrase recall@10 (dense-only): {r:.3f}")
    return 0


def cmd_migrate(args: argparse.Namespace) -> int:
    """Backfill/migration: checkpoint -> (new config, optional re-embed) -> checkpoint.

    Loads a saved index, optionally re-derives the device indexes under new
    dims/dtype from the stored full-dim embeddings (cheap), or re-embeds every stored
    chunk text with the new config's embedder on the device (``--reembed``, the full
    backfill), then writes a fresh verified checkpoint."""
    from .index.checkpoint import load_ingestor, save_ingestor

    overrides = {}
    if args.dim is not None:
        overrides["embedding_dim"] = args.dim
    if args.dim_full is not None:
        overrides["embedding_dim_full"] = args.dim_full
    if args.dtype is not None:
        overrides["embedding_dtype"] = args.dtype
    cfg = None
    if overrides:
        # peek the saved config from the manifest (cheap) instead of loading the
        # full checkpoint twice just to call .replace() on its config
        from .config import RAGConfig
        from .index.checkpoint import MANIFEST

        manifest = json.loads((Path(args.src) / MANIFEST).read_text())
        raw = dict(manifest.get("config") or {})
        for key in ("mesh_shape", "mesh_axis_names", "analyzer_languages"):
            if key in raw and isinstance(raw[key], list):
                raw[key] = tuple(raw[key])
        base_cfg = RAGConfig(**raw) if raw else RAGConfig()
        cfg = base_cfg.replace(**overrides)
    ing = load_ingestor(
        args.src, config=cfg, allow_pickle=args.allow_pickle, device=args.device
    )
    n = len(ing.corpus)
    if args.reembed and n:
        texts = [c.text for c in ing.corpus.children]
        vectors = ing.embedder.embed_texts(texts)
        ing.embeddings = {
            c.chunk_id: vectors[c.row] for c in ing.corpus.children
        }
    out = save_ingestor(ing, args.dst)
    summary = {
        "src": str(args.src), "dst": str(out), "children": n,
        "parents": len(ing.corpus.parents),
        "embedding_dim": ing.config.embedding_dim,
        "embedding_dtype": ing.config.embedding_dtype,
        "reembedded": bool(args.reembed and n),
    }
    print(json.dumps(summary) if args.json else
          f"migrated {n} chunks {args.src} -> {args.dst} "
          f"(dim={ing.config.embedding_dim}, dtype={ing.config.embedding_dtype}"
          f"{', re-embedded' if summary['reembedded'] else ''})")
    return 0


def cmd_serve(args: argparse.Namespace) -> int:
    from .facade import RAG
    from .server import serve

    rag = None
    if args.engine:
        index_dir = Path(args.index)
        rag = (
            RAG.load(index_dir, use_sharded_engine=True, device=args.device)
            if (index_dir / "manifest.json").exists()
            else RAG(use_sharded_engine=True, device=args.device)
        )
    httpd = serve(
        host=args.host, port=args.port, rag=rag, index_dir=args.index,
        ingest_root=args.ingest_root,
        auth_token=args.auth_token or os.environ.get("RAG_SERVER_TOKEN") or None,
        device=args.device,
    )
    print(f"thr-torch serving on http://{args.host}:{args.port} (index: {args.index})")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="thr-torch", description=__doc__)
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("ingest", help="ingest files or directories into the index")
    p.add_argument("paths", nargs="+")
    p.add_argument("--force", action="store_true", help="re-ingest even if unchanged")
    _add_common(p)
    p.set_defaults(fn=cmd_ingest)

    p = sub.add_parser("query", help="query the index")
    p.add_argument("query", nargs="*", help="query text (omit for --interactive)")
    p.add_argument("--top-k", type=int, default=None)
    p.add_argument("--interactive", "-i", action="store_true")
    p.add_argument("--verbose", "-v", action="store_true",
                   help="print the per-stage latency waterfall")
    _add_common(p)
    p.set_defaults(fn=cmd_query)

    p = sub.add_parser("stats", help="index statistics")
    _add_common(p)
    p.set_defaults(fn=cmd_stats)

    p = sub.add_parser("metrics", help="Prometheus metrics exposition")
    p.set_defaults(fn=cmd_metrics)

    p = sub.add_parser("bench", help="run the benchmark (not ported yet)")
    p.add_argument("--n", type=int, default=None, help="corpus size")
    p.set_defaults(fn=cmd_not_ported)

    p = sub.add_parser("eval", help="retrieval-quality ladder")
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--distractors", type=int, default=30)
    p.add_argument("--hard-negatives", type=int, default=0,
                   help="per-topic confusables reusing topic vocabulary (ranking stress)")
    p.add_argument("--stdlib", action="store_true",
                   help="independent corpus: inverse-cloze over stdlib docstrings")
    p.add_argument("--stdlib-docs", type=int, default=500)
    p.add_argument("--sources", default="stdlib",
                   help="comma list of docstring corpora for --stdlib: stdlib "
                        "and/or installed package names (numpy,jax,torch,...)")
    p.add_argument("--json", action="store_true")
    _add_device(p)
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser(
        "migrate", help="backfill/migrate a checkpoint (new dims/dtype, --reembed)"
    )
    p.add_argument("src", help="source checkpoint directory")
    p.add_argument("dst", help="destination checkpoint directory")
    p.add_argument("--dim", type=int, default=None, help="new embedding_dim (Matryoshka)")
    p.add_argument("--dim-full", type=int, default=None, help="new embedding_dim_full")
    p.add_argument("--dtype", default=None,
                   choices=["bfloat16", "float32", "int8", "int4"])
    p.add_argument("--allow-pickle", action="store_true",
                   help="permit loading a legacy v1 (pickle) checkpoint — executes "
                        "code from the file; only for checkpoints you wrote")
    p.add_argument("--reembed", action="store_true",
                   help="re-embed every chunk text (full backfill, not re-truncation)")
    p.add_argument("--json", action="store_true")
    _add_device(p)
    p.set_defaults(fn=cmd_migrate)

    p = sub.add_parser(
        "train-encoder",
        help="train the default encoder on generated paraphrase pairs",
    )
    p.add_argument("--out", default=None,
                   help="output npz (default: build/models/encoder.npz in the checkout; "
                        "serve it with RAGConfig.encoder_params_path)")
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--overlap-frac", type=float, default=0.3,
                   help="fraction of random-token overlap pairs (identity prior)")
    p.add_argument("--realtext-frac", type=float, default=0.35,
                   help="fraction of real-prose inverse-cloze pairs (harvested from "
                        "TRAIN_TEXT_SOURCES packages, disjoint from eval corpora)")
    p.add_argument("--log-every", type=int, default=100,
                   help="print the loss and accuracy every this many steps (0: never)")
    _add_device(p)
    p.set_defaults(fn=cmd_train_encoder)

    p = sub.add_parser("serve", help="HTTP serving host (/query /ingest /metrics)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8400)
    p.add_argument("--index", default="./thr_index")
    p.add_argument("--engine", action="store_true",
                   help="serve through the batched engine, concurrent queries "
                        "micro-batched into one call")
    p.add_argument("--ingest-root", default=None,
                   help="allow POST /ingest {'path': ...} for files under this directory "
                        "(disabled when omitted)")
    p.add_argument("--auth-token", default=None,
                   help="require 'Authorization: Bearer <token>' on every request "
                        "(default: $RAG_SERVER_TOKEN, or no auth when unset)")
    _add_device(p)
    p.set_defaults(fn=cmd_serve)

    args = parser.parse_args(argv)
    try:
        return args.fn(args)
    except Exception as e:  # checkpoint/IO errors surface as one line, not a traceback
        from .index.checkpoint import CheckpointError

        if isinstance(e, (CheckpointError, FileNotFoundError)):
            print(f"thr-torch {args.command}: error: {e}", file=sys.stderr)
            return 2
        raise


if __name__ == "__main__":
    sys.exit(main())
