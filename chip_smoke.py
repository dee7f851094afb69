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
   queries of 16 slots; the BowHash query encode, a batch of 128 traffic-like texts
   at phase 3's widths and the default RAGConfig's, its draws bit for bit and its
   f16 outputs within one step) and times kernel, plain version and, where one
   exists, the library call, the bf16 bucket maxima also at B = 1; every kernel body is also
   held against its plain version over a list of small and ragged shapes (MaxSim
   up to 1,024 query tokens and D = 4,096, past the staged plan, each case's plan
   logged), the quantized bucket maxima bit for bit; MaxSim is also timed past its
   staged plan (``MAXSIM_PAST_STAGED``: phase 13's shape and 256 query tokens at
   the default width) beside its bound;
3. drives the port's main path: the batched three-channel query program over a
   synthetic 1M-chunk corpus built on the card (the construction of ``bench.py``),
   through ``Engine.search_arrays`` and ``Engine.retrieve_batch``; checks
   self-retrieval, that both kernels and the BowHash query encode were launched,
   the B=1 programs, and the
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
   new process on the card, with the loaded RAG's ids;
9. the document formats and the model-server boundary: (a) 300 of phase 6's
   docstrings written as files (100 PDFs with FlateDecode content streams of
   ``Tj`` and ``TJ`` lines, 100 DOCX, 100 XLSX tables of their lines, built with
   ``zlib`` and ``zipfile``) and 9 "scans" (8 PNGs and a PDF without a text layer,
   drawn in a 5x7 bitmap font and built with ``zlib`` and ``struct``): each file
   loads back to its docstring up to whitespace; the default RAGConfig ingests them
   through ``RAG(device="cuda").ingest_directory`` with the default OCR ladder (the
   scans only when it has a recognizer: without PIL it has none, as in the JAX
   package), failing on a FAILED result; self-retrieval at B = 128 through
   ``query_batch`` (the bf16 bucket maxima and MaxSim launched) and over 32 queries
   through ``RAG.query`` (the dense scores at B = 1 and MaxSim launched); a 60-file
   subset ingested on the card and on the CPU (equal chunk ids, BM25 and graph
   arrays; dense rows within ``ENCODER_ATOL``); seconds per format and the stage
   sums; (b) a stub OpenAI-compatible model server in a process of its own on
   127.0.0.1 (``MODEL_STUB``: the port's ``BowHashEmbedder``, a token-overlap
   rerank, the rule planner's and extractor's JSON, each scan's text for vision
   OCR): a RAG with every ``*_api_base`` set ingests (a)'s PDFs and the scans and
   answers at B = 128 (the host encode, the bf16 bucket maxima, no MaxSim store)
   and through ``RAG.query`` (the dense scores at B = 1, the HTTP rerank) with the
   ids of a RAG built in-process with the stub's own models, finds every scan by
   its text, and sends the stub the expected requests per route; with a dead
   server the ingest records zero vectors and completes and the staged query
   answers through the lexical channel;
10. the quality evaluation, the tool harness, the RAG 1.0 searcher and the native
   BM25 build: (a) ``eval.evaluate_baseline_configs()`` at its defaults (five
   configurations, float32 rows, the packaged encoder) with tests/test_eval.py's
   gates, the ids against the same call on the host CPU up to near ties
   (``EVAL_TIE_ATOL``), one f32 dense-scores launch (B = 1) per query with the
   semantic channel on and one MaxSim launch per query of the full pipeline;
   (b) ``evaluate_stdlib()`` at its defaults (500 docstrings of this Python's
   stdlib, 150 queries, four configurations) beside
   ``eval_results/stdlib_500_fixed.json``, build and evaluate seconds;
   (c) ``evaluate_batched`` over ``Engine`` against ``evaluate`` over ``Retriever``
   on tests/test_eval.py's corpus (equal within 1e-9), then on (b)'s corpus
   (printed), one f32 bucket-maxima launch per batch of 64; (d)
   ``evaluate_code_graph()`` (oracle graph, 200 modules), graph_on against
   graph_off; (e) ``make_bigcorpus_eval`` cut to ``N_BIGCORPUS_DOCS`` documents with
   the training-content exclusion, through the full pipeline; (f) the tool harness:
   ``default_scenarios()`` and tests/test_harness.py's scenarios over a small RAG
   of that file's fixture text, and ``default_scenarios()`` over phase 6's RAG on
   the card and (loaded from its checkpoint) on the host CPU with equal outcomes;
   (h) ``native.build_library()`` into ``build/native/``, the native BM25 arrays
   over phase 6's child texts bit-equal to the Python build, both timed; (g) the
   RAG 1.0 ``HybridSearcher`` over phase 6's corpus on the card (one dense-scores
   launch per query) against the host CPU's; (i) ``python -m
   triple_hybrid_rag_tpu_torch eval --json`` in a new process with (a)'s metrics.
11. encoder training, the visual aligner and constrained decoding: (a) the shipped
   npz at the scaled config (43M parameters) warm-started on the card and on the
   host CPU, three steps of ``make_train_step`` on the same ``make_mixed_pairs``
   batches: step 0 (lr 0) leaves the weights bit-equal, the losses agree within
   ``STEP0_RTOL`` and then ``LATER_RTOL``; (b) ``train_default_encoder`` at the
   scaled config, warm-started, ``TRAIN_STEPS`` steps of B = 128 over this host's
   real-text harvest: ms/step on the wall, the host's batch building and the
   device's span per step, peak memory, the losses; then five steps on prepared
   batches under the profiler (device busy, kernels a step); (c) ``python -m
   triple_hybrid_rag_tpu_torch train-encoder`` cold at the default configuration in
   a new process: its last 50 steps' mean loss at most 0.8 of its first 50's, its
   file in the packaged scheme and loadable, its paraphrase recall; (d) the default
   RAGConfig serving (b)'s file: the paraphrase holdout through ``query_batch`` (the
   bf16 bucket maxima and MaxSim launched), recall@10, and the shipped and the
   fine-tuned weights' ``paraphrase_recall_at_k``; (e) ``train_visual_aligner`` at
   its default config on 256 stdlib docstrings x 2 renders against the packaged
   encoder, image->text top-1 on held-out renders, the weights saved and loaded,
   ``embed_images`` through the aligner rung; (f) constrained decoding over a random
   byte-level causal LM on the card, 20 of 20 outputs valid JSON.

12. the sharded engine and the training mesh on the one card, every mesh entry
   ``cuda:0`` (the code that would place one shard per card; only the gathers stay
   on one device): (a) the mesh helpers over ``[cuda:0] * 4`` and their errors; (b)
   phase 3's 1M-row bf16 corpus as 1x2, 1x4 and 2x2 meshes, the shards views of
   the placed rows, 128 of phase 3's queries at 1x4 and 2x2 against phase 3's
   1-shard engine (final ids up to near ties, scores within ``FUSED_ATOL``,
   refusals equal, the lexical lists bit-equal); (c) the same for the int8 rows and
   the term table at 1x4; (d) IVF at 1x4 (each shard clusters its own rows): the
   semantic recall against the exact 1x4 scan beside phase 5's; (e) phase 6's
   stdlib RAG (the default ``RAGConfig``, the trained encoder) through a 1x2
   ``ShardedEngine`` against ``query_batch``; (f) one bucket-maxima launch a shard
   and one MaxSim launch a data row in a batch, and each shard's bucket maxima at
   its own shape (250,112 rows at 1x4) against the plain version; (g) program wall,
   device busy, the stage split and peak memory a batch at 1x1, 1x2, 1x4 and 2x2;
   (h) phase 11(a)'s three steps over dp 2 x tp 2 against 11(a)'s unsharded card
   steps;
13. MaxSim at shapes past its staged plan on a served path: a BowHash RAG with
   ``maxsim_query_tokens=256, maxsim_dim=1024`` over ``N_FORMAT_DOCS`` of phase 6's
   docstrings on the card and on the host CPU, 128 queries through ``query_batch``
   and 8 through ``RAG.query``: the card's ids against the host CPU's up to near
   ties, and the MaxSim kernel launched in both, every launch on its wgmma plan.
14. the port's public surface: (a) ``examples/torch_basic_usage.py`` and
   ``examples/torch_production_serving.py`` as new processes on the card, at once:
   exit 0, no JAX module loaded, the answers of the JAX examples (the gibberish query
   refused, the ``/rerank`` winner, tenant_b's collection answering with its own text,
   the int8 checkpoint answering), and the kernels of their paths launched (dense
   scores and MaxSim for the staged queries, bucket maxima and MaxSim for the
   engine); (b) ``maxsim_scores_batch`` on gathered tokens at the default RAGConfig's
   shape (B 128, K 50, Td 64, D 128, Tq 32) and at phase 13's (B 8, Tq 256, D 1024),
   bf16 and int8, about 1 candidate in 8 invalid, empty parents, a query without
   tokens: one launch on the staged and on the wgmma plan, within 1e-6 of its plain
   version and of the gather entry over the store the tokens came from, all three
   timed with a cold L2; (c) the reference's BM25 ops over term frequencies
   (``score_postings``, ``score_postings_topk``) over phase 6's stdlib index for its
   128 queries, the ids and bits of the precomputed forms, and
   ``chunk_scores_from_entities_batch`` at B = 128 over phase 3's 1,000,448-row
   chunk-entity table, the bits of ``chunk_scores_from_entities``.

Each phase prints its wall time. Any failed check exits non-zero. The second-to-last line is a JSON object with
each kernel's launches (``launches`` on phase 3's main path, ``staged_launches``
over phase 7, ``serve_launches`` over phase 8's served requests,
``formats_launches`` and ``http_launches`` over phase 9's queries,
``eval_launches`` over phase 10(a)-(f) (``eval_f32_launches``: of them, the f32-row
body's), ``legacy_launches`` over phase 10(g), ``train_launches`` over phase
11(d), ``sharded_launches`` over phase 12(b)-(e), ``repaired_launches`` over
phase 13 and ``public_launches`` over phase 14(a)-(b) (MaxSim's entries also carry
``batch_*`` times of 14(b)), and per further path; MaxSim's also by plan: ``counted_launches_by_plan``
over the windows that check its body, ``repaired_launches_by_plan`` over phase 13),
error and
times; the last line is
``{"ok": true, "device": {...}}``. Without CUDA it exits non-zero before printing
any result.
"""

import contextlib
import dataclasses
import functools
import json
import subprocess
import sys
import time
from pathlib import Path

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
# (Td, D, Tq) and parents of the MaxSim checks past the staged plan: phase 13's RAG
# (maxsim_query_tokens 256, maxsim_dim 1024) over a store of 4,096 parents (0.54 GB),
# and RAGConfig(maxsim_query_tokens=256) at the default width over the smoke
# corpus's parents
MAXSIM_GENERAL_SHAPE, N_GENERAL_PARENTS = (64, 1024, 256), 4096
MAXSIM_LONG_QUERY_SHAPE = (64, 128, 256)
# the MaxSim checks past the staged plan: label -> ((Td, D, Tq), parents)
MAXSIM_PAST_STAGED = {"general": (MAXSIM_GENERAL_SHAPE, N_GENERAL_PARENTS),
                      "long_query": (MAXSIM_LONG_QUERY_SHAPE, N_PARENTS)}
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
# (n, d, b) of the bf16 bucket-maxima edge sweep, each unscoped and scoped, within
# FUSED_ATOL: one row, rows short of a bucket, a bucket plus one, short of a 256-row
# tile, a tile plus one, 1,000, an odd count of tiles over more tiles than the card
# has SMs, and a shard of the 1x4 mesh (250,112); one query (the second consumer
# idle), 5, 64 and 65 (either side of a consumer's 64), 128, 129 and 257 (more than
# one 128-query tile); widths of 8 and 72 (short of and ragged against a 64-element
# stage), the serving width and 4096
BF16_EDGE_SHAPES = [(1, 8, 1), (15, 72, 5), (17, 1024, 64), (255, 72, 65), (257, 1024, 128),
                    (1000, 4096, 129), (1000, 72, 257), (20005, 1024, 1), (20005, 8, 65),
                    (250_112, 1024, 128), (257, 4096, 1)]
MAXSIM_ATOL = 1e-5
# (B, K, parents, Td, D, Tq) of the MaxSim edge sweep: one query and one candidate
# (every candidate invalid), Td of one token, one past a 32-token stage, past 128
# and 4096 (128 stages streamed through a warp's ring); D of 32 (the 8M
# configuration), 40 and 36 (not a multiple of 32; int8 rows TMA cannot address),
# 33 (odd), 128, and 520 (a padded row wider than a TMA box: plain loads); Tq of 1,
# 17, 32 and 128. Past the staged plan (the wgmma plan where TMA reaches the rows,
# else the general one): Tq of 129, 256 (at D 128, one stage a row, and at D 1024,
# several) and 1024; D of 1024 at Tq 64, 2048 and 4096 at Tq 16, and 1030 (rows TMA
# cannot address, a query not of 16-byte rows). At the wgmma plan's edges: Td 1, 63,
# 65 and 130 (64-token tiles whose box reaches past the parent), Tq 129, 200, 257 and
# 1024 (the N of a pass and several passes), D 136 (a k tail; int8 rows of 136 bytes
# go to the general plan) and 4096; every K is odd or leaves a query an odd number of
# valid candidates (a consumer without a candidate), and every shape has a parent
# past the store (maxsim_inputs)
MAXSIM_EDGE_SHAPES = [(1, 1, 7, 1, 32, 1), (1, 50, 64, 33, 40, 32), (3, 1, 50, 130, 128, 128),
                      (2, 5, 9, 4096, 32, 32), (128, 50, 1000, 33, 128, 1),
                      (5, 7, 20, 130, 40, 128), (2, 9, 30, 40, 33, 16), (4, 6, 25, 65, 36, 17),
                      (1, 50, 100, 64, 128, 32), (2, 3, 10, 5, 520, 1),
                      (2, 7, 20, 40, 64, 129), (3, 5, 30, 65, 128, 256), (4, 8, 30, 64, 1024, 256),
                      (1, 4, 10, 33, 32, 1024), (4, 6, 25, 64, 1024, 64), (2, 5, 15, 40, 2048, 16),
                      (2, 3, 9, 33, 4096, 16), (2, 4, 12, 35, 1030, 130),
                      (3, 7, 20, 1, 128, 129), (2, 9, 30, 63, 256, 200), (4, 5, 25, 65, 128, 257),
                      (2, 6, 15, 130, 512, 256), (1, 3, 8, 64, 128, 1024), (3, 5, 20, 64, 136, 160),
                      (2, 4, 10, 64, 4096, 129), (2, 7, 12, 64, 1024, 256)]
# edge cases whose every candidate is invalid: the first, and the last (the wgmma plan)
MAXSIM_ALL_INVALID = (0, len(MAXSIM_EDGE_SHAPES) - 1)
TERM_ATOL = 1e-5  # f32 sums of at most 16 weights below 1, in another slot order
# BowHash query encode (csrc/bowhash.cu) at the main path's widths (dense DIM,
# MaxSim QUERY_TOKENS x MAXSIM_DIM) and the default RAGConfig's (dense 2,048 cut to
# 1,024, MaxSim 32 x 128): label -> (dense width, out width, query tokens, MaxSim width)
BOWHASH_SHAPES = {"main": (DIM, DIM, QUERY_TOKENS, MAXSIM_DIM), "default": (2048, 1024, 32, 128)}
F64_FLOPS = 34e12  # f64 outside the tensor cores, H100 SXM data sheet
LEXICAL_ATOL = 1e-4  # BM25 sums of up to 16 weights of ~10, in another order
TABLE_WIDTH, QUERY_TERMS = 128, 16  # doc_term_capacity, max_query_terms
# substrings of the hand-written kernels' names, by the engine stage that launches them
OWN_KERNELS = {"engine.dense": ("bucket_max",), "engine.lexical": ("termtable_kernel",),
               "engine.tail": ("maxsim_kernel",), "engine.encode.device": ("bowhash_",)}
# the encoder's bf16 forward against its f32 forward: unit vectors, two bf16 ulps at
# 1.0 (the tolerance tests/test_torch_encoder.py states, BF16_VS_F32_ATOL)
ENCODER_ATOL = 2e-2
N_ENCODER_TEXTS = 64
T_START = time.time()
# MaxSim launches by body and plan over every counted window that checks a body
# (the windows maxsim_body_launches reads)
MAXSIM_PLAN_LAUNCHES = {"bf16": {}, "int8": {}}
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
    log(f"fused_bucket_maxima N={n} D={DIM} B={BATCH}: kernel {ms:.4f} ms ({b_ms / ms:.3f} of the "
        f"bound), plain {plain_ms:.4f} ms, bf16 GEMM with f32 out alone {matmul_ms:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by})")
    # B = 1, the engine's single-query batches: the second consumer hands its stages back
    q1 = q[:1]
    e1 = max_err(ft.bucket_maxima(emb, q1, valid), ft.bucket_maxima_plain(emb, q1, valid))
    if not e1 <= FUSED_ATOL:
        fail(f"fused_bucket_maxima at B=1 disagrees with its plain version ({e1})")
    err = max(err, e1)
    b1_ms = time_ms(lambda: ft.bucket_maxima(emb, q1, valid))
    b1_plain = time_ms(lambda: ft.bucket_maxima_plain(emb, q1, valid), iters=3, warmup=1)
    b1_bound, b1_by = bound(n * DIM * 2 + DIM * 4 + n + nb * 4, 2.0 * n * DIM)
    log(f"fused_bucket_maxima N={n} D={DIM} B=1: kernel {b1_ms:.4f} ms ({b1_bound / b1_ms:.3f} of "
        f"the bound), plain {b1_plain:.4f} ms, bound {b1_bound:.4f} ms ({b1_by}); max |kernel - "
        f"plain| = {e1:.3g}")
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
        "ms_b1": b1_ms, "plain_ms_b1": b1_plain, "bound_ms_b1": b1_bound,
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
    """The bf16, int8 and packed-int4 bucket maxima against their plain versions at
    BF16_EDGE_SHAPES and INT_EDGE_SHAPES, unscoped and scoped (collection ids -1, 0,
    1, 2 and -2, which matches nothing), and once with every row invalid, which must
    give -inf: bf16 within FUSED_ATOL, the quantized ones bit-equal. Returns the bf16
    body's worst error."""
    from triple_hybrid_rag_tpu_torch.index import dense_index as di
    from triple_hybrid_rag_tpu_torch.ops import fused_topk as ft

    quantizers = {"int8": di.quantize_rows_int8, "int4": di.quantize_rows_int4}
    worst = dict.fromkeys(("bf16", "int8", "int4"), 0.0)
    cases = dict.fromkeys(worst, 0)
    for kind in worst:
        shapes, atol = (BF16_EDGE_SHAPES, FUSED_ATOL) if kind == "bf16" else (INT_EDGE_SHAPES, 0.0)
        for n, d, b in shapes:
            if kind == "bf16":
                rows, q, scales = unit_rows(n, d, gen, dev, torch.bfloat16), unit_rows(b, d, gen, dev), ()
            else:
                rows, row_scales = quantizers[kind](torch.randn((n, d), generator=gen, device=dev))
                q, q_scale = di.quantize_queries_int8(torch.randn((b, d), generator=gen, device=dev))
                scales = (row_scales, q_scale)
            valid = torch.rand(n, generator=gen, device=dev) > 0.1
            coll = torch.randint(0, 3, (n,), generator=gen, device=dev, dtype=torch.int32)
            cid = torch.tensor([-1, 0, 1, 2, -2], dtype=torch.int32, device=dev).repeat(b // 5 + 1)[:b]
            masks = [(valid, None, None), (valid, coll, cid)]
            if (n, d, b) == shapes[4]:
                masks.append((torch.zeros_like(valid), coll, cid))
            for v, c, k in masks:
                got = ft.bucket_maxima(rows, q, v, c, k, *scales)
                torch.cuda.synchronize()
                e = max_err(got, ft.bucket_maxima_plain(rows, q, v, c, k, *scales))
                if got.shape != (b, -(-n // 16)) or not e <= atol:
                    fail(f"fused_bucket_maxima {kind} N={n} D={d} B={b} "
                         f"{'scoped' if c is not None else 'unscoped'}"
                         f"{'' if bool(v.any()) else ', all rows invalid'} differs from its plain "
                         f"version ({e}; allowed {atol})")
                if not bool(v.any()) and not bool(torch.isinf(got).all()):
                    fail(f"fused_bucket_maxima {kind}: invalid rows must give -inf")
                worst[kind], cases[kind] = max(worst[kind], e), cases[kind] + 1
    log(f"fused_bucket_maxima bf16 edge sweep: {len(BF16_EDGE_SHAPES)} shapes (N, D, B) "
        f"{BF16_EDGE_SHAPES}, unscoped, scoped and all rows invalid: {cases['bf16']} cases agree "
        f"with the plain version within {FUSED_ATOL} (worst {worst['bf16']:.3g})")
    log(f"fused_bucket_maxima int8 / int4 edge sweep: {len(INT_EDGE_SHAPES)} shapes (N, D, B) "
        f"{INT_EDGE_SHAPES}, unscoped, scoped and all rows invalid: {cases['int8'] + cases['int4']} "
        f"cases equal the plain version bit for bit")
    return worst["bf16"]


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


def bowhash_texts(rng, n: int):
    """Query texts shaped as the benchmark's batch traffic: six terms of a
    65,536-term vocabulary, a third of them a relation question over two entities."""
    out = []
    for _ in range(n):
        terms = " ".join(f"t{int(t):06d}" for t in rng.integers(0, 65536, size=6))
        if rng.random() < 1 / 3:
            a, b = rng.integers(0, N_ENTITIES, size=2)
            terms = f"How is entity{a:05d} related to entity{b:05d}? {terms}"
        out.append(terms)
    return out


def f16_steps(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest distance between two f16 tensors in steps of f16's grid."""
    def line(x):
        i = x.contiguous().view(torch.int16).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return int((line(a) - line(b)).abs().max()) if a.numel() else 0


def check_bowhash(dev):
    """The BowHash query encode against its plain version at BOWHASH_SHAPES, a batch
    of BATCH traffic-like texts: the kernel's f32 draws bit for bit, the pooled
    query vectors and MaxSim tokens within one f16 step; timed at the default
    shape (the benchmark's). Returns its kernels-line entry."""
    from triple_hybrid_rag_tpu_torch.config import RAGConfig
    from triple_hybrid_rag_tpu_torch.models.embedder import BowHashEmbedder
    from triple_hybrid_rag_tpu_torch.ops.bowhash import bowhash_encode

    rng = np.random.default_rng(2147483659)
    entry = {"name": "bowhash_encode", "route": "cuda",
             "source": "triple_hybrid_rag_tpu_torch/csrc/bowhash.cu",
             "replaces": None, "library_ms": None, "max_abs_err": 0.0, "f16_steps": 0}
    for label, (d_full, d_out, t_q, d_m) in BOWHASH_SHAPES.items():
        emb = BowHashEmbedder(dim=d_full, config=RAGConfig())
        seeds, n_tok, tok_idx, mtok_idx, _ = emb.query_streams(bowhash_texts(rng, BATCH), t_q, d_m)
        cpu = (torch.from_numpy(seeds.view(np.int64)), n_tok, d_full, d_m,
               torch.from_numpy(tok_idx), torch.from_numpy(mtok_idx), d_out)
        card = tuple(x.to(dev) if isinstance(x, torch.Tensor) else x for x in cpu)
        n_m = seeds.shape[0] - n_tok
        draws = {where: (torch.empty((n_tok, d_full), dtype=torch.float32, device=where),
                         torch.empty((n_m, d_m), dtype=torch.float32, device=where))
                 for where in (dev, "cpu")}
        got = bowhash_encode(*card, draws=draws[dev])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = bowhash_encode(*cpu, draws=draws["cpu"])
        plain_ms = (time.perf_counter() - t0) * 1e3
        same = all(torch.equal(a.cpu().view(torch.int32), b.view(torch.int32))
                   for a, b in zip(draws[dev], draws["cpu"]))
        steps = max(f16_steps(g.cpu(), w) for g, w in zip(got, want))
        err = max(max_err(g.cpu().float(), w.float()) for g, w in zip(got, want))
        log(f"bowhash_encode {label} shape B={BATCH} (dense {d_full} cut to {d_out}, MaxSim "
            f"{t_q} x {d_m}): {n_tok} dense and {n_m} MaxSim streams; draws bit-equal to the "
            f"plain version {same}; pooled vectors and tokens within {steps} f16 steps "
            f"(max |kernel - plain| {err:.3g})")
        if not same or steps > 1:
            fail(f"bowhash_encode ({label} shape) disagrees with its plain version: draws equal "
                 f"{same}, {steps} f16 steps")
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        entry["f16_steps"] = max(entry["f16_steps"], steps)
        if label != "default":
            continue
        ms = time_ms(lambda: bowhash_encode(*card))
        n_draws = n_tok * d_full + n_m * d_m
        # the draws written and read back in f32, the outputs in f16; one f64 multiply
        # and one f64 multiply-add (the norm) a draw: a yardstick, since each stream's
        # draws are a chain of dependent 128-bit LCG steps (PERF.md)
        b_ms, b_by = bound(8 * n_draws + 2 * BATCH * (d_out + t_q * d_m) + 8 * seeds.shape[0],
                           3.0 * n_draws, F64_FLOPS)
        log(f"bowhash_encode default shape: kernel {ms:.4f} ms, plain (numpy, host) "
            f"{plain_ms:.1f} ms, bound {b_ms:.4f} ms ({b_by}), kernel / bound {ms / b_ms:.1f}")
        entry.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                     streams=int(seeds.shape[0]))
    return entry


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


def maxsim_bound(store, tok_mask, parent, tq: int):
    """(ms, "bytes" or "operations") of a MaxSim call: each valid candidate's token
    block and mask once, the candidates' ids and scores, the queries and weights;
    one product per live doc token and query token."""
    p_rows, td, d = store.shape
    b, k = parent.shape
    ok = parent >= 0
    n_valid = int(ok.sum())
    live_tokens = int(tok_mask[parent.clamp(0, p_rows - 1)][ok].sum())
    return bound(n_valid * td * (d * store.element_size() + 1) + b * k * (8 + 4)
                 + b * tq * (d + 1) * 4, 2.0 * live_tokens * tq * d)


def maxsim_edge_sweep(dev, gen):
    """Both MaxSim bodies against the plain version at MAXSIM_EDGE_SHAPES (twice with
    every candidate invalid), within MAXSIM_ATOL, each case's plan logged. Returns
    the worst error past the staged plan and the cases by plan."""
    from triple_hybrid_rag_tpu_torch.ops import maxsim as mx

    worst, cases, worst_past = 0.0, 0, 0.0
    by_plan = dict.fromkeys(mx.PLANS, 0)
    taken = []
    for i, (b, k, p_rows, td, d, tq) in enumerate(MAXSIM_EDGE_SHAPES):
        tokens, tok_mask, parent, q, w = maxsim_inputs(dev, gen, b, k, p_rows, td, d, tq)
        if i in MAXSIM_ALL_INVALID:
            parent[:] = -1
        for store in (tokens, mx.quantize_tokens(tokens)):
            plan = mx.maxsim_plan(store, parent, q)
            got = mx.maxsim_scores(store, tok_mask, parent, q, w)
            torch.cuda.synchronize()
            e = max_err(got, mx.maxsim_scores_plain(store, tok_mask, parent, q, w))
            if got.shape != (b, k) or not e <= MAXSIM_ATOL:
                fail(f"maxsim_scores {store.dtype} B={b} K={k} P={p_rows} Td={td} D={d} Tq={tq} "
                     f"({plan} plan) disagrees with its plain version ({e})")
            if i in MAXSIM_ALL_INVALID and bool((got != 0).any()):
                fail(f"maxsim_scores ({plan} plan): invalid candidates must score 0")
            worst, cases = max(worst, e), cases + 1
            by_plan[plan] += 1
            taken.append(f"{(b, k, p_rows, td, d, tq)} {'int8' if store.dtype == torch.int8 else 'bf16'}"
                         f" {plan} {e:.3g}")
            if plan != "staged":
                worst_past = max(worst_past, e)
    log(f"maxsim_scores edge sweep: {len(MAXSIM_EDGE_SHAPES)} shapes (B, K, P, Td, D, Tq), bf16 "
        f"and int8 stores, {len(MAXSIM_ALL_INVALID)} with every candidate invalid: {cases} cases "
        f"agree with the plain version within {MAXSIM_ATOL} (worst {worst:.3g}; past the staged "
        f"plan {worst_past:.3g}); cases by plan {by_plan}")
    log("  shape, store, plan, max |kernel - plain|: " + "; ".join(taken))
    return worst_past, by_plan


def check_maxsim(dev, gen):
    """Both bodies (bf16 and int8 token stores) at the smoke shape and at the
    default RAGConfig shape, 1M chunks' parents, and past the staged plan at
    MAXSIM_GENERAL_SHAPE, cold L2. Returns one kernels-line entry per body; the smoke
    shape's numbers are its main ones."""
    from triple_hybrid_rag_tpu_torch.ops import maxsim as mx

    worst_past, edge_plans = maxsim_edge_sweep(dev, gen)
    entries = {body: {
        "name": "maxsim_scores" if body == "bf16" else "maxsim_scores_int8", "route": "cuda",
        "source": "triple_hybrid_rag_tpu_torch/csrc/maxsim.cu",
        "replaces": "triple_hybrid_rag_tpu/ops/pallas/maxsim_kernel.py:67", "library_ms": None,
        "max_abs_err": 0.0, "edge_past_staged_max_abs_err": worst_past,
        "edge_cases_by_plan": edge_plans} for body in ("bf16", "int8")}
    shapes = [(label, shape, N_PARENTS) for label, shape in MAXSIM_SHAPES.items()]
    shapes += [(label, shape, p_rows) for label, (shape, p_rows) in MAXSIM_PAST_STAGED.items()]
    for label, (td, d, tq), p_rows in shapes:
        tokens, tok_mask, parent, q, w = maxsim_inputs(dev, gen, BATCH, RERANK_K, p_rows, td, d, tq)
        for store in (tokens, mx.quantize_tokens(tokens)):
            body = "int8" if store.dtype == torch.int8 else "bf16"
            plan = mx.maxsim_plan(store, parent, q)
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
            b_ms, b_by = maxsim_bound(store, tok_mask, parent, tq)
            log(f"maxsim_scores {body} tokens, {label} shape B={BATCH} K={RERANK_K} Td={td} D={d} "
                f"Tq={tq} ({plan} plan): max |kernel - plain| = {err:.3g}; kernel {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), kernel / bound "
                f"{ms / b_ms:.2f}")
            e = entries[body]
            e["max_abs_err"] = max(e["max_abs_err"], err)
            keys = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, plan=plan)
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
    from triple_hybrid_rag_tpu_torch.ops.bowhash import bowhash_encode
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
    bowhash_encode.launches = 0
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
                "maxsim_scores": maxsim_body_launches("bf16", "bf16 rows", st),
                "bowhash_encode": bowhash_encode.launches}
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
    ids_e, vals_e = eng._dense(args)
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
    ids_s, vals_s = eng_sorted._lexical(eng_sorted.prepare_queries(texts)[1])
    ids_t, vals_t = eng._lexical(eng.prepare_queries(texts)[1])
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
        ids_i, _ = eng._dense(a)
        ids_e, _ = eng_x._dense(a)
        found = [len(set(x.tolist()) & set(y[y >= 0].tolist())) / max(int((y >= 0).sum()), 1)
                 for x, y in zip(ids_i.cpu(), ids_e.cpu())]
        IVF_RECALL[kind] = float(np.mean(found))
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


@functools.lru_cache(maxsize=None)
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
    results = []
    for name, text in docs:
        results.append(rag.ingest_text(text, name=f"{name}.txt", collection=name.split(".")[0]))
        if rag.ingestor.embedder.last_errors:
            fail(f"{label}: {name}: the embedder fell back to zero vectors for items "
                 f"{rag.ingestor.embedder.last_errors}")
    return check_results(results, label)[1]


def ingest_path(dev, card):
    """The default RAGConfig ingests the standard library's docstrings through the
    facade on the card and serves them. Returns the launches of the bf16 bucket
    maxima and the bf16 MaxSim body over the queries."""
    from triple_hybrid_rag_tpu_torch import RAG, RAGConfig
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
        f"{ingest_s:.1f} s (stage sums, s: {stage_line(stages)}); index build and placement "
        f"{build_s:.2f} s; device GB " + str({k: round(v / 1e9, 4) for k, v in st.nbytes().items()})
        + f"; n_pad {st.n_pad}, lexical {st.lexical_mode}, graph {st.graph_mode}; documents past "
        f"the term table's {cfg.doc_term_capacity} slots {retriever.bm25_index.overflow_docs}, "
        f"entities past {cfg.graph_max_degree} neighbours {retriever.graph_index.overflow_entities}"
        f"; card {card}")
    if zero:
        fail(f"stdlib ingest: {zero} stored chunks have an all-zero dense row")

    queries, hits = chunk_queries(rag, BATCH)
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
    same_ingest("subset", built)
    return launches, (rag, queries, hits)


def same_ingest(label: str, built) -> None:
    """Fails unless two ingests of the same documents, ``built`` = [(corpus, placed
    state) on the card, (corpus, placed state) on the CPU], have equal chunk ids and
    BM25 and graph arrays, and dense rows within ``ENCODER_ATOL``."""
    (c_gpu, s_gpu), (c_cpu, s_cpu) = built
    if [c.chunk_id for c in c_gpu.children] != [c.chunk_id for c in c_cpu.children]:
        fail(f"{label}: card and CPU ingests gave different chunk ids")
    for key in ("lex_offsets", "lex_lengths", "lex_pd", "lex_pt", "nbr", "chunk_entities",
                "g_offsets", "g_lengths", "g_docs", "parent_of", "collection_of"):
        a, b = getattr(s_gpu, key), getattr(s_cpu, key)
        if (a is None) != (b is None) or (a is not None and not torch.equal(a.cpu(), b)):
            fail(f"{label}: card and CPU ingests placed different {key}")
    gap = float((s_gpu.embeddings.float().cpu() - s_cpu.embeddings.float()).abs().max())
    log(f"{label}: chunk ids, BM25 and graph arrays equal on card and CPU; dense rows within "
        f"{gap:.3g} (atol {ENCODER_ATOL}, the card's bf16 encoder against the CPU's)")
    if not gap <= ENCODER_ATOL:
        fail(f"{label}: card and CPU dense rows differ by {gap}")


# ---------------------------------------------------------------- phase 7


def staged_counts_reset() -> None:
    """Every kernel counter to 0 (the staged paths' windows)."""
    from triple_hybrid_rag_tpu_torch.ops.bm25 import score_termtable_batch
    from triple_hybrid_rag_tpu_torch.ops.bowhash import bowhash_encode
    from triple_hybrid_rag_tpu_torch.ops.dense_kernel import dense_scores
    from triple_hybrid_rag_tpu_torch.ops.fused_topk import bucket_maxima

    dense_scores.launches = 0
    dense_scores.launches_by_rows = dict.fromkeys(dense_scores.launches_by_rows, 0)
    score_termtable_batch.launches = 0
    bucket_maxima.launches_by_rows = dict.fromkeys(bucket_maxima.launches_by_rows, 0)
    bowhash_encode.launches = 0
    maxsim_counts_reset()


def staged_counts() -> dict:
    """Kernel launches since :func:`staged_counts_reset`, by the kernels line's names,
    and those of the f32-row bodies apart (``*_f32``)."""
    from triple_hybrid_rag_tpu_torch.ops.bm25 import score_termtable_batch
    from triple_hybrid_rag_tpu_torch.ops.bowhash import bowhash_encode
    from triple_hybrid_rag_tpu_torch.ops.dense_kernel import dense_scores
    from triple_hybrid_rag_tpu_torch.ops.fused_topk import bucket_maxima
    from triple_hybrid_rag_tpu_torch.ops.maxsim import maxsim_scores

    by_rows = bucket_maxima.launches_by_rows
    return {
        "bowhash_encode": bowhash_encode.launches,
        "dense_scores": dense_scores.launches,
        "termtable_scores": score_termtable_batch.launches,
        "maxsim_scores": maxsim_scores.launches_by_tokens["bf16"],
        "maxsim_scores_int8": maxsim_scores.launches_by_tokens["int8"],
        "fused_bucket_maxima": by_rows["bf16"] + by_rows["f32"],
        "fused_bucket_maxima_int8": by_rows["int8"],
        "fused_bucket_maxima_int4": by_rows["int4"],
        "dense_scores_f32": dense_scores.launches_by_rows["f32"],
        "fused_bucket_maxima_f32": by_rows["f32"],
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
            searched = sum(v for k, v in launches.items() if k != "bowhash_encode")
            if launches["fused_bucket_maxima"] != n_batches or launches["maxsim_scores"] != n_batches \
                    or searched != 2 * n_batches \
                    or launches["bowhash_encode"] not in (0, n_batches):
                fail(f"{label}: expected one bf16 bucket-maxima and one bf16 MaxSim launch (and "
                     f"with BowHash one encode) per engine batch, got {launches}")
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


# ---------------------------------------------------------------- phase 9

N_FORMAT_DOCS = 300  # docstrings written as files: 100 PDFs, 100 DOCX, 100 XLSX
N_CPU_SUBSET = 60  # of them ingested on the card and on the CPU (20 of each format)
N_STAGED_FORMATS = 32  # RAG.query calls a part
FORMATS = (".pdf", ".docx", ".xlsx")
# 5x7 bitmap glyphs (a row a hex byte, five bits) of the scans' text
GLYPHS = {
    "A": "0E1111 1F111111", "B": "1E11111E11111E", "C": "0E111010 10110E", "D": "1E111111 11111E",
    "E": "1F10101E10101F", "F": "1F10101E101010", "G": "0E111017 11110F", "H": "1111111F111111",
    "I": "0E040404 04040E", "J": "07020202 02120C", "K": "11121418 141211", "L": "1010101010101F",
    "M": "111B1515 111111", "N": "11111915 131111", "O": "0E111111 11110E", "P": "1E11111E101010",
    "Q": "0E111111 15120D", "R": "1E11111E141211", "S": "0F10100E01011E", "T": "1F040404040404",
    "U": "1111111111110E", "V": "1111111111 0A04", "W": "11111115 15150A", "X": "11110A04 0A1111",
    "Y": "11110A04 040404", "Z": "1F010204 08101F", "0": "0E111315 19110E", "1": "040C0404 04040E",
    "2": "0E110102 04081F", "3": "1F020402 01110E", "4": "02060A12 1F0202", "5": "1F101E01 01110E",
    "6": "0608101E 11110E", "7": "1F010204 080808", "8": "0E11110E 11110E", "9": "0E11110F 01020C",
    " ": "00000000000000",
}
SCAN_WORDS = ["ZORBLAX", "QUINTESSOR", "GASKET", "LEDGER", "FREIGHT", "MANIFEST", "PORTO",
              "VEXILLARY", "DRIZZLE", "QUORPLE", "TARIFF", "BOLLARD", "SPINDLE", "HARBOR"]


def scan_texts(n: int):
    """Distinct two-line texts of the scans (capitals and digits: the bitmap font's)."""
    out = []
    for k in range(n):
        w = [SCAN_WORDS[(k * 5 + j) % len(SCAN_WORDS)] for j in range(6)]
        out.append(f"SCAN {k} {w[0]} {w[1]} {w[2]} {100 + 37 * k}\n{w[3]} {w[4]} {w[5]} INVOICE {k}")
    return out


def render_scan(text: str, scale: int = 3, margin: int = 12):
    """(width, height, 8-bit gray pixels) of ``text`` drawn in the 5x7 bitmap font,
    black on white; no image library."""
    lines = text.split("\n")
    cw, lh = 6 * scale, 11 * scale
    w = margin * 2 + cw * max(len(line) for line in lines)
    h = margin * 2 + lh * len(lines)
    px = np.full((h, w), 255, np.uint8)
    for li, line in enumerate(lines):
        for ci, ch in enumerate(line):
            rows = bytes.fromhex(GLYPHS[ch].replace(" ", ""))
            for r, bits in enumerate(rows):
                for c in range(5):
                    if bits >> (4 - c) & 1:
                        y, x = margin + li * lh + r * scale, margin + ci * cw + c * scale
                        px[y:y + scale, x:x + scale] = 0
    return w, h, px


def png_idat(px) -> bytes:
    """The zlib stream of 8-bit gray rows, each behind PNG filter byte 0: a PNG's IDAT
    data and, as is, a PDF image stream with ``/Predictor 15``."""
    import zlib

    return zlib.compress(b"".join(b"\x00" + row.tobytes() for row in px))


def png_bytes(w: int, h: int, idat: bytes) -> bytes:
    import struct
    import zlib

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", idat) + chunk(b"IEND", b""))


def pdf_bytes(content: bytes, image=None) -> bytes:
    """A one-page PDF: a FlateDecode content stream and, with ``image`` = (w, h,
    idat), a gray image XObject the page draws."""
    import zlib

    stream = zlib.compress(content)
    while stream.endswith(b"\r"):  # the stdlib extractor, reading no /Length, would take
        content += b" "  # that byte for the line end before "endstream"
        stream = zlib.compress(content)
    res = b" /Resources << /XObject << /Im0 5 0 R >> >>" if image else b""
    objs = [b"<< /Type /Catalog /Pages 2 0 R >>", b"<< /Type /Pages /Kids [3 0 R] /Count 1 >>",
            b"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 612 792] /Contents 4 0 R%s >>" % res,
            b"<< /Filter /FlateDecode /Length %d >>\nstream\n%s\nendstream" % (len(stream), stream)]
    if image:
        w, h, idat = image
        objs.append(b"<< /Type /XObject /Subtype /Image /Width %d /Height %d /ColorSpace "
                    b"/DeviceGray /BitsPerComponent 8 /Filter /FlateDecode /DecodeParms "
                    b"<< /Predictor 15 /Colors 1 /BitsPerComponent 8 /Columns %d >> /Length %d >>"
                    b"\nstream\n%s\nendstream" % (w, h, w, len(idat), idat))
    body = b"%PDF-1.4\n" + b"".join(b"%d 0 obj\n%s\nendobj\n" % (i + 1, o) for i, o in enumerate(objs))
    return body + b"trailer\n<< /Root 1 0 R >>\n%%EOF\n"


def pdf_string(line: str) -> bytes:
    """A PDF string operand: a literal where latin-1 holds the line and no ``BT`` /
    ``ET`` could read as an operator, else UTF-16BE hex behind its byte-order mark."""
    if "BT" in line or "ET" in line or any(ord(c) > 255 for c in line):
        return b"<FEFF" + line.encode("utf-16-be").hex().upper().encode() + b">"
    esc = line.replace("\\", "\\\\").replace("(", "\\(").replace(")", "\\)")
    return b"(" + esc.encode("latin-1") + b")"


def docstring_pdf(text: str) -> bytes:
    """The docstring's lines, 12 points apart: even lines one ``Tj`` each, odd lines a
    ``TJ`` array of their words with -300 kerning (an inter-word gap); a blank line is
    a move alone."""
    ops = [b"BT /F1 10 Tf 72 760 Td"]
    for i, line in enumerate(text.split("\n")):
        if i:
            ops.append(b"0 -12 Td")
        if not line:
            continue
        if i % 2 and "[" not in line and "]" not in line and pdf_string(line)[:1] == b"(":
            ops.append(b"[" + b" -300 ".join(pdf_string(w) for w in line.split(" ")) + b"] TJ")
        else:
            ops.append(pdf_string(line) + b" Tj")
    ops.append(b"ET")
    return pdf_bytes(b"\n".join(ops))


def docstring_docx(text: str) -> bytes:
    """A DOCX whose first line is a Heading1 paragraph and every other line a
    paragraph."""
    import io
    import zipfile
    from xml.sax.saxutils import escape

    paras = []
    for i, line in enumerate(text.split("\n")):
        style = '<w:pPr><w:pStyle w:val="Heading1"/></w:pPr>' if i == 0 else ""
        paras.append(f'<w:p>{style}<w:r><w:t xml:space="preserve">{escape(line)}</w:t></w:r></w:p>')
    xml = ('<?xml version="1.0"?><w:document xmlns:w="http://schemas.openxmlformats.org/'
           'wordprocessingml/2006/main"><w:body>' + "".join(paras) + "</w:body></w:document>")
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        zf.writestr("[Content_Types].xml", "<Types/>")
        zf.writestr("word/document.xml", xml)
    return buf.getvalue()


def docstring_xlsx(text: str) -> bytes:
    """An XLSX table of the docstring's lines: column A the line (a shared string),
    column B its number."""
    import io
    import zipfile
    from xml.sax.saxutils import escape

    lines = text.split("\n")
    shared = "<sst>" + "".join(f'<si><t xml:space="preserve">{escape(s)}</t></si>' for s in lines) + "</sst>"
    rows = "".join(f'<row r="{r}"><c r="A{r}" t="s"><v>{r - 1}</v></c><c r="B{r}"><v>{r}</v></c></row>'
                   for r in range(1, len(lines) + 1))
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        zf.writestr("[Content_Types].xml", "<Types/>")
        zf.writestr("xl/sharedStrings.xml", shared)
        zf.writestr("xl/worksheets/sheet1.xml", f"<worksheet><sheetData>{rows}</sheetData></worksheet>")
    return buf.getvalue()


WRITERS = {".pdf": docstring_pdf, ".docx": docstring_docx, ".xlsx": docstring_xlsx}


def squash(text: str) -> str:
    return " ".join(text.split())


def loaded_text(doc) -> str:
    """The docstring a loaded file holds: the pages' text, the DOCX heading's ``#``
    taken off, the XLSX table's first column read back."""
    from triple_hybrid_rag_tpu_torch.types import FileType

    text = "\n\n".join(p.text for p in doc.pages)
    if doc.file_type == FileType.DOCX:
        return text.removeprefix("# ")
    if doc.file_type == FileType.XLSX:
        rows = text.split("\n")
        return "\n".join(r[2:-2].rsplit(" | ", 1)[0] for i, r in enumerate(rows) if i != 1)
    return text


def format_docs():
    """``N_FORMAT_DOCS`` of phase 6's docstrings (300 to 3,000 characters, distinct),
    evenly spaced."""
    mods, defs = stdlib_docstrings()
    seen, pool = set(), []
    for name, text in mods + defs:
        if 300 <= len(text) <= 3000 and text not in seen:
            seen.add(text)
            pool.append((name, text))
    return [pool[i] for i in np.linspace(0, len(pool) - 1, N_FORMAT_DOCS).astype(int)]


def write_format_files(root, docs, scans):
    """The docstring files (formats in turn), the scans as PNGs and one scan as a
    PDF without a text layer. Returns {path: docstring}, {path: scan text} and
    {SHA-256 of each scan's PNG: text}."""
    import hashlib
    from pathlib import Path

    root = Path(root)
    (root / "docs").mkdir()
    (root / "scans").mkdir()
    files = {}
    for i, (name, text) in enumerate(docs):
        ext = FORMATS[i % 3]
        path = root / "docs" / f"{i:03d}_{name.replace('.', '_')[:60]}{ext}"
        path.write_bytes(WRITERS[ext](text))
        files[path] = text
    scan_files, ocr_texts = {}, {}
    for k, text in enumerate(scans):
        w, h, px = render_scan(text)
        idat = png_idat(px)
        png = png_bytes(w, h, idat)
        if k == len(scans) - 1:  # the loader rebuilds this very PNG from the page's image
            path = root / "scans" / f"scan_{k}.pdf"
            path.write_bytes(pdf_bytes(b"q %d 0 0 %d 0 0 cm /Im0 Do Q" % (w, h), (w, h, idat)))
        else:
            path = root / "scans" / f"scan_{k}.png"
            path.write_bytes(png)
        scan_files[path] = text
        ocr_texts[hashlib.sha256(png).hexdigest()] = text
    return files, scan_files, ocr_texts


def check_results(results, label: str):
    """Fails on a FAILED result. Returns the seconds per file suffix and the summed
    stage ms."""
    from triple_hybrid_rag_tpu_torch.types import IngestionStatus

    per_format: dict = {}
    stages = dict.fromkeys(("load_ms", "chunk_ms", "embed_ms", "store_ms", "ner_ms"), 0.0)
    for res in results:
        if res.status == IngestionStatus.FAILED:
            fail(f"{label}: ingesting {res.filename} failed: {res.error}")
        suffix = "." + res.filename.rsplit(".", 1)[-1]
        per_format[suffix] = per_format.get(suffix, 0.0) + res.timings.get("total_ms", 0.0) / 1e3
        for k in stages:
            stages[k] += res.timings.get(k, 0.0)
    return per_format, stages


def stage_line(stages: dict) -> str:
    return ", ".join(f"{k[:-3]} {v / 1e3:.2f}" for k, v in stages.items())


def chunk_queries(rag, n: int):
    """``n`` queries made of evenly spaced chunks' own first twelve analyzer tokens,
    and ``hits(results, idx)``: how many found a chunk of their query's text."""
    from triple_hybrid_rag_tpu_torch.analyzer import Analyzer

    corpus = rag.ingestor.corpus
    analyzer = Analyzer(rag.config)
    rows = np.linspace(0, len(corpus) - 1, n).astype(int)
    queries = [" ".join(analyzer.tokenize(corpus.children[r].text)[:12]) for r in rows]
    same_text: dict = {}
    for c in corpus.children:
        same_text.setdefault(c.text, set()).add(c.chunk_id)

    def hits(results, idx):
        return sum(any(x.chunk_id in same_text[corpus.children[rows[i]].text] for x in r.results)
                   for i, r in zip(idx, results))

    return queries, hits


def counted(fn):
    """(fn(), the kernel launches it made): every counter set to 0 just before, read
    just after."""
    torch.cuda.synchronize()
    staged_counts_reset()
    out = fn()
    torch.cuda.synchronize()
    return out, staged_counts()


def formats_ingest(dev, card, tmp):
    """Phase 9(a): the docstring files and the scans ingested through
    ``RAG(device=dev)`` under the default RAGConfig (the encoder, the default OCR
    ladder), queried at B = 128 and through ``RAG.query``; a subset ingested on the
    card and on the CPU. Returns (launches, {scan file: text}, {scan PNG's SHA-256:
    text}, the docstring PDFs)."""
    from pathlib import Path

    from triple_hybrid_rag_tpu_torch import RAG, RAGConfig

    docs = format_docs()
    files, scan_files, ocr_texts = write_format_files(tmp, docs, scan_texts(9))
    cfg = RAGConfig()
    rag = RAG(cfg, device=dev)
    ocr = rag.ingestor.loader.ocr
    rung = type(ocr.ocr_fn).__name__ if ocr is not None else None
    log(f"OCR ladder: {rung} (HTTP vision when ocr_api_base is set, then pytesseract with its "
        f"binary, then the glyph matcher when PIL imports, else none)")
    for path, text in files.items():
        got = loaded_text(rag.ingestor.loader.load(path))
        if squash(got) != squash(text):
            fail(f"{path.name}: the loaded text is not its docstring: {got[:200]!r} against "
                 f"{text[:200]!r}")
    log(f"format files: {len(files)} docstrings (PDF, DOCX, XLSX in turn) load back to their "
        f"text up to whitespace; {len(scan_files)} scans (8 PNG, 1 PDF without a text layer)")
    t0 = time.time()
    results = rag.ingest_directory(Path(tmp) / "docs")
    if ocr is not None:  # without a recognizer the scans are phase 9(b)'s alone
        results += rag.ingest_directory(Path(tmp) / "scans")
    per_format, stages = check_results(results, "format ingest")
    torch.cuda.synchronize()
    ingest_s = time.time() - t0
    st = rag.retriever.state
    n = len(rag.ingestor.corpus)
    zero = int((~(st.embeddings[:n] != 0).any(dim=1)).sum())
    log(f"format ingest: {len(results)} files, {n} children, {rag.ingestor.corpus.n_parents} "
        f"parents in {ingest_s:.2f} s (s per format: "
        + ", ".join(f"{k} {v:.2f}" for k, v in sorted(per_format.items()))
        + f"; stage sums, s: {stage_line(stages)}); card {card}")
    if zero:
        fail(f"format ingest: {zero} stored chunks have an all-zero dense row")
    if ocr is not None:
        for path in list(scan_files)[::4]:
            page = rag.ingestor.loader.load(path).pages[0]
            log(f"  {path.name}: {rung} read {page.text[:60]!r} at confidence "
                f"{page.ocr_confidence:.3f} (the scan says {scan_files[path][:40]!r})")

    queries, hits = chunk_queries(rag, BATCH)
    rag.query_batch(queries[:8])  # warm-up
    res, batch_launches = counted(lambda: rag.query_batch(queries))
    frac = hits(res, range(BATCH)) / BATCH
    log(f"format queries B={BATCH}: self-retrieval {frac:.4f} (refused "
        f"{sum(r.refused for r in res)}); kernel launches {batch_launches}")
    if frac < 0.95 or batch_launches["fused_bucket_maxima"] < 1 or batch_launches["maxsim_scores"] < 1:
        fail(f"format queries B={BATCH}: self-retrieval {frac}, launches {batch_launches}")
    t0 = time.perf_counter()
    staged, staged_launches = counted(lambda: [rag.query(q) for q in queries[:N_STAGED_FORMATS]])
    e2e = (time.perf_counter() - t0) / N_STAGED_FORMATS * 1e3
    one_frac = hits(staged, range(N_STAGED_FORMATS)) / N_STAGED_FORMATS
    log(f"format queries through RAG.query: self-retrieval {one_frac:.4f} of {N_STAGED_FORMATS}, "
        f"e2e {e2e:.2f} ms/query; kernel launches {staged_launches}; card {card}")
    if one_frac < 0.95 or staged_launches["dense_scores"] < 1 or staged_launches["maxsim_scores"] < 1:
        fail(f"format queries through RAG.query: self-retrieval {one_frac}, launches {staged_launches}")

    subset = [p for p in files if int(p.name[:3]) < N_CPU_SUBSET]
    built = []
    for where in (dev, "cpu"):
        t0 = time.time()
        r = RAG(cfg, device=where, use_sharded_engine=True)
        check_results([r.ingest(p) for p in subset], f"format subset on {where}")
        built.append((r.ingestor.corpus, r.retriever.state))
        log(f"format subset of {len(subset)} files ingested and placed on {where} in "
            f"{time.time() - t0:.1f} s")
    same_ingest("format subset", built)
    launches: dict = {}
    add_counts(launches, batch_launches)
    add_counts(launches, staged_launches)
    pdfs = [p for p in files if p.suffix == ".pdf"]
    return launches, scan_files, ocr_texts, pdfs


# The stub model server of phase 9(b), run in a process of its own (``python -c``,
# the repo root its working directory): OpenAI-compatible routes answered by the
# functions of ``stub_models`` (the same functions serve the in-process comparison).
# Reads {"ocr": {sha256 hex: text}} as one JSON line on stdin, prints its port,
# counts requests by route (GET /counts).
MODEL_STUB = r"""
import json, sys, threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
import chip_smoke

job = json.loads(sys.stdin.readline())
models = chip_smoke.stub_models(job["ocr"])
counts = {}
lock = threading.Lock()

class Handler(BaseHTTPRequestHandler):
    def log_message(self, *args):
        pass

    def _send(self, payload):
        body = json.dumps(payload).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        with lock:
            self._send(dict(counts))

    def do_POST(self):
        payload = json.loads(self.rfile.read(int(self.headers.get("Content-Length", 0))) or b"{}")
        route, out = models.answer(self.path, payload)
        with lock:
            counts[route] = counts.get(route, 0) + 1
        self._send(out)

httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
print(httpd.server_address[1], flush=True)
httpd.serve_forever()
"""


class stub_models:
    """The stub model server's models: ``/embeddings`` from the port's
    ``BowHashEmbedder`` on the CPU (the default RAGConfig's width), ``/rerank`` a
    token-overlap score, ``/chat/completions`` the rule planner's plan as JSON, the
    rule extractor's entities and relations as JSON, and each scan's text for vision
    OCR, keyed by the image's SHA-256."""

    def __init__(self, ocr: dict) -> None:
        from triple_hybrid_rag_tpu_torch.config import RAGConfig
        from triple_hybrid_rag_tpu_torch.models.embedder import BowHashEmbedder
        from triple_hybrid_rag_tpu_torch.models.entity_extractor import RuleBasedExtractor
        from triple_hybrid_rag_tpu_torch.models.planner import RuleBasedPlanner

        cfg = RAGConfig()
        self.ocr_texts = ocr
        self.embedder = BowHashEmbedder(cfg.embedding_dim_full, cfg)
        self.rerank_calls: list = []
        self.planner = RuleBasedPlanner(cfg)
        self.extractor = RuleBasedExtractor(cfg)

    def rerank(self, query: str, texts) -> list:
        self.rerank_calls.append(len(texts))
        q = set(query.lower().split())
        return [round(len(q & set(t.lower().split())) / max(1, len(q)), 4) for t in texts]

    def plan(self, query: str) -> dict:
        p = self.planner.plan(query)
        return {"keywords": p.keywords, "semantic_query_text": p.semantic_query_text,
                "intent": p.intent, "requires_graph": p.requires_graph,
                "graph_entities": p.graph_entities, "graph_query": p.graph_query, "weights": p.weights}

    def ner(self, text: str) -> dict:
        from triple_hybrid_rag_tpu_torch.types import ParentChunk

        res = self.extractor.extract(ParentChunk(parent_id="p", doc_id="d" * 64, parent_idx=0,
                                                 text=text), [])
        name = {e.entity_id: e.canonical_name for e in res.entities}
        return {"entities": [{"name": e.canonical_name, "type": e.entity_type.value,
                              "description": e.description} for e in res.entities],
                "relations": [{"subject": name[r.subject_id], "relation_type": r.relation_type.value,
                               "object": name[r.object_id], "confidence": r.confidence}
                              for r in res.relations if r.subject_id in name and r.object_id in name]}

    def ocr(self, image: bytes, mode: str = "base") -> str:
        import hashlib

        return self.ocr_texts.get(hashlib.sha256(image).hexdigest(), "")

    def answer(self, path: str, payload: dict):
        """(route, response) of one request."""
        import base64

        if path.endswith("/embeddings"):
            vecs = self.embedder.embed_texts([str(x) for x in payload["input"]])
            return "embeddings", {"data": [{"index": i, "embedding": v.tolist()}
                                           for i, v in enumerate(vecs)]}
        if path.endswith("/rerank"):
            scores = self.rerank(payload["query"], payload["documents"])
            return "rerank", {"results": [{"index": i, "relevance_score": s}
                                          for i, s in enumerate(scores)]}
        system, user = payload["messages"][0]["content"], payload["messages"][-1]["content"]
        if isinstance(user, list):
            url = next(p["image_url"]["url"] for p in user if p.get("type") == "image_url")
            route, content = "ocr", self.ocr(base64.b64decode(url.split(",", 1)[1]))
        elif "query planner" in system:
            route, content = "planner", json.dumps(self.plan(user.removeprefix("Query: ")))
        else:
            route, content = "ner", json.dumps(self.ner(user.split("\n\n", 1)[1]))
        return route, {"choices": [{"message": {"content": content}}]}


def start_model_stub(ocr: dict):
    """The stub model server in a new process; (process, base URL). The process is
    killed at exit, whatever ends this one."""
    import atexit
    import os

    proc = subprocess.Popen([sys.executable, "-c", MODEL_STUB], stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, text=True,
                            cwd=os.path.dirname(os.path.abspath(__file__)))
    atexit.register(proc.kill)
    proc.stdin.write(json.dumps({"ocr": ocr}) + "\n")
    proc.stdin.flush()
    port = proc.stdout.readline().strip()
    if not port.isdigit():
        fail(f"the stub model server did not start (exit {proc.poll()})")
    return proc, f"http://127.0.0.1:{port}/v1"


class TextEmbedder:
    """An embedder's text half, as an HTTP embedder offers it: no token embeddings
    (so no MaxSim store) and an ``embed_query`` that answers what the server does."""

    def __init__(self, inner) -> None:
        self.inner, self.dim = inner, inner.dim

    def embed_texts(self, texts):
        return self.inner.embed_texts(texts)

    def embed_query(self, text: str):
        return self.inner.embed_texts([text])[0]


def http_rags(dev, base: str, models):
    """(the RAG with every ``*_api_base`` at the stub, the RAG built in-process with
    the stub's own models), both on ``dev`` under the default RAGConfig otherwise
    (the HTTP one without retries, so the stub counts each request once)."""
    from triple_hybrid_rag_tpu_torch import RAG, RAGConfig
    from triple_hybrid_rag_tpu_torch.models.entity_extractor import CallableExtractor
    from triple_hybrid_rag_tpu_torch.models.planner import CallablePlanner

    cfg = RAGConfig(embed_api_base=base, rerank_api_base=base, llm_api_base=base,
                    ocr_api_base=base, api_retries=0)
    local_cfg = RAGConfig()
    local = RAG(local_cfg, embedder=TextEmbedder(models.embedder), rerank_fn=models.rerank,
                ocr_fn=models.ocr,
                planner=CallablePlanner(models.plan, local_cfg),
                extractor=CallableExtractor(models.ner, local_cfg), device=dev)
    return RAG(cfg, device=dev), local


def http_models(dev, card, pdfs, scan_files, ocr):
    """Phase 9(b): the stub model server; a RAG with every ``*_api_base`` set ingests
    phase 9(a)'s PDFs and the scans, and answers at B = 128 and through
    ``RAG.query`` with the ids of a RAG built in-process with the stub's models; the
    scans are found by their text; the requests per route are the expected
    batching; a dead server degrades as the reference's does. Returns the launches
    of the HTTP RAG's queries."""
    import math

    from triple_hybrid_rag_tpu_torch.models.http_clients import HTTPEmbedder

    proc, base = start_model_stub(ocr)
    try:
        models = stub_models(ocr)
        rag, local = http_rags(dev, base, models)
        if type(rag.ingestor.embedder.inner) is not HTTPEmbedder:
            fail("the *_api_base settings did not wire the HTTP embedder")
        paths = pdfs + list(scan_files)
        took = {}
        for label, r in (("HTTP", rag), ("in-process", local)):
            t0 = time.time()
            results = [r.ingest(p) for p in paths]
            _, stages = check_results(results, f"{label} ingest")
            torch.cuda.synchronize()
            took[label] = time.time() - t0
            log(f"{label} models: {len(results)} files ({r.ingestor.corpus.n_parents} parents, "
                f"{len(r.ingestor.corpus)} children) ingested in {took[label]:.2f} s (stage sums, "
                f"s: {stage_line(stages)}); card {card}")
        n_embed = sum(math.ceil(r.n_children / 20) for r in results if r.n_children)
        want = {"embeddings": n_embed, "ner": local.ingestor.corpus.n_parents, "ocr": len(scan_files)}
        if rag.retriever.maxsim_index is not None or rag.retriever.state.parent_emb is None:
            fail("the HTTP embedder's RAG built a MaxSim store, or no parent embeddings")
        queries, hits = chunk_queries(local, BATCH)
        for r in (rag, local):
            r.query_batch(queries[:8])  # warm-up
        want["embeddings"] += math.ceil(8 / 20)
        want["planner"] = 8
        t0 = time.perf_counter()
        got, batch_launches = counted(lambda: rag.query_batch(queries))
        http_ms = (time.perf_counter() - t0) / BATCH * 1e3
        t0 = time.perf_counter()
        ref = local.query_batch(queries)
        local_ms = (time.perf_counter() - t0) / BATCH * 1e3
        want["embeddings"] += math.ceil(BATCH / 20)
        want["planner"] += BATCH
        log(f"HTTP models B={BATCH}: self-retrieval {hits(got, range(BATCH)) / BATCH:.4f}; e2e "
            f"{http_ms:.3f} ms/query against {local_ms:.3f} in-process; kernel launches "
            f"{batch_launches}")
        same_ids(f"HTTP models B={BATCH} against the in-process models", pairs(ref), pairs(got), 1e-5)
        if batch_launches["fused_bucket_maxima"] < 1 or batch_launches["maxsim_scores"]:
            fail(f"HTTP models B={BATCH}: launches {batch_launches}: the bf16 bucket maxima and "
                 "no MaxSim were expected")
        n = N_STAGED_FORMATS
        t0 = time.perf_counter()
        got, staged_launches = counted(lambda: [rag.query(q) for q in queries[:n]])
        http_ms = (time.perf_counter() - t0) / n * 1e3
        t0 = time.perf_counter()
        models.rerank_calls.clear()
        ref = [local.query(q) for q in queries[:n]]
        local_ms = (time.perf_counter() - t0) / n * 1e3
        want["embeddings"] += n
        want["planner"] += n
        want["rerank"] = len(models.rerank_calls)  # the in-process RAG's reranks, one a request
        log(f"HTTP models through RAG.query: self-retrieval {hits(got, range(n)) / n:.4f} of {n}; e2e "
            f"{http_ms:.2f} ms/query against {local_ms:.2f} in-process; kernel launches "
            f"{staged_launches}; card {card}")
        same_ids("HTTP models through RAG.query against the in-process models", pairs(ref),
                 pairs(got), 1e-5)
        if staged_launches["dense_scores"] != n or staged_launches["maxsim_scores"]:
            fail(f"HTTP models through RAG.query: launches {staged_launches}")
        found = rag.query_batch(list(scan_files.values()))
        by_path = {r.filename: r.doc_id for r in results}
        missing = [p.name for p, r in zip(scan_files, found)
                   if by_path[p.name] not in {x.doc_id for x in r.results}]
        want["embeddings"] += 1
        want["planner"] += len(scan_files)
        if missing:
            fail(f"scans not found by their text: {missing}")
        _, counts = stub_get(base)
        log(f"stub requests by route {dict(sorted(counts.items()))}; expected {dict(sorted(want.items()))}")
        if counts != want:
            fail(f"the stub's requests {counts} are not the expected batching {want}")
        emb = rag.ingestor.embedder.inner
        texts = [c.text for c in local.ingestor.corpus.children[:20]]
        t0 = time.perf_counter()
        for _ in range(5):
            emb.embed_texts(texts)
        batch_ms = (time.perf_counter() - t0) / 5 * 1e3
        t0 = time.perf_counter()
        for _ in range(5):
            models.embedder.embed_texts(texts)
        log(f"HTTP embed: {batch_ms:.2f} ms a batch of 20 against "
            f"{(time.perf_counter() - t0) / 5 * 1e3:.2f} in-process; ingest {took['HTTP']:.2f} s "
            f"against {took['in-process']:.2f}; {len(scan_files)} scans found by their text")
    finally:
        proc.kill()
        proc.wait(30)
    dead_server(dev, pdfs[:3])
    launches: dict = {}
    add_counts(launches, batch_launches)
    add_counts(launches, staged_launches)
    return launches


def stub_get(base: str):
    return http(base.removesuffix("/v1"), "/counts")


def dead_server(dev, pdfs) -> None:
    """Every ``*_api_base`` at a port nobody listens on: the ingest records zero
    vectors and completes (rule NER), the staged query answers through the lexical
    channel (``tests/test_http_clients.py::test_rag_facade_survives_dead_model_server``)."""
    from triple_hybrid_rag_tpu_torch import RAG, RAGConfig
    from triple_hybrid_rag_tpu_torch.loader import DocumentLoader

    dead = "http://127.0.0.1:9"
    rag = RAG(RAGConfig(embed_api_base=dead, llm_api_base=dead, rerank_api_base=dead,
                        api_retries=0, api_timeout_s=0.5, safety_threshold=0.0), device=dev)
    results = [rag.ingest(p) for p in pdfs]
    check_results(results, "dead-server ingest")
    if any(np.any(v) for v in rag.ingestor.embeddings.values()):
        fail("dead-server ingest: a chunk has a non-zero embedding")
    text = DocumentLoader().load(pdfs[0]).full_text
    words = [w for w in text.split() if w.isalpha() and len(w) > 4][:8]
    out = rag.query(" ".join(words))
    log(f"dead model server: {len(results)} files completed with zero vectors; the staged query "
        f"answered {len(out.results)} results (refused {out.refused}), the first from "
        f"{out.results[0].doc_id[:12] if out.results else None}")
    if out.refused or not out.results or out.results[0].doc_id != results[0].doc_id:
        fail("dead-server query did not answer through the lexical channel")


def formats_path(dev, card):
    """Phase 9: (a) the document formats and OCR, (b) the HTTP model clients.
    Returns the launches of each."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="thr-formats-") as tmp:
        t0 = time.time()
        formats, scan_files, ocr_texts, pdfs = formats_ingest(dev, card, tmp)
        log(f"phase 9(a) wall time {time.time() - t0:.1f} s")
        t0 = time.time()
        served = http_models(dev, card, pdfs, scan_files, ocr_texts)
        log(f"phase 9(b) wall time {time.time() - t0:.1f} s")
    return formats, served


# ---------------------------------------------------------------- phase 10

N_BIGCORPUS_DOCS = 3000  # the corpus-scale eval cut to this many documents (eval_results/: 33,000)
N_BIGCORPUS_QUERIES = 200
N_LEGACY_QUERIES = 64
NATIVE_DOCS = 20_000  # README's size for the native build's speed-up
# card against the host CPU: the bf16 encoder's rows differ by about one bf16 ulp
# (9.8e-4 near 0.5, phase 6) and final scores where the ids agree by up to 3.75e-3
# (phase 10(a) on an H100), so two results may swap where their scores lie within
# twice that
EVAL_TIE_ATOL = 1e-2
EVAL_METRIC_ATOL = 1e-9  # batched against staged (tests/test_eval.py's bound), CLI against (a)
LEGACY_TIE_ATOL = 1e-5  # bf16 rows: the dense-scores kernel's f32 sums in another order
LADDER = ("1_lexical_only", "2_dense_only", "3_dual_hybrid_rrf", "4_triple_hybrid",
          "5_full_pipeline")
HARNESS_TEXT = "Acme Corp settles invoices within thirty days. Maria Silva works for Acme Corp."


def stdlib_eval_config():
    """``evaluate_stdlib``'s default configuration at k = 10 (float32 rows)."""
    from triple_hybrid_rag_tpu_torch.config import RAGConfig

    return RAGConfig(capacity_round=64, embedding_dtype="float32", safety_threshold=0.0,
                     final_top_k=10, rerank_top_k=20, denoise_alpha=0.0, graph_enabled=False)


def metric_line(m: dict, k: int = 10) -> str:
    return (f"recall@{k} {m[f'recall@{k}']:.4f}, ndcg@{k} {m[f'ndcg@{k}']:.4f}, mrr "
            f"{m['mrr']:.4f} ({int(m['n_queries'])} queries)")


def recorded(name: str) -> dict:
    """The ``results`` of an ``eval_results/`` file (not this port's: printed beside
    its numbers, never compared), or {} when the checkout lacks it."""
    from pathlib import Path

    path = Path(__file__).resolve().parent / "eval_results" / name
    return json.loads(path.read_text())["results"] if path.exists() else {}


def expect_launches(label: str, launches: dict, want: dict) -> None:
    """Fails unless ``launches`` equal ``want`` (kernels not named there: 0)."""
    full = {k: want.get(k, 0) for k in launches}
    if launches != full:
        fail(f"{label}: kernel launches {launches}, expected {full}")


def eval_ladder(dev, card):
    """Phase 10(a): ``evaluate_baseline_configs()`` at its defaults (five
    configurations, float32 rows, the packaged encoder) on the card and on the host
    CPU. Gates of tests/test_eval.py; ids card against CPU up to near ties; one f32
    dense-scores launch per query with the semantic channel on, MaxSim in
    5_full_pipeline. Returns (metrics, launches)."""
    from triple_hybrid_rag_tpu_torch.eval import evaluate_baseline_configs

    res, res_cpu = {}, {}
    t0 = time.time()
    m, launches = counted(lambda: evaluate_baseline_configs(device=dev, results=res))
    card_s = time.time() - t0
    t0 = time.time()
    m_cpu = evaluate_baseline_configs(device="cpu", results=res_cpu)
    cpu_s = time.time() - t0
    n = int(m[LADDER[0]]["n_queries"])
    for name in LADDER:
        log(f"BASELINE {name}: card {metric_line(m[name])}; host CPU {metric_line(m_cpu[name])}")
        same_ids(f"BASELINE {name}, card against the host CPU", pairs(res_cpu[name]),
                 pairs(res[name]), EVAL_TIE_ATOL)
    log(f"BASELINE ladder: {card_s:.1f} s on the card (five retrievers built, {5 * n} staged "
        f"queries), {cpu_s:.1f} s on the host CPU; kernel launches {launches}; card {card}")
    r = {name: m[name]["recall@10"] for name in LADDER}
    if min(r["1_lexical_only"], r["3_dual_hybrid_rrf"], r["5_full_pipeline"]) <= 0.3:
        fail(f"BASELINE ladder: recall@10 {r} at or below 0.3")
    if r["3_dual_hybrid_rrf"] < min(r["1_lexical_only"], r["2_dense_only"]) - 1e-6:
        fail(f"BASELINE ladder: dual hybrid below the weaker single channel: {r}")
    expect_launches("BASELINE ladder", launches,
                    {"dense_scores": 4 * n, "dense_scores_f32": 4 * n, "maxsim_scores": n})
    return m, launches


def eval_stdlib(dev, card):
    """Phase 10(b): ``evaluate_stdlib()`` at its defaults (500 docstrings of this
    Python's stdlib, 150 queries, four configurations) beside
    eval_results/stdlib_500_fixed.json's. Returns (the corpus, launches)."""
    from triple_hybrid_rag_tpu_torch.eval import evaluate_stdlib, make_stdlib_eval

    t0 = time.time()
    data = make_stdlib_eval(stdlib_eval_config())
    build_s = time.time() - t0
    t0 = time.time()
    m, launches = counted(lambda: evaluate_stdlib(device=dev))
    eval_s = time.time() - t0
    old = recorded("stdlib_500_fixed.json")
    for name, mm in m.items():
        was = metric_line(old[name]) if name in old else "absent"
        log(f"stdlib {name}: card {metric_line(mm)}; eval_results/stdlib_500_fixed.json (another "
            f"Python build, an older encoder) {was}")
    n = int(m["full_pipeline"]["n_queries"])
    log(f"stdlib eval: corpus built in {build_s:.1f} s (harvest, cloze, chunking: "
        f"make_stdlib_eval); evaluate_stdlib {eval_s:.1f} s (the corpus again, four retrievers "
        f"built, {4 * n} staged queries); {len(data.corpus)} chunks; kernel launches {launches}; "
        f"card {card}")
    expect_launches("stdlib eval", launches,
                    {"dense_scores": 3 * n, "dense_scores_f32": 3 * n, "maxsim_scores": n})
    return data, launches


def batched_against_staged(dev, card, stdlib_data):
    """Phase 10(c): ``evaluate_batched`` over ``Engine`` against ``evaluate`` over
    ``Retriever`` on tests/test_eval.py's corpus (equal within 1e-9, as the reference's
    two paths are on it), then on (b)'s corpus under its full pipeline (printed).
    Returns the launches."""
    from triple_hybrid_rag_tpu_torch.config import RAGConfig
    from triple_hybrid_rag_tpu_torch.engine import Engine
    from triple_hybrid_rag_tpu_torch.eval import evaluate, evaluate_batched, make_eval_corpus
    from triple_hybrid_rag_tpu_torch.index.graph_index import build_graph_index
    from triple_hybrid_rag_tpu_torch.retrieval import Retriever

    cfg = RAGConfig(capacity_round=64, embedding_dim=128, embedding_dim_full=256,
                    embedding_dtype="float32", safety_threshold=0.0, final_top_k=10,
                    rerank_top_k=20, denoise_alpha=0.0, embedder_backend="bowhash")
    data = make_eval_corpus(cfg, docs_per_topic=2, distractors=10)
    total: dict = {}
    for label, corpus, queries, c, gidx in (
        ("make_eval_corpus", data.corpus, data.queries, cfg,
         build_graph_index(data.entity_store, data.corpus, cfg)),
        ("stdlib full pipeline", stdlib_data.corpus, stdlib_data.queries, stdlib_eval_config(),
         None),
    ):
        ret = Retriever(corpus, c, graph_index=gidx, device=dev)
        eng = Engine.from_retriever(ret)
        t0 = time.time()
        staged, l_staged = counted(
            lambda: evaluate(lambda q: ret.retrieve(q, top_k=10), queries, k=10))
        staged_s = time.time() - t0
        t0 = time.time()
        batched, l_batched = counted(lambda: evaluate_batched(eng, queries, k=10))
        batched_s = time.time() - t0
        gap = {key: abs(batched[key] - staged[key]) for key in ("recall@10", "ndcg@10", "mrr")}
        log(f"{label}: staged {metric_line(staged)} in {staged_s:.2f} s, launches {l_staged}; "
            f"batched (B = 64) {metric_line(batched)} in {batched_s:.2f} s, launches {l_batched}; "
            f"gaps {gap}; card {card}")
        n = len(queries)
        if l_staged["dense_scores_f32"] != n or l_batched["fused_bucket_maxima_f32"] != -(-n // 64):
            fail(f"{label}: expected {n} f32 dense-scores launches staged and one f32 "
                 f"bucket-maxima launch per batch of 64")
        if label == "make_eval_corpus" and max(gap["recall@10"], gap["ndcg@10"]) > EVAL_METRIC_ATOL:
            fail(f"{label}: batched and staged metrics differ by {gap}")
        add_counts(total, l_staged)
        add_counts(total, l_batched)
    return total


def eval_code_graph(dev, card):
    """Phase 10(d): ``evaluate_code_graph()`` (oracle graph, 200 modules): graph_on
    against graph_off, beside eval_results/code_graph_240.json (240 modules).
    Returns the launches."""
    from triple_hybrid_rag_tpu_torch.eval import evaluate_code_graph

    t0 = time.time()
    m, launches = counted(lambda: evaluate_code_graph(device=dev))
    secs = time.time() - t0
    old = recorded("code_graph_240.json")
    for name, mm in m.items():
        kinds = ", ".join(f"{k[len('recall@10_'):]} {v:.4f}" for k, v in mm.items()
                          if k.startswith("recall@10_"))
        was = metric_line(old[name]) if name in old else "absent"
        log(f"code graph {name}: card {metric_line(mm)}, recall@10 by kind {kinds}; "
            f"eval_results/code_graph_240.json {was}")
    n = int(m["graph_on"]["n_queries"])
    gain = m["graph_on"]["recall@10"] - m["graph_off"]["recall@10"]
    log(f"code graph: graph_on minus graph_off recall@10 {gain:+.4f}; {secs:.1f} s (corpus, "
        f"three retrievers, {3 * n} staged queries); kernel launches {launches}; card {card}")
    expect_launches("code graph", launches,
                    {"dense_scores": 2 * n, "dense_scores_f32": 2 * n, "maxsim_scores": 2 * n})
    return launches


def eval_bigcorpus(dev, card):
    """Phase 10(e): ``make_bigcorpus_eval`` cut to N_BIGCORPUS_DOCS documents, the
    training-content exclusion on, through the full pipeline. Returns the launches."""
    from triple_hybrid_rag_tpu_torch.eval import evaluate, make_bigcorpus_eval
    from triple_hybrid_rag_tpu_torch.retrieval import Retriever

    cfg = stdlib_eval_config()
    t0 = time.time()
    data = make_bigcorpus_eval(cfg, n_docs=N_BIGCORPUS_DOCS, n_queries=N_BIGCORPUS_QUERIES)
    build_s = time.time() - t0
    t0 = time.time()
    ret = Retriever(data.corpus, cfg, device=dev)
    torch.cuda.synchronize()
    index_s = time.time() - t0
    t0 = time.time()
    m, launches = counted(lambda: evaluate(lambda q: ret.retrieve(q, top_k=10), data.queries, k=10))
    eval_s = time.time() - t0
    old = recorded("bigcorpus.json").get("full_pipeline")
    log(f"bigcorpus (cut to {N_BIGCORPUS_DOCS} documents of 33,000; {len(data.corpus)} chunks, "
        f"{data.corpus.n_parents} parents): full pipeline {metric_line(m)}; "
        f"eval_results/bigcorpus.json at 33,000 documents "
        f"{metric_line(old) if old else 'absent'}; corpus {build_s:.1f} s (exclusion harvest, "
        f"AST walk, cloze, chunking), retriever {index_s:.1f} s (embed, index, place), "
        f"evaluate {eval_s:.1f} s; kernel launches {launches}; card {card}")
    n = int(m["n_queries"])
    expect_launches("bigcorpus", launches,
                    {"dense_scores": n, "dense_scores_f32": n, "maxsim_scores": n})
    return launches


def outcomes(summary: dict) -> list:
    return [(r["scenario"], r["ok"], r["failures"]) for r in summary["results"]]


def harness_check(dev, card, rag6):
    """Phase 10(f): the tool harness on the card: ``default_scenarios()`` (all four
    must pass) and tests/test_harness.py's three scenarios (their outcomes) over a
    small RAG of that file's fixture text; ``default_scenarios()`` over phase 6's RAG
    on the card and, loaded from its checkpoint, on the host CPU (equal outcomes).
    Returns the launches."""
    import tempfile

    from triple_hybrid_rag_tpu_torch import RAG, RAGConfig
    from triple_hybrid_rag_tpu_torch.harness import (
        HarnessRunner, Scenario, default_scenarios, expect_refusal, expect_sources,
        expect_success, expect_text_contains)
    from triple_hybrid_rag_tpu_torch.tools import make_knowledge_tools

    cfg = RAGConfig(graph_enabled=True, embedding_dtype="float32", safety_threshold=0.6,
                    rerank_backend="maxsim")
    small = RAG(cfg, device=dev)
    small.ingest_text(HARNESS_TEXT, name="pay.md")
    runner = HarnessRunner(make_knowledge_tools(small))
    summary, launches = counted(lambda: runner.run(default_scenarios()))
    log(f"harness, default scenarios over the fixture's RAG: {summary['passed']} of "
        f"{summary['total']} passed {outcomes(summary)}; kernel launches {launches}")
    if summary["passed"] != summary["total"] or launches["dense_scores_f32"] < 1:
        fail(f"harness: default scenarios {outcomes(summary)}, launches {launches}")
    three = runner.run([
        Scenario("hit", "search_knowledge_base", {"query": "invoice settlement days"},
                 [expect_success, expect_sources(1), expect_text_contains("invoices")]),
        Scenario("refusal", "search_knowledge_base", {"query": "qqq zzz gibberish"},
                 [expect_refusal]),
        Scenario("entity", "lookup_entity", {"name": "Acme Corp"}, [expect_success]),
    ])
    wrong = runner.run([Scenario("wrong_expectation", "search_knowledge_base",
                                 {"query": "invoice settlement days"}, [expect_refusal])])
    unknown = runner.run([Scenario("nope", "no_such_tool", {}, [expect_success])])
    log(f"harness, tests/test_harness.py's scenarios: {outcomes(three)}, {outcomes(wrong)}, "
        f"{outcomes(unknown)}; ms {[r['duration_ms'] for r in three['results']]}")
    if (three["passed"], wrong["failed"], unknown["failed"]) != (3, 1, 1) \
            or not wrong["results"][0]["failures"]:
        fail("harness: tests/test_harness.py's scenarios gave other outcomes")
    on_card = HarnessRunner(make_knowledge_tools(rag6)).run(default_scenarios())
    with tempfile.TemporaryDirectory(prefix="thr-harness-") as tmp:
        rag6.save(tmp)
        t0 = time.time()
        cpu = RAG.load(tmp, device="cpu")
        on_cpu = HarnessRunner(make_knowledge_tools(cpu)).run(default_scenarios())
        cpu_s = time.time() - t0
    log(f"harness, default scenarios over phase 6's RAG: card {outcomes(on_card)}; host CPU "
        f"(loaded from its checkpoint, {cpu_s:.1f} s) {outcomes(on_cpu)}")
    if outcomes(on_card) != outcomes(on_cpu):
        fail("harness: phase 6's RAG gave other outcomes on the card than on the host CPU")
    return launches


def native_check(texts, card):
    """Phase 10(h): ``native.build_library()`` into build/native/, then the native
    BM25 build over phase 6's child texts bit-equal to the Python build; both builds
    timed there and at NATIVE_DOCS documents (host CPU). Returns the Python build."""
    from triple_hybrid_rag_tpu_torch import native
    from triple_hybrid_rag_tpu_torch.config import RAGConfig
    from triple_hybrid_rag_tpu_torch.index.bm25_index import build_bm25_index

    t0 = time.time()
    if not native.build_library() or not native.available():
        fail(f"native library: {native.load_error()}")
    log(f"native library built and loaded in {time.time() - t0:.1f} s "
        f"({native.library_path().relative_to(native.library_path().parents[2])})")
    cfg = RAGConfig()
    out = None
    for docs in (texts, (texts * (NATIVE_DOCS // max(len(texts), 1) + 1))[:NATIVE_DOCS]):
        t0 = time.time()
        nat = build_bm25_index(docs, cfg)
        nat_s = time.time() - t0
        t0 = time.time()
        py = build_bm25_index(docs, cfg.replace(use_native=False))
        py_s = time.time() - t0
        out = out or py
        for key, arr in py.arrays().items():
            mine = nat.arrays()[key]
            if mine.dtype != arr.dtype or mine.shape != arr.shape or \
                    mine.tobytes() != arr.tobytes():
                fail(f"native BM25 build over {len(docs)} texts: {key} differs from the Python build")
        if nat.vocab.to_list() != py.vocab.to_list() or (nat.l_max, nat.overflow_docs) != (
                py.l_max, py.overflow_docs):
            fail(f"native BM25 build over {len(docs)} texts: vocabulary or statistics differ")
        log(f"native BM25 build over {len(docs)} texts: {nat_s:.2f} s against the Python "
            f"build's {py_s:.2f} s ({py_s / nat_s:.2f}x), every array bit-equal (host CPU of "
            f"the card's machine; README: 10.6x at 20k documents)")
    return out


def legacy_check(dev, card, rag6, queries, bm25):
    """Phase 10(g): the RAG 1.0 ``HybridSearcher`` over phase 6's corpus on the card
    (bf16 rows: one dense-scores launch per query) against the same searcher on the
    host CPU: equal results, or channels that differ by near ties of the vector
    scores only. Returns the launches."""
    from triple_hybrid_rag_tpu_torch.index.dense_index import build_dense_index, truncate_matryoshka
    from triple_hybrid_rag_tpu_torch.legacy import HybridSearcher
    from triple_hybrid_rag_tpu_torch.models.embedder import BowHashEmbedder

    corpus, cfg = rag6.ingestor.corpus, rag6.config
    emb = BowHashEmbedder(dim=cfg.embedding_dim_full, config=cfg)
    t0 = time.time()
    vecs = emb.embed_texts(corpus.child_texts())
    embed_s = time.time() - t0
    card_hs, cpu_hs = (
        HybridSearcher(corpus, cfg, embedder=emb, bm25_index=bm25,
                       dense_index=build_dense_index(vecs, cfg, where), device=where)
        for where in (dev, "cpu"))
    qs = queries[:N_LEGACY_QUERIES]
    card_hs.search_query(qs[0])  # warm-up
    t0 = time.perf_counter()
    got, launches = counted(lambda: [card_hs.search_query(q) for q in qs])
    ms = (time.perf_counter() - t0) / len(qs) * 1e3
    want = [cpu_hs.search_query(q) for q in qs]
    same, near = 0, 0
    k = card_hs.search_config.vector_top_k
    for q, a, b in zip(qs, got, want):
        if [x.chunk_id for x in a] == [x.chunk_id for x in b]:
            same += 1
            if max([abs(x.rrf_score - y.rrf_score) for x, y in zip(a, b)] + [0.0]) > 1e-6:
                fail(f"legacy searcher: RRF scores differ for {q!r}")
            continue
        # the results may differ only through near ties of the vector channel
        qv = truncate_matryoshka(emb.embed_query(q)[None], cfg.embedding_dim)[0]
        ids_c, _ = card_hs.dense_index.search(torch.from_numpy(qv).to(dev), k)
        ids_h, s_h = cpu_hs.dense_index.search(torch.from_numpy(qv), k)
        if near_ties_only(ids_c.cpu()[None], ids_h[None], s_h[None], LEGACY_TIE_ATOL) < 0:
            fail(f"legacy searcher: {q!r} differs beyond near ties of the vector channel")
        near += 1
    log(f"legacy HybridSearcher over phase 6's {len(corpus)} chunks (bf16 rows, BowHash {emb.dim} "
        f"-> {cfg.embedding_dim}, embedded in {embed_s:.1f} s): {ms:.3f} ms a query on the card; "
        f"{same} of {len(qs)} queries equal to the host CPU's, {near} differ by near ties of the "
        f"vector channel; kernel launches {launches}; card {card}")
    expect_launches("legacy searcher", launches, {"dense_scores": len(qs)})
    return launches


def cli_eval(card, ladder: dict, device) -> None:
    """Phase 10(i): ``python -m triple_hybrid_rag_tpu_torch eval --json`` in a new
    process on the card (its default device) must give (a)'s metrics."""
    import os

    t0 = time.time()
    on = [] if torch.device(device).type == "cuda" else ["--device", str(device)]
    out = subprocess.run(
        [sys.executable, "-m", "triple_hybrid_rag_tpu_torch", "eval", "--json", *on],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True,
        timeout=900,
    )
    if out.returncode != 0:
        fail(f"thr-torch eval exited {out.returncode}: {out.stderr[-2000:]}")
    got = json.loads(out.stdout.strip().splitlines()[-1])
    gap = max(abs(got[name][key] - v) for name in LADDER for key, v in ladder[name].items())
    log(f"CLI: python -m triple_hybrid_rag_tpu_torch eval --json in {time.time() - t0:.1f} s "
        f"(a new process on the card); largest metric gap to (a) {gap:.3g}; card {card}")
    if list(got) != list(LADDER) or gap > EVAL_METRIC_ATOL:
        fail(f"thr-torch eval gave other metrics than (a): {got}")


def eval_path(dev, card, ctx):
    """Phase 10: the quality evaluation, the tool harness, the RAG 1.0 searcher and
    the native BM25 build, on the card. Returns (eval launches, legacy launches)."""
    rag6, queries, _ = ctx
    evals: dict = {}
    t0 = time.time()
    ladder, part = eval_ladder(dev, card)
    add_counts(evals, part)
    log(f"phase 10(a) wall time {time.time() - t0:.1f} s")
    t0 = time.time()
    stdlib_data, part = eval_stdlib(dev, card)
    add_counts(evals, part)
    log(f"phase 10(b) wall time {time.time() - t0:.1f} s")
    t0 = time.time()
    add_counts(evals, batched_against_staged(dev, card, stdlib_data))
    del stdlib_data
    log(f"phase 10(c) wall time {time.time() - t0:.1f} s")
    t0 = time.time()
    add_counts(evals, eval_code_graph(dev, card))
    log(f"phase 10(d) wall time {time.time() - t0:.1f} s")
    t0 = time.time()
    add_counts(evals, eval_bigcorpus(dev, card))
    log(f"phase 10(e) wall time {time.time() - t0:.1f} s")
    t0 = time.time()
    add_counts(evals, harness_check(dev, card, rag6))
    log(f"phase 10(f) wall time {time.time() - t0:.1f} s")
    t0 = time.time()
    bm25 = native_check(rag6.ingestor.corpus.child_texts(), card)
    log(f"phase 10(h) wall time {time.time() - t0:.1f} s")
    t0 = time.time()
    legacy = legacy_check(dev, card, rag6, queries, bm25)
    log(f"phase 10(g) wall time {time.time() - t0:.1f} s")
    t0 = time.time()
    cli_eval(card, ladder, dev)
    log(f"phase 10(i) wall time {time.time() - t0:.1f} s")
    return evals, legacy


# ---------------------------------------------------------------- phase 11

TRAIN_STEPS = 200  # (b): the shipped encoder's warm-started fine-tune
TRAIN_LR = 2e-4  # a low-LR fine-tune, the reference's warm-start recipe (docs/STATUS.md)
CHECK_BATCH = 64  # (a): pairs per batch, card against host
CHECK_STEPS = 3
# (a) step 0: the same weights in f32 on both, f32 sums in another order
STEP0_RTOL = 1e-4
# (a) later steps: after one or two Adam steps of 1e-5 and 2e-5, in which a
# gradient entry near zero may take either sign on the two devices
LATER_RTOL = 1e-3
CLI_STEPS = 300
CLI_BAR = 0.8  # the reference's test_training_step_learns bar
N_ALIGNER_TEXTS = 256  # (e): stdlib docstrings x 2 renders
N_ALIGNER_HELDOUT = 64
ALIGNER_STEPS = 200
N_JSON = 20  # (f): constrained outputs that must parse


def train_batches(cfg, n: int, batch: int, seed: int):
    """``n`` batches of ``make_mixed_pairs`` (the recipe's mixture over this host's
    real-text harvest) hashed at 32 tokens a side, anchors in f16: numpy arrays."""
    from triple_hybrid_rag_tpu_torch.config import get_settings
    from triple_hybrid_rag_tpu_torch.models.encoder import TextHasher, anchor_arrays
    from triple_hybrid_rag_tpu_torch.models.pretrain import make_mixed_pairs, realtext_documents

    docs = realtext_documents()
    hasher = TextHasher(cfg, get_settings())
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        pairs = make_mixed_pairs(batch, rng, overlap_frac=0.3, realtext_frac=0.35, realtext_docs=docs)
        arrs = []
        for texts in ([q for q, _ in pairs], [d for _, d in pairs]):
            ids, mask = hasher.encode(texts, max_tokens=32)
            ap, at = anchor_arrays(texts, cfg, hasher.analyzer, max_tokens=32)
            arrs += [ids, mask, ap.astype(np.float16), at.astype(np.float16)]
        out.append(arrs)
    return out, len(docs)


def train_config(steps: int, lr: float, cfg):
    """``train_default_encoder``'s TrainConfig for ``steps`` steps."""
    from triple_hybrid_rag_tpu_torch.models.training import TrainConfig

    return TrainConfig(learning_rate=lr, warmup_steps=max(20, steps // 20), decay_steps=max(steps, 100),
                       matryoshka_dims=(cfg.out_dim, cfg.out_dim // 2, cfg.out_dim // 4),
                       maxsim_weight=0.25)


def train_card_host(dev, card):
    """Phase 11(a): the shipped npz at the scaled config, warm-started on the card
    and on the host CPU, ``CHECK_STEPS`` steps of ``make_train_step`` on the same
    batches: step 0 (lr 0) leaves the weights bit-equal and its loss agrees within
    STEP0_RTOL, the later losses within LATER_RTOL."""
    from triple_hybrid_rag_tpu_torch.models.pretrain import (
        DEFAULT_PARAMS, load_encoder_weights_, scaled_encoder_config)
    from triple_hybrid_rag_tpu_torch.models.training import create_train_state, make_train_step

    cfg = dataclasses.replace(scaled_encoder_config(), dtype="float32")
    tc = train_config(TRAIN_STEPS, TRAIN_LR, cfg)
    data, n_docs = train_batches(cfg, CHECK_STEPS, CHECK_BATCH, seed=7)
    losses, params = {}, {}
    for where in (dev, "cpu"):
        model, state = create_train_state(cfg, tc, device=where)
        load_encoder_weights_(model, DEFAULT_PARAMS)
        start = {k: p.detach().clone() for k, p in model.named_parameters()}
        step = make_train_step(model, tc)
        losses[str(where)] = []
        t0 = time.time()
        for i, arrs in enumerate(data):
            state, m = step(state, *[torch.from_numpy(a).to(where) for a in arrs])
            losses[str(where)].append((float(m["loss"]), float(m["accuracy"])))
            if i == 0 and any(not torch.equal(p, start[k]) for k, p in model.named_parameters()):
                fail(f"phase 11(a) on {where}: step 0 (lr 0) changed the weights")
        log(f"phase 11(a) on {where}: {CHECK_STEPS} steps of B = {CHECK_BATCH} in "
            f"{time.time() - t0:.2f} s; (loss, accuracy) {losses[str(where)]}")
        params[str(where)] = {k: p.detach().cpu() for k, p in model.named_parameters()}
    TRAIN_CHECK.update(data=data, losses=losses[str(dev)], params=params[str(dev)])
    got, want = losses[str(dev)], losses["cpu"]
    rel = [abs(g[0] - w[0]) / abs(w[0]) for g, w in zip(got, want)]
    drift = max(float((params[str(dev)][k] - params["cpu"][k]).abs().max()) for k in params["cpu"])
    log(f"phase 11(a): card against host CPU, relative loss gaps {[f'{r:.3g}' for r in rel]} "
        f"(limits {STEP0_RTOL} at step 0, {LATER_RTOL} after), largest weight gap after "
        f"{CHECK_STEPS} steps {drift:.3g}; {n_docs} harvested documents; card {card}")
    if rel[0] > STEP0_RTOL or max(rel[1:]) > LATER_RTOL:
        fail(f"phase 11(a): the card's losses {got} differ from the host's {want}")


def train_throughput(dev, card, tmp):
    """Phase 11(b): ``train_default_encoder`` at the scaled config warm-started from
    the shipped npz for TRAIN_STEPS steps at B = 128 on the card: ms/step on the
    wall, the host's batch building and the device's span per step, peak memory,
    first and last losses. Returns the saved path."""
    from triple_hybrid_rag_tpu_torch.models.pretrain import (
        DEFAULT_PARAMS, scaled_encoder_config, train_default_encoder)

    stats: dict = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    path, metrics = train_default_encoder(
        f"{tmp}/finetuned.npz", steps=TRAIN_STEPS, enc_cfg=scaled_encoder_config(), lr=TRAIN_LR,
        init_params_path=DEFAULT_PARAMS, log_every=0, device=dev, stats=stats)
    wall = time.time() - t0
    skip = min(10, TRAIN_STEPS // 4)  # the first steps warm the allocator and the libraries up
    step_ms = np.diff(stats["t"][skip:]) * 1e3
    host = np.array(stats["host_s"][skip:]) * 1e3
    device = np.array(stats["device_ms"][skip:])
    loss, acc = stats["loss"], stats["accuracy"]
    log(f"phase 11(b): {TRAIN_STEPS} steps of B = 128 at the scaled config (43M parameters, "
        f"warm-started, lr {TRAIN_LR}) in {wall:.1f} s with the start and the saves; per step "
        f"(median after {skip}) wall {np.median(step_ms):.2f} ms, host batch building "
        f"{np.median(host):.2f} ms ({100 * np.median(host) / np.median(step_ms):.1f} % of the wall), "
        f"device span {np.median(device):.2f} ms (mean {device.mean():.2f}); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; loss {loss[0]:.4f} -> {loss[-1]:.4f}, "
        f"accuracy {acc[0]:.3f} -> {acc[-1]:.3f}; card {card}")
    first, last = float(np.mean(loss[:50])), float(np.mean(loss[-50:]))
    log(f"phase 11(b): mean loss of the first 50 steps {first:.4f}, of the last 50 {last:.4f}")
    if not np.isfinite(loss).all() or last > 2 * first:
        fail(f"phase 11(b): the fine-tune diverged: {first} -> {last}")
    return path


def train_profile(dev, card, steps: int = 5) -> None:
    """Phase 11(b), second part: ``steps`` steps of ``make_train_step`` at the scaled
    config and B = 128 on batches built beforehand, under torch.profiler: the
    step's wall without the host's batch building, the device's busy time (the
    kernels' own times) and the kernels a step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from triple_hybrid_rag_tpu_torch.models.pretrain import scaled_encoder_config
    from triple_hybrid_rag_tpu_torch.models.training import create_train_state, make_train_step

    cfg = dataclasses.replace(scaled_encoder_config(), dtype="float32")
    tc = train_config(TRAIN_STEPS, TRAIN_LR, cfg)
    model, state = create_train_state(cfg, tc, device=dev)
    step = make_train_step(model, tc)
    data, _ = train_batches(cfg, steps + 1, 128, seed=11)
    batches = [[torch.from_numpy(a).to(dev) for a in arrs] for arrs in data]
    state, _ = step(state, *batches[0])  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches[1:]:
            state, _ = step(state, *b)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(device_self_ms(e) for e in kernels) / steps
    launches = sum(e.count for e in kernels) / steps
    top = sorted(kernels, key=device_self_ms, reverse=True)[:5]
    log(f"phase 11(b) profile: {steps} steps of B = 128 on prepared batches: wall {wall:.2f} ms/step "
        f"(profiler on), device busy {busy:.2f} ms/step ({100 * busy / wall:.1f} % of the wall, "
        f"idle {100 * max(0.0, 1 - busy / wall):.1f} %), {launches:.0f} kernels a step; longest: "
        + "; ".join(f"{device_self_ms(e) / steps:.2f} ms x{e.count // steps} {e.key[:60]}" for e in top)
        + f"; card {card}")


def train_cli(card, tmp, device):
    """Phase 11(c): ``python -m triple_hybrid_rag_tpu_torch train-encoder --steps
    CLI_STEPS`` cold at the default configuration in a new process on the card; the
    mean loss of its last 50 steps at most CLI_BAR of its first 50's; the file in
    ``save_packaged_encoder``'s scheme, loadable. Returns its recall line."""
    import os
    import re

    from triple_hybrid_rag_tpu_torch.models.encoder import encoder_params_to_flax, init_encoder
    from triple_hybrid_rag_tpu_torch.models.pretrain import default_encoder_config, load_default_encoder

    out = f"{tmp}/cli_encoder.npz"
    t0 = time.time()
    res = subprocess.run(
        [sys.executable, "-m", "triple_hybrid_rag_tpu_torch", "train-encoder", "--steps",
         str(CLI_STEPS), "--out", out, "--log-every", "1", "--device", str(device)],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True, timeout=600)
    wall = time.time() - t0
    if res.returncode != 0:
        fail(f"thr-torch train-encoder exited {res.returncode}: {res.stderr[-2000:]}")
    losses = [float(x) for x in re.findall(r"^step \d+: loss=([0-9.]+)", res.stdout, re.M)]
    recall = [x for x in res.stdout.splitlines() if "paraphrase recall" in x]
    first, last = float(np.mean(losses[:50])), float(np.mean(losses[-50:]))
    log(f"phase 11(c): thr-torch train-encoder --steps {CLI_STEPS} in {wall:.1f} s (a new process: "
        f"start, harvest, training, save, recall) on the card; mean loss {first:.4f} over the first "
        f"50 steps, {last:.4f} over the last 50 ({last / first:.3f}, limit {CLI_BAR}); "
        f"{recall[-1] if recall else 'no recall line'}; card {card}")
    if len(losses) != CLI_STEPS or not recall or last > CLI_BAR * first:
        fail(f"phase 11(c): the CLI did not learn or report: {res.stdout[-2000:]}")
    cfg = default_encoder_config()
    want = encoder_params_to_flax(init_encoder(cfg, device="cpu").state_dict(), cfg.n_heads)
    with np.load(out) as npz:
        meta = json.loads(bytes(npz["__meta__"]).decode())
        names = [k for k in npz.files if k != "__meta__"]
        bad = [k for k in names if k not in want or npz[k].shape != want[k].shape
               or npz[k].dtype != np.float16]
    if (sorted(names) != sorted(want) or bad or meta["encoder_config"] != dataclasses.asdict(cfg)
            or meta["format"] != 1 or set(meta["metrics"]) != {"loss", "accuracy"}):
        fail(f"phase 11(c): the CLI's file is not in the packaged scheme: {bad} {meta}")
    if load_default_encoder(path=out, device=device) is None:
        fail("phase 11(c): load_default_encoder could not read the CLI's file")
    return recall[-1]


def serve_trained(dev, card, path):
    """Phase 11(d): the default RAGConfig with ``encoder_params_path`` = (b)'s file
    on the card: the paraphrase holdout's 64 documents ingested, its 64 queries
    through ``query_batch``; recall@10, and ``paraphrase_recall_at_k`` of the
    shipped and the fine-tuned weights. Returns the launches."""
    from triple_hybrid_rag_tpu_torch import RAG, RAGConfig
    from triple_hybrid_rag_tpu_torch.models.pretrain import (
        load_default_encoder, make_paraphrase_holdout, paraphrase_recall_at_k)

    docs, queries, rel = make_paraphrase_holdout()
    cfg = RAGConfig().replace(encoder_params_path=str(path))
    rag = RAG(cfg, device=dev)
    for i, d in enumerate(docs):
        rag.ingest_text(d, name=f"holdout_{i}.md")
    inner = getattr(rag.ingestor.embedder, "inner", rag.ingestor.embedder)
    if type(inner).__name__ != "EncoderEmbedder" or inner.enc_cfg.d_model != 512:
        fail(f"phase 11(d): the RAG embeds with {type(inner).__name__}, not the fine-tuned encoder")
    t0 = time.time()
    results, launches = counted(lambda: rag.query_batch(queries, top_k=10))
    ms = (time.time() - t0) * 1e3
    hits = sum(any(docs[rel[i]] in x.text for x in r.results[:10]) for i, r in enumerate(results))
    refused = sum(bool(r.refused) for r in results)
    shipped = paraphrase_recall_at_k(load_default_encoder(cfg.replace(encoder_params_path=None), device=dev))
    tuned = paraphrase_recall_at_k(load_default_encoder(cfg, device=dev))
    log(f"phase 11(d): the fine-tuned checkpoint served by the default RAGConfig: recall@10 "
        f"{hits / len(queries):.4f} over {len(queries)} paraphrase queries through query_batch "
        f"({refused} refused by the 0.6 gate; {ms:.1f} ms for the batch); dense-only "
        f"paraphrase_recall_at_k(10): shipped {shipped:.4f}, fine-tuned {tuned:.4f}; launches "
        f"{launches['fused_bucket_maxima']} bf16 bucket maxima, {launches['maxsim_scores']} "
        f"MaxSim bf16; card {card}")
    if launches["fused_bucket_maxima"] < 1 or launches["maxsim_scores"] < 1:
        fail(f"phase 11(d): the trained checkpoint was not served through both kernels: {launches}")
    return launches


def noise_png(seed: int) -> bytes:
    """A random RGB image with no text: the OCR ladder finds none."""
    from PIL import Image
    import io

    arr = np.random.default_rng(seed).integers(0, 255, (40, 56, 3)).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def aligner_path(dev, card, tmp):
    """Phase 11(e): ``train_visual_aligner`` at its default config against the
    packaged encoder's text vectors, on N_ALIGNER_TEXTS stdlib docstrings x 2
    renders for ALIGNER_STEPS steps; image->text top-1 on held-out renders; save
    and load; the encoder's ``embed_images`` through the aligner rung."""
    from triple_hybrid_rag_tpu_torch.models import embedder as emb_mod
    from triple_hybrid_rag_tpu_torch.models import visual_align as va
    from triple_hybrid_rag_tpu_torch.models.pretrain import load_default_encoder

    _, defs = stdlib_docstrings()
    texts = [t for _, t in defs if len(t.split()) >= 6]
    pick = np.linspace(0, len(texts) - 1, N_ALIGNER_TEXTS + N_ALIGNER_HELDOUT).astype(int)
    chosen = [texts[i] for i in pick]
    train, held = chosen[:N_ALIGNER_TEXTS], chosen[N_ALIGNER_TEXTS:]
    enc = load_default_encoder(device=dev)
    marks = {}

    def note(msg: str) -> None:
        marks.setdefault("pairs" if msg.startswith("training pairs") else "other", time.time())

    t0 = time.time()
    params, cfg = va.train_visual_aligner(train, enc, steps=ALIGNER_STEPS, batch=64, seed=0,
                                          log=note, device=dev)
    torch.cuda.synchronize()
    t1 = time.time()
    render_s = marks["pairs"] - t0
    step_ms = (t1 - marks["pairs"]) / ALIGNER_STEPS * 1e3
    va_emb = va.VisualAlignEmbedder(params, cfg, device=dev)
    rng = np.random.default_rng(123)
    top1 = {}
    for name, group in (("held-out texts", held), ("fresh renders of training texts", train[:N_ALIGNER_HELDOUT])):
        grids = [va.render_training_pair(t, rng, cfg.image_size) for t in group]
        keep = [i for i, g in enumerate(grids) if g is not None]
        iv = va_emb.embed_grids(np.stack([grids[i] for i in keep]))
        tv = np.asarray(enc.embed_texts([group[i] for i in keep]), np.float32)
        tv /= np.maximum(np.linalg.norm(tv, axis=1, keepdims=True), 1e-9)
        top1[name] = (float(np.mean(np.argmax(iv @ tv.T, axis=1) == np.arange(len(keep)))), len(keep))
    log(f"phase 11(e): the visual aligner (96 px, patch 8, d 256, 4 layers, B = 64) on "
        f"{len(train)} docstrings x 2 renders: rendering and text vectors {render_s:.1f} s, "
        f"{ALIGNER_STEPS} steps at {step_ms:.2f} ms/step on the wall; image->text top-1 "
        + ", ".join(f"{k} {v:.4f} of {n} (chance {1 / n:.4f})" for k, (v, n) in top1.items())
        + f"; card {card}")
    if not all(np.isfinite(v) for v, _ in top1.values()):
        fail("phase 11(e): the aligner's vectors are not finite")
    weights = f"{tmp}/visual_aligner.npz"
    va.save_aligner(params, cfg, weights)
    loaded, lcfg = va.load_aligner(weights)
    if lcfg != cfg or any(not torch.equal(loaded[k], params[k].cpu()) for k in params):
        fail("phase 11(e): the aligner's weights did not load back bit for bit")
    old = va.DEFAULT_ALIGNER_PATH
    va.DEFAULT_ALIGNER_PATH = weights
    emb_mod._ImageHashMixin._aligner_cache.clear()
    try:
        photos = [noise_png(s) for s in range(4)]
        got = enc.embed_images(photos)
        want = np.stack([va_emb.embed_image_bytes(p) for p in photos])
        percept = np.stack([enc._visual_image_vec(p) for p in photos])
    finally:
        va.DEFAULT_ALIGNER_PATH = old
        emb_mod._ImageHashMixin._aligner_cache.clear()
    gap, other = float(np.abs(got - want).max()), float(np.abs(got - percept).min(axis=1).max())
    log(f"phase 11(e): EncoderEmbedder.embed_images of 4 text-free images through the aligner "
        f"rung: largest gap to VisualAlignEmbedder {gap:.3g}; weights saved and loaded bit for bit")
    if gap > 1e-5 or np.allclose(got, percept):
        fail("phase 11(e): embed_images did not take the aligner rung")


class TinyLM(torch.nn.Module):
    """A randomly initialised byte-level causal transformer (2 layers, width 64)."""

    def __init__(self, d: int = 64, layers: int = 2, heads: int = 4, ctx: int = 512) -> None:
        super().__init__()
        self.ctx = ctx
        self.emb = torch.nn.Embedding(256, d)
        self.pos = torch.nn.Embedding(ctx, d)
        self.layers = torch.nn.ModuleList(
            torch.nn.TransformerEncoderLayer(d, heads, 4 * d, dropout=0.0, batch_first=True)
            for _ in range(layers))
        self.head = torch.nn.Linear(d, 256)

    @torch.no_grad()
    def logprobs(self, ids) -> np.ndarray:
        dev = self.head.weight.device
        ids = torch.tensor([list(ids)[-(self.ctx - 1):] or [0]], device=dev)
        t = ids.shape[1]
        x = self.emb(ids) + self.pos(torch.arange(t, device=dev))
        mask = torch.nn.Transformer.generate_square_subsequent_mask(t, device=dev)
        for layer in self.layers:
            x = layer(x, src_mask=mask, is_causal=True)
        return torch.log_softmax(self.head(x[0, -1]).float(), dim=-1).cpu().numpy()


def constrained_path(dev, card):
    """Phase 11(f): ``constrained_generate``, ``make_constrained_planner_fn`` and
    ``make_choice_reranker_fn`` over TinyLM on the card: N_JSON outputs, each valid
    JSON; plans and [0, 1] scores."""
    from triple_hybrid_rag_tpu_torch.models.constrained import (
        Choice, Lit, constrained_generate, make_choice_reranker_fn, make_constrained_planner_fn)

    torch.manual_seed(0)
    lm = TinyLM().to(dev).eval()
    calls = [0]

    def fn(ids):
        calls[0] += 1
        return lm.logprobs(ids)

    entities = ["Acme Corp", "Beta Labs", "Zenith project", "Maria Silva"]
    template = [Lit('{"op": "'), Choice(["neighborhood", "path", "related"], name="op"),
                Lit('", "hops": '), Choice(["1", "2", "3"], name="hops"),
                Lit(', "entity": "'), Choice(entities, name="entity"), Lit('"}')]
    t0 = time.time()
    valid = 0
    for i in range(N_JSON):
        text, chosen = constrained_generate(fn, template, prompt=f"query {i}: how is {entities[i % 4]} linked?\n")
        try:
            data = json.loads(text)
            valid += data["op"] == chosen["op"] and data["entity"] == chosen["entity"]
        except (ValueError, KeyError):
            pass
    planner = make_constrained_planner_fn(fn, entities)
    plans = [planner(q) for q in ("How is Acme Corp connected to the Zenith project?",
                                  "who is Maria Silva")]
    scores = make_choice_reranker_fn(fn)("invoice terms", ["Acme Corp settles invoices in 30 days.",
                                                           "Red foxes live in forests."])
    torch.cuda.synchronize()
    wall = time.time() - t0
    log(f"phase 11(f): constrained decoding over a random 2-layer byte LM on the card: {valid} of "
        f"{N_JSON} outputs valid JSON; plans {plans}; rerank scores {[round(s, 4) for s in scores]}; "
        f"{calls[0]} model calls in {wall:.2f} s ({wall / calls[0] * 1e3:.2f} ms each); card {card}")
    if valid != N_JSON or not all("intent" in p for p in plans) or not all(0 <= s <= 1 for s in scores):
        fail("phase 11(f): constrained decoding gave an invalid output")


def training_path(dev, card):
    """Phase 11: encoder training, the trained checkpoint served, the visual
    aligner and constrained decoding, on the card. Returns the launches of (d)."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        train_card_host(dev, card)
        log(f"phase 11(a) wall time {time.time() - t0:.1f} s")
        t0 = time.time()
        path = train_throughput(dev, card, tmp)
        train_profile(dev, card)
        log(f"phase 11(b) wall time {time.time() - t0:.1f} s")
        t0 = time.time()
        train_cli(card, tmp, dev)
        log(f"phase 11(c) wall time {time.time() - t0:.1f} s")
        t0 = time.time()
        launches = serve_trained(dev, card, path)
        log(f"phase 11(d) wall time {time.time() - t0:.1f} s")
        t0 = time.time()
        aligner_path(dev, card, tmp)
        log(f"phase 11(e) wall time {time.time() - t0:.1f} s")
        t0 = time.time()
        constrained_path(dev, card)
        log(f"phase 11(f) wall time {time.time() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------- phase 12

# (n_shards, data rows) of the meshes phase 12 places on the one card
MESHES = {"1x1": (1, 1), "1x2": (2, 1), "1x4": (4, 1), "2x2": (2, 2)}
# 12(h): the three checked steps' learning rates (0, 1e-5, 2e-5) summed. An Adam step
# moves a weight by up to its rate, and a gradient entry near zero may take either
# sign on the sharded and the unsharded step
TRAIN_WEIGHT_ATOL = 3e-5
IVF_RECALL: dict = {}  # phase 5's semantic recall per row type, printed beside 12(d)
TRAIN_CHECK: dict = {}  # phase 11(a)'s batches, the card's losses and weights, for 12(h)


def sharded_counts() -> dict:
    """Launches since the last ``staged_counts_reset``, by kernel entry name."""
    from triple_hybrid_rag_tpu_torch.ops.bm25 import score_termtable_batch
    from triple_hybrid_rag_tpu_torch.ops.bowhash import bowhash_encode
    from triple_hybrid_rag_tpu_torch.ops.dense_kernel import dense_scores
    from triple_hybrid_rag_tpu_torch.ops.fused_topk import bucket_maxima
    from triple_hybrid_rag_tpu_torch.ops.maxsim import maxsim_scores

    by_rows, by_tokens = bucket_maxima.launches_by_rows, maxsim_scores.launches_by_tokens
    return {"bowhash_encode": bowhash_encode.launches, "fused_bucket_maxima": by_rows["bf16"], "fused_bucket_maxima_int8": by_rows["int8"],
            "fused_bucket_maxima_int4": by_rows["int4"], "fused_bucket_maxima_f32": by_rows["f32"],
            "maxsim_scores": by_tokens["bf16"], "maxsim_scores_int8": by_tokens["int8"],
            "termtable_scores": score_termtable_batch.launches, "dense_scores": dense_scores.launches}


@contextlib.contextmanager
def uncounted():
    """Launches inside the block (the 1-shard engines the sharded ones are held
    against) leave every counter as it was."""
    from triple_hybrid_rag_tpu_torch.ops.bm25 import score_termtable_batch
    from triple_hybrid_rag_tpu_torch.ops.bowhash import bowhash_encode
    from triple_hybrid_rag_tpu_torch.ops.dense_kernel import dense_scores
    from triple_hybrid_rag_tpu_torch.ops.fused_topk import bucket_maxima
    from triple_hybrid_rag_tpu_torch.ops.maxsim import maxsim_scores

    saved = (dict(bucket_maxima.launches_by_rows), dict(maxsim_scores.launches_by_tokens),
             score_termtable_batch.launches, dense_scores.launches,
             dict(dense_scores.launches_by_rows), bucket_maxima.launches, bowhash_encode.launches)
    try:
        yield
    finally:
        torch.cuda.synchronize()
        (bucket_maxima.launches_by_rows, maxsim_scores.launches_by_tokens,
         score_termtable_batch.launches, dense_scores.launches, dense_scores.launches_by_rows,
         bucket_maxima.launches, bowhash_encode.launches) = saved


def mesh_engine(run, state, cfg, name: str):
    """An engine over ``state`` on the mesh ``name`` of ``MESHES``, every entry the
    one card."""
    from triple_hybrid_rag_tpu_torch.engine import Engine
    from triple_hybrid_rag_tpu_torch.parallel import corpus_mesh

    s, d = MESHES[name]
    mesh = corpus_mesh(s, d, devices=[run.dev] * (s * d))
    return Engine(dataclasses.replace(state, config=cfg), embedder=run.syn.embedder,
                  device=run.dev, mesh=mesh)


def lexical_lists(eng, args):
    """The merged lexical (ids, scores) of every data row of a prepared batch."""
    parts = [eng._lexical(eng.row_args(args, r)) for r in range(eng.mesh.shape["data"])]
    return tuple(torch.cat([p[i].to(args.q_vec.device) for p in parts], 0) for i in range(2))


def mesh_checks(dev) -> None:
    """Phase 12(a): the mesh helpers over ``[cuda:0] * 4`` and their errors."""
    from triple_hybrid_rag_tpu_torch.parallel import (
        corpus_mesh, default_mesh, multislice_mesh, single_device_mesh)

    four = [dev] * 4
    got = {
        "corpus 1x4": corpus_mesh(devices=four).shape,
        "corpus 2x2": corpus_mesh(2, 2, devices=four).shape,
        "multislice 2x2": multislice_mesh(2, 2, devices=four).shape,
        "multislice 2x1x2": multislice_mesh(2, 1, 2, devices=four).shape,
        "single": single_device_mesh(dev).shape,
        "default (cuda)": default_mesh("cuda").shape,
        "default (cuda:0)": default_mesh("cuda:0").shape,
    }
    want = {"corpus 1x4": (1, 4), "corpus 2x2": (2, 2), "multislice 2x2": (2, 2),
            "multislice 2x1x2": (4, 1), "single": (1, 1),
            "default (cuda)": (1, torch.cuda.device_count()), "default (cuda:0)": (1, 1)}
    for k, shape in got.items():
        if (shape["data"], shape["shard"]) != want[k]:
            fail(f"phase 12(a): mesh {k} has shape {shape}, not {want[k]}")
    if corpus_mesh(devices=four).devices() != [torch.device("cuda", 0)] * 4:
        fail("phase 12(a): the 1x4 mesh is not cuda:0 four times")
    errors = 0
    for fn, kw in ((corpus_mesh, dict(data_parallel=0)), (corpus_mesh, dict(n_shards=8)),
                   (corpus_mesh, dict(data_parallel=5)), (multislice_mesh, dict(
                       n_slices=0, shards_per_slice=2)), (multislice_mesh, dict(
                       n_slices=2, shards_per_slice=4))):
        try:
            fn(devices=four, **kw)
        except ValueError:
            errors += 1
    log(f"phase 12(a): mesh shapes {got}; {errors} of 5 bad meshes raised ValueError")
    if errors != 5:
        fail("phase 12(a): a bad mesh was built")


def same_as_one_shard(label: str, eng, want, args) -> int:
    """``eng``'s outputs on prepared ``args`` against the 1-shard engine's ``want``
    (its run and its lexical lists): final ids up to near ties, scores within
    FUSED_ATOL, refusals equal, the lexical lists bit-equal. Returns the slots whose
    ids differ."""
    out = eng.run(args)
    lex = lexical_lists(eng, args)
    (ids1, s1, ref1, *_), lex1 = want
    n_diff = near_ties_only(out[0], ids1, s1, FUSED_ATOL)
    gap = max_err(out[1], s1)
    refused = torch.equal(out[2], ref1)
    lex_equal = torch.equal(lex[0], lex1[0]) and torch.equal(lex[1], lex1[1])
    log(f"{label}: {n_diff} of {ids1.numel()} final slots differ from the 1-shard engine "
        f"(near ties, atol {FUSED_ATOL}); max final-score gap {gap:.3g}; refusals equal "
        f"{refused}; lexical lists bit-equal {lex_equal}")
    if n_diff < 0 or not gap <= FUSED_ATOL or not refused or not lex_equal:
        fail(f"{label}: the sharded engine differs from the 1-shard engine")
    return n_diff


def shard_launches(label: str, eng, args, kind: str, body: str, lexical: bool = False) -> None:
    """One batch: one bucket-maxima launch per shard of the row type ``kind``, one
    MaxSim launch per data row of ``body``, one term-table launch per shard when
    ``lexical``."""
    before = sharded_counts()
    eng.run(args)
    torch.cuda.synchronize()
    after = sharded_counts()
    delta = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    s, d = eng.mesh.shape["shard"], eng.mesh.shape["data"]
    want = {("fused_bucket_maxima" if kind == "bf16" else f"fused_bucket_maxima_{kind}"): s * d,
            ("maxsim_scores" if body == "bf16" else "maxsim_scores_int8"): d}
    if lexical:
        want["termtable_scores"] = s * d
    log(f"{label}: launches in one batch of {BATCH} {delta} (want {want})")
    if delta != want:
        fail(f"{label}: launches {delta}, not one a shard and one MaxSim a data row {want}")


def shard_kernel_checks(eng, args, kind: str) -> None:
    """Each shard's bucket maxima at its own shape against the plain version
    (bf16 within FUSED_ATOL, int8 bit for bit); comparison launches, not counted."""
    from triple_hybrid_rag_tpu_torch.index.dense_index import quantize_queries_int8
    from triple_hybrid_rag_tpu_torch.ops import fused_topk as ft

    q = args.q_vec.float()
    errs = []
    for sh in eng.placement.shards[0]:
        if kind == "int8":
            q_i8, q_scale = quantize_queries_int8(q)
            call = (sh.embeddings, q_i8, sh.valid, None, None, sh.dense_scales, q_scale)
        else:
            call = (sh.embeddings, q, sh.valid)
        errs.append(max_err(ft.bucket_maxima(*call), ft.bucket_maxima_plain(*call)))
    torch.cuda.synchronize()
    n_loc = eng.placement.n_loc
    log(f"phase 12(f): {kind} bucket maxima of each of {len(errs)} shards at N = {n_loc}: "
        f"max |kernel - plain| {[f'{e:.3g}' for e in errs]}")
    if (kind == "int8" and any(e != 0.0 for e in errs)) or not max(errs) <= FUSED_ATOL:
        fail(f"phase 12(f): a shard's {kind} bucket maxima disagree with the plain version")


def mesh_times(engines, args_list, card: str) -> None:
    """Phase 12(g): program wall and device busy ms per batch of 128 on each mesh,
    the stage split, and each mesh's peak memory above what the corpus holds."""
    for name, (eng, peak) in engines.items():
        eng.run(args_list[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for a in args_list:
            eng.run(a)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / len(args_list) * 1e3
        busy = stage_profile(eng, args_list, f"phase 12(g), bf16, mesh {name}")
        stages = ", ".join(f"{k[7:]} {v:.3f}" for k, v in STAGE_MS.items())
        log(f"phase 12(g) mesh {name}: wall {wall:.3f} ms/batch, device busy {busy:.3f} "
            f"ms/batch (idle {100 * max(0.0, 1 - busy / wall):.1f} %); stages (device ms/batch) "
            f"{stages}; peak device memory of placing and serving {peak:.3f} GB above the corpus; "
            f"all shards on one card ({card})")


def sharded_path(run, stdlib, dev, card) -> dict:
    """Phase 12: the sharded engine on the one card, every mesh entry ``cuda:0``.
    Returns the launches of (b)-(e), the sharded engines' alone (the 1-shard
    engines they are held against run ``uncounted``)."""
    from triple_hybrid_rag_tpu_torch.index.state import ivf_layout
    from triple_hybrid_rag_tpu_torch.parallel import ShardedEngine, corpus_mesh

    t0 = time.time()
    mesh_checks(dev)
    log(f"phase 12(a) wall time {time.time() - t0:.1f} s")

    st, cfg = run.syn.state, run.syn.state.config
    eng1 = run.engine(st, cfg)
    args_list = [eng1.prepare_queries(run.texts[i * BATCH:(i + 1) * BATCH])[1] for i in range(2)]
    args = args_list[0]
    want = (eng1.run(args), lexical_lists(eng1, args))
    torch.cuda.synchronize()
    staged_counts_reset()  # the sharded engines' launches from here to (e)
    engines = {"1x1": (eng1, 0.0)}
    t0 = time.time()
    for name in ("1x2", "1x4", "2x2"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        tb = time.time()
        eng = mesh_engine(run, st, cfg, name)
        torch.cuda.synchronize()
        build_s = time.time() - tb
        pl = eng.placement
        aliased = all(sh.embeddings.data_ptr() == st.embeddings[i * pl.n_loc].data_ptr()
                      for i, sh in enumerate(pl.shards[0]))
        log(f"phase 12(b) mesh {name}: placed in {build_s:.2f} s, {len(pl.shards[0])} shards of "
            f"{pl.n_loc} rows (capacity {pl.n_pad}), rows aliased {aliased}, largest per-shard "
            f"postings block {pl.lex_l_max} (1 shard {st.lex_l_max}), mention block {pl.g_l_max}")
        if pl.n_loc * len(pl.shards[0]) != st.n_pad or not aliased:
            fail(f"phase 12(b) mesh {name}: shards do not alias the rows")
        if name != "1x2":
            same_as_one_shard(f"phase 12(b) bf16 mesh {name}", eng, want, args)
            shard_launches(f"phase 12(f) bf16 mesh {name}", eng, args, "bf16", "bf16")
        eng.run(args)
        torch.cuda.synchronize()
        engines[name] = (eng, (torch.cuda.max_memory_allocated() - held) / 1e9)
    log(f"phase 12(b) wall time {time.time() - t0:.1f} s")

    t0 = time.time()
    for conf in ("int8", "termtable"):
        st_c, cfg_c = run.staged_states[conf]
        e1 = run.engine(st_c, cfg_c)
        with uncounted():
            want_c = (e1.run(args), lexical_lists(e1, args))
        e4 = mesh_engine(run, st_c, cfg_c, "1x4")
        same_as_one_shard(f"phase 12(c) {conf} mesh 1x4", e4, want_c, args)
        kind, body = ("int8", "int8") if conf == "int8" else ("bf16", "bf16")
        shard_launches(f"phase 12(f) {conf} mesh 1x4", e4, args, kind, body,
                       lexical=conf == "termtable")
        if conf == "int8":
            int8_engine = e4
        del e1
    log(f"phase 12(c) wall time {time.time() - t0:.1f} s")

    t0 = time.time()
    cfg_i = cfg.replace(semantic_backend="ivf")
    st_i = ivf_layout(st, cfg_i)
    tb = time.time()
    e_ivf = mesh_engine(run, st_i, cfg_i, "1x4")
    torch.cuda.synchronize()
    build_s = time.time() - tb
    run.self_retrieval(e_ivf, "phase 12(d) IVF bf16 mesh 1x4")
    ids_i, _ = e_ivf._dense(args)
    ids_e, _ = engines["1x4"][0]._dense(args)
    found = [len(set(x.tolist()) & set(y[y >= 0].tolist())) / max(int((y >= 0).sum()), 1)
             for x, y in zip(ids_i.cpu(), ids_e.cpu())]
    log(f"phase 12(d) IVF bf16 mesh 1x4: per-shard layouts built in {build_s:.2f} s "
        f"({e_ivf.placement.shards[0][0].ivf_centroids.shape[0]} blocks a shard); semantic "
        f"recall@{cfg.semantic_top_k} against the exact 1x4 scan {float(np.mean(found)):.4f} "
        f"(min {min(found):.4f}) over {BATCH} queries; phase 5, one shard: "
        f"{IVF_RECALL.get('bf16', float('nan')):.4f}")
    if float(np.mean(found)) < 0.5:
        fail("phase 12(d): the sharded IVF lost the exact scan's neighbours")
    del e_ivf, st_i
    torch.cuda.empty_cache()
    log(f"phase 12(d) wall time {time.time() - t0:.1f} s")

    t0 = time.time()
    rag, queries, _ = stdlib
    eng_rag = rag._get_engine()
    e2 = ShardedEngine(rag.retriever, corpus_mesh(2, devices=[dev] * 2))
    with uncounted():
        _, o1 = eng_rag.search_arrays(queries)
        ref = [[x.chunk_id for x in r.results] for r in rag.query_batch(queries[:16])]
    before = sharded_counts()
    _, o2 = e2.search_arrays(queries)
    torch.cuda.synchronize()
    delta = {k: v - before[k] for k, v in sharded_counts().items() if v != before[k]}
    n_diff = near_ties_only(o2[0], o1[0], o1[1], FUSED_ATOL)
    gap = max_err(o2[1], o1[1])
    got = [[x.chunk_id for x in r.results] for r in e2.retrieve_batch(queries[:16])]
    log(f"phase 12(e) default RAGConfig, trained encoder, stdlib corpus ({rag.retriever.state.n_pad} "
        f"rows) over a 1x2 ShardedEngine: {n_diff} of {o1[0].numel()} final slots differ from "
        f"query_batch's engine (near ties, atol {FUSED_ATOL}), max score gap {gap:.3g}, refusals "
        f"equal {torch.equal(o1[2], o2[2])}, decoded ids of 16 queries equal {got == ref}; "
        f"launches in the batch {delta}")
    if (n_diff < 0 or not gap <= FUSED_ATOL or not torch.equal(o1[2], o2[2])
            or delta != {"fused_bucket_maxima": 2, "maxsim_scores": 1}):
        fail("phase 12(e): the 1x2 ShardedEngine differs from query_batch")
    log(f"phase 12(e) wall time {time.time() - t0:.1f} s")
    torch.cuda.synchronize()
    launches = sharded_counts()
    log(f"phase 12: launches of the sharded engines over (b)-(e) {launches}")

    t0 = time.time()
    shard_kernel_checks(engines["1x4"][0], args, "bf16")
    shard_kernel_checks(int8_engine, args, "int8")
    del int8_engine
    log(f"phase 12(f) wall time {time.time() - t0:.1f} s")
    t0 = time.time()
    mesh_times(engines, args_list, card)
    log(f"phase 12(g) wall time {time.time() - t0:.1f} s")
    return launches


def sharded_training(dev, card) -> None:
    """Phase 12(h): phase 11(a)'s three steps (the shipped npz at the scaled config,
    B = 64) sharded over dp 2 x tp 2 on the one card: losses within LATER_RTOL of
    11(a)'s unsharded card steps (STEP0_RTOL at step 0), the weights within
    TRAIN_WEIGHT_ATOL, ms a step."""
    from triple_hybrid_rag_tpu_torch.models.pretrain import (
        DEFAULT_PARAMS, load_encoder_weights_, scaled_encoder_config)
    from triple_hybrid_rag_tpu_torch.models.training import (
        create_train_state, make_train_step, shard_train_state, training_mesh)

    cfg = dataclasses.replace(scaled_encoder_config(), dtype="float32")
    tc = train_config(TRAIN_STEPS, TRAIN_LR, cfg)
    model, state = create_train_state(cfg, tc, device=dev)
    load_encoder_weights_(model, DEFAULT_PARAMS)
    mesh = training_mesh(tp=2, devices=[dev] * 4)
    state = shard_train_state(state, mesh)
    step = make_train_step(model, tc, mesh)
    losses, ms = [], []
    for arrs in TRAIN_CHECK["data"]:
        batch = [torch.from_numpy(a).to(dev) for a in arrs]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, *batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append((float(m["loss"]), float(m["accuracy"])))
    want = TRAIN_CHECK["losses"]
    rel = [abs(g[0] - w[0]) / abs(w[0]) for g, w in zip(losses, want)]
    ref = TRAIN_CHECK["params"]
    gap = max(float((p.detach().cpu() - ref[k]).abs().max()) for k, p in model.named_parameters())
    log(f"phase 12(h) training over dp {mesh.shape['dp']} x tp {mesh.shape['tp']} on the one card: "
        f"{len(losses)} steps of B = {CHECK_BATCH}, (loss, accuracy) {losses}; relative loss gaps "
        f"to 11(a)'s unsharded card steps {[f'{r:.3g}' for r in rel]} (limits {STEP0_RTOL} at step "
        f"0, {LATER_RTOL} after); largest weight gap {gap:.3g} (limit {TRAIN_WEIGHT_ATOL}); "
        f"ms a step {[f'{x:.1f}' for x in ms]}; card {card}")
    if rel[0] > STEP0_RTOL or max(rel[1:]) > LATER_RTOL or not gap <= TRAIN_WEIGHT_ATOL:
        fail("phase 12(h): the sharded steps differ from the unsharded ones")


# ---------------------------------------------------------------- phase 13

REPAIRED_QUERY_TOKENS, REPAIRED_DIM = 256, 1024  # past the MaxSim kernel's staged plan
N_REPAIRED_STAGED = 8
# card against host CPU: the same BowHash rows; the dense scores and MaxSim sums of
# the same bf16 products in another order (a few 1e-6 a score) decide near ties only
REPAIRED_TIE_ATOL = 1e-3


def repaired_maxsim_path(dev, card) -> dict:
    """Phase 13: a served RAG whose MaxSim shape is past the kernel's staged plan
    (256 query tokens of width 1024, which the kernel once refused): the same BowHash
    RAG over ``N_FORMAT_DOCS`` docstrings on the card and on the host CPU, 128 queries
    through ``query_batch`` and ``N_REPAIRED_STAGED`` through ``RAG.query``; equal ids
    up to near ties, and the MaxSim kernel launched in both. Returns the launches."""
    from triple_hybrid_rag_tpu_torch import RAG, RAGConfig

    t0 = time.time()
    cfg = RAGConfig(embedder_backend="bowhash", maxsim_query_tokens=REPAIRED_QUERY_TOKENS,
                    maxsim_dim=REPAIRED_DIM)
    docs = format_docs()
    rags = {}
    for where in (dev, "cpu"):
        rags[where] = RAG(cfg, device=where)
        ingest_all(rags[where], docs, f"phase 13 ingest on {where}")
    rag, host = rags[dev], rags["cpu"]
    st = rag.retriever.state
    queries, hits = chunk_queries(rag, BATCH)
    staged_q = queries[:N_REPAIRED_STAGED]
    log(f"phase 13: {len(docs)} docstrings ingested on the card and on the host CPU in "
        f"{time.time() - t0:.1f} s; MaxSim store {st.maxsim_tokens.dtype} "
        f"{tuple(st.maxsim_tokens.shape)}, queries of {cfg.maxsim_query_tokens} tokens")
    t1 = time.time()
    batched, batch_launches = counted(lambda: rag.query_batch(queries))
    batch_plans = maxsim_plan_counts()
    staged, staged_launches = counted(lambda: [rag.query(x) for x in staged_q])
    staged_plans = maxsim_plan_counts()
    log(f"phase 13: {BATCH} queries through query_batch and {len(staged_q)} through RAG.query on "
        f"the card in {time.time() - t1:.2f} s; self-retrieval {hits(batched, range(BATCH)) / BATCH:.4f}"
        f" batched, {hits(staged, range(len(staged_q))) / len(staged_q):.4f} staged; launches "
        f"batched {batch_launches}, staged {staged_launches}; MaxSim launches by plan batched "
        f"{batch_plans}, staged {staged_plans}; card {card}")
    for label, launches, plans in (("batched", batch_launches, batch_plans),
                                   ("staged", staged_launches, staged_plans)):
        if launches["maxsim_scores"] < 1:
            fail(f"phase 13 ({label}): the bf16 MaxSim body was not launched: {launches}")
        if plans["wgmma"] != launches["maxsim_scores"] + launches["maxsim_scores_int8"]:
            fail(f"phase 13 ({label}): MaxSim launches by plan {plans}, all expected on the wgmma plan")
    t1 = time.time()
    same_ids("phase 13, query_batch, card against host CPU", pairs(host.query_batch(queries)),
             pairs(batched), REPAIRED_TIE_ATOL)
    same_ids("phase 13, RAG.query, card against host CPU", pairs([host.query(x) for x in staged_q]),
             pairs(staged), REPAIRED_TIE_ATOL)
    log(f"phase 13: the host CPU's answers in {time.time() - t1:.1f} s; phase 13 wall time "
        f"{time.time() - t0:.1f} s")
    out = dict(batch_launches)
    add_counts(out, staged_launches)
    add_counts(batch_plans, staged_plans)
    return out, batch_plans


# ---------------------------------------------------------------- phase 14

# the port's examples: what each must answer, and the kernels its path reaches
EXAMPLES = {
    "torch_basic_usage.py": {
        "launches": ("dense_scores", "maxsim"),
        "lines": ["Q: completely unrelated gibberish zzz\n  REFUSED: ",
                  "Q: How long do we have to pay an invoice?\n  [",
                  "Q: Who works for Acme Corp?\n  [", "graph: '# Service Agreement",
                  "Q: what animals live in the forest\n  [", ": '# Wildlife Notes",
                  "entities related to Acme Corp: ['Maria Silva'", "restored corpus: {'documents': 2"],
    },
    "torch_production_serving.py": {
        "launches": ("bucket_maxima", "maxsim"),
        "lines": ["batched [invoice...] -> # Billing policy", "batched [customs...] -> # Shipping",
                  "cross-tenant top -> # Shipping", "HTTP /rerank -> winner index 1 (maxsim",
                  "migrated int8 checkpoint answers: refused=False, top='# Billing policy'"],
    },
}
# maxsim_scores_batch: the default RAGConfig's shape and phase 13's, (B, K, Td, D, Tq)
# and the plan the kernel must take for a store of B * K rows
MAXSIM_BATCH_SHAPES = {"default": ((BATCH, RERANK_K, 64, 128, 32), "staged"),
                       "past_staged": ((8, RERANK_K, 64, REPAIRED_DIM, REPAIRED_QUERY_TOKENS), "wgmma")}
MAXSIM_BATCH_ATOL = 1e-6  # tests/test_torch_contracts.py's, against the reference
MAXSIM_BATCH_PARENTS = 20_000  # the store the gather entry reads the same tokens from
N_GRAPH_CHECKS = 8


def run_examples(card) -> dict:
    """14(a): both port examples as new processes on the card, at once: exit 0, no
    JAX module loaded, the expected answers, and each kernel of their path launched.
    Returns the launches by the kernels line's names."""
    t0 = time.time()
    root = Path(__file__).resolve().parent
    procs = {name: subprocess.Popen([sys.executable, str(root / "examples" / name)], cwd=root,
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for name in EXAMPLES}
    done = {}
    try:
        for name, p in procs.items():
            done[name] = p.communicate(timeout=400)
    except subprocess.TimeoutExpired:
        fail(f"phase 14(a): {name} did not finish in 400 s")
    finally:
        for p in procs.values():  # none outlives the phase
            if p.poll() is None:
                p.kill()
                p.wait()
    out = {}
    names = {"dense_scores": "dense_scores", "bucket_maxima": "fused_bucket_maxima",
             "maxsim": "maxsim_scores"}
    for name, (stdout, stderr) in done.items():
        if procs[name].returncode != 0:
            fail(f"phase 14(a): {name} exited {procs[name].returncode}: {stderr[-2000:]}")
        want = EXAMPLES[name]
        missing = [line for line in want["lines"] if line not in stdout]
        if missing:
            fail(f"phase 14(a): {name} did not answer {missing}; its output:\n{stdout}")
        tail = dict(line.split(": ", 1) for line in stdout.splitlines()
                    if line.startswith(("jax loaded: ", "kernel launches: ")))
        launches = json.loads(tail.get("kernel launches", "{}"))
        log(f"phase 14(a): {name}: jax loaded {tail.get('jax loaded')}, kernel launches {launches}")
        for line in stdout.splitlines():
            log(f"  | {line}")
        if tail.get("jax loaded") != "False":
            fail(f"phase 14(a): {name} loaded a JAX module")
        if sorted(launches) != sorted(want["launches"]) or min(launches.values()) < 1:
            fail(f"phase 14(a): {name} did not launch each kernel of its path: {launches}")
        for k, v in launches.items():
            out[names[k]] = out.get(names[k], 0) + v
    log(f"phase 14(a): both examples ran on the card in {time.time() - t0:.1f} s (at once); card {card}")
    return out


def batch_inputs(dev, gen, b, k, td, d, tq):
    """A store of unit bf16 tokens with mask holes and empty parents, candidates
    gathered from it (about 1 in 8 invalid), and f16-wire queries with masked
    tokens, one query with none."""
    store = torch.randn((MAXSIM_BATCH_PARENTS, td, d), generator=gen, device=dev)
    store = (store / store.norm(dim=-1, keepdim=True)).to(torch.bfloat16)
    store_mask = torch.rand((MAXSIM_BATCH_PARENTS, td), generator=gen, device=dev) > 0.2
    store_mask[::97] = False  # parents without any token
    parent = torch.randint(0, MAXSIM_BATCH_PARENTS, (b, k), generator=gen, device=dev)
    valid = torch.rand((b, k), generator=gen, device=dev) > 0.125
    q = torch.randn((b, tq, d), generator=gen, device=dev)
    q = (q / q.norm(dim=-1, keepdim=True)).half().float()
    q_mask = torch.rand((b, tq), generator=gen, device=dev) > 0.25
    q_mask[-1] = False
    return store, store_mask, parent, valid, q, q_mask


def maxsim_batch_check(dev, gen, card) -> dict:
    """14(b): ``maxsim_scores_batch`` on gathered tokens at the default shape and at
    phase 13's, bf16 and int8: its launches counted (the kernel on the plan the shape
    must take), against its plain version within MAXSIM_BATCH_ATOL, against the
    gather entry over the store the tokens came from, and both timed (cold L2).
    Returns {body: {launches, max_abs_err, timings by shape}}."""
    from triple_hybrid_rag_tpu_torch.ops import maxsim as mx

    t0 = time.time()
    out = {body: {"launches": 0, "max_abs_err": 0.0} for body in ("bf16", "int8")}
    for label, ((b, k, td, d, tq), plan) in MAXSIM_BATCH_SHAPES.items():
        store, store_mask, parent, valid, q, q_mask = batch_inputs(dev, gen, b, k, td, d, tq)
        for tokens in (store, mx.quantize_tokens(store)):
            body = "int8" if tokens.dtype == torch.int8 else "bf16"
            docs = tokens[parent]  # [B, K, Td, D], the candidates' tokens gathered
            dmask = store_mask[parent]
            args = (docs, dmask, q, q_mask, valid)
            torch.cuda.synchronize()
            maxsim_counts_reset()
            got = mx.maxsim_scores_batch(*args)
            torch.cuda.synchronize()
            launched, plans = dict(mx.maxsim_scores.launches_by_tokens), maxsim_plan_counts()
            if launched[body] != 1 or plans[plan] != 1:
                fail(f"phase 14(b): maxsim_scores_batch ({body}, {label}) launches {launched}, "
                     f"plans {plans}: one launch on the {plan} plan expected")
            out[body]["launches"] += launched[body]
            view = docs.reshape(b * k, td, d)
            rows = torch.arange(b * k, device=dev).view(b, k)
            ids = torch.where(valid, rows, torch.full_like(rows, -1))
            want = mx.maxsim_scores_plain(view, dmask.reshape(b * k, td), ids, q, q_mask.float())
            gather_ids = torch.where(valid, parent, torch.full_like(parent, -1))
            gathered = mx.maxsim_scores(tokens, store_mask, gather_ids, q, q_mask.float())
            torch.cuda.synchronize()
            err, err_gather = max_err(got, want), max_err(got, gathered)
            if got.shape != (b, k) or not err <= MAXSIM_BATCH_ATOL or not err_gather <= MAXSIM_BATCH_ATOL:
                fail(f"phase 14(b): maxsim_scores_batch ({body}, {label}) against its plain version "
                     f"{err}, against the gather entry {err_gather}")
            if bool((got[~valid] != 0).any()) or bool((got[-1] != 0).any()):
                fail(f"phase 14(b): maxsim_scores_batch ({body}, {label}): an invalid candidate or "
                     "a query without tokens scored")
            ms = time_ms(lambda: mx.maxsim_scores_batch(*args), iters=50, cold_l2=True)
            gather_ms = time_ms(lambda: mx.maxsim_scores(tokens, store_mask, gather_ids, q,
                                                         q_mask.float()), iters=50, cold_l2=True)
            plain_ms = time_ms(lambda: mx.maxsim_scores_plain(view, dmask.reshape(b * k, td), ids, q,
                                                              q_mask.float()), iters=10, cold_l2=True)
            b_ms, b_by = maxsim_bound(view, dmask.reshape(b * k, td), ids, tq)
            log(f"phase 14(b): maxsim_scores_batch {body} tokens, {label} B={b} K={k} Td={td} D={d} "
                f"Tq={tq} ({plan} plan): max |kernel - plain| = {err:.3g}, against the gather entry "
                f"{err_gather:.3g}; batch {ms:.4f} ms, gather entry {gather_ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); card {card}")
            o = out[body]
            o["max_abs_err"] = max(o["max_abs_err"], err, err_gather)
            o.update({f"batch_ms_{label}": ms, f"batch_gather_ms_{label}": gather_ms,
                      f"batch_plain_ms_{label}": plain_ms, f"batch_bound_ms_{label}": b_ms,
                      f"batch_plan_{label}": plan})
            del docs, dmask, view, got, want, gathered
        del store, store_mask
        torch.cuda.empty_cache()
    log(f"phase 14(b): wall {time.time() - t0:.1f} s")
    return out


def ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest distance in f32 units in the last place between two tensors."""
    return int((a.float().view(torch.int32).long() - b.float().view(torch.int32).long()).abs().max())


def bm25_graph_check(dev, lexical, graph_tables, card) -> None:
    """14(c): the reference's BM25 ops over term frequencies on the card, over phase
    6's stdlib index for its 128 queries: ``score_postings_topk`` the ids and score
    bits of ``score_postings_topk_pre``, ``score_postings`` the bits of
    ``score_postings_pre``; then ``chunk_scores_from_entities_batch`` at B = 128
    over phase 3's 1,000,448-row chunk-entity table, k-hop entity scores from random
    seeds, the bits of ``chunk_scores_from_entities`` for 8 queries."""
    from triple_hybrid_rag_tpu_torch.analyzer import Analyzer
    from triple_hybrid_rag_tpu_torch.ops import bm25, graph

    t0 = time.time()
    index, queries = lexical
    cfg = index.config
    analyzer = Analyzer(cfg)
    qt = torch.from_numpy(np.stack([index.encode_query(analyzer.tokenize(x)) for x in queries])).to(dev)
    on = {name: torch.from_numpy(np.asarray(getattr(index, name))).to(dev) for name in (
        "offsets", "lengths", "postings_doc", "postings_tf", "contrib_denom_k1", "idf",
        "postings_weight")}
    tf_args = (on["offsets"], on["lengths"], on["postings_doc"], on["postings_tf"],
               on["contrib_denom_k1"], on["idf"], cfg.bm25_k1 + 1.0)
    pre_args = (on["offsets"], on["lengths"], on["postings_doc"], on["postings_weight"])
    shape = dict(l_max=index.l_max, n_pad=index.n_pad)
    top_k = cfg.lexical_top_k
    t1 = time.time()
    ids, vals = bm25.score_postings_topk(*tf_args, qt, **shape, top_k=top_k)
    torch.cuda.synchronize()
    topk_s = time.time() - t1
    want_ids, want_vals = bm25.score_postings_topk_pre(*pre_args, qt, **shape, top_k=top_k)
    if not torch.equal(ids, want_ids) or not torch.equal(vals.view(torch.int32), want_vals.view(torch.int32)):
        fail(f"phase 14(c): score_postings_topk against score_postings_topk_pre: ids equal "
             f"{torch.equal(ids, want_ids)}, scores {ulps(vals, want_vals)} ulps apart")
    worst = 0
    t1 = time.time()
    for i in range(qt.shape[0]):
        got = bm25.score_postings(*tf_args, qt[i], **shape)
        want = bm25.score_postings_pre(*pre_args, qt[i], **shape)
        worst = max(worst, ulps(got, want))
    torch.cuda.synchronize()
    dense_s = time.time() - t1
    if worst:
        fail(f"phase 14(c): score_postings against score_postings_pre: {worst} ulps apart")
    matched = int((ids >= 0).sum())
    log(f"phase 14(c): BM25 over term frequencies, {qt.shape[0]} stdlib queries over {index.n_docs} "
        f"chunks ({index.postings_tf.nbytes / 1e6:.2f} MB of postings_tf, "
        f"{index.contrib_denom_k1.nbytes / 1e6:.3f} MB of contrib_denom_k1 on the host): "
        f"score_postings_topk the ids and bits of score_postings_topk_pre ({matched} ids, one "
        f"batch in {topk_s * 1e3:.1f} ms), score_postings the bits of score_postings_pre "
        f"({dense_s / qt.shape[0] * 1e3:.2f} ms a query); card {card}")
    nbr, chunk_entities = graph_tables
    gen = torch.Generator(device=dev).manual_seed(14)
    seeds = graph.seed_vectors(torch.randint(0, nbr.shape[0], (BATCH, 4), generator=gen, device=dev),
                               nbr.shape[0])
    scores = graph.khop_entity_scores(nbr, seeds, hops=2)
    torch.cuda.synchronize()
    t1 = time.time()
    got = graph.chunk_scores_from_entities_batch(chunk_entities, scores)
    torch.cuda.synchronize()
    batch_s = time.time() - t1
    for i in range(N_GRAPH_CHECKS):
        want = graph.chunk_scores_from_entities(chunk_entities, scores[i])
        if not torch.equal(got[i].view(torch.int32), want.view(torch.int32)):
            fail(f"phase 14(c): chunk_scores_from_entities_batch row {i}: {ulps(got[i], want)} ulps "
                 "from chunk_scores_from_entities")
    log(f"phase 14(c): chunk_scores_from_entities_batch B={BATCH} over {chunk_entities.shape[0]} x "
        f"{chunk_entities.shape[1]} chunk entities in {batch_s * 1e3:.1f} ms; {N_GRAPH_CHECKS} rows "
        f"the bits of chunk_scores_from_entities ({int((got > 0).sum())} chunk scores above 0); "
        f"phase 14(c) wall {time.time() - t0:.1f} s")


def public_surface_path(dev, card, lexical, graph_tables):
    """Phase 14: the port's public surface on the card. Returns the launches of its
    paths by the kernels line's names, and MaxSim's batch entry by body."""
    t0 = time.time()
    launches = run_examples(card)
    gen = torch.Generator(device=dev).manual_seed(1414)
    batch = maxsim_batch_check(dev, gen, card)
    launches["maxsim_scores"] = launches.get("maxsim_scores", 0) + batch["bf16"]["launches"]
    launches["maxsim_scores_int8"] = batch["int8"]["launches"]
    bm25_graph_check(dev, lexical, graph_tables, card)
    log(f"phase 14 wall time {time.time() - t0:.1f} s; public launches {launches}")
    return launches, batch


def maxsim_plan_counts() -> dict:
    """The MaxSim launches by plan since the last reset."""
    from triple_hybrid_rag_tpu_torch.ops.maxsim import maxsim_scores

    return dict(maxsim_scores.launches_by_plan)


def maxsim_counts_reset() -> None:
    from triple_hybrid_rag_tpu_torch.ops.maxsim import maxsim_scores

    maxsim_scores.launches_by_tokens = dict.fromkeys(maxsim_scores.launches_by_tokens, 0)
    maxsim_scores.launches_by_plan = dict.fromkeys(maxsim_scores.launches_by_plan, 0)


def maxsim_body_launches(body: str, label: str, state) -> int:
    """The MaxSim launches by token dtype since the last reset: the configuration's
    body must have run, and no other. Prints the token store's device GB."""
    from triple_hybrid_rag_tpu_torch.ops.maxsim import maxsim_scores

    by_tokens = dict(maxsim_scores.launches_by_tokens)
    plans = maxsim_plan_counts()
    log(f"{label}: MaxSim launches by token store {by_tokens}, by plan {plans}; store "
        f"{state.maxsim_tokens.dtype} {tuple(state.maxsim_tokens.shape)}, device GB "
        f"{state.nbytes()['maxsim'] / 1e9:.4f} with the mask")
    if by_tokens[body] < 1 or sum(by_tokens.values()) != by_tokens[body]:
        fail(f"{label}: the {body} MaxSim body was not the one launched: {by_tokens}")
    add_counts(MAXSIM_PLAN_LAUNCHES[body], plans)
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
    bf16_worst = bucket_maxima_edge_sweep(dev, gen)
    kernels = [check_fused(data), check_int(data, "int8"), check_int(data, "int4")]
    kernels[0]["edge_max_abs_err"] = bf16_worst
    dense = check_dense(data)
    f32_bodies = check_f32(data, dev, gen)
    del data
    torch.cuda.empty_cache()
    kernels += [*check_maxsim(dev, gen), check_termtable(dev, gen), dense, check_bowhash(dev)]
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
    torch.cuda.empty_cache()
    log(f"phase 7 wall time {time.time() - t_phase:.1f} s; staged launches {staged}")
    t_phase = time.time()
    served = serving_path(stdlib, card)
    log(f"phase 8 wall time {time.time() - t_phase:.1f} s; serve launches {served}")
    t_phase = time.time()
    formats, http_served = formats_path(dev, card)
    log(f"phase 9 wall time {time.time() - t_phase:.1f} s; format launches {formats}, HTTP "
        f"launches {http_served}")
    t_phase = time.time()
    evals, legacy = eval_path(dev, card, stdlib)
    log(f"phase 10 wall time {time.time() - t_phase:.1f} s; eval launches {evals}, legacy "
        f"launches {legacy}")
    t_phase = time.time()
    trained = training_path(dev, card)
    log(f"phase 11 wall time {time.time() - t_phase:.1f} s; trained-checkpoint launches {trained}")
    t_phase = time.time()
    sharded = sharded_path(run, stdlib, dev, card)
    # phase 14 reads phase 6's lexical index and phase 3's graph tables
    lexical = (stdlib[0].retriever.bm25_index, stdlib[1])
    graph_tables = (run.syn.state.nbr, run.syn.state.chunk_entities)
    del run, stdlib
    torch.cuda.empty_cache()
    t0 = time.time()
    sharded_training(dev, card)
    log(f"phase 12(h) wall time {time.time() - t0:.1f} s")
    log(f"phase 12 wall time {time.time() - t_phase:.1f} s; sharded launches {sharded}")
    repaired, repaired_plans = repaired_maxsim_path(dev, card)
    public, batch = public_surface_path(dev, card, lexical, graph_tables)
    del lexical, graph_tables
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
        k["formats_launches"] = formats.get(k["name"], 0)
        k["http_launches"] = http_served.get(k["name"], 0)
        k["eval_launches"] = evals.get(k["name"], 0)
        k["legacy_launches"] = legacy.get(k["name"], 0)
        k["train_launches"] = trained.get(k["name"], 0)
        k["sharded_launches"] = sharded.get(k["name"], 0)
        k["repaired_launches"] = repaired.get(k["name"], 0)
        k["public_launches"] = public.get(k["name"], 0)
        if k["name"] in ivf_bodies:  # MaxSim's batch entry (phase 14(b))
            k.update({key: v for key, v in batch[ivf_bodies[k["name"]]].items()
                      if key not in ("launches", "max_abs_err")})
            k["max_abs_err"] = max(k["max_abs_err"], batch[ivf_bodies[k["name"]]]["max_abs_err"])
        if k["name"] in ivf_bodies:  # MaxSim: the launches by plan
            k["counted_launches_by_plan"] = MAXSIM_PLAN_LAUNCHES[ivf_bodies[k["name"]]]
            k["repaired_launches_by_plan"] = repaired_plans  # both bodies' (the bf16 store's)
        if k["name"] in ("dense_scores", "fused_bucket_maxima"):  # of them, the f32 body's
            k["eval_f32_launches"] = evals.get(k["name"] + "_f32", 0)
    log(f"total wall time {time.time() - T_START:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
