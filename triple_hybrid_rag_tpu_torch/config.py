"""Static configuration of the PyTorch/CUDA retrieval engine.

A copy of the JAX package's ``RAGConfig`` with the same fields and defaults, so one
configuration describes both implementations (the tests build the port's config from
the reference's with ``dataclasses.asdict``), plus the port's own fields
(``PORT_ONLY_FIELDS``: the on-device cross-encoder's), which a checkpoint records only
when they differ from their defaults. The config is a frozen, hashable
dataclass: built from ``RAG_*`` environment variables by :meth:`RAGConfig.from_env`
and tweaked per call with :meth:`RAGConfig.replace`.

Defaults mirror the reference: channel weights lexical 0.7 / semantic 0.8 / graph 1.0,
RRF k=60, safety threshold 0.6, denoise alpha 0.6, channel top-k 50/100/50, rerank 50,
final 5, Matryoshka 2048 -> 1024 truncation.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Optional, Tuple


def _env_bool(name: str, default: bool) -> bool:
    raw = os.environ.get(name)
    if raw is None:
        return default
    return raw.strip().lower() in ("1", "true", "yes", "on")


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    return int(raw) if raw is not None else default


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    return float(raw) if raw is not None else default


def _env_str(name: str, default: str) -> str:
    return os.environ.get(name, default)


@dataclass(frozen=True)
class RAGConfig:
    """Frozen, hashable configuration (field-for-field the reference's)."""

    # ---- channel enables ----
    lexical_enabled: bool = True
    semantic_enabled: bool = True
    graph_enabled: bool = True
    rerank_enabled: bool = True
    denoise_enabled: bool = True
    safety_enabled: bool = True
    conformal_denoise_enabled: bool = False  # percentile variant of the denoiser
    ner_enabled: bool = True
    ner_retry_sleep_cap_s: float = 10.0

    # ---- RRF fusion ----
    rrf_k: int = 60
    lexical_weight: float = 0.7
    semantic_weight: float = 0.8
    graph_weight: float = 1.0
    # ordering key: 0.0 = rank-RRF, 1.0 = CombSUM over per-channel min-max scores
    fusion_score_blend: float = 1.0
    # per-query semantic down-weighting by the lexical channel's top-2 margin
    # (ops/fusion.fuse_rrf lex_conf_gate); 0.0 = off
    fusion_lex_conf_gate: float = 12.0

    # ---- safety / denoising ----
    safety_threshold: float = 0.6  # applies to the (calibrated) rerank score
    denoise_alpha: float = 0.6
    conformal_alpha: float = 0.6

    # ---- channel top-k ----
    lexical_top_k: int = 50
    semantic_top_k: int = 100
    graph_top_k: int = 50
    rerank_top_k: int = 50  # fused candidate pool handed to the reranker
    final_top_k: int = 5

    # ---- chunking ----
    parent_chunk_tokens: int = 1000
    parent_chunk_min_tokens: int = 800
    child_chunk_tokens: int = 200
    child_chunk_overlap_tokens: int = 50
    child_token_buffer_pct: float = 0.2
    use_tiktoken: bool = False

    # ---- embeddings ----
    # "auto" | "encoder" | "bowhash" | "hash": "auto" and "encoder" load the
    # packaged trained encoder (models/embedder.get_default_embedder)
    embedder_backend: str = "auto"
    embedding_dim_full: int = 2048
    embedding_dim: int = 1024  # Matryoshka prefix-truncated + re-L2-normalized
    embedding_dtype: str = "bfloat16"  # float32 | bfloat16 | int8 | int4 (packed nibbles)
    encoder_anchor_pool_w2: Optional[float] = 0.65
    encoder_params_path: Optional[str] = None
    embedding_batch_size: int = 20
    semantic_backend: str = "exact"  # "exact" | "ivf" (blocked IVF, index/ivf.py)
    ivf_block_rows: int = 512
    ivf_probes: int = 32
    ivf_kmeans_iters: int = 8
    ivf_clusters: int = 0

    # ---- lexical / BM25 ----
    bm25_k1: float = 1.5
    bm25_b: float = 0.75
    max_query_terms: int = 16  # static query-term slots (padded/masked)
    doc_term_capacity: int = 128
    # "sorted" | "auto" (= sorted): CSR postings; "termtable" | "postings": the doc-major table
    lexical_backend: str = "auto"
    bm25_df_cap: int = 0  # 0 = uncapped; else a term keeps its top-tf postings
    lexical_tiering: bool = True  # rare terms use small gather windows
    bm25_small_window: int = 128  # window for terms with stored df <= this
    bm25_large_slots: int = 4  # query slots for high-df terms
    topk_backend: str = "exact"

    # ---- graph channel ----
    graph_hops: int = 2
    graph_max_degree: int = 64
    graph_max_entities_per_chunk: int = 16
    graph_fuzzy_threshold: float = 0.35  # trigram-jaccard entity name matching
    graph_max_seeds: int = 8  # seed-entity slots per query
    graph_seed_stop_df: float = 0.05
    graph_seed_stop_min: int = 64
    # "auto" picks the sparse mention-postings scorer exactly when it is provably
    # exact (every possibly-activated entity fits graph_active_slots and no
    # mention list was capped); otherwise the dense chunk_entities scan
    graph_backend: str = "auto"  # "auto" | "dense" | "sparse"
    graph_mention_cap: int = 4096
    graph_active_slots: int = 1024
    # batches of at most this many queries take the sparse path even when the
    # large-batch mode is the dense scan (top-slots approximation past the budget)
    graph_sparse_max_batch: int = 4

    # ---- rerank / late interaction ----
    # "maxsim" | "dot" | "none" | "cross_encoder" (the port's on-device LLM judge,
    # models/cross_encoder.py, over a placed document-token store and model)
    rerank_backend: str = "maxsim"
    maxsim_doc_tokens: int = 64
    maxsim_query_tokens: int = 32
    maxsim_dim: int = 128
    rerank_max_candidates: int = 50
    # the cross-encoder's stored weights: "bfloat16", or "float8_e4m3fn" (e4m3 codes
    # with per-row scales, dequantized to bf16 at use)
    cross_encoder_weight_dtype: str = "bfloat16"
    rerank_blend_rrf: float = 0.5  # order = (1-b)*rerank + b*minmax(rrf)

    # ---- plan-aware relational overrides ----
    planner_relational_text_scale: float = 0.5
    rerank_blend_rrf_relational: float = 0.8

    # ---- sharding / parallelism (the port runs on one device) ----
    mesh_shape: Tuple[int, ...] = (1,)
    mesh_axis_names: Tuple[str, ...] = ("shard",)
    shard_axis: str = "shard"
    data_axis: Optional[str] = None

    # ---- capacity ----
    chunk_capacity: int = 0
    capacity_round: int = 1024  # round capacities to multiples of this

    # ---- planner ----
    planner_backend: str = "rules"

    # ---- external model servers (unused by the port) ----
    embed_api_base: str = ""
    embed_api_model: str = ""
    rerank_api_base: str = ""
    rerank_api_model: str = ""
    llm_api_base: str = ""
    llm_api_model: str = ""
    ocr_api_base: str = ""
    ocr_api_model: str = ""
    api_key: str = ""
    api_timeout_s: float = 30.0
    api_retries: int = 2

    # ---- analyzer ----
    analyzer_languages: Tuple[str, ...] = ("en", "pt")
    analyzer_strip_accents: bool = True
    analyzer_min_token_len: int = 2
    analyzer_stemming: str = "light"  # "light" (S-stemmer) | "none"
    vocab_hash_buckets: int = 32768

    # ---- observability ----
    metrics_enabled: bool = True
    timings_enabled: bool = True

    # ---- native / kernels ----
    use_native: bool = True
    use_pallas: bool = False  # reference-only switch; the port's kernels are always on
    # Dense channel through the hand-written fused matmul + bucket-max kernel
    # (ops/fused_topk.py), which never writes the f32[B, N] score matrix.
    # None = auto. The reference's auto rule (fused only above
    # fused_topk_auto_bytes of score transient) rests on a TPU measurement and
    # does not apply here: in the port None resolves to the kernel on a CUDA
    # device and to the bucketed matmul path on the CPU. False forces the
    # bucketed path (a bf16 GEMM with f32 output, then
    # ops/topk.bucketed_masked_top_k_batch).
    # Both paths are exact, so the choice changes no result.
    use_fused_topk: Optional[bool] = None
    fused_topk_auto_bytes: int = 1_500_000_000  # reference-only (TPU auto rule)

    @classmethod
    def from_env(cls, **overrides: object) -> "RAGConfig":
        """Build a config from ``RAG_*`` environment variables."""
        base = cls()
        env_map: dict[str, object] = {}
        for f in dataclasses.fields(cls):
            env_name = "RAG_" + f.name.upper()
            if os.environ.get(env_name) is None:
                continue
            default = getattr(base, f.name)
            if isinstance(default, bool):
                env_map[f.name] = _env_bool(env_name, default)
            elif isinstance(default, int):
                env_map[f.name] = _env_int(env_name, default)
            elif isinstance(default, float):
                env_map[f.name] = _env_float(env_name, default)
            elif isinstance(default, str):
                env_map[f.name] = _env_str(env_name, default)
            elif default is None and f.name == "use_fused_topk":
                raw = os.environ[env_name].strip().lower()
                if raw not in ("", "auto"):
                    env_map[f.name] = _env_bool(env_name, False)
            elif default is None and f.type in ("Optional[str]", "typing.Optional[str]"):
                raw = os.environ[env_name]
                if raw.strip():
                    env_map[f.name] = raw
        env_map.update(overrides)
        return dataclasses.replace(base, **env_map)  # type: ignore[arg-type]

    def replace(self, **kw: object) -> "RAGConfig":
        return dataclasses.replace(self, **kw)  # type: ignore[arg-type]

    def round_capacity(self, n: int) -> int:
        """Round a corpus size up to the capacity granularity."""
        r = self.capacity_round
        return max(r, ((n + r - 1) // r) * r)


PORT_ONLY_FIELDS = ("cross_encoder_weight_dtype",)

_SETTINGS: Optional[RAGConfig] = None


def get_settings() -> RAGConfig:
    """Process-wide config singleton (built from the environment on first use)."""
    global _SETTINGS
    if _SETTINGS is None:
        _SETTINGS = RAGConfig.from_env()
    return _SETTINGS


def reset_settings() -> None:
    """Clear the singleton."""
    global _SETTINGS
    _SETTINGS = None
