"""HTTP model adapters: OpenAI-compatible clients for the external serving boundary.

A copy of the JAX package's ``models/http_clients.py``: the same request bodies,
retries and fallbacks. The upstream project's model boundary is concrete HTTP: an
OpenAI-compatible ``/embeddings`` endpoint for its embeddings, vLLM's native
``/rerank`` with a chat+logprob fallback, JSON-chat planning, JSON-chat NER, and a
vision-LLM OCR chat call. These clients point the port at such a server (vLLM, LM
Studio, OpenAI or any OpenAI-compatible one)::

    from triple_hybrid_rag_tpu_torch import RAG, RAGConfig
    rag = RAG(config=RAGConfig(embed_api_base="http://127.0.0.1:1234/v1",
                               embed_api_model="qwen3-vl-embedding"))

Everything is stdlib ``urllib`` (no SDK dependency) with the reference's resilience
ladder: per-request timeout, bounded retries with exponential backoff on transient
failures (network errors / 5xx / 429), immediate failure on other 4xx, and the same
degradation at each boundary: zero vectors for failed embedding batches, neutral 0.5
scores / the fallback rung for reranking, the rule-based plan and extractor as
fallbacks. The clients run on the host; what they return goes to the device like
any embedder's or reranker's output (an HTTP embedder's queries are embedded on the
host, and it has no token embeddings, so the rerank falls to ``dot``).

The ``*_api_base`` config fields activate them (:func:`wire_http_models`), or they
are built explicitly. The ``rag_metrics`` counters and timers are the reference's.
"""

from __future__ import annotations

import base64
import json
import math
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..config import RAGConfig, get_settings
from ..observability import rag_metrics

__all__ = [
    "HTTPStatusError",
    "post_json",
    "HTTPEmbedder",
    "HTTPRerankerFn",
    "HTTPChatJSON",
    "HTTPVisionOCR",
    "make_planner_fn",
    "make_extractor_fn",
    "wire_http_models",
    "PLANNER_SYSTEM_PROMPT",
    "NER_SYSTEM_PROMPT",
    "RERANK_SYSTEM_PROMPT",
]


class HTTPStatusError(RuntimeError):
    """Non-2xx HTTP response (carries the status for ladder decisions)."""

    def __init__(self, status: int, url: str, body: str = "") -> None:
        super().__init__(f"HTTP {status} from {url}: {body[:200]}")
        self.status = status


_RETRYABLE_STATUS = frozenset({429, 500, 502, 503, 504})


def post_json(
    url: str,
    payload: dict,
    timeout_s: float = 30.0,
    retries: int = 2,
    backoff_s: float = 0.5,
    api_key: str = "",
    _sleep: Callable[[float], None] = time.sleep,
) -> dict:
    """POST JSON with the reference's timeout/retry ladder.

    Retries network errors, timeouts, and retryable statuses (429/5xx) with
    exponential backoff; other 4xx raise immediately (they will not fix themselves).
    Mirrors the resilience contract the reference spec mandates for all external calls
    (``docs/RAG2.0/Triple-Hybrid-RAG.docx.md:1019-1029``: timeouts, retries, breakers).
    """
    body = json.dumps(payload).encode("utf-8")
    headers = {"Content-Type": "application/json"}
    if api_key:
        headers["Authorization"] = f"Bearer {api_key}"
    last_exc: Optional[Exception] = None
    for attempt in range(retries + 1):
        if attempt:
            _sleep(backoff_s * (2.0 ** (attempt - 1)))
        req = urllib.request.Request(url, data=body, headers=headers, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=timeout_s) as resp:
                return json.loads(resp.read().decode("utf-8"))
        except urllib.error.HTTPError as e:
            err_body = ""
            try:
                err_body = e.read().decode("utf-8", "replace")
            except Exception:
                pass
            exc = HTTPStatusError(e.code, url, err_body)
            if e.code not in _RETRYABLE_STATUS:
                raise exc
            last_exc = exc
        except Exception as e:  # URLError, timeout, ConnectionReset, bad JSON
            last_exc = e
        if attempt < retries:  # the final failed attempt is not a retry
            rag_metrics.counter("http_model_retries_total").inc()
    assert last_exc is not None
    raise last_exc


def _chat_url(base_url: str) -> str:
    return base_url.rstrip("/") + "/chat/completions"


def _data_url(image: bytes) -> str:
    """base64 data URL with magic-byte type sniffing (reference ocr.py:233-247)."""
    mime = "image/png"
    if image[:3] == b"\xff\xd8\xff":
        mime = "image/jpeg"
    elif image[:6] in (b"GIF87a", b"GIF89a"):
        mime = "image/gif"
    elif image[:4] == b"RIFF" and image[8:12] == b"WEBP":
        mime = "image/webp"
    return f"data:{mime};base64," + base64.b64encode(image).decode("ascii")


# ---------------------------------------------------------------------------
# Embeddings: OpenAI-compatible POST {base}/embeddings
# ---------------------------------------------------------------------------


class HTTPEmbedder:
    """``Embedder``-protocol client for an OpenAI-compatible ``/embeddings`` server.

    Wire behavior matches the reference embedders: batches of ``batch_size`` (20 —
    ``rag2/embedder.py:103``), ``encoding_format="float"``, full model-dim vectors
    returned raw (Matryoshka truncate+renormalize happens in the dense index build,
    ``index/dense_index.py``), zero vectors for a failed batch so ingestion continues
    (``rag2/embedder.py:203-211``), and a raising ``embed_query``
    (``rag2/embedder.py:226-247``). Image inputs post base64 data-URL content parts
    (``core/embedder.py:141-210``).
    """

    def __init__(
        self,
        base_url: str,
        model: str = "",
        dim: Optional[int] = None,
        batch_size: int = 20,
        timeout_s: float = 30.0,
        retries: int = 2,
        backoff_s: float = 0.5,
        api_key: str = "",
        config: Optional[RAGConfig] = None,
    ) -> None:
        cfg = config or get_settings()
        self.base_url = base_url.rstrip("/")
        self.model = model
        self.dim = dim or cfg.embedding_dim_full
        self.batch_size = max(1, batch_size)
        self.timeout_s = timeout_s
        self.retries = retries
        self.backoff_s = backoff_s
        self.api_key = api_key

    # -- wire --

    def _post(self, inputs: list) -> np.ndarray:
        data = post_json(
            self.base_url + "/embeddings",
            {"model": self.model, "input": inputs, "encoding_format": "float"},
            timeout_s=self.timeout_s,
            retries=self.retries,
            backoff_s=self.backoff_s,
            api_key=self.api_key,
        )
        out = np.zeros((len(inputs), self.dim), np.float32)
        for pos, row in enumerate(data["data"]):
            # align by the protocol's OWN index key: servers may omit rows that
            # failed (e.g. an over-long input), and positional assignment would
            # silently shift every later embedding onto the wrong input
            i = row.get("index", pos)
            if not isinstance(i, int) or not (0 <= i < len(inputs)):
                continue
            vec = np.asarray(row["embedding"], np.float32)
            if vec.shape[0] != self.dim:
                # dimension drift: warn-and-adapt like the reference (embedder.py:140-145)
                rag_metrics.counter("http_embed_dim_mismatch_total").inc()
                k = min(vec.shape[0], self.dim)
                out[i, :k] = vec[:k]
            else:
                out[i] = vec
        return out

    # -- Embedder protocol --

    def embed_texts(self, texts: Sequence[str]) -> np.ndarray:
        if not texts:
            return np.zeros((0, self.dim), np.float32)
        out = np.zeros((len(texts), self.dim), np.float32)
        for start in range(0, len(texts), self.batch_size):
            batch = list(texts[start : start + self.batch_size])
            try:
                out[start : start + len(batch)] = self._post(batch)
            except Exception:
                # failed batch -> zero vectors; ingestion continues (fail-soft ladder)
                rag_metrics.counter("http_embed_failed_batches_total").inc()
        return out

    def embed_query(self, text: str) -> np.ndarray:
        try:
            return self._post([text])[0]
        except Exception as e:
            raise ValueError(f"query embedding failed: {e}") from e

    def embed_images(self, images: Sequence[bytes]) -> np.ndarray:
        out = np.zeros((len(images), self.dim), np.float32)
        for i, img in enumerate(images):
            try:
                out[i] = self._post(
                    [{"type": "image_url", "image_url": {"url": _data_url(img)}}]
                )[0]
            except Exception:
                rag_metrics.counter("http_embed_failed_batches_total").inc()
        return out

    def embed_mixed(self, items: Sequence[tuple]) -> np.ndarray:
        out = np.zeros((len(items), self.dim), np.float32)
        for i, (modality, payload) in enumerate(items):
            if modality == "image":
                out[i] = self.embed_images([payload])[0]
            else:
                try:
                    out[i] = self._post([str(payload)])[0]
                except Exception:
                    pass
        return out


# ---------------------------------------------------------------------------
# Rerank: vLLM-native /rerank, chat+logprob fallback
# ---------------------------------------------------------------------------

RERANK_SYSTEM_PROMPT = (
    "You judge whether a document is relevant to a query. "
    "Answer with exactly one word: yes or no."
)

_YES_TOKENS = frozenset({"yes", "sim", "y"})
_NO_TOKENS = frozenset({"no", "nao", "não", "n"})


class HTTPRerankerFn:
    """``fn(query, texts) -> [0,1] scores`` rung for :class:`CallableReranker`.

    Ladder parity with the reference reranker (``retrieval/reranker.py:287-353``):
    try vLLM's native ``POST {root}/rerank`` (the ``/v1`` suffix is stripped, exactly
    as the reference rewrites the URL, reranker.py:307-312); on 404 or failure fall
    back to per-document chat scoring with yes/no logprob softmax
    (``reranker.py:194-285``), fanned out over a bounded worker pool (the reference's
    ``asyncio.Semaphore(5)``). Raises only when both rungs fail completely, so the
    wrapping ``CallableReranker`` degrades to its on-device fallback.
    """

    def __init__(
        self,
        base_url: str,
        model: str = "",
        timeout_s: float = 30.0,
        retries: int = 1,
        backoff_s: float = 0.5,
        api_key: str = "",
        max_concurrency: int = 5,
    ) -> None:
        self.base_url = base_url.rstrip("/")
        self.model = model
        self.timeout_s = timeout_s
        self.retries = retries
        self.backoff_s = backoff_s
        self.api_key = api_key
        self.max_concurrency = max_concurrency
        self._native_available = True  # sticky: flips off on first 404

    # -- native /rerank rung --

    def _rerank_url(self) -> str:
        root = self.base_url
        if root.endswith("/v1"):
            root = root[: -len("/v1")]
        return root + "/rerank"

    def _rerank_native(self, query: str, texts: Sequence[str]) -> List[float]:
        data = post_json(
            self._rerank_url(),
            {"model": self.model, "query": query, "documents": list(texts)},
            timeout_s=self.timeout_s,
            retries=self.retries,
            backoff_s=self.backoff_s,
            api_key=self.api_key,
        )
        scores = [0.5] * len(texts)  # neutral default (reranker.py:335-341)
        for row in data.get("results", []):
            idx = int(row.get("index", -1))
            if 0 <= idx < len(scores):
                scores[idx] = float(row.get("relevance_score", 0.5))
        return scores

    # -- chat+logprob rung --

    def _score_pair(self, query: str, document: str) -> float:
        data = post_json(
            _chat_url(self.base_url),
            {
                "model": self.model,
                "messages": [
                    {"role": "system", "content": RERANK_SYSTEM_PROMPT},
                    {
                        "role": "user",
                        "content": f"Query: {query}\n\nDocument:\n{document}\n\n"
                        "Is this document relevant to the query? Answer yes or no.",
                    },
                ],
                "max_tokens": 10,
                "temperature": 0.1,
                "logprobs": True,
                "top_logprobs": 5,
            },
            timeout_s=self.timeout_s,
            retries=self.retries,
            backoff_s=self.backoff_s,
            api_key=self.api_key,
        )
        choice = data["choices"][0]
        answer = (choice.get("message", {}).get("content") or "").strip().lower()

        # logprob softmax over yes/no alternatives (reranker.py:231-256)
        content_lp = (choice.get("logprobs") or {}).get("content") or []
        if content_lp:
            yes_lp, no_lp = -math.inf, -math.inf
            for alt in content_lp[0].get("top_logprobs", []):
                tok = str(alt.get("token", "")).strip().lower()
                lp = float(alt.get("logprob", -math.inf))
                if tok in _YES_TOKENS:
                    yes_lp = max(yes_lp, lp)
                elif tok in _NO_TOKENS:
                    no_lp = max(no_lp, lp)
            if yes_lp > -math.inf or no_lp > -math.inf:
                m = max(yes_lp, no_lp)
                yes_p = math.exp(yes_lp - m)
                no_p = math.exp(no_lp - m)
                return yes_p / (yes_p + no_p)

        # text parse ladder (reranker.py:258-279): first word, then anywhere
        first = answer.split()[0].rstrip(".,!?;:") if answer.split() else ""
        if first.startswith("yes") or first in _YES_TOKENS:
            return 0.9
        if first.startswith("no") or first in _NO_TOKENS:
            # a no-leading answer is irrelevant-leaning even when 'yes' appears
            # later in a hedge ('No. It does say yes to a different question.')
            # — 0.6 previously outranked the 0.5 neutral default
            return 0.4 if "yes" in answer else 0.1
        if "yes" in answer:
            return 0.7
        if "no" in answer:
            return 0.3
        return 0.5

    def _rerank_chat(self, query: str, texts: Sequence[str]) -> List[float]:
        scores = [0.5] * len(texts)
        errors = 0
        with ThreadPoolExecutor(max_workers=self.max_concurrency) as pool:
            futs = {pool.submit(self._score_pair, query, t): i for i, t in enumerate(texts)}
            for fut, i in futs.items():
                try:
                    scores[i] = fut.result()
                except Exception:
                    errors += 1
        if errors == len(texts):
            raise RuntimeError("chat rerank failed for every document")
        return scores

    def __call__(self, query: str, texts: Sequence[str]) -> List[float]:
        if not texts:
            return []
        if self._native_available:
            try:
                with rag_metrics.time("http_rerank_native_ms"):
                    return self._rerank_native(query, texts)
            except HTTPStatusError as e:
                if e.status == 404:
                    self._native_available = False  # endpoint absent: stop probing
                rag_metrics.counter("http_rerank_native_failures_total").inc()
            except Exception:
                rag_metrics.counter("http_rerank_native_failures_total").inc()
        with rag_metrics.time("http_rerank_chat_ms"):
            return self._rerank_chat(query, texts)


# ---------------------------------------------------------------------------
# JSON chat: planner + NER callables
# ---------------------------------------------------------------------------


class HTTPChatJSON:
    """Generic JSON-object chat call: ``fn(user_content) -> dict``.

    The reference pattern for planner and NER: one system prompt, one user message,
    ``response_format={"type": "json_object"}``, ``json.loads`` of the content
    (``rag2/query_planner.py:140-162``, ``rag2/entity_extraction.py:228-263``).
    Raises on failure — the wrapping ``CallablePlanner``/``CallableExtractor``
    fall back to the rule-based implementations.
    """

    def __init__(
        self,
        base_url: str,
        model: str = "",
        system_prompt: str = "",
        temperature: float = 0.0,
        max_tokens: int = 1024,
        timeout_s: float = 30.0,
        retries: int = 1,
        backoff_s: float = 0.5,
        api_key: str = "",
        user_template: str = "{content}",
    ) -> None:
        self.base_url = base_url.rstrip("/")
        self.model = model
        self.system_prompt = system_prompt
        self.temperature = temperature
        self.max_tokens = max_tokens
        self.timeout_s = timeout_s
        self.retries = retries
        self.backoff_s = backoff_s
        self.api_key = api_key
        self.user_template = user_template

    @staticmethod
    def parse_json_content(content: str) -> dict:
        """Tolerant JSON extraction: strips markdown fences, grabs the outer object."""
        text = content.strip()
        if text.startswith("```"):
            text = text.split("\n", 1)[1] if "\n" in text else text
            if text.rstrip().endswith("```"):
                text = text.rstrip()[: -len("```")]
        try:
            data = json.loads(text)
        except json.JSONDecodeError:
            start, end = text.find("{"), text.rfind("}")
            if start < 0 or end <= start:
                raise
            data = json.loads(text[start : end + 1])
        if not isinstance(data, dict):
            raise ValueError(f"model returned non-object JSON: {type(data)}")
        return data

    def __call__(self, content: str) -> dict:
        data = post_json(
            _chat_url(self.base_url),
            {
                "model": self.model,
                "messages": [
                    {"role": "system", "content": self.system_prompt},
                    {"role": "user", "content": self.user_template.format(content=content)},
                ],
                "temperature": self.temperature,
                "max_tokens": self.max_tokens,
                "response_format": {"type": "json_object"},
            },
            timeout_s=self.timeout_s,
            retries=self.retries,
            backoff_s=self.backoff_s,
            api_key=self.api_key,
        )
        raw = data["choices"][0].get("message", {}).get("content") or ""
        return self.parse_json_content(raw)


PLANNER_SYSTEM_PROMPT = """You are a retrieval query planner for a triple-hybrid \
(lexical + semantic + knowledge-graph) search engine over Portuguese and English \
documents. Analyze the user query and respond ONLY with a JSON object:
{
  "keywords": [..],               // content words for BM25 lexical search
  "semantic_query_text": "...",   // rephrased query for embedding search
  "intent": "factual" | "procedural" | "comparative" | "entity_lookup" | "relational",
  "requires_graph": true | false, // true when the query asks about entities/relations
  "graph_entities": [..],         // entity names mentioned in the query
  "graph_query": null | {"op": "neighborhood", "entity": "..", "hops": 1-3}
               | {"op": "path", "from": "..", "to": ".."}
               | {"op": "related", "entity": ".."}
               | {"op": "keywords", "keywords": [..]},
  "weights": {"lexical": 0.7, "semantic": 0.8, "graph": 1.0}  // adjust per intent
}
Examples:
Query: "qual o prazo de pagamento das faturas?" ->
{"keywords": ["prazo", "pagamento", "faturas"], "semantic_query_text": "prazo de \
pagamento de faturas", "intent": "factual", "requires_graph": false, \
"graph_entities": [], "graph_query": null, \
"weights": {"lexical": 0.7, "semantic": 0.8, "graph": 1.0}}
Query: "how is ACME Corp related to the Zenith project?" ->
{"keywords": ["acme", "zenith", "project"], "semantic_query_text": "relationship \
between ACME Corp and the Zenith project", "intent": "relational", \
"requires_graph": true, "graph_entities": ["ACME Corp", "Zenith"], \
"graph_query": {"op": "path", "from": "ACME Corp", "to": "Zenith"}, \
"weights": {"lexical": 0.5, "semantic": 0.7, "graph": 1.0}}"""


NER_SYSTEM_PROMPT = """You extract entities and relations from document text for a \
knowledge graph. Respond ONLY with a JSON object:
{
  "entities": [{"name": "..", "type": "..", "description": ".."}],
  "relations": [{"subject": "..", "relation_type": "..", "object": ".."}]
}
Entity types: person, organization, location, product, service, event, date, money, \
contract, clause, document, concept, technology, metric, other.
Relation types: works_for, located_in, part_of, produces, uses, related_to, mentions, \
has_clause, signed_by, effective_on, costs, provides, depends_on.
Use the exact surface names from the text for subject/object; keep descriptions short."""


def make_planner_fn(
    base_url: str, model: str = "", **kw: object
) -> Callable[[str], dict]:
    """Planner callable for :class:`CallablePlanner` (``fn(query) -> plan dict``)."""
    return HTTPChatJSON(
        base_url,
        model=model,
        system_prompt=PLANNER_SYSTEM_PROMPT,
        max_tokens=512,
        user_template="Query: {content}",
        **kw,  # type: ignore[arg-type]
    )


def make_extractor_fn(
    base_url: str, model: str = "", **kw: object
) -> Callable[[str], dict]:
    """NER callable for :class:`CallableExtractor` (``fn(parent_text) -> dict``)."""
    return HTTPChatJSON(
        base_url,
        model=model,
        system_prompt=NER_SYSTEM_PROMPT,
        max_tokens=2048,
        user_template="Extract entities and relations from this text:\n\n{content}",
        **kw,  # type: ignore[arg-type]
    )


# ---------------------------------------------------------------------------
# Vision OCR: chat call with an image content part
# ---------------------------------------------------------------------------

OCR_SYSTEM_PROMPT = (
    "You are an OCR engine. Transcribe ALL text in the image exactly as written, "
    "preserving reading order and line breaks. Render tables as markdown tables. "
    "Output only the transcription, no commentary."
)


class HTTPVisionOCR:
    """``ocr_fn(image_bytes, mode) -> text`` rung for :class:`OCRProcessor`.

    The reference's OCR recognition is exactly this: an OpenAI-compatible chat call
    with a base64 data-URL image part against a vision LLM (qwen3-vl / DeepSeek-OCR,
    ``ingestion/ocr.py:223-340``). The mode ladder (tiny..gundam) maps to a token
    budget here; tiling/merging/escalation live in ``ocr.OCRProcessor``. Failures
    raise — the processor's retry/escalation ladder handles them.
    """

    MODE_TOKENS: Dict[str, int] = {
        "tiny": 512, "small": 1024, "base": 2048, "large": 4096, "gundam": 4096,
    }

    def __init__(
        self,
        base_url: str,
        model: str = "",
        timeout_s: float = 60.0,
        retries: int = 1,
        backoff_s: float = 0.5,
        api_key: str = "",
    ) -> None:
        self.base_url = base_url.rstrip("/")
        self.model = model
        self.timeout_s = timeout_s
        self.retries = retries
        self.backoff_s = backoff_s
        self.api_key = api_key

    def __call__(self, image: bytes, mode: str = "base") -> str:
        data = post_json(
            _chat_url(self.base_url),
            {
                "model": self.model,
                "messages": [
                    {"role": "system", "content": OCR_SYSTEM_PROMPT},
                    {
                        "role": "user",
                        "content": [
                            {"type": "image_url", "image_url": {"url": _data_url(image)}},
                            {"type": "text", "text": "Transcribe all text in this image."},
                        ],
                    },
                ],
                "max_tokens": self.MODE_TOKENS.get(mode, 2048),
                "temperature": 0.0,
            },
            timeout_s=self.timeout_s,
            retries=self.retries,
            backoff_s=self.backoff_s,
            api_key=self.api_key,
        )
        return data["choices"][0].get("message", {}).get("content") or ""


# ---------------------------------------------------------------------------
# Config-driven wiring
# ---------------------------------------------------------------------------


def wire_http_models(config: Optional[RAGConfig] = None) -> dict:
    """Construct whichever HTTP clients the config's ``*_api_base`` fields enable.

    Returns a dict with any of: ``embedder`` (Embedder protocol), ``planner_fn``
    (for CallablePlanner), ``extractor_fn`` (for CallableExtractor), ``rerank_fn``
    (for CallableReranker), ``ocr_fn`` (for OCRProcessor). Empty dict when no
    external servers are configured — the on-mesh defaults apply.
    """
    cfg = config or get_settings()
    common = dict(
        timeout_s=cfg.api_timeout_s,
        retries=cfg.api_retries,
        api_key=cfg.api_key,
    )
    out: dict = {}
    if cfg.embed_api_base:
        out["embedder"] = HTTPEmbedder(
            cfg.embed_api_base,
            model=cfg.embed_api_model,
            dim=cfg.embedding_dim_full,
            batch_size=cfg.embedding_batch_size,
            config=cfg,
            **common,  # type: ignore[arg-type]
        )
    if cfg.llm_api_base:
        out["planner_fn"] = make_planner_fn(cfg.llm_api_base, cfg.llm_api_model, **common)
        out["extractor_fn"] = make_extractor_fn(cfg.llm_api_base, cfg.llm_api_model, **common)
    if cfg.rerank_api_base:
        out["rerank_fn"] = HTTPRerankerFn(cfg.rerank_api_base, cfg.rerank_api_model, **common)
    if cfg.ocr_api_base:
        out["ocr_fn"] = HTTPVisionOCR(cfg.ocr_api_base, cfg.ocr_api_model, **common)
    return out
