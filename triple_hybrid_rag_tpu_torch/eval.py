"""Retrieval-quality evaluation: recall@k / NDCG@k / MRR over labeled corpora.

The port of the JAX package's ``eval.py``, function for function:

- :func:`recall_at_k` / :func:`ndcg_at_k` / :func:`mrr` — metrics over ranked chunk ids,
- :func:`make_eval_corpus` — a synthetic labeled corpus: topical documents with known
  relevant chunks per query (paraphrase queries exercise the semantic channel, keyword
  queries the lexical channel, entity queries the graph channel),
- :func:`evaluate` / :func:`evaluate_batched` — a retriever (one staged query at a
  time) or an :class:`~triple_hybrid_rag_tpu_torch.engine.Engine` (batches) over a
  query set, metrics aggregated,
- :func:`evaluate_baseline_configs` — the five BASELINE configurations: lexical-only,
  dense-only, dual-hybrid RRF, triple-hybrid, full pipeline with rerank,
- the independent corpora: inverse-cloze over harvested docstrings
  (:func:`make_stdlib_eval`, :func:`evaluate_stdlib`, the corpus-scale
  :func:`make_bigcorpus_eval`) and the code-structure knowledge graph
  (:func:`make_code_graph_eval`, :func:`evaluate_code_graph`,
  :func:`make_bigcorpus_graph_eval`).

Every function that builds a retriever takes ``device`` (CUDA unless ``"cpu"``) and
places it there: on the card the staged queries launch the dense-scores kernel (f32
rows at B = 1 under the BASELINE configurations) and the MaxSim kernel. Package
docstrings are harvested in a child process (``harvest.py``), so a JAX package among
the sources is never loaded here; the standard library is harvested in this process,
as the reference does. ``results`` (optional) collects each query's
:class:`~triple_hybrid_rag_tpu_torch.types.RetrievalResult`, to hold two runs'
ranked ids against each other.
"""

from __future__ import annotations

import hashlib
import math
import os
import sys
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Set

import numpy as np

from .chunker import HierarchicalChunker
from .config import RAGConfig
from .corpus import CorpusStore
from .harvest import harvest_in_child, module_candidates, source_candidates
from .index.graph_index import build_graph_index
from .models.entity_extractor import EntityStore, RuleBasedExtractor
from .retrieval import Retriever
from .types import RetrievalResult


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


def recall_at_k(ranked_ids: Sequence[str], relevant: Set[str], k: int = 10) -> float:
    """|top-k ∩ relevant| / |relevant|."""
    if not relevant:
        return 0.0
    hits = sum(1 for cid in list(ranked_ids)[:k] if cid in relevant)
    return hits / len(relevant)


def ndcg_at_k(ranked_ids: Sequence[str], relevant: Set[str], k: int = 10) -> float:
    """Binary-relevance NDCG@k."""
    if not relevant:
        return 0.0
    dcg = sum(
        1.0 / math.log2(i + 2)
        for i, cid in enumerate(list(ranked_ids)[:k])
        if cid in relevant
    )
    ideal = sum(1.0 / math.log2(i + 2) for i in range(min(len(relevant), k)))
    return dcg / ideal if ideal > 0 else 0.0


def mrr(ranked_ids: Sequence[str], relevant: Set[str]) -> float:
    for i, cid in enumerate(ranked_ids):
        if cid in relevant:
            return 1.0 / (i + 1)
    return 0.0


# ---------------------------------------------------------------------------
# labeled synthetic corpus
# ---------------------------------------------------------------------------

_TOPICS = [
    ("payments", "invoice settlement billing penalty quarterly",
     "Invoices must be settled within thirty days. The billing cycle is quarterly and "
     "late settlement incurs a penalty fee."),
    ("contracts", "termination clause renewal notice breach",
     "The termination clause requires ninety days notice. Renewal is automatic unless "
     "either party objects; breach voids the renewal provision."),
    ("security", "password rotation authentication portal access",
     "Passwords rotate every ninety days through the self-service portal. Two-factor "
     "authentication is mandatory for all remote access."),
    ("logistics", "freight shipment customs warehouse delivery",
     "Freight shipments clear customs before warehouse intake. Delivery windows are "
     "confirmed forty-eight hours ahead."),
    ("wildlife", "foxes bears forest habitat hibernation",
     "Red foxes share the northern forest habitat with brown bears. Bears hibernate "
     "through the winter months."),
    ("compute", "quantum processor qubit coherence hardware",
     "Quantum processors maintain qubit coherence through cryogenic hardware. Error "
     "correction consumes most physical qubits."),
]

_COMPANIES = ["Acme Corp", "Beta Logistics", "CloudStack Systems", "Delta Insurance"]
_PEOPLE = ["John Smith", "Maria Silva", "Wei Chen", "Ana Costa"]


@dataclass
class EvalQuery:
    text: str
    relevant_chunk_ids: Set[str]
    kind: str  # "keyword" | "paraphrase" | "entity"


@dataclass
class EvalCorpus:
    corpus: CorpusStore
    entity_store: EntityStore
    queries: List[EvalQuery] = field(default_factory=list)
    # triple precision/recall vs the AST oracle when the graph was self-extracted
    # (make_code_graph_eval(graph_source="extracted")); None otherwise
    extraction_metrics: Optional[Dict[str, float]] = None


def make_eval_corpus(
    cfg: RAGConfig,
    docs_per_topic: int = 4,
    distractors: int = 30,
    hard_negatives: int = 0,
) -> EvalCorpus:
    """Labeled corpus: per topic, documents whose chunks are relevant to that topic's
    queries, plus distractor documents relevant to nothing.

    ``hard_negatives`` adds per-topic confusable documents that REUSE topic vocabulary
    in off-topic statements (e.g. payment words inside a memo about something else) —
    they stress ranking rather than matching, the regime where fusion and reranking
    must earn their keep."""
    store = CorpusStore()
    estore = EntityStore()
    chunker = HierarchicalChunker(cfg)
    extractor = RuleBasedExtractor(cfg)
    topic_chunks: Dict[str, Set[str]] = {name: set() for name, _, _ in _TOPICS}
    entity_chunks: Dict[str, Set[str]] = {}

    def ingest(name: str, text: str) -> List[str]:
        doc_id = hashlib.sha256(name.encode()).hexdigest()
        parents, children = chunker.chunk_document(text, doc_id)
        store.add_chunks(parents, children)
        for p in parents:
            kids = [c for c in children if c.parent_id == p.parent_id]
            estore.store_extraction(extractor.extract(p, kids))
        return [c.chunk_id for c in children if c.row >= 0]

    for t_idx, (name, keywords, body) in enumerate(_TOPICS):
        company = _COMPANIES[t_idx % len(_COMPANIES)]
        person = _PEOPLE[t_idx % len(_PEOPLE)]
        for d in range(docs_per_topic):
            text = (
                f"# {name.title()} Document {d}\n\n{body} "
                f"{person} works for {company}. {company} oversees the {name} program. "
                f"Additional {name} detail {d}: " + " ".join(
                    f"{kw} consideration {d}-{i}." for i, kw in enumerate(keywords.split())
                )
            )
            ids = ingest(f"{name}-{d}.md", text)
            topic_chunks[name].update(ids)
            entity_chunks.setdefault(company, set()).update(ids)
            entity_chunks.setdefault(person, set()).update(ids)

    for d in range(distractors):
        ingest(
            f"distractor-{d}.md",
            f"# Miscellany {d}\n\nGeneric filler text item {d} about unrelated daily "
            f"matters, routine errands, and schedule notes numbered {d}. "
            + " ".join(f"filler{d}w{i} note." for i in range(30)),
        )

    # hard negatives: topic vocabulary sprinkled into off-topic documents (NOT labeled
    # relevant) — lexical overlap without topical relevance
    for t_idx, (name, keywords, _) in enumerate(_TOPICS):
        kws = keywords.split()
        for h in range(hard_negatives):
            sprinkle = " ".join(
                f"A passing mention of {kws[(h + i) % len(kws)]} in an unrelated memo."
                for i in range(2)
            )
            ingest(
                f"hardneg-{name}-{h}.md",
                f"# Office Memo {name}-{h}\n\nStationery reorder minutes item {h}. "
                f"{sprinkle} Remaining agenda covers parking assignments {h}.",
            )

    queries: List[EvalQuery] = []
    paraphrases = {
        "payments": "how long do we have to pay an invoice and what happens if late",
        "contracts": "what notice period is needed to end the agreement",
        "security": "how often must credentials be changed and how to log in remotely",
        "logistics": "when are shipping deliveries confirmed and cleared",
        "wildlife": "which animals live in the woods and sleep all winter",
        "compute": "how do quantum machines keep their qubits stable",
    }
    for name, keywords, _ in _TOPICS:
        rel = topic_chunks[name]
        queries.append(EvalQuery(keywords, rel, "keyword"))
        queries.append(EvalQuery(paraphrases[name], rel, "paraphrase"))
    for t_idx, (name, _, _) in enumerate(_TOPICS[: len(_PEOPLE)]):
        person = _PEOPLE[t_idx % len(_PEOPLE)]
        company = _COMPANIES[t_idx % len(_COMPANIES)]
        queries.append(
            EvalQuery(f"Who works for {company}?", entity_chunks[company], "entity")
        )
        # the PEOPLE half of the entity ground truth was built but never queried
        queries.append(
            EvalQuery(
                f"How is {person} related to {company}?",
                entity_chunks[person], "entity",
            )
        )
    return EvalCorpus(corpus=store, entity_store=estore, queries=queries)


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------


def evaluate(
    retrieve_fn: Callable[[str], RetrievalResult],
    queries: Sequence[EvalQuery],
    k: int = 10,
    results: Optional[List[RetrievalResult]] = None,
) -> Dict[str, float]:
    """Aggregate recall@k / NDCG@k / MRR over a query set (plus per-kind recall)."""
    return _metrics([(q, retrieve_fn(q.text)) for q in queries], k, results)


def _metrics(answered, k: int, results: Optional[List[RetrievalResult]]) -> Dict[str, float]:
    """The metrics of (query, result) pairs; each result appended to ``results``."""
    recalls, ndcgs, mrrs = [], [], []
    by_kind: Dict[str, List[float]] = {}
    for q, result in answered:
        if results is not None:
            results.append(result)
        ranked = [r.chunk_id for r in result.results]
        r = recall_at_k(ranked, q.relevant_chunk_ids, k)
        recalls.append(r)
        ndcgs.append(ndcg_at_k(ranked, q.relevant_chunk_ids, k))
        mrrs.append(mrr(ranked, q.relevant_chunk_ids))
        by_kind.setdefault(q.kind, []).append(r)
    out = {
        f"recall@{k}": float(np.mean(recalls)),
        f"ndcg@{k}": float(np.mean(ndcgs)),
        "mrr": float(np.mean(mrrs)),
        "n_queries": float(len(recalls)),
    }
    for kind, vals in by_kind.items():
        out[f"recall@{k}_{kind}"] = float(np.mean(vals))
    return out


def evaluate_batched(
    engine,
    queries: Sequence[EvalQuery],
    k: int = 10,
    batch_size: int = 64,
    results: Optional[List[RetrievalResult]] = None,
) -> Dict[str, float]:
    """:func:`evaluate` through ``Engine.retrieve_batch``: one batched program per
    ``batch_size`` queries instead of one staged query each (on the card the f32
    rows' dense channel is the fused bucket-maxima kernel)."""
    answered = []
    for lo in range(0, len(queries), batch_size):
        chunk = queries[lo : lo + batch_size]
        answered += zip(chunk, engine.retrieve_batch([q.text for q in chunk], top_k=k))
    return _metrics(answered, k, results)


def evaluate_baseline_configs(
    base_cfg: Optional[RAGConfig] = None,
    k: int = 10,
    distractors: int = 30,
    hard_negatives: int = 0,
    device=None,
    results: Optional[Dict[str, List[RetrievalResult]]] = None,
) -> Dict[str, Dict[str, float]]:
    """Run the five BASELINE configurations over the labeled corpus, each through
    a :class:`Retriever` on ``device``."""
    base = base_cfg or RAGConfig(
        capacity_round=64,
        embedding_dim=256,
        embedding_dim_full=512,
        embedding_dtype="float32",
        safety_threshold=0.0,
        final_top_k=max(k, 10),
        rerank_top_k=max(2 * k, 20),
        denoise_alpha=0.0,
    )
    data = make_eval_corpus(base, distractors=distractors, hard_negatives=hard_negatives)
    out: Dict[str, Dict[str, float]] = {}

    configs = {
        "1_lexical_only": base.replace(semantic_enabled=False, graph_enabled=False,
                                       rerank_enabled=False),
        "2_dense_only": base.replace(lexical_enabled=False, graph_enabled=False,
                                     rerank_enabled=False),
        "3_dual_hybrid_rrf": base.replace(graph_enabled=False, rerank_enabled=False),
        "4_triple_hybrid": base.replace(rerank_enabled=False),
        "5_full_pipeline": base,
    }
    for name, cfg in configs.items():
        gidx = (
            build_graph_index(data.entity_store, data.corpus, cfg)
            if cfg.graph_enabled
            else None
        )
        retriever = Retriever(data.corpus, cfg, graph_index=gidx, device=device)
        out[name] = evaluate(
            lambda q: retriever.retrieve(q, top_k=k), data.queries, k=k,
            results=None if results is None else results.setdefault(name, []),
        )
    return out


# ---------------------------------------------------------------------------
# independent-corpus evaluation (text this repository did not author)
# ---------------------------------------------------------------------------


#: third-party packages whose docstrings extend the independent corpus. All are
#: installed packages; their prose was written by thousands of external contributors (NumPy/
#: SciPy/pandas/JAX/PyTorch docs), so neither this repo's topics nor its encoder's
#: training lexicon could have been tuned to them.
_PACKAGE_SOURCES = (
    "numpy", "scipy", "pandas", "jax", "torch", "einops", "chex",
    # a second wave widens the author pool with ML-docs prose
    # genres the first seven underrepresent. NEVER add a package from
    # models.pretrain.TRAIN_TEXT_SOURCES here — the encoder fine-tunes on those,
    # and the disjointness test (test_pretrain.py) exists to keep these evals
    # independent of training text (flax/optax were caught by exactly that test).
    "transformers", "accelerate", "haiku",
)


_module_candidates = module_candidates


def _stdlib_documents(
    min_len: int = 400,
    max_docs: int = 800,
    sources: Sequence[str] = ("stdlib",),
) -> List[tuple]:
    """(name, text) pairs harvested from module/function docstrings.

    ``sources`` selects corpora: "stdlib" (prose by hundreds of CPython
    contributors) and/or installed package names (see ``_PACKAGE_SOURCES``).
    Deterministic given the installed versions; the documents equal the JAX
    package's on the same machine.

    Source ownership is enforced per attribute (:func:`harvest.source_candidates`):
    each document is attributable to its source's authors. The package sources are
    imported in one child process (:func:`harvest.harvest_in_child`), never here;
    this process keeps the reference's ``seen`` / ``min_len`` / budget passes."""
    import warnings

    docs: List[tuple] = []
    seen: Set[str] = set()
    packages = [s for s in dict.fromkeys(sources) if s != "stdlib"]
    harvested: Dict[str, list] = {}

    def candidates(source: str):
        if source == "stdlib":
            return source_candidates(source, min_len)
        if not harvested and packages:
            harvested.update(harvest_in_child(packages, min_len))
        return harvested[source]

    def harvest(source: str, cap: int) -> int:
        n_source = 0
        for cands in candidates(source):
            for name, text in cands:
                if len(text) < min_len or text in seen:
                    continue
                seen.add(text)
                docs.append((name, text))
                n_source += 1
                if n_source >= cap:
                    return n_source
        return n_source

    with warnings.catch_warnings():
        warnings.filterwarnings("ignore")
        # pass 1: even split of the budget so a prolific source (stdlib) cannot
        # crowd out the others; pass 2 backfills shortfall from small sources
        # (the `seen` set makes re-harvesting a source resume, not repeat)
        for s_idx, source in enumerate(sources):
            cap = -(-(max_docs - len(docs)) // (len(sources) - s_idx))
            if cap > 0:
                harvest(source, cap)
        for source in sources:
            if len(docs) >= max_docs:
                break
            harvest(source, max_docs - len(docs))
    return docs


def _ast_documents(
    min_len: int = 300,
    max_docs: int = 100000,
    exclude_top: Sequence[str] = (),
    exclude_texts: Optional[Set[str]] = None,
    include_top: Optional[Sequence[str]] = None,
    collect_classes: Optional[Dict[str, List[tuple]]] = None,
) -> List[tuple]:
    """(qualified_name, docstring) pairs harvested by PARSING package source files.

    The import-based harvester (:func:`_stdlib_documents`) tops out near ~12k
    documents because it only imports two package levels; this walks every ``.py``
    file under site-packages and the stdlib with :mod:`ast` — no imports, no side
    effects, full depth — and yields module/class/function docstrings: the
    corpus-scale eval, quality and latency measured on the same real-text corpus.

    Disjointness from the encoder training pool is enforced two ways: by source
    ownership (``exclude_top`` prunes the training packages' directory trees) and
    by content (``exclude_texts`` drops any doc whose exact text appears in the
    training pool, which also catches vendored copies).

    ``include_top`` flips the filter to allow-list mode: ONLY the named top-level
    directories are walked (the training-pool harvest; the stdlib root has no
    top dir on any allow list, so stdlib — an eval source — is naturally out).

    ``collect_classes`` (optional out-param) is filled with the AST class
    structure of every walked module: ``modpath -> [(class_name, [base_names])]``
    — the ground-truth relational facts (class PART_OF module, class DEPENDS_ON
    base) for the corpus-scale graph eval (:func:`make_bigcorpus_graph_eval`),
    mirroring :func:`_stdlib_module_structure` without imports.
    """
    import ast as _ast
    import sysconfig

    roots = [p for p in sys.path if p.endswith("site-packages") and os.path.isdir(p)]
    roots.append(sysconfig.get_paths()["stdlib"])
    skip_dirs = {"tests", "test", "testing", "vendor", "vendored", "_vendor",
                 "site-packages", "conftest", "__pycache__"}
    excluded = set(exclude_top)
    included = set(include_top) if include_top is not None else None

    def _norm(text: str) -> str:
        return " ".join(text.split()).lower()

    # whitespace/case-normalized comparison: the same docstring re-wrapped by
    # another package (flax's attention-mask prose appears verbatim in several
    # downstream trees) must still be excluded
    excluded_norm = (
        {_norm(t) for t in exclude_texts} if exclude_texts is not None else None
    )

    def top_ok(top: str) -> bool:
        if included is not None:
            return top in included
        return top not in excluded

    docs: List[tuple] = []
    seen: Set[str] = set()
    for root in roots:
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = sorted(
                d for d in dirnames
                if not d.startswith(".") and d not in skip_dirs
                and (
                    top_ok(os.path.relpath(os.path.join(dirpath, d), root)
                           .split(os.sep)[0])
                    or os.path.dirname(os.path.relpath(os.path.join(dirpath, d), root))
                )
            )
            for fn in sorted(filenames):
                if not fn.endswith(".py"):
                    continue
                path = os.path.join(dirpath, fn)
                rel = os.path.relpath(path, root)
                top = rel.split(os.sep)[0]
                if not top_ok(top) or top.startswith("test"):
                    continue
                modpath = rel[:-3].replace(os.sep, ".")
                try:
                    with open(path, encoding="utf-8", errors="replace") as f:
                        tree = _ast.parse(f.read())
                except (SyntaxError, ValueError, OSError):
                    continue
                cands: List[tuple] = [(modpath, _ast.get_docstring(tree))]
                for node in _ast.walk(tree):
                    if isinstance(node, (_ast.FunctionDef, _ast.AsyncFunctionDef,
                                         _ast.ClassDef)):
                        cands.append((f"{modpath}.{node.name}",
                                      _ast.get_docstring(node)))
                        if collect_classes is not None and isinstance(node, _ast.ClassDef):
                            bases = []
                            for b in node.bases:
                                if isinstance(b, _ast.Name):
                                    bases.append(b.id)
                                elif isinstance(b, _ast.Attribute):
                                    bases.append(b.attr)
                            collect_classes.setdefault(modpath, []).append(
                                (node.name, bases)
                            )
                for name, text in cands:
                    if not text:
                        continue
                    text = text.strip()
                    if len(text) < min_len or text in seen:
                        continue
                    if excluded_norm is not None and _norm(text) in excluded_norm:
                        continue
                    seen.add(text)
                    docs.append((name, text))
                    if len(docs) >= max_docs:
                        return docs
    return docs


def make_bigcorpus_eval(
    cfg: RAGConfig,
    n_docs: int = 50000,
    n_queries: int = 500,
    seed: int = 0,
    min_len: int = 300,
    exclude_training_content: bool = True,
) -> EvalCorpus:
    """Corpus-scale inverse-cloze eval over AST-harvested docstrings (~46k max).

    Same query construction as :func:`make_stdlib_eval`; the document pool is the
    full-depth :func:`_ast_documents` walk with the encoder training packages
    (both the import-harvest list and the deep additions) excluded by
    directory AND by content hash."""
    from .models.pretrain import (
        TRAIN_TEXT_SOURCES_DEEP,
        realtext_documents,
        realtext_documents_deep,
    )

    exclude_texts: Optional[Set[str]] = None
    if exclude_training_content:
        exclude_texts = {t.strip() for t in realtext_documents(max_docs=100000)}
        exclude_texts |= {t.strip() for t in realtext_documents_deep(max_docs=200000)}
    docs = _ast_documents(
        min_len=min_len, max_docs=n_docs,
        exclude_top=TRAIN_TEXT_SOURCES_DEEP, exclude_texts=exclude_texts,
    )
    return _cloze_eval_from_docs(cfg, docs, n_queries, seed)


def make_bigcorpus_graph_eval(
    cfg: RAGConfig,
    n_docs: int = 33000,
    n_queries: int = 500,
    n_graph_queries: int = 200,
    seed: int = 0,
    min_len: int = 220,
    api_class_cap: int = 50,
    extractor=None,
    exclude_training_content: bool = True,
) -> EvalCorpus:
    """The corpus-scale THREE-channel eval: the 33k cloze corpus plus a
    self-extracted knowledge graph and a relational query slice.

    It measures the shipped three-channel configuration past a few hundred modules,
    with the same methodology as :func:`make_code_graph_eval` at corpus scale:

    - **Documents**: the full :func:`make_bigcorpus_eval` harvest (training
      packages excluded by directory and content hash) with the standard
      held-out-sentence cloze queries.
    - **API carrier docs**: for every harvested module whose own docstring doc
      is in the corpus and whose source defines classes, one API-reference doc
      states the AST facts as prose ("The class {C} belongs to the module
      {M}.") — the textual carrier a real corpus would have. Never labeled
      relevant (the relational queries target the module's own description, so
      the graph must ROUTE through the relation, not string-match the
      statement).
    - **Graph**: the shipped :class:`RuleBasedExtractor` runs over EVERY parent
      exactly as ingestion would, followed by the ``link_mentions`` sweep; the
      AST facts only score the extraction (``extraction_metrics``).
    - **Relational queries** ("The class {C} belongs to which module?"): classes
      with a unique definition site whose name does not occur in the answer
      module's doc — lexically invisible, graph-routable (same filters as the
      240-module eval: len >= 4, capitalized, key absent from the folded body).
    """
    from .models.entity_extractor import RuleBasedExtractor, _fold_ws, canonical_key
    from .models.pretrain import (
        TRAIN_TEXT_SOURCES_DEEP,
        realtext_documents,
        realtext_documents_deep,
    )
    from .types import RelationType
    import time as _time

    exclude_texts: Optional[Set[str]] = None
    if exclude_training_content:
        exclude_texts = {t.strip() for t in realtext_documents(max_docs=100000)}
        exclude_texts |= {t.strip() for t in realtext_documents_deep(max_docs=200000)}
    classes: Dict[str, List[tuple]] = {}
    docs = _ast_documents(
        min_len=min_len, max_docs=n_docs,
        exclude_top=TRAIN_TEXT_SOURCES_DEEP, exclude_texts=exclude_texts,
        collect_classes=classes,
    )
    details: dict = {}
    data = _cloze_eval_from_docs(cfg, docs, n_queries, seed, details=details)
    store, estore, queries = data.corpus, data.entity_store, data.queries
    rel_ids_by_name = details.get("rel_ids_by_name", {})
    body_by_name = details.get("body_by_name", {})
    parent_children = details.get("parent_children", [])
    all_children = list(details.get("all_children", []))
    chunker = HierarchicalChunker(cfg)

    # unique-definition-site filter across ALL walked structure
    def_sites: Dict[str, List[str]] = {}
    for mod, cls_list in classes.items():
        for cname, _bases in cls_list:
            def_sites.setdefault(canonical_key(cname), []).append(mod)

    # API carrier docs + oracle triples, only for modules whose own doc is in
    # the corpus (the relational answers must exist to be retrievable)
    corpus_modules = [m for m in classes if m in rel_ids_by_name]
    oracle_triples: Set[tuple] = set()
    graph_candidates: List[tuple] = []
    for mod in corpus_modules:
        cls_list = classes[mod][:api_class_cap]
        mod_key = canonical_key(mod)
        lines = []
        folded_body = _fold_ws(body_by_name.get(mod, ""))
        for cname, bases in cls_list:
            lines.append(f"The class {cname} belongs to the module {mod}.")
            oracle_triples.add((canonical_key(cname), RelationType.PART_OF.value, mod_key))
            for b in bases:
                if b.startswith("_") or canonical_key(b) == canonical_key(cname):
                    continue
                lines.append(f"The class {cname} depends on the class {b}.")
                oracle_triples.add(
                    (canonical_key(cname), RelationType.DEPENDS_ON.value, canonical_key(b))
                )
            key = canonical_key(cname)
            if (
                len(cname) >= 4
                and len(def_sites.get(key, [])) == 1
                and key not in folded_body
                and not cname[0].islower()
                and rel_ids_by_name.get(mod)
            ):
                graph_candidates.append((cname, rel_ids_by_name[mod]))
        api_text = f"# {mod} API reference\n\n" + " ".join(lines)
        api_id = hashlib.sha256(f"bigcorpus-api-{mod}".encode()).hexdigest()
        a_parents, a_children = chunker.chunk_document(api_text, api_id)
        store.add_chunks(a_parents, a_children)
        for p in a_parents:
            parent_children.append(
                (p, [c for c in a_children if c.parent_id == p.parent_id])
            )
        all_children.extend(a_children)

    # the shipped ingest-path extraction over every parent, then the global
    # dictionary-linking sweep (timed: this is the ingest cost a user pays)
    ex = extractor or RuleBasedExtractor(cfg)
    t0 = _time.time()
    for p, kids in parent_children:
        estore.store_extraction(ex.extract(p, kids))
    t_extract = _time.time() - t0
    t0 = _time.time()
    estore.link_mentions(all_children)
    t_link = _time.time() - t0

    # score typed triples against the AST oracle (PART_OF / DEPENDS_ON)
    ent_key = {
        e.entity_id: canonical_key(e.canonical_name) for e in estore.entities.values()
    }
    typed = {RelationType.PART_OF.value, RelationType.DEPENDS_ON.value}
    extracted = {
        (ent_key[r.subject_id], r.relation_type.value, ent_key[r.object_id])
        for r in estore.relations
        if r.relation_type.value in typed
    }
    tp = len(extracted & oracle_triples)
    extraction_metrics = {
        "oracle_triples": float(len(oracle_triples)),
        "extracted_typed_triples": float(len(extracted)),
        "triple_recall": tp / max(len(oracle_triples), 1),
        "triple_precision": tp / max(len(extracted), 1),
        "entities": float(len(estore.entities)),
        "mentions": float(len(estore.mentions)),
        "api_modules": float(len(corpus_modules)),
        "extract_s": round(t_extract, 1),
        "link_s": round(t_link, 1),
    }

    templates = (
        "The class {c} belongs to which module?",
        "Which library module is the class {c} part of?",
    )
    rng = np.random.default_rng(seed + 1)
    rng.shuffle(graph_candidates)
    for j, (cname, rel_ids) in enumerate(graph_candidates[:n_graph_queries]):
        queries.append(EvalQuery(templates[j % len(templates)].format(c=cname),
                                 rel_ids, "graph"))
    return EvalCorpus(corpus=store, entity_store=estore, queries=queries,
                      extraction_metrics=extraction_metrics)


def make_stdlib_eval(
    cfg: RAGConfig,
    n_docs: int = 500,
    n_queries: int = 150,
    seed: int = 0,
    sources: Sequence[str] = ("stdlib",),
) -> EvalCorpus:
    """Inverse-cloze eval over harvested docstrings: one sentence is REMOVED from a
    document and used as the query; the retriever must find the remaining
    document from topical coherence alone. Neither documents nor queries were
    authored by (or generated from the lexicon of) this repo."""
    docs = _stdlib_documents(max_docs=n_docs * 2, sources=sources)[:n_docs]
    return _cloze_eval_from_docs(cfg, docs, n_queries, seed)


def _cloze_eval_from_docs(
    cfg: RAGConfig,
    docs: List[tuple],
    n_queries: int,
    seed: int,
    details: Optional[dict] = None,
) -> EvalCorpus:
    """``details`` (optional out-param) collects what graph construction on top
    of the cloze corpus needs: ``rel_ids_by_name`` (doc name -> its child chunk
    ids), ``parent_children`` ((parent, [children]) pairs in ingest order),
    ``all_children``, and ``body_by_name`` (post-cloze-removal text)."""
    rng = np.random.default_rng(seed)
    store = CorpusStore()
    estore = EntityStore()
    chunker = HierarchicalChunker(cfg)
    queries: List[EvalQuery] = []

    q_doc_idx = rng.permutation(len(docs))[: min(n_queries, len(docs))]
    held_out: Dict[int, str] = {}
    for i in q_doc_idx:
        _, text = docs[i]
        # sentences with enough signal to be a plausible query (>= 8 words)
        sents = [s.strip() for s in text.replace("\n", " ").split(". ")]
        sents = [s for s in sents if len(s.split()) >= 8]
        if len(sents) < 2:
            continue  # keep at least one sentence in the doc
        held_out[int(i)] = str(sents[rng.integers(0, len(sents))])

    import re as _re

    for i, (name, text) in enumerate(docs):
        body = text
        if i in held_out:
            # whitespace-FLEXIBLE removal: the query sentence was extracted from
            # newline-collapsed text, but docstrings wrap at ~72 chars, so a
            # plain substring replace matched almost never and the query stayed
            # VERBATIM in its document — the eval then measured exact-substring
            # retrieval, inflating every published number on this corpus
            pattern = r"\s+".join(_re.escape(w) for w in held_out[i].split())
            body = _re.sub(pattern, " ", body, count=1)
        doc_id = hashlib.sha256(f"stdlib-{name}".encode()).hexdigest()
        parents, children = chunker.chunk_document(f"# {name}\n\n{body}", doc_id)
        store.add_chunks(parents, children)
        if details is not None:
            details.setdefault("rel_ids_by_name", {})[name] = {
                c.chunk_id for c in children if c.row >= 0
            }
            details.setdefault("body_by_name", {})[name] = body
            for p in parents:
                details.setdefault("parent_children", []).append(
                    (p, [c for c in children if c.parent_id == p.parent_id])
                )
            details.setdefault("all_children", []).extend(children)
        if i in held_out:
            rel = {c.chunk_id for c in children if c.row >= 0}
            if rel:
                queries.append(EvalQuery(held_out[i], rel, "cloze"))
    return EvalCorpus(corpus=store, entity_store=estore, queries=queries)


def evaluate_stdlib(
    base_cfg: Optional[RAGConfig] = None,
    k: int = 10,
    n_docs: int = 500,
    n_queries: int = 150,
    seed: int = 0,
    sources: Sequence[str] = ("stdlib",),
    configs: Optional[Sequence[str]] = None,
    device=None,
    results: Optional[Dict[str, List[RetrievalResult]]] = None,
) -> Dict[str, Dict[str, float]]:
    """Full pipeline + per-channel ablations on the independent docstring corpus.

    ``configs`` optionally restricts which ablations run (names from the table
    below) — large-corpus runs use ``["full_pipeline"]`` to go 4x faster."""
    base = base_cfg or RAGConfig(
        capacity_round=64,
        embedding_dtype="float32",
        safety_threshold=0.0,
        final_top_k=max(k, 10),
        rerank_top_k=max(2 * k, 20),
        denoise_alpha=0.0,
        graph_enabled=False,  # docstrings carry no entity graph
    )
    data = make_stdlib_eval(
        base, n_docs=n_docs, n_queries=n_queries, seed=seed, sources=sources
    )
    out: Dict[str, Dict[str, float]] = {}
    table = {
        "lexical_only": base.replace(semantic_enabled=False, rerank_enabled=False),
        "dense_only": base.replace(lexical_enabled=False, rerank_enabled=False),
        "hybrid_rrf": base.replace(rerank_enabled=False),
        "full_pipeline": base,
    }
    for name, cfg in table.items():
        if configs is not None and name not in configs:
            continue
        retriever = Retriever(data.corpus, cfg, device=device)
        out[name] = evaluate(
            lambda q: retriever.retrieve(q, top_k=k), data.queries, k=k,
            results=None if results is None else results.setdefault(name, []),
        )
    return out


# ---------------------------------------------------------------------------
# entity-rich independent evaluation: knowledge graph from real code structure
# ---------------------------------------------------------------------------


def _stdlib_module_structure(max_modules: int = 300) -> List[tuple]:
    """(module_name, docstring, [(class, [bases]), ...]) from real CPython source.

    The documents are module docstrings (prose by CPython contributors); the
    graph facts are AST-extracted from the same modules' actual source: which
    classes each module defines and what they inherit from. Neither the text
    nor the triples were authored by this repo: graph evidence on text this
    repository did not design (the graph is the highest-weighted channel)."""
    import ast
    import importlib
    import warnings

    out: List[tuple] = []
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore")
        for mod_name in _module_candidates("stdlib"):
            try:
                m = importlib.import_module(mod_name)
            except Exception:
                continue
            doc = (m.__doc__ or "").strip()
            path = getattr(m, "__file__", None)
            if len(doc) < 300 or not path or not path.endswith(".py"):
                continue
            try:
                with open(path, encoding="utf-8", errors="replace") as f:
                    tree = ast.parse(f.read())
            except Exception:
                continue
            classes = []
            for node in tree.body:
                if isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
                    bases = [b.id for b in node.bases if isinstance(b, ast.Name)]
                    classes.append((node.name, bases))
            if classes:
                out.append((mod_name, doc, classes))
            if len(out) >= max_modules:
                break
    return out


def make_code_graph_eval(
    cfg: RAGConfig,
    n_modules: int = 200,
    n_graph_queries: int = 120,
    n_cloze_queries: int = 120,
    seed: int = 0,
    graph_source: str = "oracle",
    include_api_docs: bool = False,
    extractor=None,
) -> EvalCorpus:
    """Independent corpus whose knowledge graph mirrors real code structure.

    Documents: stdlib module docstrings. Entities: the modules plus the classes
    their source actually defines (AST). Relations: ``class PART_OF module``
    (definition site) and ``class DEPENDS_ON base`` (inheritance). Mentions:
    substring occurrences in the chunked children, exactly the ``CallableExtractor``
    rule (models/entity_extractor.py).

    Two query kinds:

    - ``graph``: "The class {C} belongs to which module?" where C's name does
      NOT occur in its module's docstring — the lexical and dense channels have
      nothing to grip (the query shares only stop-words with the answer doc),
      but the graph holds the ``C -PART_OF-> M`` edge and M is mentioned in its
      own doc. Only classes with a unique definition site are used: the
      relational / entity-lookup intent on facts this repository did not plant.
    - ``cloze``: the standard held-out-sentence inverse-cloze queries over the
      same corpus, to show the graph channel does not regress non-graph queries.

    Closing the NER -> graph loop on real text:

    - ``include_api_docs``: adds one API-reference document per module stating its
      AST facts as prose ("The class {C} belongs to the module {M}."), the textual
      carrier a real corpus would have. Its chunks are NEVER labeled relevant —
      the relational queries still target the module's own description, so the
      channel must ROUTE through the relation, not string-match the statement.
    - ``graph_source="extracted"``: instead of injecting oracle triples, the
      shipped extractor (``extractor`` or :class:`RuleBasedExtractor`) runs over
      every parent chunk exactly as ingestion would, followed by the
      ``EntityStore.link_mentions`` dictionary-linking sweep; the AST facts are
      then only used to SCORE the extraction (triple precision/recall in
      ``EvalCorpus.extraction_metrics``). Requires ``include_api_docs=True`` —
      prose must state the facts for any extractor to have a chance.
    """
    from .models.entity_extractor import RuleBasedExtractor, _fold_ws, canonical_key
    from .types import (
        Entity,
        EntityMention,
        EntityType,
        ExtractionResult,
        Relation,
        RelationType,
    )
    import re as _re
    import uuid as _uuid

    if graph_source not in ("oracle", "extracted"):
        raise ValueError(f"graph_source must be oracle|extracted, got {graph_source!r}")
    if graph_source == "extracted" and not include_api_docs:
        raise ValueError("graph_source='extracted' requires include_api_docs=True "
                         "(the facts must exist as prose for extraction)")
    rng = np.random.default_rng(seed)
    mods = _stdlib_module_structure(max_modules=n_modules * 2)[:n_modules]

    # class name -> list of defining modules (for the uniqueness filter)
    def_sites: Dict[str, List[str]] = {}
    for mod_name, _, classes in mods:
        for cname, _bases in classes:
            def_sites.setdefault(canonical_key(cname), []).append(mod_name)

    store = CorpusStore()
    estore = EntityStore()
    chunker = HierarchicalChunker(cfg)
    queries: List[EvalQuery] = []

    # pick cloze docs up front (same inverse-cloze recipe as make_stdlib_eval)
    cloze_idx = set(
        int(i) for i in rng.permutation(len(mods))[: min(n_cloze_queries, len(mods))]
    )

    def ent(name: str, etype: EntityType) -> Entity:
        key = canonical_key(name)
        return Entity(
            entity_id=str(_uuid.uuid5(_uuid.NAMESPACE_OID, "thr-ent:" + key)),
            canonical_name=name,
            entity_type=etype,
        )

    graph_candidates: List[tuple] = []  # (class_name, relevant chunk ids)
    oracle_triples: Set[tuple] = set()  # (subj_key, rtype_value, obj_key)
    parent_children: List[tuple] = []  # (ParentChunk, [ChildChunk]) for extraction
    all_children: List = []
    for i, (mod_name, doc, classes) in enumerate(mods):
        body = doc
        held_out = None
        if i in cloze_idx:
            sents = [s.strip() for s in doc.replace("\n", " ").split(". ")]
            sents = [s for s in sents if len(s.split()) >= 8]
            if len(sents) >= 2:
                held_out = str(sents[rng.integers(0, len(sents))])
                pattern = r"\s+".join(_re.escape(w) for w in held_out.split())
                body = _re.sub(pattern, " ", body, count=1)

        doc_id = hashlib.sha256(f"codegraph-{mod_name}".encode()).hexdigest()
        parents, children = chunker.chunk_document(f"# {mod_name}\n\n{body}", doc_id)
        store.add_chunks(parents, children)
        for p in parents:
            parent_children.append((p, [c for c in children if c.parent_id == p.parent_id]))
        all_children.extend(children)

        # the AST ground-truth triples (graph content in oracle mode; the scoring
        # key in extracted mode)
        mod_key = canonical_key(mod_name)
        for cname, bases in classes:
            oracle_triples.add((canonical_key(cname), RelationType.PART_OF.value, mod_key))
            for b in bases:
                if b.startswith("_") or canonical_key(b) == canonical_key(cname):
                    continue
                oracle_triples.add(
                    (canonical_key(cname), RelationType.DEPENDS_ON.value, canonical_key(b))
                )

        if include_api_docs:
            # the textual carrier of the AST facts — one API-reference doc per
            # module, chunks never labeled relevant (see docstring)
            lines = []
            for cname, bases in classes:
                lines.append(f"The class {cname} belongs to the module {mod_name}.")
                for b in bases:
                    if b.startswith("_") or canonical_key(b) == canonical_key(cname):
                        continue
                    lines.append(f"The class {cname} depends on the class {b}.")
            api_text = f"# {mod_name} API reference\n\n" + " ".join(lines)
            api_id = hashlib.sha256(f"codegraph-api-{mod_name}".encode()).hexdigest()
            a_parents, a_children = chunker.chunk_document(api_text, api_id)
            store.add_chunks(a_parents, a_children)
            for p in a_parents:
                parent_children.append(
                    (p, [c for c in a_children if c.parent_id == p.parent_id])
                )
            all_children.extend(a_children)

        if graph_source == "oracle":
            # --- inject per-parent, CallableExtractor mention semantics ---
            mod_ent = ent(mod_name, EntityType.TECHNOLOGY)
            entities = {canonical_key(mod_name): mod_ent}
            relations: List[Relation] = []
            for cname, bases in classes:
                c_ent = entities.setdefault(canonical_key(cname), ent(cname, EntityType.CONCEPT))
                relations.append(Relation(
                    relation_id=str(_uuid.uuid4()),
                    subject_id=c_ent.entity_id,
                    object_id=mod_ent.entity_id,
                    relation_type=RelationType.PART_OF,
                    source_chunk_id=parents[0].parent_id if parents else None,
                ))
                for b in bases:
                    if b.startswith("_") or canonical_key(b) == canonical_key(cname):
                        continue
                    b_ent = entities.setdefault(canonical_key(b), ent(b, EntityType.CONCEPT))
                    relations.append(Relation(
                        relation_id=str(_uuid.uuid4()),
                        subject_id=c_ent.entity_id,
                        object_id=b_ent.entity_id,
                        relation_type=RelationType.DEPENDS_ON,
                        source_chunk_id=parents[0].parent_id if parents else None,
                    ))
            mentions = []
            for child in children:
                folded = _fold_ws(child.text)
                for key, e in entities.items():
                    if key in folded:
                        mentions.append(EntityMention(
                            entity_id=e.entity_id, chunk_id=child.chunk_id,
                            surface_form=e.canonical_name,
                        ))
            estore.store_extraction(ExtractionResult(
                entities=list(entities.values()), mentions=mentions, relations=relations,
            ))

        rel_ids = {c.chunk_id for c in children if c.row >= 0}
        if not rel_ids:
            continue
        if held_out is not None:
            queries.append(EvalQuery(held_out, rel_ids, "cloze"))
        folded_doc = _fold_ws(body)
        for cname, _bases in classes:
            key = canonical_key(cname)
            if (
                len(cname) >= 4
                and len(def_sites.get(key, [])) == 1     # unique definition site
                and key not in folded_doc                 # lexically absent from answer
                and not cname[0].islower()                # planner needs a capital
            ):
                graph_candidates.append((cname, rel_ids))

    extraction_metrics = None
    if graph_source == "extracted":
        # the shipped ingest-path extraction, parent by parent, then the global
        # dictionary-linking sweep (the reference's ILIKE-match analogue)
        ex = extractor or RuleBasedExtractor(cfg)
        for p, kids in parent_children:
            estore.store_extraction(ex.extract(p, kids))
        estore.link_mentions(all_children)
        # score typed triples against the AST oracle
        ent_key = {
            e.entity_id: canonical_key(e.canonical_name)
            for e in estore.entities.values()
        }
        typed = {RelationType.PART_OF.value, RelationType.DEPENDS_ON.value}
        extracted = {
            (ent_key[r.subject_id], r.relation_type.value, ent_key[r.object_id])
            for r in estore.relations
            if r.relation_type.value in typed
        }
        tp = len(extracted & oracle_triples)
        extraction_metrics = {
            "oracle_triples": float(len(oracle_triples)),
            "extracted_typed_triples": float(len(extracted)),
            "triple_recall": tp / max(len(oracle_triples), 1),
            "triple_precision": tp / max(len(extracted), 1),
            "related_to_edges": float(sum(
                1 for r in estore.relations
                if r.relation_type == RelationType.RELATED_TO
            )),
            "entities": float(len(estore.entities)),
            "mentions": float(len(estore.mentions)),
        }
    elif include_api_docs:
        # oracle graph + api docs: bind oracle entities into the api chunks too so
        # both modes see the same mention surface
        estore.link_mentions(all_children)

    templates = (
        "The class {c} belongs to which module?",
        "Which library module is the class {c} part of?",
    )
    rng.shuffle(graph_candidates)
    for j, (cname, rel_ids) in enumerate(graph_candidates[:n_graph_queries]):
        queries.append(EvalQuery(templates[j % len(templates)].format(c=cname),
                                 rel_ids, "graph"))
    return EvalCorpus(corpus=store, entity_store=estore, queries=queries,
                      extraction_metrics=extraction_metrics)


def evaluate_code_graph(
    base_cfg: Optional[RAGConfig] = None,
    k: int = 10,
    n_modules: int = 200,
    n_graph_queries: int = 120,
    n_cloze_queries: int = 120,
    seed: int = 0,
    graph_source: str = "oracle",
    include_api_docs: bool = False,
    extractor=None,
    device=None,
    results: Optional[Dict[str, List[RetrievalResult]]] = None,
) -> Dict[str, Dict[str, float]]:
    """Graph-on vs graph-off through the FULL funnel on the code-structure corpus.

    Graph-on against graph-off on text this repository did not design: ``graph``
    rows measure that;
    ``cloze`` rows guard against regression on non-relational queries.

    ``graph_source="extracted"`` replaces the oracle triples
    with the shipped extractor's output over the corpus text (requires
    ``include_api_docs``); the returned dict gains an ``extraction`` entry with
    triple precision/recall vs the AST oracle."""
    base = base_cfg or RAGConfig(
        capacity_round=64,
        embedding_dtype="float32",
        safety_threshold=0.0,
        final_top_k=max(k, 10),
        rerank_top_k=max(2 * k, 20),
        denoise_alpha=0.0,
        graph_enabled=True,
    )
    data = make_code_graph_eval(
        base, n_modules=n_modules, n_graph_queries=n_graph_queries,
        n_cloze_queries=n_cloze_queries, seed=seed,
        graph_source=graph_source, include_api_docs=include_api_docs,
        extractor=extractor,
    )
    table = {
        "graph_off": base.replace(graph_enabled=False),
        "graph_on": base,
        "graph_only": base.replace(lexical_enabled=False, semantic_enabled=False,
                                   rerank_enabled=False),
    }
    out: Dict[str, Dict[str, float]] = {}
    for name, cfg in table.items():
        gidx = (
            build_graph_index(data.entity_store, data.corpus, cfg)
            if cfg.graph_enabled else None
        )
        retriever = Retriever(data.corpus, cfg, graph_index=gidx, device=device)
        out[name] = evaluate(
            lambda q: retriever.retrieve(q, top_k=k), data.queries, k=k,
            results=None if results is None else results.setdefault(name, []),
        )
    if data.extraction_metrics is not None:
        out["extraction"] = data.extraction_metrics
    return out
