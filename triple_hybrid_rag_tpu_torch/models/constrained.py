"""Grammar-constrained decoding over a causal LM: structured output from any model.

A copy of the JAX package's ``models/constrained.py`` (numpy only). Small local
models rarely emit parseable JSON plans, NER or Cypher on their own; the robust
alternative is to make invalid output IMPOSSIBLE: decode against a template whose
literal spans are forced and whose choice points are selected by the MODEL'S OWN
LIKELIHOOD over the allowed options. The result is always grammatically valid and
still genuinely model-generated — the model's logits pick every decision.

The only model interface needed is ``logprobs_fn(token_ids) -> [vocab] next-token
log-probabilities``, so this works with a transformers causal LM, a PyTorch model on
the card, or anything else that scores tokens. Templates are sequences of
:class:`Lit` (forced literal text) and :class:`Choice` (model-selected option). The
planner and reranker adapters plug such a model into ``CallablePlanner`` and
``CallableReranker``; no model ships with the package.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np

__all__ = [
    "Lit",
    "Choice",
    "constrained_generate",
    "byte_tokenizer",
    "make_constrained_planner_fn",
    "make_choice_reranker_fn",
]


@dataclass(frozen=True)
class Lit:
    """Forced literal text (teacher-forced into the context; never sampled)."""

    text: str


@dataclass(frozen=True)
class Choice:
    """Model-selected option: argmax over the options' total sequence log-likelihood.

    ``name`` keys the selection in the returned choices dict."""

    options: tuple
    name: str = ""

    def __init__(self, options: Sequence[str], name: str = "") -> None:
        object.__setattr__(self, "options", tuple(options))
        object.__setattr__(self, "name", name)


TemplateNode = Union[Lit, Choice]


def byte_tokenizer():
    """(encode, decode) for byte-level ids — works with any vocab >= 256 model."""

    def encode(text: str) -> List[int]:
        return list(text.encode("utf-8"))

    def decode(ids: Sequence[int]) -> str:
        return bytes(ids).decode("utf-8", "replace")

    return encode, decode


def _sequence_logprob(
    logprobs_fn: Callable[[Sequence[int]], np.ndarray],
    prefix: List[int],
    continuation: List[int],
) -> float:
    """Teacher-forced log-likelihood of ``continuation`` given ``prefix``."""
    total = 0.0
    ids = list(prefix)
    for tok in continuation:
        lp = np.asarray(logprobs_fn(ids), np.float64)
        lp = lp - _logsumexp(lp)  # tolerate raw logits
        total += float(lp[tok])
        ids.append(tok)
    return total


def _logsumexp(x: np.ndarray) -> float:
    m = float(np.max(x))
    return m + float(np.log(np.sum(np.exp(x - m))))


def constrained_generate(
    logprobs_fn: Callable[[Sequence[int]], np.ndarray],
    template: Sequence[TemplateNode],
    prompt: str = "",
    encode: Optional[Callable[[str], List[int]]] = None,
    length_normalize: bool = True,
) -> tuple:
    """Decode the template against the model; returns (text, {name: chosen option}).

    Literals are forced; each Choice picks the option with the highest (length-
    normalized) sequence log-likelihood given everything decoded so far. Output is
    valid-by-construction while every decision comes from the model's logits.
    """
    if encode is None:
        encode, _ = byte_tokenizer()
    ids: List[int] = encode(prompt)
    out: List[str] = []
    chosen: Dict[str, str] = {}
    for node in template:
        if isinstance(node, Lit):
            out.append(node.text)
            ids.extend(encode(node.text))
            continue
        best, best_score = None, -np.inf
        for opt in node.options:
            opt_ids = encode(opt)
            if not opt_ids:
                continue
            score = _sequence_logprob(logprobs_fn, ids, opt_ids)
            if length_normalize:
                score /= len(opt_ids)
            if score > best_score:
                best, best_score = opt, score
        best = best if best is not None else (node.options[0] if node.options else "")
        out.append(best)
        ids.extend(encode(best))
        if node.name:
            chosen[node.name] = best
    return "".join(out), chosen


# ---------------------------------------------------------------------------
# adapters: planner + reranker rungs over a constrained local LM
# ---------------------------------------------------------------------------

_OPS = ("neighborhood", "path", "related", "keywords")
_INTENTS = ("factual", "procedural", "comparative", "entity_lookup", "relational")


def make_constrained_planner_fn(
    logprobs_fn: Callable[[Sequence[int]], np.ndarray],
    entity_names: Sequence[str],
    encode: Optional[Callable[[str], List[int]]] = None,
) -> Callable[[str], dict]:
    """``fn(query) -> plan dict`` for :class:`CallablePlanner`.

    The model chooses the intent, whether the graph is needed, the graph op, and the
    seed entities (from the known entity registry) — every choice by likelihood, the
    JSON syntax forced. The emitted ``graph_query`` is directly executable by
    ``GraphIndex.execute_query`` (the planner-generated-Cypher analogue)."""
    entity_names = [e for e in entity_names if e]

    def fn(query: str) -> dict:
        prompt = (
            "Plan the retrieval for this query.\n"
            f"Query: {query}\nPlan JSON: "
        )
        template: List[TemplateNode] = [
            Lit('{"intent": "'),
            Choice(_INTENTS, name="intent"),
            Lit('", "requires_graph": '),
            Choice(("true", "false"), name="graph"),
        ]
        if entity_names:
            template += [
                Lit(', "graph_query": {"op": "'),
                Choice(_OPS, name="op"),
                Lit('", "entity": "'),
                Choice(entity_names, name="entity"),
                Lit('"}'),
            ]
        template += [Lit("}")]
        text, chosen = constrained_generate(logprobs_fn, template, prompt, encode)
        data = json.loads(text)  # valid by construction
        plan: dict = {"intent": data["intent"], "requires_graph": data["requires_graph"]}
        if data["requires_graph"] and "graph_query" in data:
            gq = dict(data["graph_query"])
            if gq["op"] == "path" and len(entity_names) >= 2:
                # second endpoint: the model picks among the remaining entities
                _, second = constrained_generate(
                    logprobs_fn,
                    [Choice([e for e in entity_names if e != gq["entity"]], name="to")],
                    prompt + text + ' to: "',
                    encode,
                )
                gq = {"op": "path", "from": gq["entity"], "to": second["to"]}
            if gq["op"] == "keywords":
                gq = {"op": "keywords", "keywords": query.split()[:5]}
            plan["graph_query"] = gq
            plan["graph_entities"] = [
                v for k, v in (("entity", gq.get("entity")), ("from", gq.get("from")),
                               ("to", gq.get("to"))) if v
            ]
        return plan

    return fn


def make_choice_reranker_fn(
    logprobs_fn: Callable[[Sequence[int]], np.ndarray],
    encode: Optional[Callable[[str], List[int]]] = None,
) -> Callable[[str, Sequence[str]], List[float]]:
    """``fn(query, texts) -> [0,1] scores`` for :class:`CallableReranker`: the local
    analogue of the reference's chat yes/no logprob softmax (reranker.py:231-256),
    with the yes/no comparison done directly on the model's sequence likelihoods."""
    if encode is None:
        encode, _ = byte_tokenizer()

    def fn(query: str, texts: Sequence[str]) -> List[float]:
        scores = []
        for doc in texts:
            prompt = (
                f"Query: {query}\nDocument: {doc[:300]}\n"
                "Is this document relevant? Answer: "
            )
            ids = encode(prompt)
            lp_yes = _sequence_logprob(logprobs_fn, ids, encode("yes"))
            lp_no = _sequence_logprob(logprobs_fn, ids, encode("no"))
            m = max(lp_yes, lp_no)
            p_yes = np.exp(lp_yes - m)
            scores.append(float(p_yes / (p_yes + np.exp(lp_no - m))))
        return scores

    return fn
