"""The port's grammar-constrained decoding (``models/constrained.py``) against the
JAX package's copy, on the CPU.

Both packages' ``constrained_generate``, ``make_constrained_planner_fn`` and
``make_choice_reranker_fn`` get the same ``logprobs_fn`` and must give the same
texts, choices, plans and scores: equal, since the module is numpy only. The
``logprobs_fn`` is a deterministic numpy bigram-hash model that always runs and,
where ``transformers`` imports, ``tests/test_local_llm.py``'s random GPT-2.
"""

import json

import numpy as np
import pytest
import torch

from triple_hybrid_rag_tpu.models import constrained as ref
from triple_hybrid_rag_tpu_torch.models import constrained as port

ENTITIES = ["Acme Corp", "Beta Labs", "Zenith project", "Maria Silva"]
QUERIES = ["How is Acme Corp connected to the Zenith project?",
           "relationship between Acme Corp and Beta Labs", "who is Maria Silva", "payment terms"]
DOCS = ["Acme Corp supplies the Zenith project with hardware.", "Red foxes live in forests.", ""]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's small tensors, so the suite's parallel
    workers do not oversubscribe the cores; restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def numpy_logprobs(ids):
    """A deterministic next-byte model: logits seeded by the last two ids."""
    tail = list(ids)[-2:]
    seed = 1 + sum((i + 1) * 257 ** k for k, i in enumerate(tail))
    return np.random.default_rng(seed).standard_normal(256) * 3.0


def gpt2_logprobs():
    """The GPT-2 fixture's model; each context's logits computed once (both packages
    ask for the same contexts)."""
    pytest.importorskip("transformers")
    from transformers import GPT2Config, GPT2LMHeadModel

    torch.manual_seed(0)
    model = GPT2LMHeadModel(GPT2Config(vocab_size=256, n_positions=512, n_embd=64, n_layer=2,
                                       n_head=4))
    model.eval()
    seen: dict = {}

    def fn(ids):
        ids = tuple(list(ids)[-511:] or [0])
        if ids not in seen:
            with torch.no_grad():
                seen[ids] = model(torch.tensor([ids])).logits[0, -1].numpy()
        return seen[ids]

    return fn


MODELS = {"numpy": lambda: numpy_logprobs, "gpt2": gpt2_logprobs}


def template(mod):
    return [
        mod.Lit('{"op": "'), mod.Choice(["neighborhood", "path", "related"], name="op"),
        mod.Lit('", "hops": '), mod.Choice(["1", "2", "3"], name="hops"),
        mod.Lit(', "empty": "'), mod.Choice(["", "x"], name="empty"), mod.Lit('"}'),
    ]


def test_names_equal_reference():
    assert set(ref.__all__) <= set(port.__all__)
    assert port._OPS == ref._OPS and port._INTENTS == ref._INTENTS
    enc, dec = port.byte_tokenizer()
    assert enc("fatura é") == ref.byte_tokenizer()[0]("fatura é") and dec(enc("ação")) == "ação"


@pytest.mark.parametrize("kind", list(MODELS))
def test_constrained_generate_matches_reference(kind):
    fn = MODELS[kind]()
    for prompt in ("query: alpha beta\n", ""):
        for norm in (True, False):
            got = port.constrained_generate(fn, template(port), prompt, length_normalize=norm)
            want = ref.constrained_generate(fn, template(ref), prompt, length_normalize=norm)
            assert got == want
            data = json.loads(got[0])  # valid by construction
            assert data["op"] == got[1]["op"] and str(data["hops"]) == got[1]["hops"]


@pytest.mark.parametrize("kind", list(MODELS))
def test_planner_and_reranker_match_reference(kind):
    fn = MODELS[kind]()
    for names in (ENTITIES, []):
        got_fn = port.make_constrained_planner_fn(fn, names)
        want_fn = ref.make_constrained_planner_fn(fn, names)
        for q in QUERIES:
            assert got_fn(q) == want_fn(q)
    got = port.make_choice_reranker_fn(fn)(QUERIES[0], DOCS)
    assert got == ref.make_choice_reranker_fn(fn)(QUERIES[0], DOCS)
    assert all(0.0 <= s <= 1.0 for s in got)


def test_planner_drives_the_port_planner():
    """The plan dict feeds the port's ``CallablePlanner``, as the reference's does."""
    from triple_hybrid_rag_tpu.config import RAGConfig as RefConfig
    from triple_hybrid_rag_tpu.models.planner import CallablePlanner as RefPlanner
    from triple_hybrid_rag_tpu_torch.config import RAGConfig
    from triple_hybrid_rag_tpu_torch.models.planner import CallablePlanner

    got = CallablePlanner(port.make_constrained_planner_fn(numpy_logprobs, ENTITIES), RAGConfig())
    want = RefPlanner(ref.make_constrained_planner_fn(numpy_logprobs, ENTITIES), RefConfig())
    for q in QUERIES:
        a, b = got.plan(q), want.plan(q)
        assert (a.intent, a.requires_graph, a.graph_query, a.keywords) == (
            b.intent, b.requires_graph, b.graph_query, b.keywords)
