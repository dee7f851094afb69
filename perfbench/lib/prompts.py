"""The cross-encoder's inputs as the benchmark makes them: the stand-in tokenizer,
the chat rung's prompt around a document, and each parent's document as token ids.

Written out from the rules the program documents (``models/cross_encoder.py``), so
that nothing here imports the program; both sides of a cross-encoder plug-in call
it. The tokenizer lower-cases a text and splits it into words and single
punctuation marks; "yes" and "no" are ids 1 and 2, 0 pads, and every other token
is ``3 + blake2s(token) mod (vocab - 3)``. The prompt is the chat rung's: its system
prompt, ``Query: <text>``, ``Document:``, the document, and the question that asks
for yes or no.

A parent's document (:func:`documents`) is the generator's terms of its children,
child after child (``children_per_parent * terms_per_doc`` of them), spread in order
over a length drawn per parent from the seed in ``[doc_tokens_min,
doc_tokens_max]``, with seeded filler ids in the slots between: the words and word
pieces that the synthetic corpus does not model.
"""

from __future__ import annotations

import hashlib
import re
from typing import List, Sequence, Tuple

import torch

from .hashing import term_str

PAD, YES, NO = 0, 1, 2
FIRST_HASHED = 3
WORD = re.compile(r"\w+|[^\w\s]")
SYSTEM = ("You judge whether a document is relevant to a query. "
          "Answer with exactly one word: yes or no.")
QUERY = "Query: {query}\n\nDocument:\n"
ASK = "\n\nIs this document relevant to the query? Answer yes or no."


def token_id(token: str, vocab: int) -> int:
    if token in ("yes", "no"):
        return YES if token == "yes" else NO
    h = int.from_bytes(hashlib.blake2s(token.encode("utf-8"), digest_size=8).digest(), "little")
    return FIRST_HASHED + h % (vocab - FIRST_HASHED)


def tokenize(text: str, vocab: int) -> List[int]:
    return [token_id(t, vocab) for t in WORD.findall(text.lower())]


def prompt(query: str, document: Sequence[int], vocab: int) -> List[int]:
    """One (query, document) prompt's ids."""
    return (tokenize(SYSTEM + "\n" + QUERY.format(query=query), vocab) + [int(t) for t in document]
            + tokenize(ASK, vocab))


def _seed(seed: int) -> int:
    digest = hashlib.sha256(f"{int(seed)}\x00documents".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def documents(corpus, spec: dict, seed: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ids i32[P, doc_tokens_max], lengths i32[P]) on ``device``: the document of
    every parent row P of the corpus's rows (0 past each length). ``spec`` holds
    ``doc_tokens_min``, ``doc_tokens_max`` and the model's ``vocab_size``."""
    dev = torch.device(device)
    lo, hi, vocab = int(spec["doc_tokens_min"]), int(spec["doc_tokens_max"]), int(spec["vocab_size"])
    per = corpus.children_per_parent
    terms = corpus.term_ids  # i32[n_pad, L] on the host
    n_terms = per * terms.shape[1]
    if lo < n_terms or hi < lo:
        raise ValueError(f"documents of {lo}..{hi} tokens cannot hold {n_terms} terms")
    p = -(-terms.shape[0] // per)
    table = torch.tensor([token_id(term_str(i), vocab) for i in range(len(corpus.vocab))],
                         dtype=torch.int32, device=dev)
    rows = torch.zeros((p * per, terms.shape[1]), dtype=torch.long, device=dev)
    rows[: terms.shape[0]] = torch.from_numpy(terms).to(dev).long()
    words = table[rows.view(p, n_terms)]
    del rows
    gen = torch.Generator(device=dev).manual_seed(_seed(seed))
    lengths = torch.randint(lo, hi + 1, (p,), generator=gen, device=dev)
    ids = torch.randint(FIRST_HASHED, vocab, (p, hi), generator=gen, device=dev, dtype=torch.int32)
    slots = torch.arange(n_terms, device=dev)[None, :] * lengths[:, None] // n_terms
    ids.scatter_(1, slots, words)
    ids.masked_fill_(torch.arange(hi, device=dev)[None, :] >= lengths[:, None], PAD)
    return ids, lengths.to(torch.int32)

