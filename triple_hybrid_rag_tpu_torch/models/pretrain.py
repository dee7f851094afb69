"""Encoder pretraining: the recipe that produces the packaged default weights.

A port of the JAX package's ``models/pretrain.py``. The semantic channel's value is
paraphrase geometry: "how long do we have to pay" must land near "invoices settle
within thirty days" with no shared token. The module holds

- the bilingual (EN/PT) concept lexicon :data:`CONCEPTS` (verbatim; the encoder's
  identity anchors take their synonym keys from it) and the sentence templates;
- the pair generators (paraphrase, random-token overlap, real-text inverse cloze,
  BM25-confusable hard negatives, their mixture) and the held-out paraphrase set,
  numpy copies of the reference's: the same seed gives the same pairs, string for
  string;
- the real-text harvest (:data:`TRAIN_TEXT_SOURCES`, disjoint from every eval
  corpus);
- the configurations (:func:`default_encoder_config`, :func:`scaled_encoder_config`),
  the npz format (:func:`save_packaged_encoder`, :func:`load_default_encoder`) and
  the training run (:func:`train_default_encoder`, ``thr-torch train-encoder``).

The packaged weights are the reference's own ``models/data/encoder.npz``
(:data:`DEFAULT_PARAMS`), read with numpy from its place in the checkout; the port
ships no copy and never writes there. A training run writes
:data:`TRAINED_PARAMS` (``build/models/encoder.npz`` in the checkout) unless told
otherwise; ``RAGConfig.encoder_params_path`` serves it.
"""

from __future__ import annotations

import dataclasses
import json
import time
import zipfile
import zlib
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import RAGConfig, get_settings
from ..device import resolve_device

# ---------------------------------------------------------------------------
# concept lexicon: group -> surface forms. Form 0 is the canonical (document) form;
# later forms are synonyms/translations used by queries. EN + PT, spanning the eval
# corpus topics (payments/contracts/security/logistics/wildlife/compute) plus common
# business vocabulary.
# ---------------------------------------------------------------------------

CONCEPTS: Dict[str, List[str]] = {
    # payments / finance
    "invoice": ["invoice", "bill", "fatura", "cobranca"],
    "payment": ["payment", "remittance", "pagamento", "quitacao"],
    "deadline": ["deadline", "due date", "prazo", "data limite"],
    "penalty": ["penalty", "late fee", "multa", "acrescimo"],
    "refund": ["refund", "reimbursement", "reembolso", "estorno"],
    "discount": ["discount", "price reduction", "desconto", "abatimento"],
    "budget": ["budget", "spending plan", "orcamento", "verba"],
    "revenue": ["revenue", "income", "receita", "faturamento"],
    "expense": ["expense", "cost", "despesa", "custo"],
    "tax": ["tax", "levy", "imposto", "tributo"],
    "installment": ["installment", "partial payment", "parcela", "prestacao"],
    "receipt": ["receipt", "proof of payment", "recibo", "comprovante"],
    "account": ["account", "ledger", "conta", "cadastro"],
    "balance": ["balance", "outstanding amount", "saldo", "montante devido"],
    "interest": ["interest", "accrued charge", "juros", "rendimento"],
    "payroll": ["payroll", "salary processing", "folha de pagamento", "salarios"],
    "quarterly": ["quarterly", "every three months", "trimestral", "a cada trimestre"],
    "billing": ["billing", "invoicing", "cobranca mensal", "emissao de fatura"],
    # contracts / legal
    "contract": ["contract", "agreement", "contrato", "acordo"],
    "clause": ["clause", "provision", "clausula", "disposicao"],
    "termination": ["termination", "cancellation", "rescisao", "cancelamento"],
    "renewal": ["renewal", "extension", "renovacao", "prorrogacao"],
    "notice": ["notice", "advance warning", "aviso previo", "notificacao"],
    "breach": ["breach", "violation", "descumprimento", "infracao"],
    "liability": ["liability", "legal responsibility", "responsabilidade", "onus"],
    "warranty": ["warranty", "guarantee", "garantia", "cobertura"],
    "signature": ["signature", "signing", "assinatura", "firma"],
    "amendment": ["amendment", "modification", "aditivo", "alteracao contratual"],
    "party": ["party", "contracting side", "parte contratante", "signatario"],
    "arbitration": ["arbitration", "dispute resolution", "arbitragem", "mediacao"],
    "confidentiality": ["confidentiality", "secrecy", "confidencialidade", "sigilo"],
    "compliance": ["compliance", "regulatory conformity", "conformidade", "adequacao"],
    "jurisdiction": ["jurisdiction", "governing law", "jurisdicao", "foro"],
    # security / IT
    "password": ["password", "credential", "senha", "chave de acesso"],
    "rotation": ["rotation", "periodic change", "rotacao", "troca periodica"],
    "authentication": ["authentication", "identity verification", "autenticacao", "validacao de identidade"],
    "portal": ["portal", "self service site", "portal de autoatendimento", "plataforma"],
    "access": ["access", "entry permission", "acesso", "permissao"],
    "encryption": ["encryption", "cipher protection", "criptografia", "cifragem"],
    "backup": ["backup", "data copy", "copia de seguranca", "salvaguarda"],
    "firewall": ["firewall", "network barrier", "barreira de rede", "filtro de trafego"],
    "audit": ["audit", "inspection", "auditoria", "verificacao"],
    "breach_sec": ["security incident", "intrusion", "incidente de seguranca", "invasao"],
    "permission": ["permission", "authorization", "autorizacao", "privilegio"],
    "twofactor": ["two factor", "second factor", "dois fatores", "segunda etapa"],
    "remote": ["remote", "offsite", "remoto", "a distancia"],
    "vpn": ["vpn", "secure tunnel", "tunel seguro", "rede privada"],
    "malware": ["malware", "malicious software", "software malicioso", "virus"],
    # logistics
    "freight": ["freight", "cargo", "frete", "carga"],
    "shipment": ["shipment", "consignment", "remessa", "envio"],
    "customs": ["customs", "border clearance", "alfandega", "despacho aduaneiro"],
    "warehouse": ["warehouse", "storage facility", "armazem", "deposito"],
    "delivery": ["delivery", "drop off", "entrega", "distribuicao"],
    "tracking": ["tracking", "shipment status", "rastreamento", "acompanhamento"],
    "carrier": ["carrier", "transport company", "transportadora", "operador logistico"],
    "inventory": ["inventory", "stock", "estoque", "inventario"],
    "pallet": ["pallet", "loading platform", "palete", "estrado"],
    "route": ["route", "itinerary", "rota", "trajeto"],
    "container": ["container", "shipping box", "conteiner", "caixa de transporte"],
    "window": ["window", "time slot", "janela de horario", "intervalo agendado"],
    "manifest": ["manifest", "cargo list", "manifesto", "lista de carga"],
    # wildlife / nature
    "fox": ["fox", "vulpine animal", "raposa", "animal vulpino"],
    "bear": ["bear", "ursine animal", "urso", "animal ursino"],
    "forest": ["forest", "woods", "floresta", "mata"],
    "habitat": ["habitat", "natural home", "habitat natural", "territorio"],
    "hibernation": ["hibernation", "winter sleep", "hibernacao", "sono de inverno"],
    "migration": ["migration", "seasonal movement", "migracao", "deslocamento sazonal"],
    "predator": ["predator", "hunting animal", "predador", "cacador natural"],
    "river": ["river", "waterway", "rio", "curso de agua"],
    "nest": ["nest", "breeding site", "ninho", "local de reproducao"],
    "species": ["species", "animal kind", "especie", "tipo de animal"],
    # compute / tech
    "quantum": ["quantum", "qubit based", "quantico", "de qubits"],
    "processor": ["processor", "chip", "processador", "unidade de processamento"],
    "coherence": ["coherence", "quantum stability", "coerencia", "estabilidade quantica"],
    "cryogenic": ["cryogenic", "ultra cold", "criogenico", "ultrafrio"],
    "error_corr": ["error correction", "fault mitigation", "correcao de erros", "mitigacao de falhas"],
    "hardware": ["hardware", "physical equipment", "equipamento fisico", "maquinario"],
    "software": ["software", "program code", "programa", "aplicativo"],
    "network": ["network", "interconnect", "rede", "interconexao"],
    "latency": ["latency", "response delay", "latencia", "tempo de resposta"],
    "throughput": ["throughput", "processing rate", "vazao", "taxa de processamento"],
    "storage": ["storage", "data retention", "armazenamento", "retencao de dados"],
    "cluster": ["cluster", "machine group", "agrupamento de maquinas", "conjunto de servidores"],
    "cache": ["cache", "fast buffer", "memoria intermediaria", "buffer rapido"],
    "compile": ["compile", "build step", "compilacao", "etapa de construcao"],
    # office / hr / general business
    "meeting": ["meeting", "gathering", "reuniao", "encontro"],
    "schedule": ["schedule", "calendar plan", "cronograma", "agenda"],
    "report": ["report", "written summary", "relatorio", "resumo escrito"],
    "approval": ["approval", "sign off", "aprovacao", "autorizacao formal"],
    "employee": ["employee", "staff member", "funcionario", "colaborador"],
    "manager": ["manager", "supervisor", "gerente", "gestor"],
    "customer": ["customer", "client", "cliente", "consumidor"],
    "vendor": ["vendor", "supplier", "fornecedor", "prestador"],
    "training": ["training", "instruction course", "treinamento", "capacitacao"],
    "vacation": ["vacation", "paid leave", "ferias", "licenca remunerada"],
    "onboarding": ["onboarding", "new hire setup", "integracao de novatos", "admissao"],
    "policy": ["policy", "internal rule", "politica interna", "norma"],
    "department": ["department", "division", "departamento", "setor"],
    "headquarters": ["headquarters", "main office", "sede", "escritorio central"],
    "complaint": ["complaint", "grievance", "reclamacao", "queixa"],
    "feedback": ["feedback", "evaluation comments", "retorno avaliativo", "comentarios"],
    "promotion": ["promotion", "career advancement", "promocao", "ascensao"],
    "resignation": ["resignation", "voluntary exit", "demissao voluntaria", "desligamento"],
    "overtime": ["overtime", "extra hours", "horas extras", "sobrejornada"],
    "insurance": ["insurance", "coverage plan", "seguro", "apolice"],
    "maintenance": ["maintenance", "upkeep", "manutencao", "conservacao"],
    "equipment": ["equipment", "gear", "equipamento", "aparelhagem"],
    "safety": ["safety", "accident prevention", "seguranca do trabalho", "prevencao de acidentes"],
    "emergency": ["emergency", "urgent incident", "emergencia", "urgencia"],
    "deadline_proj": ["milestone", "project checkpoint", "marco do projeto", "etapa"],
}

# Statement templates (documents; {0},{1},{2} = concept slots). Their glue vocabulary
# is DISJOINT from the query templates' so held-out paraphrase pairs share no tokens.
DOC_TEMPLATES = [
    "The {0} establishes the {1} together with the {2}.",
    "Our standard {0} covers the {1} and also the {2}.",
    "Each {0} must record the {1} before the {2} starts.",
    "This document describes the {0}, the {1}, and the {2}.",
    "A new {0} was registered linking the {1} to the {2}.",
    "The updated {0} now lists every {1} under the {2} section.",
    "Internal rules state the {0} determines the {1} for any {2}.",
    "During review the {0} confirmed the {1} alongside the {2}.",
]

QUERY_TEMPLATES = [
    "what is the {0} regarding the {1} and the {2}?",
    "how does the {0} relate to the {1} given the {2}?",
    "tell me about the {0} concerning the {1} plus the {2}",
    "where can i find the {0} tied to the {1} within the {2}?",
    "explain the {0} versus the {1} in terms of the {2}",
    "qual o {0} em relacao ao {1} e ao {2}?",
    "como funciona o {0} junto com o {1} no contexto do {2}?",
    "quero saber sobre o {0} vinculado ao {1} e ao {2}",
]

_GROUPS = sorted(CONCEPTS)


def render(groups: Sequence[str], form_idx: Sequence[int], template: str) -> str:
    forms = [CONCEPTS[g][f % len(CONCEPTS[g])] for g, f in zip(groups, form_idx)]
    return template.format(*forms)


def make_pairs(n: int, rng: np.random.Generator) -> List[Tuple[str, str]]:
    """(query, positive) paraphrase pairs: same concepts, different forms+templates."""
    pairs = []
    for _ in range(n):
        k = 3
        groups = [str(g) for g in rng.choice(_GROUPS, size=k, replace=False)]
        fa = rng.integers(0, 4, size=k)
        fb = (fa + 1 + rng.integers(0, 3, size=k)) % 4  # always a different form
        q = render(groups, fb, QUERY_TEMPLATES[int(rng.integers(len(QUERY_TEMPLATES)))])
        d = render(groups, fa, DOC_TEMPLATES[int(rng.integers(len(DOC_TEMPLATES)))])
        pairs.append((q, d))
    return pairs


def make_overlap_pairs(n: int, rng: np.random.Generator) -> List[Tuple[str, str]]:
    """(query, positive) pairs of RANDOM token strings with partial overlap.

    The lexicon covers a few hundred tokens; every other token in a real corpus hits
    an untrained hash bucket, and a model trained only on the lexicon embeds such text
    as noise. These pairs teach the identity prior for ARBITRARY buckets: the positive
    shares 40-80% of the doc's tokens (any random ids), so the pooled head must learn
    bag-of-buckets behavior — match-on-shared-tokens — for the whole vocab space.
    Mixed with the paraphrase pairs this gives BowHash-like robustness on unseen
    vocabulary plus learned synonym geometry on the lexicon.
    """
    # a COMMON pool per call: in-batch negatives share vocabulary with the query, so
    # the model must rank by OVERLAP DEGREE (hard negatives), not mere co-occurrence
    pool = [f"w{int(rng.integers(0, 500_000))}" for _ in range(max(24, 3 * n))]
    pairs = []
    for _ in range(n):
        n_doc = int(rng.integers(8, 20))
        words = [pool[int(rng.integers(len(pool)))] for _ in range(n_doc)]
        keep = max(2, int(len(words) * rng.uniform(0.5, 0.9)))
        q_words = [words[i] for i in rng.permutation(len(words))[:keep]]
        # query-only noise drawn from the same pool (appears in other docs too)
        q_words += [pool[int(rng.integers(len(pool)))] for _ in range(int(rng.integers(0, 3)))]
        pairs.append((" ".join(q_words), " ".join(words)))
    return pairs



_ROOT = Path(__file__).resolve().parents[2]
# the JAX package, whose files the port reads and never writes
_REFERENCE_DIR = _ROOT / "triple_hybrid_rag_tpu"
# the directory of the reference's packaged weights, in the checkout beside this
# package (read by path, never written)
DATA_DIR = _REFERENCE_DIR / "models" / "data"
DEFAULT_PARAMS = DATA_DIR / "encoder.npz"
# where a training run writes by default (``build/`` is not committed)
TRAINED_PARAMS = _ROOT / "build" / "models" / "encoder.npz"

_ENCODER_CACHE: dict = {}


def load_default_encoder(rag_cfg: Optional[RAGConfig] = None, path=None, device=None):
    """:class:`~.encoder.EncoderEmbedder` from the packaged weights on ``device``
    (CUDA unless ``device="cpu"``), or None when the file is absent or its arrays
    or ``__meta__`` cannot be parsed. Any other failure (torch, CUDA) raises.

    ``rag_cfg.encoder_params_path`` overrides :data:`DEFAULT_PARAMS`, and
    ``rag_cfg.encoder_anchor_pool_w2`` replaces the trained pooled-anchor weight
    (the MaxSim token weight stays the trained one). Instances are cached per
    path, the settings the embedder depends on, and device."""
    from .encoder import EncoderConfig, EncoderEmbedder, encoder_params_from_flax

    rag_cfg = rag_cfg or get_settings()
    if path is None:
        cfg_path = getattr(rag_cfg, "encoder_params_path", None)
        path = Path(cfg_path) if cfg_path else DEFAULT_PARAMS
    else:
        path = Path(path)
    if not path.exists():
        return None
    dev = resolve_device(device)
    pool_w2 = getattr(rag_cfg, "encoder_anchor_pool_w2", None)
    # the embedder tokenizes with an Analyzer built from rag_cfg: configs that
    # tokenize differently must not share an instance
    cache_key = (
        str(path), rag_cfg.maxsim_dim, pool_w2,
        rag_cfg.analyzer_stemming, rag_cfg.analyzer_strip_accents,
        rag_cfg.analyzer_min_token_len, rag_cfg.analyzer_languages, str(dev),
    )
    if cache_key in _ENCODER_CACHE:
        return _ENCODER_CACHE[cache_key]
    try:
        with np.load(path) as npz:
            meta = json.loads(bytes(npz["__meta__"]).decode())
            enc_cfg = EncoderConfig(**meta["encoder_config"])
            flat = {name: npz[name] for name in npz.files if name != "__meta__"}
    except (OSError, EOFError, ValueError, KeyError, TypeError, zipfile.BadZipFile, zlib.error):
        return None
    if pool_w2 is not None:
        enc_cfg = dataclasses.replace(enc_cfg, anchor_pool_w2=pool_w2)
    emb = EncoderEmbedder(
        enc_cfg=enc_cfg, rag_cfg=rag_cfg, params=encoder_params_from_flax(flat), device=dev
    )
    _ENCODER_CACHE[cache_key] = emb
    return emb


#: Installed packages whose docstrings form the real-text training corpus. Chosen
#: disjoint from every quality-evaluation source (``eval._PACKAGE_SOURCES`` plus
#: "stdlib"), so the independent evals stay independent: the encoder never sees an
#: eval-corpus sentence in training, only same-register prose by other authors.
#: (Not included: the stdlib, an eval source; PIL, whose import prints.)
TRAIN_TEXT_SOURCES = (
    "sklearn", "matplotlib", "sympy", "networkx", "requests", "urllib3",
    "flax", "optax", "setuptools", "jinja2", "yaml",
    "pygments", "click", "attrs", "dateutil", "psutil", "rich", "tornado",
    "IPython", "lxml", "bs4", "cryptography", "absl", "toolz", "fsspec",
    "tqdm", "jsonschema", "cloudpickle",
)

#: The deep-harvest training pool: the import list above plus large packages
#: harvested by parsing their source files (``eval._ast_documents``, full depth).
#: Still disjoint from every eval source, and ``make_bigcorpus_eval`` excludes
#: everything here by directory and by content.
TRAIN_TEXT_SOURCES_DEEP = TRAIN_TEXT_SOURCES + (
    "google", "tensorflow", "tf_keras", "keras", "nltk", "OpenGL", "PIL",
    "pygame", "mujoco", "mpmath", "huggingface_hub", "libcst", "tensorboard",
    "more_itertools", "babel", "prompt_toolkit", "pyparsing", "hypothesis",
    "werkzeug", "oauthlib",
)

_REALTEXT_CACHE: Dict[tuple, List[str]] = {}


def realtext_documents(
    max_docs: int = 6000, sources: Sequence[str] = TRAIN_TEXT_SOURCES
) -> List[str]:
    """Harvested real-prose training documents (cached per argument set). The
    packages are imported in a child process (``eval._stdlib_documents``)."""
    key = (max_docs, tuple(sources))
    if key not in _REALTEXT_CACHE:
        from ..eval import _stdlib_documents

        _REALTEXT_CACHE[key] = [
            t for _, t in _stdlib_documents(max_docs=max_docs, sources=sources)
        ]
    return _REALTEXT_CACHE[key]


def realtext_documents_deep(
    max_docs: int = 40000,
    sources: Sequence[str] = TRAIN_TEXT_SOURCES_DEEP,
    min_len: int = 300,
) -> List[str]:
    """The deep training pool: full-depth AST harvest over the training packages'
    source trees (no imports, no side effects). Cached per argument set."""
    key = ("deep", max_docs, tuple(sources), min_len)
    if key not in _REALTEXT_CACHE:
        from ..eval import _ast_documents

        self_docs = _ast_documents(
            min_len=min_len, max_docs=max_docs, include_top=sources
        )
        _REALTEXT_CACHE[key] = [t for _, t in self_docs]
    return _REALTEXT_CACHE[key]


def _cloze_from_text(
    text: str, rng: np.random.Generator, window: int
) -> Optional[Tuple[str, str]]:
    """One inverse-cloze (query, positive) pair from a document, or None when the
    text has too few usable sentences. The query is one sentence REMOVED from the
    text; the positive is a random ``window``-word span of the remainder."""
    sents = [s.strip() for s in text.replace("\n", " ").split(". ") if len(s.split()) >= 6]
    if len(sents) < 2:
        return None
    qi = int(rng.integers(len(sents)))
    q = sents[qi]
    rest_words = " ".join(sents[:qi] + sents[qi + 1 :]).split()
    if len(rest_words) > window:
        start = int(rng.integers(0, len(rest_words) - window + 1))
        rest_words = rest_words[start : start + window]
    return q, " ".join(rest_words)


def make_realtext_pairs(
    n: int,
    rng: np.random.Generator,
    docs: Optional[Sequence[str]] = None,
    window: int = 48,
) -> List[Tuple[str, str]]:
    """(query, positive) inverse-cloze pairs over REAL prose.

    They teach the contextual part real-text co-occurrence: the query is one
    sentence REMOVED from a harvested docstring, the positive is a random
    ``window``-word span of the remainder — the inverse-cloze task the independent
    evals pose, but over :data:`TRAIN_TEXT_SOURCES`, which share no document with
    any eval corpus.
    """
    texts = list(docs) if docs is not None else realtext_documents()
    pairs: List[Tuple[str, str]] = []
    attempts = 0
    while len(pairs) < n and attempts < 50 * n:
        attempts += 1
        pair = _cloze_from_text(texts[int(rng.integers(len(texts)))], rng, window)
        if pair is not None:
            pairs.append(pair)
    return pairs


def bm25_neighbor_map(
    docs: Sequence[str], k1: float = 1.2, b: float = 0.75
) -> np.ndarray:
    """int32[n_docs] index of each document's most BM25-confusable OTHER document.

    Host-side sparse BM25 (scipy CSR, chunked doc-vs-doc scoring) over the
    training pool (BM25-error hard-negative mining). A document's nearest BM25 neighbor is exactly the distractor
    the lexical channel confuses it with; training the dense channel to separate
    such pairs is what lets fusion beat lexical-only on real text."""
    import scipy.sparse as sp

    from ..analyzer import Analyzer

    an = Analyzer(get_settings())
    vocab: Dict[str, int] = {}
    rows, cols, vals = [], [], []
    doc_lens = np.zeros(len(docs), np.float32)
    for i, text in enumerate(docs):
        counts: Dict[int, int] = {}
        toks = an.tokenize(text)
        doc_lens[i] = len(toks)
        for t in toks:
            j = vocab.setdefault(t, len(vocab))
            counts[j] = counts.get(j, 0) + 1
        rows.extend([i] * len(counts))
        cols.extend(counts.keys())
        vals.extend(counts.values())
    n, v = len(docs), max(len(vocab), 1)
    tf = sp.csr_matrix((vals, (rows, cols)), shape=(n, v), dtype=np.float32)
    df = np.asarray((tf > 0).sum(axis=0)).ravel().astype(np.float32)
    idf = np.log(1.0 + (n - df + 0.5) / (df + 0.5))
    avg_len = max(float(doc_lens.mean()), 1.0)
    # BM25 doc-side weight per (doc, term); query side uses raw tf * idf
    norm = k1 * (1.0 - b + b * doc_lens / avg_len)  # [n]
    w = tf.copy()
    coo = w.tocoo()
    w_vals = (coo.data * (k1 + 1.0)) / (coo.data + norm[coo.row])
    w = sp.csr_matrix((w_vals * idf[coo.col], (coo.row, coo.col)), shape=(n, v))
    q = tf.multiply(sp.csr_matrix(idf[None, :]))  # query-side: tf * idf
    out = np.zeros(n, np.int32)
    chunk = 512
    for s in range(0, n, chunk):
        scores = np.asarray((q[s : s + chunk] @ w.T).todense())
        for r in range(scores.shape[0]):
            scores[r, s + r] = -np.inf  # a doc is not its own neighbor
        out[s : s + chunk] = np.argmax(scores, axis=1)
    return out


def make_hardneg_pairs(
    n: int,
    rng: np.random.Generator,
    docs: Sequence[str],
    neighbors: np.ndarray,
    window: int = 48,
) -> List[Tuple[str, str]]:
    """Inverse-cloze pairs emitted in BM25-CONFUSABLE groups.

    For a sampled doc X, emit a cloze pair from X AND one from its most
    BM25-confusable neighbor Y — inside one InfoNCE batch each positive is the
    other's in-batch negative, so the model must separate exactly the pairs the
    lexical channel cannot. No loss-function change needed: hard negatives ride
    the standard in-batch-negatives contract of ``training.make_train_step``."""
    pairs: List[Tuple[str, str]] = []
    attempts = 0
    while len(pairs) < n and attempts < 50 * n:
        attempts += 1
        i = int(rng.integers(len(docs)))
        j = int(neighbors[i])
        a = _cloze_from_text(docs[i], rng, window)
        bpair = _cloze_from_text(docs[j], rng, window)
        if a is None or bpair is None:
            continue
        pairs.append(a)
        if len(pairs) < n:
            pairs.append(bpair)
    return pairs


def make_mixed_pairs(
    n: int,
    rng: np.random.Generator,
    overlap_frac: float = 0.5,
    realtext_frac: float = 0.0,
    realtext_docs: Optional[Sequence[str]] = None,
    hardneg_frac: float = 0.0,
    neighbors: Optional[np.ndarray] = None,
    realtext_window: int = 48,
):
    """Training mixture: paraphrase (synonym geometry) + overlap (identity prior)
    + real-text inverse cloze (real-prose co-occurrence; see make_realtext_pairs)
    + BM25-confusable hard-negative groups (see make_hardneg_pairs; requires
    ``neighbors`` from :func:`bm25_neighbor_map`). The shuffle keeps confusable
    pairs in the SAME batch — in-batch co-presence is what makes them negatives."""
    n_hard = int(n * hardneg_frac) if neighbors is not None else 0
    n_real = int(n * realtext_frac)
    n_overlap = int(n * overlap_frac)
    pairs = make_pairs(n - n_overlap - n_real - n_hard, rng) + make_overlap_pairs(
        n_overlap, rng
    )
    if n_real:
        pairs += make_realtext_pairs(
            n_real, rng, docs=realtext_docs, window=realtext_window
        )
    if n_hard:
        pairs += make_hardneg_pairs(
            n_hard, rng, list(realtext_docs or realtext_documents()),
            neighbors, window=realtext_window,
        )
    order = rng.permutation(len(pairs))
    return [pairs[i] for i in order]


# ---------------------------------------------------------------------------
# held-out paraphrase evaluation set
# ---------------------------------------------------------------------------


def make_paraphrase_holdout(
    n_docs: int = 64, seed: int = 2024
) -> Tuple[List[str], List[str], List[int]]:
    """(docs, queries, relevant_doc_idx): doc i uses CANONICAL forms + a statement
    template; query j asks about the same concept combination with ALTERNATE forms +
    a question template — zero content-token overlap with its relevant doc by
    construction (glue vocabularies are disjoint; asserted in tests)."""
    from ..analyzer import Analyzer

    an = Analyzer(get_settings())
    rng = np.random.default_rng(seed)
    docs, queries, rel = [], [], []
    seen = set()
    i = 0
    while len(docs) < n_docs:
        groups = tuple(str(g) for g in rng.choice(_GROUPS, size=3, replace=False))
        if groups in seen:
            continue
        doc = render(groups, [0, 0, 0], DOC_TEMPLATES[i % len(DOC_TEMPLATES)])
        alt = [int(1 + rng.integers(0, 3)) for _ in groups]
        query = render(groups, alt, QUERY_TEMPLATES[i % len(QUERY_TEMPLATES)])
        i += 1
        # enforce TRUE zero token overlap: multi-word surface forms can contain another
        # group's tokens (e.g. "proof of payment" vs the payment group) — skip those
        if set(an.tokenize(doc)) & set(an.tokenize(query)):
            continue
        seen.add(groups)
        docs.append(doc)
        queries.append(query)
        rel.append(len(docs) - 1)
    return docs, queries, rel


def paraphrase_recall_at_k(embedder, k: int = 10, n_docs: int = 64, seed: int = 2024) -> float:
    """Dense-only recall@k of an Embedder on the held-out paraphrase set."""
    docs, queries, rel = make_paraphrase_holdout(n_docs=n_docs, seed=seed)
    d = np.asarray(embedder.embed_texts(docs), np.float32)
    q = np.asarray(embedder.embed_texts(queries), np.float32)
    d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-9)
    q /= np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-9)
    scores = q @ d.T
    order = np.argsort(-scores, axis=1)[:, :k]
    hits = sum(1 for i, r in enumerate(rel) if r in order[i].tolist())
    return hits / len(rel)


# ---------------------------------------------------------------------------
# training recipe + packaging
# ---------------------------------------------------------------------------


def default_encoder_config():
    """The small tier: ~5M params (~10 MB f16 npz), what ``thr-torch
    train-encoder`` trains."""
    from .encoder import EncoderConfig

    return EncoderConfig(
        vocab_buckets=16384, d_model=192, n_layers=4, n_heads=6, d_mlp=768,
        max_tokens=64, out_dim=1024, token_dim=128, dtype="bfloat16",
    )


def scaled_encoder_config():
    """The shipped architecture: ~43M params (d_model 512, 8 layers), what the
    packaged ``encoder.npz`` holds. max_tokens 96 covers a full child chunk's
    analyzer tokens."""
    from .encoder import EncoderConfig

    return EncoderConfig(
        vocab_buckets=32768, d_model=512, n_layers=8, n_heads=8, d_mlp=2048,
        max_tokens=96, out_dim=1024, token_dim=128, dtype="bfloat16",
    )


def refuse_reference_path(path) -> Path:
    """``path`` as a Path, or ValueError when it lies inside the JAX package: the
    port reads the reference's files and writes none of them."""
    path = Path(path)
    if _REFERENCE_DIR in path.resolve().parents:
        raise ValueError(f"{path} is inside the JAX package; write elsewhere")
    return path


def save_packaged_encoder(params, enc_cfg, path=TRAINED_PARAMS, metrics: Optional[dict] = None) -> Path:
    """npz in the reference's format: f16 weights under flax's names
    (``params/block_0/attn/query/kernel``, ...) + the EncoderConfig and the
    training metrics as the ``__meta__`` JSON. ``params`` is an :class:`Encoder`
    or its state dict; the reference's ``load_encoder_params`` and
    ``load_default_encoder`` read the file."""
    from .encoder import encoder_params_to_flax

    path = refuse_reference_path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    state = params.state_dict() if hasattr(params, "state_dict") else params
    flat = {
        name: a.astype(np.float16)
        for name, a in encoder_params_to_flax(state, enc_cfg.n_heads).items()
    }
    meta = {
        "encoder_config": dataclasses.asdict(enc_cfg),
        "metrics": metrics or {},
        "format": 1,
    }
    np.savez_compressed(path, __meta__=np.frombuffer(json.dumps(meta).encode(), np.uint8), **flat)
    return path


def load_encoder_weights_(model, path) -> None:
    """Restore a packaged npz's arrays into ``model`` (an :class:`Encoder`) in the
    model's own dtype: every parameter must be present with its shape, as the
    reference's ``load_encoder_params`` checks. The f16 arrays widen exactly."""
    from .encoder import encoder_params_from_flax

    with np.load(path) as npz:
        flat = {name: npz[name] for name in npz.files if name != "__meta__"}
    loaded = encoder_params_from_flax(flat)
    for name, p in model.named_parameters():
        if name not in loaded:
            raise KeyError(f"checkpoint missing parameter {name}")
        t = loaded[name]
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"shape mismatch for {name}: {tuple(t.shape)} vs {tuple(p.shape)}")
        p.data = t.to(device=p.device, dtype=p.dtype)


def train_default_encoder(
    out_path=TRAINED_PARAMS,
    steps: int = 2000,
    batch_size: int = 128,
    seed: int = 0,
    enc_cfg=None,
    log_every: int = 100,
    lr: float = 1e-3,
    overlap_frac: float = 0.3,
    realtext_frac: float = 0.35,
    init_params_path=None,
    hardneg_frac: float = 0.0,
    q_tokens: int = 32,
    d_tokens: int = 32,
    realtext_max_docs: int = 6000,
    realtext_window: int = 48,
    realtext_deep: bool = False,
    device=None,
    stats: Optional[dict] = None,
):
    """Train the packaged encoder on generated pairs and save it to ``out_path``
    on ``device`` (CUDA unless ``device="cpu"``). Returns (path, metrics).

    Deterministic in its pairs given ``seed`` (+ the installed versions of
    :data:`TRAIN_TEXT_SOURCES` when ``realtext_frac`` > 0). Loss = symmetric
    InfoNCE over pooled embeddings at Matryoshka prefixes (out_dim, /2, /4) + a
    MaxSim token-level InfoNCE term weighted 0.25. Training computes in f32; the
    saved config keeps ``enc_cfg``'s dtype.

    ``init_params_path`` warm-starts from a packaged checkpoint of the same
    EncoderConfig (dtype aside), the fine-tuning path. Its f16 arrays become f32
    parameters, trained as a cold start's are. (The reference's restore leaves them
    f16, and off the TPU its optimizer then squares f16 gradients, which underflow
    to zero second moments and steps of up to lr / 1e-8 times the first moment:
    ROADMAP.md, Queue 3.) ``hardneg_frac`` > 0 adds BM25-confusable in-batch hard-negative
    groups. ``q_tokens``/``d_tokens`` set the per-side training sequence widths.
    The file is also saved every 500 steps.

    ``stats``, when a dict, receives per step its start on the host's clock in
    seconds under ``t``, the host's seconds building the batch (pairs, hashing,
    anchors, the copy) under ``host_s``, the device's span of the step in ms from
    CUDA events under ``device_ms`` (none on the CPU), and the loss and accuracy
    under ``loss`` and ``accuracy``."""
    import torch

    from .encoder import TextHasher, anchor_arrays
    from .training import TrainConfig, create_train_state, make_train_step

    out_path = refuse_reference_path(out_path)
    dev = resolve_device(device)
    enc_cfg = enc_cfg or default_encoder_config()
    # f32 compute for training (the packaged config keeps bf16 for inference;
    # dtype only affects activations)
    train_enc_cfg = dataclasses.replace(enc_cfg, dtype="float32")
    tc = TrainConfig(
        learning_rate=lr,
        warmup_steps=max(20, steps // 20),
        decay_steps=max(steps, 100),
        matryoshka_dims=(enc_cfg.out_dim, enc_cfg.out_dim // 2, enc_cfg.out_dim // 4),
        maxsim_weight=0.25,
    )
    model, state = create_train_state(train_enc_cfg, tc, device=dev)
    if init_params_path is not None:
        with np.load(init_params_path) as npz:
            meta = json.loads(bytes(npz["__meta__"]).decode())
        saved = {k: v for k, v in meta["encoder_config"].items() if k != "dtype"}
        want = {k: v for k, v in dataclasses.asdict(enc_cfg).items() if k != "dtype"}
        if saved != want:
            raise ValueError(f"init_params_path EncoderConfig mismatch: {saved} != {want}")
        load_encoder_weights_(model, init_params_path)
    step_fn = make_train_step(model, tc)
    hasher = TextHasher(train_enc_cfg, get_settings())
    rng = np.random.default_rng(seed)

    real_docs = None
    if realtext_frac > 0 or hardneg_frac > 0:
        real_docs = (
            realtext_documents_deep(max_docs=realtext_max_docs)
            if realtext_deep
            else realtext_documents(max_docs=realtext_max_docs)
        )
    neighbors = None
    if hardneg_frac > 0 and real_docs:
        neighbors = bm25_neighbor_map(real_docs)
    q_tokens = min(q_tokens, enc_cfg.max_tokens)
    d_tokens = min(d_tokens, enc_cfg.max_tokens)
    timed = stats is not None and dev.type == "cuda"
    events = []
    if stats is not None:
        stats.update(t=[], host_s=[], device_ms=[], loss=[], accuracy=[])

    def to_dev(a, dtype=None):
        return torch.from_numpy(a if dtype is None else a.astype(dtype)).to(dev)

    metrics = {}
    for s in range(steps):
        t0 = time.perf_counter()
        pairs = make_mixed_pairs(
            batch_size, rng, overlap_frac=overlap_frac,
            realtext_frac=realtext_frac, realtext_docs=real_docs,
            hardneg_frac=hardneg_frac, neighbors=neighbors,
            realtext_window=realtext_window,
        )
        q_texts = [q for q, _ in pairs]
        d_texts = [d for _, d in pairs]
        q_ids, q_mask = hasher.encode(q_texts, max_tokens=q_tokens)
        d_ids, d_mask = hasher.encode(d_texts, max_tokens=d_tokens)
        q_ap, q_at = anchor_arrays(q_texts, train_enc_cfg, hasher.analyzer, max_tokens=q_tokens)
        d_ap, d_at = anchor_arrays(d_texts, train_enc_cfg, hasher.analyzer, max_tokens=d_tokens)
        # f16 wire format for the anchors, as the reference sends them (the blend
        # upcasts on the device; unit vectors with ~1e-3 components)
        batch = (
            to_dev(q_ids), to_dev(q_mask), to_dev(q_ap, np.float16), to_dev(q_at, np.float16),
            to_dev(d_ids), to_dev(d_mask), to_dev(d_ap, np.float16), to_dev(d_at, np.float16),
        )
        if stats is not None:
            stats["t"].append(t0)
            stats["host_s"].append(time.perf_counter() - t0)
        if timed:
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
        state, metrics = step_fn(state, *batch)
        if timed:
            ev[1].record()
            events.append(ev)
        if stats is not None:
            stats["loss"].append(metrics["loss"])
            stats["accuracy"].append(metrics["accuracy"])
        if log_every and s % log_every == 0:
            print(
                f"step {s}: loss={float(metrics['loss']):.4f} "
                f"acc={float(metrics['accuracy']):.3f}",
                flush=True,
            )
        if s and s % 500 == 0:  # periodic save: a killed run keeps its progress
            save_packaged_encoder(state.model, enc_cfg, out_path,
                                  metrics={k: float(v) for k, v in metrics.items()})
    final = {k: float(v) for k, v in metrics.items()}
    if stats is not None:
        stats["device_ms"] = [a.elapsed_time(b) for a, b in events]
        stats["loss"] = [float(v) for v in stats["loss"]]
        stats["accuracy"] = [float(v) for v in stats["accuracy"]]
    path = save_packaged_encoder(state.model, enc_cfg, out_path, metrics=final)
    return path, final
