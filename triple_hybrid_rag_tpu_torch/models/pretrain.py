"""The packaged query encoder: its concept lexicon, its loader, the real-text pool.

A subset of the JAX package's ``models/pretrain.py``: :data:`CONCEPTS` (verbatim; the
encoder's identity anchors take their synonym keys from it, so the copy must stay
equal to the reference's), :data:`DEFAULT_PARAMS` and :func:`load_default_encoder`,
and the real-text harvest (:data:`TRAIN_TEXT_SOURCES`,
:data:`TRAIN_TEXT_SOURCES_DEEP`, :func:`realtext_documents`,
:func:`realtext_documents_deep`), which the corpus-scale evals exclude from their
documents. The weights are the reference's own ``models/data/encoder.npz``, read
with numpy from its place in the checkout; the port ships no copy of them. Training
and the pair generators are not ported (ROADMAP.md, Queue 1: training).
"""

from __future__ import annotations

import dataclasses
import json
import zipfile
import zlib
from pathlib import Path
from typing import Dict, List, Optional, Sequence

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

# the reference's packaged weights, in the checkout beside this package
DEFAULT_PARAMS = (
    Path(__file__).resolve().parents[2] / "triple_hybrid_rag_tpu" / "models" / "data" / "encoder.npz"
)

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
