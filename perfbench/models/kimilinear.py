"""Reranker ``kimilinear`` (program side): Kimi-Linear-48B-A3B-Instruct as the
program's on-device LLM cross-encoder (``rerank_backend`` "cross_encoder",
``triple_hybrid_rag_tpu_torch/models/kimi_linear.py``), holding the configuration's
share of each routed expert's channels. It places each parent's document as token ids
(``lib/prompts.documents``, as ``moonlight`` does) and the model at the widths of the
configuration file's published keys, holding ``expert_share.channels_held`` channels
from ``expert_share.channels_first``; weights drawn from the run's seed by the
program's ``init_kimi_linear`` (bf16, or the control's
``cross_encoder_weight_dtype``). The staged retriever builds its reranker from what
is placed. Its hand-written kernel, ``csrc/kda.cu``, runs inside each KDA layer's
``engine.staged.rerank.kda`` range."""


def place(inputs) -> dict:
    from triple_hybrid_rag_tpu_torch.models.kimi_linear import KimiLinearConfig, init_kimi_linear

    from perfbench.lib.prompts import documents

    conf, share = inputs.config, inputs.config["expert_share"]
    cfg = KimiLinearConfig.from_hf(conf, share["channels_first"], share["channels_held"])
    ids, lengths = documents(inputs.corpus, dict(conf["documents"], vocab_size=cfg.vocab_size),
                             inputs.seed, inputs.device)
    model = init_kimi_linear(cfg, inputs.seed, inputs.device,
                             weight_dtype=inputs.cfg.cross_encoder_weight_dtype)
    return {"xenc_doc_ids": ids, "xenc_doc_len": lengths, "xenc_model": model}
