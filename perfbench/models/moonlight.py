"""Reranker ``moonlight`` (program side): Moonlight-16B-A3B as the program's
on-device LLM cross-encoder (``rerank_backend`` "cross_encoder",
``triple_hybrid_rag_tpu_torch/models/cross_encoder.py``). It places each parent's
document as token ids (``lib/prompts.documents``, about 0.8 GB of int32 at 1M
chunks) and the whole model, at the widths of the configuration file's published
keys, with weights drawn from the run's seed by the program's
``init_cross_encoder`` (bf16, or the control's ``cross_encoder_weight_dtype``). The
staged retriever builds its reranker from what is placed. No hand-written kernel:
the routed experts run through ``torch._grouped_mm``."""


def place(inputs) -> dict:
    from triple_hybrid_rag_tpu_torch.models.cross_encoder import CrossEncoderConfig, init_cross_encoder

    from perfbench.lib.prompts import documents

    cfg = CrossEncoderConfig.from_hf(inputs.config)
    ids, lengths = documents(inputs.corpus, dict(inputs.config["documents"], vocab_size=cfg.vocab_size),
                             inputs.seed, inputs.device)
    model = init_cross_encoder(cfg, inputs.seed, inputs.device,
                               weight_dtype=inputs.cfg.cross_encoder_weight_dtype)
    return {"xenc_doc_ids": ids, "xenc_doc_len": lengths, "xenc_model": model}
