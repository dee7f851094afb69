"""Reranker ``maxsim`` (program side): the late-interaction MaxSim rerank over the
parents' token store, the default reranker of the benchmark. It places the
generator's token store and mask, quantized by the program's own token quantizer
where ``embedding_dtype`` asks for int8 or int4 (the store is int8 under both, as
the program stores it). Over a placed store the program builds its MaxSim
reranker from ``rerank_backend`` "maxsim", and the batched engine reranks by the
store it finds."""


def place(inputs) -> dict:
    tokens = inputs.corpus.tokens
    if inputs.cfg.embedding_dtype in ("int8", "int4"):
        from triple_hybrid_rag_tpu_torch.ops.maxsim import quantize_tokens

        tokens = quantize_tokens(tokens)
    return {"maxsim_tokens": tokens, "maxsim_mask": inputs.corpus.tok_mask}
