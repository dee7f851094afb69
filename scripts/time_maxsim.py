"""Time the MaxSim rerank kernel of a checkout at the smoke and the default shape.

    python3 scripts/time_maxsim.py [--root DIR]

Imports ``triple_hybrid_rag_tpu_torch`` from DIR (default: this checkout), builds
its ``csrc/maxsim.cu`` and times ``ops.maxsim.maxsim_scores`` with CUDA events
under a cold L2 on the inputs of ``chip_smoke.py`` phase 2 (this checkout's
``maxsim_inputs``, same seed): B = 128 x K = 50, 200,704 parents, at Td 32, D 64,
Tq 16 (the smoke run's corpus) and Td 64, D 128, Tq 32 (the default RAGConfig),
with a bf16 token store and, where the checkout's wrapper takes one, an int8
store. Each kernel is held against its plain version before it is timed, once
with the L2 emptied by reading a 64 MB buffer (``chip_smoke.time_ms``) and once
by overwriting it (the method of earlier ``chip_smoke.py`` runs, whose dirty
lines the timed call pays to write back). Two checkouts are compared by running the
script for each in one chip call. Prints the card and one JSON line. Needs one
CUDA card.
"""

import argparse
import importlib.util
import json
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]


def time_after_write(fn, iters: int = 50) -> float:
    """Median device time of ``fn`` after 64 MB were overwritten (dirty in L2)."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(2):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(1_000_000)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE), help="checkout whose port is timed")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("CUDA is not available", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("smoke_helpers", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    sys.path.insert(0, str(Path(args.root).resolve()))
    from triple_hybrid_rag_tpu_torch.ops import maxsim as mx

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1234)
    times = {}
    for label, (td, d, tq) in cs.MAXSIM_SHAPES.items():
        tokens, tok_mask, parent, q, w = cs.maxsim_inputs(
            dev, gen, cs.BATCH, cs.RERANK_K, cs.N_PARENTS, td, d, tq)
        stores = {"bf16": tokens}
        if hasattr(mx, "quantize_tokens"):
            stores["int8"] = mx.quantize_tokens(tokens)
        for body, store in stores.items():
            err = cs.max_err(mx.maxsim_scores(store, tok_mask, parent, q, w),
                             mx.maxsim_scores_plain(store, tok_mask, parent, q, w))
            if not err <= cs.MAXSIM_ATOL:
                print(f"{label} {body}: kernel disagrees with its plain version ({err})",
                      file=sys.stderr)
                return 1
            fn = lambda: mx.maxsim_scores(store, tok_mask, parent, q, w)  # noqa: E731
            times.setdefault(label, {})[body] = {
                "read_flush": cs.time_ms(fn, iters=50, cold_l2=True),
                "write_flush": time_after_write(fn),
            }
        del tokens, tok_mask, stores
        torch.cuda.empty_cache()
    print(cs.card_line())
    print(json.dumps({"root": args.root, "times_ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
