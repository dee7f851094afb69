"""Time the MaxSim rerank kernel of a checkout at the shapes of ``chip_smoke.py``.

    python3 scripts/time_maxsim.py [--root DIR] [--sweep] [--force-general]

Imports ``triple_hybrid_rag_tpu_torch`` from DIR (default: this checkout), builds
its ``csrc/maxsim.cu`` and times ``ops.maxsim.maxsim_scores`` with CUDA events
under a cold L2 on the inputs of ``chip_smoke.py`` phase 2 (this checkout's
``maxsim_inputs``, same seed), B = 128 x K = 50, with a bf16 token store and,
where the checkout's wrapper takes one, an int8 store. Each kernel is held against
its plain version before it is timed.

Without ``--sweep``: the staged plan's served shapes over 200,704 parents (Td 32,
D 64, Tq 16, the smoke run's corpus; Td 64, D 128, Tq 32, the default RAGConfig),
timed once with the L2 emptied by reading a 64 MB buffer (``chip_smoke.time_ms``)
and once by overwriting it (the method of earlier ``chip_smoke.py`` runs, whose
dirty lines the timed call pays to write back); then the shapes past the staged
plan (``chip_smoke.MAXSIM_PAST_STAGED``: Td 64, D 1024, Tq 256 over 4,096 parents;
Td 64, D 128, Tq 256 over 200,704), read flush only, and split by kernel name
(``torch.profiler`` over 20 back-to-back calls, device ms a call: the query's
rounding pass and the main kernel). Two checkouts are compared by running the
script for each in one chip call (parent, change, change, parent).

``--sweep``: Td 64 at Tq 32, 64, 128, 256 and D 128, 384, 1024 over 4,096
parents, each with its bound (``chip_smoke.maxsim_bound``) and the plan it took
(where the checkout's wrapper reports one). ``--force-general`` first builds a copy
of the checkout's ``csrc/`` (under ``build/``) whose launcher never takes the
staged plan, so that every shape of the sweep runs the general plan of a source
whose launcher tests ``tq <= kMaxQ`` for the staged plan (the source of PR 15).

Prints the card and one JSON line. Needs one CUDA card.
"""

import argparse
import importlib.util
import json
import shutil
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]
SWEEP_TQ = (32, 64, 128, 256)
SWEEP_D = (128, 384, 1024)
SWEEP_TD, SWEEP_PARENTS = 64, 4096
STAGED_TEST = "int err = tq <= kMaxQ ? 0 : -1;"  # the launcher's staged-plan test


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


def kernel_split(fn, calls: int = 20) -> dict:
    """Device ms a call of each kernel ``fn`` launches, by name (warm: back to back)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", getattr(ev, "cuda_time_total", 0))
        if t > 0:  # "void (anonymous namespace)::name<...>(...)" -> "name"
            name = ev.key.replace("(anonymous namespace)::", "").replace("void ", "")
            name = name.split("<")[0].split("(")[0]
            out[name] = out.get(name, 0.0) + t / 1e3 / calls
    return out


def force_general_build() -> None:
    """Point the checkout's kernel build at a copy of its sources whose MaxSim
    launcher never takes the staged plan (a measurement build, under ``build/``)."""
    from triple_hybrid_rag_tpu_torch.kernels import build

    dst = HERE / "build" / "forced_general_csrc"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(build.CSRC, dst)
    cu = dst / "maxsim.cu"
    text = cu.read_text()
    if STAGED_TEST not in text:
        raise SystemExit(f"--force-general: {cu} has no line {STAGED_TEST!r}")
    cu.write_text(text.replace(STAGED_TEST, "int err = -1;"))
    build.CSRC = dst
    build.BUILD_DIR = HERE / "build" / "forced_general_kernels"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE), help="checkout whose port is timed")
    ap.add_argument("--sweep", action="store_true", help="time the Tq x D grid at Td 64")
    ap.add_argument("--force-general", action="store_true",
                    help="build the checkout's MaxSim launcher without its staged plan")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("CUDA is not available", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("smoke_helpers", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    sys.path.insert(0, str(Path(args.root).resolve()))
    from triple_hybrid_rag_tpu_torch.ops import maxsim as mx

    if args.force_general:
        force_general_build()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1234)
    if args.sweep:
        shapes = {f"Tq{tq}_D{d}": ((SWEEP_TD, d, tq), SWEEP_PARENTS, False)
                  for d in SWEEP_D for tq in SWEEP_TQ}
    else:
        shapes = {label: (shape, cs.N_PARENTS, True) for label, shape in cs.MAXSIM_SHAPES.items()}
        shapes.update({label: (shape, p_rows, False)
                       for label, (shape, p_rows) in cs.MAXSIM_PAST_STAGED.items()})
    times = {}
    for label, ((td, d, tq), p_rows, both_flushes) in shapes.items():
        tokens, tok_mask, parent, q, w = cs.maxsim_inputs(
            dev, gen, cs.BATCH, cs.RERANK_K, p_rows, td, d, tq)
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
            row = {"read_flush": cs.time_ms(fn, iters=50, cold_l2=True)}
            if both_flushes:
                row["write_flush"] = time_after_write(fn)
            elif not args.sweep:
                row["kernels_warm"] = kernel_split(fn)
            row["bound_ms"], row["bound_by"] = cs.maxsim_bound(store, tok_mask, parent, tq)
            if hasattr(mx, "maxsim_plan"):
                row["plan"] = mx.maxsim_plan(store, parent, q)
            elif args.force_general:
                row["plan"] = "general (forced)"
            times.setdefault(label, {})[body] = row
        del tokens, tok_mask, stores
        torch.cuda.empty_cache()
    print(cs.card_line())
    print(json.dumps({"root": args.root, "sweep": args.sweep, "force_general": args.force_general,
                      "times_ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
