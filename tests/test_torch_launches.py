"""Kernel launches and their counts (``kernels/build.launch``).

Every wrapper of a hand-written kernel launches through ``kernels.build.launch``,
which counts each launch in ``rag_metrics`` as ``kernel_launches_total`` by C entry
point and, for MaxSim, by plan. On a CPU tensor a wrapper runs its plain version and
counts nothing. The launch path itself runs here against a stand-in library (no
kernel runs): one counted launch of the wrapper's entry point on the current
stream, the MaxSim plan labelled with a name of ``PLANS``, and a returned CUDA
error raised and not counted.
"""

from __future__ import annotations

import contextlib
import ctypes
import types

import numpy as np
import pytest
import torch

from triple_hybrid_rag_tpu_torch.kernels import build
from triple_hybrid_rag_tpu_torch.ops import bm25, bowhash, dense_kernel, fused_topk, kda, maxsim

STREAM = 7  # the stand-in stream handle


def _inputs():
    g = torch.Generator().manual_seed(0)
    rows = torch.randn(48, 64, generator=g).to(torch.bfloat16)
    q = torch.randn(3, 64, generator=g)
    tokens = torch.randn(6, 8, 64, generator=g).to(torch.bfloat16)
    parents = torch.tensor([[0, 5, -1], [2, 2, 1], [4, -1, 3]])
    seeds = torch.from_numpy(np.arange(1, 6, dtype=np.uint64).view(np.int64))
    return {
        "bucket_maxima": (fused_topk.bucket_maxima, fused_topk._launch_bucket_maxima,
                          (rows, q, torch.ones(48, dtype=torch.bool), None, None, None, None)),
        "dense_scores": (dense_kernel.dense_scores, dense_kernel._launch_dense_scores, (rows, q)),
        "maxsim_scores": (maxsim.maxsim_scores, maxsim._launch_maxsim,
                          (tokens, torch.ones(6, 8, dtype=torch.bool), parents,
                           torch.randn(3, 4, 64, generator=g), torch.ones(3, 4))),
        "termtable_scores": (bm25.score_termtable_batch, bm25._launch_termtable,
                             (torch.randint(0, 20, (48, 8), generator=g, dtype=torch.int32),
                              torch.rand(48, 8, generator=g),
                              torch.randint(0, 20, (3, 4), generator=g, dtype=torch.int32))),
        "bowhash_encode": (
            lambda *a: bowhash.bowhash_encode(*a), lambda *a: bowhash._launch_bowhash_encode(*a, None),
            (seeds, 3, 64, 16, torch.tensor([[0, 1, 2], [2, -1, -1]], dtype=torch.int32),
             torch.tensor([[0, 1], [1, -1]], dtype=torch.int32), 32)),
        "kda_layer": (kda.kda_layer, lambda *a: kda._launch(*a, 128 ** -0.5),
                      (*(torch.randn(10, 256, generator=g).to(torch.bfloat16) for _ in range(3)),
                       [torch.rand(256, 4, generator=g).to(torch.bfloat16) for _ in range(3)],
                       torch.randn(10, 256, generator=g).to(torch.bfloat16), torch.zeros(2), torch.zeros(256),
                       torch.randn(10, 2, generator=g).to(torch.bfloat16),
                       torch.randn(10, 256, generator=g).to(torch.bfloat16), torch.ones(128).to(torch.bfloat16),
                       torch.tensor([0, 4, 10]), 2, 1e-5)),
    }


# the wrapper -> the C entry point a bf16 (or f32 for the term table) call launches
ENTRY = {"bucket_maxima": "fused_bucket_maxima_bf16", "dense_scores": "dense_scores_bf16",
         "maxsim_scores": "maxsim_scores_bf16", "termtable_scores": "termtable_scores_f32",
         "bowhash_encode": "bowhash_encode", "kda_layer": "kda_layer_bf16"}


@pytest.mark.parametrize("wrapper", sorted(ENTRY))
def test_cpu_call_counts_no_launch(wrapper):
    plain, _, args = _inputs()[wrapper]
    before = build.launch_counts(), build.launch_counts(by="plan")
    plain(*args)
    assert (build.launch_counts(), build.launch_counts(by="plan")) == before


class _StandIn:
    """A library whose entry points record their arguments and return ``err``; the
    MaxSim plan query answers plan ``plan`` with no scratch."""

    def __init__(self, err: int = 0, plan: int = 0) -> None:
        self.calls = []
        self.err, self.plan = err, plan

    def __getattr__(self, fn):
        def call(*args):
            self.calls.append((fn, args))
            if fn.startswith("maxsim_plan_"):
                ctypes.c_int.from_address(args[5]).value = self.plan
                ctypes.c_int64.from_address(args[6]).value = 0
                return 0
            return self.err
        return call


@pytest.fixture
def stand_in(monkeypatch):
    lib = _StandIn()
    monkeypatch.setattr(build, "load", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=STREAM))
    return lib


def _grew(before, after):
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


@pytest.mark.parametrize("wrapper", sorted(ENTRY))
def test_launch_counts_one_per_call_by_entry_point(stand_in, wrapper):
    _, launch, args = _inputs()[wrapper]
    before = build.launch_counts()
    launch(*args)
    assert _grew(before, build.launch_counts()) == {ENTRY[wrapper]: 1}
    fn, passed = stand_in.calls[-1]
    signature = next(lib[fn] for lib in build.SIGNATURES.values() if fn in lib)
    assert fn == ENTRY[wrapper] and passed[-1] == STREAM and len(passed) == len(signature)


@pytest.mark.parametrize("plan", range(len(maxsim.PLANS)))
def test_maxsim_plan_labels_are_plans(stand_in, plan):
    stand_in.plan = plan
    _, launch, args = _inputs()["maxsim_scores"]
    before = build.launch_counts(by="plan")
    launch(*args)
    assert _grew(before, build.launch_counts(by="plan")) == {maxsim.PLANS[plan]: 1}
    assert [fn for fn, _ in stand_in.calls] == ["maxsim_plan_bf16", "maxsim_scores_bf16"]


def test_returned_error_raises_and_counts_nothing(stand_in):
    stand_in.err = 700
    _, launch, args = _inputs()["dense_scores"]
    before = build.launch_counts()
    with pytest.raises(RuntimeError, match="dense_scores_bf16: CUDA error 700"):
        launch(*args)
    assert build.launch_counts() == before
