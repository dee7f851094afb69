"""BowHash query encode: the token directions of a batch drawn and pooled on the card.

``BowHashEmbedder`` (``models/embedder.py``) gives each token a unit direction, numpy's
``default_rng(seed).standard_normal(dim)`` over the SHA-256 seed of the token's key,
and embeds a text as the normalized sum of its tokens' directions. Drawn on the
host, one generator a token, those draws were most of the batched path's host
prep. :func:`bowhash_encode` draws every distinct stream of a batch at once and
pools them into the engine's query wire format (f16 query vectors and MaxSim
tokens): the hand-written kernel ``csrc/bowhash.cu`` on a CUDA device (no TPU
kernel is replaced: the JAX package draws on the host), :func:`bowhash_encode_plain`
on the CPU.

:func:`draw_plain` is the kernel's arithmetic in numpy, step for step: SeedSequence,
PCG64 (XSL-RR) and numpy's 64-bit ziggurat with the tables the kernel reads
(``csrc/ziggurat_tables.cuh``, written by ``scripts/extract_ziggurat_tables.py``).
Its streams equal numpy's own bit for bit; the CPU tests hold it to that.
"""

from __future__ import annotations

import functools
import math
import re
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

TABLES_HEADER = Path(__file__).resolve().parent.parent / "csrc" / "ziggurat_tables.cuh"
# the pool kernel holds a query's dense sum (f32) in the 48 KB of shared memory a
# block has without opting in, beside its 64 bytes of static reduction scratch
MAX_POOL_DIM = (48 * 1024 - 64) // 4

_M32 = np.uint64(0xFFFFFFFF)
_M52 = np.uint64(0x000FFFFFFFFFFFFF)
_MUL_HI = np.uint64(2549297995355413924)
_MUL_LO = np.uint64(4865540595714422341)
_ZIG_R = 3.6541528853610087963519472518
_ZIG_INV_R = 0.27366123732975827203338247596
# SeedSequence's hash constants (numpy/random/bit_generator.pyx)
_INIT_A, _MULT_A, _INIT_B, _MULT_B = 0x43B0D7E5, 0x931E8875, 0x8B51F9DD, 0x58F38DED
_MIX_L, _MIX_R = 0xCA01F9DD, 0x4973F715


@functools.lru_cache(maxsize=None)
def ziggurat_tables() -> Dict[str, np.ndarray]:
    """The header's three tables as uint64[256]: ``kZigKi``, and ``kZigWiBits`` /
    ``kZigFiBits`` (the doubles' bit patterns)."""
    text = TABLES_HEADER.read_text()
    out = {}
    for name, body in re.findall(r"(\w+)\[256\] = \{([^}]*)\}", text):
        out[name] = np.array([int(v, 16) for v in re.findall(r"0x([0-9a-f]{16})ULL", body)],
                             np.uint64)
    return out


def _mul64(a: np.ndarray, b: np.uint64) -> Tuple[np.ndarray, np.ndarray]:
    """(high, low) 64-bit halves of the 128-bit products a * b."""
    a0, a1 = a & _M32, a >> np.uint64(32)
    b0, b1 = b & _M32, b >> np.uint64(32)
    p00, p01, p10, p11 = a0 * b0, a0 * b1, a1 * b0, a1 * b1
    mid = (p00 >> np.uint64(32)) + (p01 & _M32) + (p10 & _M32)
    lo = (mid << np.uint64(32)) | (p00 & _M32)
    hi = p11 + (p01 >> np.uint64(32)) + (p10 >> np.uint64(32)) + (mid >> np.uint64(32))
    return hi, lo


class _Pcg64:
    """PCG64 states of many streams: numpy's ``pcg64_set_seed`` after
    ``SeedSequence(seed).generate_state(4, np.uint64)``, then ``pcg64_next64``."""

    def __init__(self, seeds: np.ndarray) -> None:
        words = np.array([self._seed_words(int(s)) for s in seeds], np.uint64).reshape(-1, 4)
        s0, s1, s2, s3 = words.T
        self.inc_hi = (s2 << np.uint64(1)) | (s3 >> np.uint64(63))
        self.inc_lo = (s3 << np.uint64(1)) | np.uint64(1)
        self.hi = np.zeros_like(s0)
        self.lo = np.zeros_like(s0)
        self.step()
        lo = self.lo + s1
        self.hi = self.hi + s0 + (lo < self.lo).astype(np.uint64)
        self.lo = lo
        self.step()

    @staticmethod
    def _seed_words(seed: int):
        """SeedSequence(seed).generate_state(4, np.uint64), as Python ints."""
        m = 0xFFFFFFFF
        hc = _INIT_A

        def hashmix(v):
            nonlocal hc
            v = (v ^ hc) & m
            hc = (hc * _MULT_A) & m
            v = (v * hc) & m
            return v ^ (v >> 16)

        def mixw(x, y):
            r = (_MIX_L * x - _MIX_R * y) & m
            return r ^ (r >> 16)

        # the seed's 32-bit words, least significant first; one word below 2^32,
        # where the pool is run out with hashmix(0), as the second word (0) gives
        pool = [hashmix(seed & m), hashmix((seed >> 32) & m), hashmix(0), hashmix(0)]
        for src in range(4):
            for dst in range(4):
                if src != dst:
                    pool[dst] = mixw(pool[dst], hashmix(pool[src]))
        hb, out = _INIT_B, []
        for i in range(8):
            v = (pool[i & 3] ^ hb) & m
            hb = (hb * _MULT_B) & m
            v = (v * hb) & m
            out.append(v ^ (v >> 16))
        return [out[2 * k] | (out[2 * k + 1] << 32) for k in range(4)]

    def step(self, sel=slice(None)) -> None:
        lo = self.lo[sel]
        p_hi, p_lo = _mul64(lo, _MUL_LO)
        hi = p_hi + lo * _MUL_HI + self.hi[sel] * _MUL_LO
        s = p_lo + self.inc_lo[sel]
        self.hi[sel] = hi + self.inc_hi[sel] + (s < p_lo).astype(np.uint64)
        self.lo[sel] = s

    def next_u64(self, sel) -> np.ndarray:
        self.step(sel)
        hi, lo = self.hi[sel], self.lo[sel]
        x = hi ^ lo
        rot = hi >> np.uint64(58)
        return (x >> rot) | (x << ((np.uint64(64) - rot) & np.uint64(63)))


def draw_plain(seeds, dim: int) -> Tuple[np.ndarray, Dict[str, int]]:
    """f32[S, dim]: row s is ``default_rng(seeds[s]).standard_normal(dim)`` cast to
    float32, by the kernel's arithmetic (all streams advance together, each in
    its own state of numpy's ``random_standard_normal``). Also the draws by path:
    ``fast`` (the layer's core), ``wedge`` (accepted against exp), ``tail`` (the
    base strip past r, through log1p) and ``rejected`` (tries that drew again).
    exp and log1p are the C library's (``math``), as in numpy's build."""
    t = ziggurat_tables()
    ki = t["kZigKi"]
    wi = t["kZigWiBits"].view(np.float64)
    fi = t["kZigFiBits"].view(np.float64)
    seeds = np.asarray(seeds, dtype=np.uint64).reshape(-1)
    n = seeds.shape[0]
    gen = _Pcg64(seeds)
    out = np.zeros((n, dim), np.float64)
    done = np.zeros(n, np.int64)
    mode = np.zeros(n, np.int8)  # 0 a new draw, 1 the wedge's uniform, 2 / 3 the tail's two
    held_x = np.zeros(n, np.float64)
    held_idx = np.zeros(n, np.int64)
    held_neg = np.zeros(n, bool)
    held_xx = np.zeros(n, np.float64)
    paths = dict(fast=0, wedge=0, tail=0, rejected=0)
    while True:
        live = np.nonzero(done < dim)[0]
        if not live.size:
            break
        r = gen.next_u64(live)
        m = mode[live]
        emit_at, emit_val = [], []

        new = live[m == 0]
        if new.size:
            rn = r[m == 0]
            idx = (rn & np.uint64(0xFF)).astype(np.int64)
            rn = rn >> np.uint64(8)
            neg = (rn & np.uint64(1)).astype(bool)
            rabs = (rn >> np.uint64(1)) & _M52
            x = rabs.astype(np.float64) * wi[idx]
            x = np.where(neg, -x, x)
            fast = rabs < ki[idx]
            paths["fast"] += int(fast.sum())
            emit_at.append(new[fast])
            emit_val.append(x[fast])
            tail = ~fast & (idx == 0)
            wedge = ~fast & (idx != 0)
            mode[new[tail]] = 2
            held_neg[new[tail]] = ((rabs[tail] >> np.uint64(8)) & np.uint64(1)).astype(bool)
            mode[new[wedge]] = 1
            held_x[new[wedge]] = x[wedge]
            held_idx[new[wedge]] = idx[wedge]

        u = (r >> np.uint64(11)).astype(np.float64) * (1.0 / 9007199254740992.0)
        for i in np.nonzero(m)[0]:
            s, k = live[i], m[i]
            if k == 1:
                j = held_idx[s]
                x = held_x[s]
                mode[s] = 0
                if (fi[j - 1] - fi[j]) * u[i] + fi[j] < math.exp(-0.5 * x * x):
                    paths["wedge"] += 1
                    emit_at.append(np.array([s]))
                    emit_val.append(np.array([x]))
                else:
                    paths["rejected"] += 1
            elif k == 2:
                held_xx[s] = -_ZIG_INV_R * math.log1p(-u[i])
                mode[s] = 3
            elif k == 3:
                yy = -math.log1p(-u[i])
                xx = held_xx[s]
                if yy + yy > xx * xx:
                    paths["tail"] += 1
                    v = _ZIG_R + xx
                    emit_at.append(np.array([s]))
                    emit_val.append(np.array([-v if held_neg[s] else v]))
                    mode[s] = 0
                else:
                    paths["rejected"] += 1
                    mode[s] = 2
        if emit_at:
            at = np.concatenate(emit_at)
            out[at, done[at]] = np.concatenate(emit_val)
            done[at] += 1
    return out.astype(np.float32), paths


def _unit_rows(raw: np.ndarray) -> np.ndarray:
    """f32 rows over their f32 norms (the sum of squares in f64, rounded once)."""
    norms = np.sqrt(np.square(raw.astype(np.float64)).sum(axis=1)).astype(np.float32)
    return raw / norms[:, None]


def bowhash_encode_plain(seeds, n_tok: int, dim_tok: int, dim_m: int, tok_idx, mtok_idx,
                         out_dim: int, draws=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel (CPU tensors): the same draws, norms, token-order
    f32 sums and the two normalizations, in numpy. ``draws``: as for
    :func:`bowhash_encode`."""
    seeds = seeds.cpu().numpy().view(np.uint64)
    tok_idx, mtok_idx = tok_idx.cpu().numpy(), mtok_idx.cpu().numpy()
    raw_tok = draw_plain(seeds[:n_tok], dim_tok)[0]
    raw_m = draw_plain(seeds[n_tok:], dim_m)[0]
    if draws is not None:
        draws[0].copy_(torch.from_numpy(raw_tok))
        draws[1].copy_(torch.from_numpy(raw_m))
    tok_dirs, m_dirs = _unit_rows(raw_tok), _unit_rows(raw_m)
    b = tok_idx.shape[0]
    q_vec = np.zeros((b, out_dim), np.float16)
    for i in range(b):
        acc = np.zeros(dim_tok, np.float32)
        for s in tok_idx[i]:
            if s < 0:
                break
            acc += tok_dirs[s]
        n = np.float32(math.sqrt(float(np.square(acc.astype(np.float64)).sum())))
        v = (acc / n if n > 0 else acc)[:out_dim]
        n2 = np.float32(math.sqrt(float(np.square(v.astype(np.float64)).sum())))
        q_vec[i] = (v / max(n2, np.float32(1e-12))).astype(np.float16)
    q_tok = np.where((mtok_idx >= 0)[..., None], m_dirs[np.maximum(mtok_idx, 0)], 0)
    return torch.from_numpy(q_vec), torch.from_numpy(q_tok.astype(np.float16))


def _launch_bowhash_encode(seeds, n_tok, dim_tok, dim_m, tok_idx, mtok_idx, out_dim, draws):
    from ..kernels.build import launch

    dev = seeds.device
    b, l = tok_idx.shape
    t = mtok_idx.shape[1]
    n_m = seeds.shape[0] - n_tok
    if draws is None:
        raw_tok = torch.empty((n_tok, dim_tok), dtype=torch.float32, device=dev)
        raw_m = torch.empty((n_m, dim_m), dtype=torch.float32, device=dev)
    else:
        raw_tok, raw_m = draws
    norms = torch.empty((n_tok + n_m,), dtype=torch.float32, device=dev)
    q_vec = torch.empty((b, out_dim), dtype=torch.float16, device=dev)
    q_tok = torch.empty((b, t, dim_m), dtype=torch.float16, device=dev)
    launch("bowhash", "bowhash_encode", dev, seeds.data_ptr(), n_tok, dim_tok, n_m, dim_m,
           tok_idx.data_ptr(), b, l, mtok_idx.data_ptr(), t, out_dim, raw_tok.data_ptr(),
           raw_m.data_ptr(), norms.data_ptr(), q_vec.data_ptr(), q_tok.data_ptr())
    return q_vec, q_tok


def bowhash_encode(
    seeds: torch.Tensor,  # i64[n_tok + n_m]: the u64 seeds' bits, dense streams first
    n_tok: int,
    dim_tok: int,
    dim_m: int,
    tok_idx: torch.Tensor,  # i32[B, L]: each query's dense streams in token order, -1 after
    mtok_idx: torch.Tensor,  # i32[B, T]: its first T tokens' MaxSim streams, -1 after
    out_dim: int,
    draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q_vec f16[B, out_dim], q_tok f16[B, T, dim_m]): each query's dense
    directions summed in token order and normalized, cut to ``out_dim`` and
    normalized again; its MaxSim directions, zero past its tokens. The kernel on
    a CUDA tensor (or raise), the plain version on a CPU tensor.

    ``draws``, where given, is a pair of contiguous f32 tensors ``[n_tok, dim_tok]``
    and ``[n_m, dim_m]`` on the seeds' device that receive the raw draws (row s =
    ``default_rng(seed).standard_normal(dim)`` as float32), in place of the
    kernel's own scratch."""
    if not 0 < out_dim <= dim_tok <= MAX_POOL_DIM or dim_m <= 0:
        raise ValueError(f"bad widths: dense {dim_tok} cut to {out_dim}, MaxSim {dim_m} "
                         f"(the dense width may not pass {MAX_POOL_DIM})")
    if seeds.dtype != torch.int64 or tok_idx.dtype != torch.int32 or mtok_idx.dtype != torch.int32:
        raise TypeError("seeds must be int64, the stream indexes int32")
    if not 0 <= n_tok <= seeds.shape[0] or tok_idx.shape[0] != mtok_idx.shape[0]:
        raise ValueError(f"bad shapes: {seeds.shape[0]} seeds ({n_tok} dense), "
                         f"indexes {tuple(tok_idx.shape)} and {tuple(mtok_idx.shape)}")
    if draws is not None:
        shapes = ((n_tok, dim_tok), (seeds.shape[0] - n_tok, dim_m))
        if any(tuple(x.shape) != sh or x.dtype != torch.float32 or not x.is_contiguous()
               or x.device != seeds.device or x.data_ptr() % 16
               for x, sh in zip(draws, shapes)):
            raise ValueError(f"draws must be contiguous, 16-byte aligned f32 tensors of shapes "
                             f"{shapes} on {seeds.device}")
    if seeds.device.type == "cuda":
        if not (tok_idx.device == mtok_idx.device == seeds.device):
            raise ValueError("seeds and stream indexes must be on one device")
        if not (seeds.is_contiguous() and tok_idx.is_contiguous() and mtok_idx.is_contiguous()):
            raise ValueError("seeds and stream indexes must be contiguous")
        return _launch_bowhash_encode(seeds, n_tok, dim_tok, dim_m, tok_idx, mtok_idx, out_dim,
                                      draws)
    return bowhash_encode_plain(seeds, n_tok, dim_tok, dim_m, tok_idx, mtok_idx, out_dim, draws)

