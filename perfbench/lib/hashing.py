"""The BowHash spec's hash directions, and the tables of them that the generator
sums into rows and token stores.

A token's direction is a unit Gaussian drawn from the SHA-256 of a key made of
the token (``tok\\x00<token>`` for dense rows, ``mtok<dim>\\x00<token>`` for MaxSim
vectors). Nothing here imports the program or torch, so the table's blocks can be
drawn in worker processes that import numpy alone: each draw needs its own
generator, and one process makes about 25,000 a second.
"""

from __future__ import annotations

import hashlib
import os
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context

import numpy as np

POOL_MIN_TERMS = 16384  # smaller tables are drawn in the calling process
MAX_WORKERS = 8


def term_str(i: int) -> str:
    return f"t{i:06d}"


def hash_seed(text: str) -> int:
    """The BowHash seed of a key: the first 8 bytes of its SHA-256, little-endian."""
    return int.from_bytes(hashlib.sha256(text.encode("utf-8")).digest()[:8], "little")


def unit_gaussian(key: str, dim: int) -> np.ndarray:
    """f32[dim]: the unit Gaussian direction of ``key`` (BowHash's token rule)."""
    v = np.random.default_rng(hash_seed(key)).standard_normal(dim).astype(np.float32)
    v /= np.linalg.norm(v)
    return v


def token_direction(token: str, dim: int) -> np.ndarray:
    """A token's dense-row direction (BowHash ``_token_vec``)."""
    return unit_gaussian("tok\x00" + token, dim)


def maxsim_direction(token: str, dim: int) -> np.ndarray:
    """A token's MaxSim vector (BowHash ``mtok_vec``)."""
    return unit_gaussian(f"mtok{dim}\x00" + token, dim)


KINDS = {"tok": token_direction, "mtok": maxsim_direction}


def _block(kind: str, lo: int, hi: int, dim: int, keep: int) -> np.ndarray:
    """f16[hi - lo, keep]: the first ``keep`` coordinates of terms lo..hi-1's unit
    ``dim``-wide directions."""
    fn = KINDS[kind]
    out = np.empty((hi - lo, keep), np.float16)
    for i in range(lo, hi):
        out[i - lo] = fn(term_str(i), dim)[:keep]
    return out


def direction_table(kind: str, vocab: int, dim: int, keep: int) -> np.ndarray:
    """f16[vocab, keep]: the directions of terms 0..vocab-1 (``kind`` "tok" or
    "mtok"), each drawn ``dim`` wide and cut to its first ``keep`` coordinates.
    A large table is drawn in blocks by worker processes, started fresh (spawn)
    and joined before this returns."""
    workers = min(MAX_WORKERS, len(os.sched_getaffinity(0)))
    if vocab < POOL_MIN_TERMS or workers < 2:
        return _block(kind, 0, vocab, dim, keep)
    step = -(-vocab // (4 * workers))
    bounds = [(lo, min(lo + step, vocab)) for lo in range(0, vocab, step)]
    with ProcessPoolExecutor(workers, mp_context=get_context("spawn")) as pool:
        parts = list(pool.map(_block, *zip(*[(kind, lo, hi, dim, keep) for lo, hi in bounds])))
    return np.concatenate(parts)
