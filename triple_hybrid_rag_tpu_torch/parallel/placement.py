"""Placement of an index state over a mesh: the per-shard and per-data-row states.

The port's counterpart of the placement in the JAX ``ShardedEngine.__init__``
(``parallel/engine.py``). The capacity rounds up to a multiple of the shard count
(under IVF, of shards x ``ivf_block_rows``) and shard ``s`` holds rows
``[s * n_loc, (s + 1) * n_loc)``:

- row-sharded tables (the term table, the dense rows, their scales and ``valid``,
  ``chunk_entities``, ``collection_of``) are sliced; on the device that already
  holds the unsharded tensor a shard is a view of it where the kernels' 16-byte
  alignment holds (the reference's ``may_alias``), else a copy;
- the sorted lexical CSR and the graph mention CSR split per shard
  (:func:`~triple_hybrid_rag_tpu_torch.index.state.split_csr`): postings carry
  precomputed BM25 weights, so the global IDF survives the split, and the
  ``graph_mention_cap`` truncation was applied globally before it. ``l_max`` is
  the largest (term, shard) block, as in the reference;
- under IVF each shard clusters its own rows (``ivf_build_local`` per shard);
- the replicated tables (``nbr``, ``parent_of``, the MaxSim store,
  ``parent_emb``) are held once per data row, on the row's first device, where
  its tail runs.

Each shard and each row is an :class:`IndexState` (``dataclasses.replace`` of the
unsharded one), so the engine's channel code runs on it unchanged. Shards of
different data rows on one device share their tensors.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from ..index.ivf import ivf_build_local
from ..index.state import IndexState, _pad_rows, split_csr
from ..ops.bm25 import DOC_PAD
from .mesh import DeviceMesh


@dataclass
class Placement:
    """An index state laid out over a mesh."""

    mesh: DeviceMesh
    n_pad: int  # capacity after rounding to the mesh
    n_loc: int  # rows a shard
    lex_l_max: int  # largest (term, shard) postings block
    g_l_max: int  # largest (entity, shard) mention block
    shards: List[List[IndexState]]  # [data row][shard]
    rows: List[IndexState]  # per data row: the replicated tables on its first device

    def statics(self) -> Tuple[int, int, int, int]:
        """What a program over this placement depends on beyond the state's own
        statistics (compared by ``Engine.refresh``)."""
        return self.n_pad, self.n_loc, self.lex_l_max, self.g_l_max


def _on(t: Optional[torch.Tensor], dev: torch.device) -> Optional[torch.Tensor]:
    """``t`` on ``dev``: itself where it lies there 16-byte aligned, a copy otherwise."""
    if t is None:
        return None
    if t.device == dev:
        return t if t.data_ptr() % 16 == 0 else t.clone()
    return t.to(dev)


def _unpermute_ivf(state: IndexState) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The rows (and scales) of a blocked-IVF state back in original row order. A
    dead slot's row (an invalid row) comes back as zeros with scale 1: no build or
    probe reads it."""
    perm = state.ivf_perm.long()
    alive = perm < state.n_pad
    rows = torch.zeros_like(state.embeddings)
    rows[perm[alive]] = state.embeddings[alive]
    scales = None
    if state.dense_scales is not None:
        scales = torch.ones_like(state.dense_scales)
        scales[perm[alive]] = state.dense_scales[alive]
    return rows, scales


def place(state: IndexState, mesh: DeviceMesh) -> Placement:
    """Lay ``state`` out over ``mesh`` (see the module docstring)."""
    home = state.parent_of.device
    if mesh.size == 1 and mesh.grid[0][0] == home:
        # one device, the state's own: used as it is
        return Placement(mesh, state.n_pad, state.n_pad, state.lex_l_max, state.g_l_max,
                         [[state]], [state])
    cfg = state.config
    s = mesh.shape["shard"]
    ivf_w = max(1, cfg.ivf_block_rows) if state.ivf_mode else 1
    unit = s * ivf_w
    n_pad = -(-state.n_pad // unit) * unit
    n_loc = n_pad // s

    def pad(t, fill=None):
        return None if t is None else _pad_rows(t, n_pad, fill)

    rows, scales = (_unpermute_ivf(state) if state.ivf_mode
                    else (state.embeddings, state.dense_scales))
    table = {
        "embeddings": pad(rows, 0), "dense_scales": pad(scales, 1.0), "valid": pad(state.valid),
        "term_ids": pad(state.term_ids, DOC_PAD), "term_weights": pad(state.term_weights),
        "chunk_entities": pad(state.chunk_entities), "collection_of": pad(state.collection_of),
    }
    lex, lex_l_max = [(None,) * 4] * s, state.lex_l_max
    if state.lex_offsets is not None:
        lex, lex_l_max = split_csr(state.lex_offsets, state.lex_lengths, state.lex_pd,
                                   state.lex_pt, n_loc, s)
    ment, g_l_max = [(None,) * 4] * s, state.g_l_max
    if state.g_offsets is not None:
        ment, g_l_max = split_csr(state.g_offsets, state.g_lengths, state.g_docs, None, n_loc, s)

    shard_cache: Dict[Tuple[int, torch.device], IndexState] = {}

    def shard(si: int, dev: torch.device) -> IndexState:
        if (si, dev) in shard_cache:
            return shard_cache[si, dev]
        lo, hi = si * n_loc, (si + 1) * n_loc
        part = {k: _on(None if t is None else t[lo:hi], dev) for k, t in table.items()}
        offs, lens, pd, pw = (_on(t, dev) for t in lex[si])
        g_off, g_len, g_docs, _ = (_on(t, dev) for t in ment[si])
        sh = dataclasses.replace(
            state, device=dev, n_pad=n_loc, lex_offsets=offs, lex_lengths=lens, lex_pd=pd,
            lex_pt=pw, lex_l_max=lex_l_max, g_offsets=g_off, g_lengths=g_len, g_docs=g_docs,
            g_l_max=g_l_max, **part,
        )
        if state.ivf_mode:
            r, sc, perm, cent = ivf_build_local(
                sh.embeddings, sh.dense_scales, sh.valid, block_rows=ivf_w,
                n_clusters=cfg.ivf_clusters, iters=cfg.ivf_kmeans_iters,
            )
            sh = dataclasses.replace(sh, embeddings=r, dense_scales=sc, ivf_perm=perm,
                                     ivf_centroids=cent)
        shard_cache[si, dev] = sh
        return sh

    row_cache: Dict[torch.device, IndexState] = {}

    def row(dev: torch.device) -> IndexState:
        if dev not in row_cache:
            row_cache[dev] = dataclasses.replace(
                state, device=dev, n_pad=n_pad, nbr=_on(state.nbr, dev),
                parent_of=_on(pad(state.parent_of), dev),
                maxsim_tokens=_on(state.maxsim_tokens, dev),
                maxsim_mask=_on(state.maxsim_mask, dev), parent_emb=_on(state.parent_emb, dev),
            )
        return row_cache[dev]

    return Placement(
        mesh, n_pad, n_loc, lex_l_max, g_l_max,
        [[shard(si, dev) for si, dev in enumerate(r)] for r in mesh.grid],
        [row(r[0]) for r in mesh.grid],
    )
