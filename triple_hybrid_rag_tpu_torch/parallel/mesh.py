"""Device meshes: a grid of ``torch.device`` entries with named axes.

A port of the JAX package's ``parallel/mesh.py``. Axis convention:

- ``"shard"``: the corpus axis. Postings, embedding rows and chunk-entity rows are
  split over it; each shard's top-k lists are gathered to its data row's first
  device and merged exactly.
- ``"data"``: the query-batch axis. Each data row holds a whole corpus replica and
  serves a contiguous slice of the batch.

One process drives every device of a mesh (no process group). A device may
repeat: ``corpus_mesh(devices=["cpu"] * 8)`` is an 8-shard mesh on the CPU, and
``["cuda:0"] * 4`` four shards on one card, the counterpart of XLA's forced host
device count. ``devices=None`` means every visible CUDA card; without CUDA that
raises, as :func:`~triple_hybrid_rag_tpu_torch.device.resolve_device` does.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from ..device import resolve_device

DeviceLike = Union[str, torch.device]


class DeviceMesh:
    """A 2-D grid of devices with two named axes (rows along the first)."""

    def __init__(self, grid: Sequence[Sequence[torch.device]],
                 axis_names: Tuple[str, str] = ("data", "shard")) -> None:
        self.grid: Tuple[Tuple[torch.device, ...], ...] = tuple(tuple(row) for row in grid)
        self.axis_names = tuple(axis_names)
        if not self.grid or not self.grid[0] or any(len(r) != len(self.grid[0]) for r in self.grid):
            raise ValueError("a mesh needs a non-empty rectangular grid of devices")

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis_names[0]: len(self.grid), self.axis_names[1]: len(self.grid[0])}

    @property
    def size(self) -> int:
        return len(self.grid) * len(self.grid[0])

    def devices(self) -> List[torch.device]:
        """Every entry of the grid, row by row (a device may repeat)."""
        return [d for row in self.grid for d in row]

    def __repr__(self) -> str:
        return f"DeviceMesh({self.shape}, {[[str(d) for d in r] for r in self.grid]})"


def _device(d: DeviceLike) -> torch.device:
    """A mesh entry as a device with an explicit index (``cuda`` -> ``cuda:<current>``);
    a CUDA entry without CUDA raises."""
    dev = resolve_device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _devices(devices: Optional[Sequence[DeviceLike]]) -> List[torch.device]:
    if devices is None:
        resolve_device(None)  # raises without CUDA
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [_device(d) for d in devices]


def _grid(devices: List[torch.device], rows: int, cols: int) -> List[List[torch.device]]:
    return [devices[r * cols:(r + 1) * cols] for r in range(rows)]


def corpus_mesh(
    n_shards: Optional[int] = None,
    data_parallel: int = 1,
    devices: Optional[Sequence[DeviceLike]] = None,
) -> DeviceMesh:
    """Mesh with a corpus ``shard`` axis and a ``data`` axis. Defaults to every
    device on the shard axis."""
    raw = list(devices) if devices is not None else None
    if data_parallel < 1:
        raise ValueError(f"data_parallel must be >= 1, got {data_parallel}")
    devs = _devices(raw)
    if n_shards is None:
        n_shards = len(devs) // data_parallel
    need = n_shards * data_parallel
    if need > len(devs) or n_shards < 1:
        # n_shards floor-divides to 0 when data_parallel exceeds the device count:
        # no degenerate N x 0 mesh
        raise ValueError(
            f"mesh {data_parallel}x{n_shards} needs {max(need, data_parallel)} "
            f"devices, have {len(devs)}"
        )
    return DeviceMesh(_grid(devs, data_parallel, n_shards))


def multislice_mesh(
    n_slices: int,
    shards_per_slice: int,
    data_per_slice: int = 1,
    devices: Optional[Sequence[DeviceLike]] = None,
) -> DeviceMesh:
    """The multi-slice layout: corpus shards stay inside a slice and slices fold into
    the ``data`` axis as corpus replicas serving disjoint slices of the batch, so
    only the batch crosses slices. Devices enumerate slice by slice. An entry with a
    ``slice_index`` attribute is checked: a shard row must not span two slices (a
    ``torch.device`` has none and reads as slice 0, as the reference's default)."""
    raw = list(devices) if devices is not None else None
    if n_slices < 1 or shards_per_slice < 1 or data_per_slice < 1:
        raise ValueError(
            f"multislice_mesh({n_slices=}, {shards_per_slice=}, {data_per_slice=}) "
            "needs positive dimensions"
        )
    devs = _devices(raw)
    need = n_slices * data_per_slice * shards_per_slice
    if need > len(devs):
        raise ValueError(f"mesh needs {need} devices, have {len(devs)}")
    rows = n_slices * data_per_slice
    slice_ids = _grid([getattr(d, "slice_index", 0) or 0 for d in (raw or devs)], rows,
                      shards_per_slice)
    if any(s != row[0] for row in slice_ids for s in row):
        raise ValueError(
            "a shard row spans slice boundaries (the per-query gather would cross "
            f"slices): shards_per_slice={shards_per_slice} does not fit one slice"
        )
    return DeviceMesh(_grid(devs, rows, shards_per_slice))


def single_device_mesh(device: Optional[DeviceLike] = None) -> DeviceMesh:
    """1x1 mesh: the sharded engine on one device (default: the first CUDA card)."""
    return DeviceMesh([[_device(device if device is not None else "cuda:0")]])


def default_mesh(device: DeviceLike) -> DeviceMesh:
    """The facade's mesh for a RAG on ``device``: every visible card
    (:func:`corpus_mesh`) when it is the default CUDA device, as the reference's
    facade shards over every device; else ``device`` alone (``"cpu"``,
    ``"cuda:1"``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return corpus_mesh()
    return single_device_mesh(dev)
