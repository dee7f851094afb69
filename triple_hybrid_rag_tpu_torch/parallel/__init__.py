"""Multi-device execution: device meshes, sharded index placement, the sharded engine.

The port of the JAX package's ``parallel/``. The corpus axis of every index
structure splits over a mesh's ``shard`` axis, each shard's top-k lists are
gathered to its data row's first device and merged exactly, and query batches split
over the ``data`` axis. One process drives every device of the mesh.
"""

from .mesh import DeviceMesh, corpus_mesh, default_mesh, multislice_mesh, single_device_mesh

__all__ = ["corpus_mesh", "multislice_mesh", "single_device_mesh", "ShardedEngine"]


def __getattr__(name):
    # loaded on first access: engine.py imports this package's mesh and placement
    if name == "ShardedEngine":
        from .engine import ShardedEngine

        return ShardedEngine
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
