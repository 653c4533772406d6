"""Data-parallel axes and each rank's rows of the batch (port of the
non-FSDP part of ``repro/parallel/sharding.py``: ``dp_axes``,
``dp_size``, ``model_size``, ``batch_specs``).

The reference shards a global batch over the data-parallel mesh axes
(``P(("pod", "data"), ...)``) and replicates the params; ``shard_map``
hands each device its block. The port's ranks each hold their own
block: `batch_rows` is the slice of the global batch that the
reference's layout gives this rank, from its coordinates on the mesh's
data axes (row-major, outermost axis first; in a remapped mesh the
coordinate of a rank is its slot's, ``group.rank(axis)``).

The mesh is always passed in: there is no module-level current mesh
(the reference's ``set_current_mesh`` / ``_CURRENT_MESH``). Param
sharding (FSDP, tensor parallel) is not ported; every param is
replicated.
"""
from __future__ import annotations

from typing import Tuple

from repro_torch.core.collectives import group as grp


def dp_axes(mesh) -> Tuple[str, ...]:
    """Data-parallel mesh axes, outermost first ("dcn" across the WAN
    links, "pod" across pods, "data" inside)."""
    return tuple(a for a in ("dcn", "pod", "data") if a in mesh.axis_names)


def dp_size(mesh) -> int:
    s = 1
    for a in dp_axes(mesh):
        s *= mesh.shape[a]
    return s


def model_size(mesh) -> int:
    return mesh.shape.get("model", 1)


def dp_index(mesh) -> int:
    """This rank's block of a batch sharded over the data axes: its
    coordinates on them, row-major in mesh order."""
    i = 0
    for a in dp_axes(mesh):
        i = i * mesh.shape[a] + grp.rank(mesh.axis(a))
    return i


def batch_rows(mesh, global_batch: int) -> slice:
    """The rows of a ``global_batch``-row batch that this rank holds: the
    reference's ``batch_specs`` splits the batch axis over the data axes
    when they divide it, else replicates it."""
    n = dp_size(mesh)
    if global_batch % n:
        return slice(0, global_batch)
    per = global_batch // n
    i = dp_index(mesh)
    return slice(i * per, (i + 1) * per)
