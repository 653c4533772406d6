"""Data-parallel axes, each rank's rows of the batch, and each rank's
experts (port of the non-FSDP part of ``repro/parallel/sharding.py``:
``dp_axes``, ``dp_size``, ``model_size``, ``batch_specs``, and
``ep_param_specs`` as `map_ep`).

The reference shards a global batch over the data-parallel mesh axes
(``P(("pod", "data"), ...)``) and replicates the params; ``shard_map``
hands each device its block. The port's ranks each hold their own
block: `batch_rows` is the slice of the global batch that the
reference's layout gives this rank, from its coordinates on the mesh's
data axes (row-major, outermost axis first; in a remapped mesh the
coordinate of a rank is its slot's, ``group.rank(axis)``).

Expert parallelism: the reference splits the MoE experts of each layer
(``w_gate``, ``w_up``, ``w_down``, stacked ``(L, E, ...)``) over the
``model`` axis on E and replicates everything else (its
``ep_param_specs``; here `map_ep` treats the two kinds of leaf apart).
A port rank at coordinate ``m`` of the axis holds the experts
``[m * E/tp, (m+1) * E/tp)`` of every layer (`expert_range`): every
rank draws the full params from the same generator and keeps its slice
(`ep_shard`), so each rank's layout equals a one-rank draw's, sliced;
`ep_gather` puts the slices back together (checkpoints).

The mesh is always passed in: there is no module-level current mesh
(the reference's ``set_current_mesh`` / ``_CURRENT_MESH``). FSDP and
tensor-parallel param sharding are not ported.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.collectives import group as grp

#: the MoE block's expert weights, split over the expert-parallel axis
EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


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


# ---------------------------------------------------------------------------
# expert parallelism
# ---------------------------------------------------------------------------
def _map_with_path(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(v, fn, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_map_with_path(v, fn, path + (i,))
               for i, v in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") \
            else type(tree)(out)
    return fn(path, tree)


def _is_expert(path) -> bool:
    """A MoE block's expert weight: ``.../moe/{w_gate,w_up,w_down}``
    (not the dense residual MLP's, ``.../moe/dense/w_*``)."""
    return len(path) >= 2 and path[-2] == "moe" and \
        path[-1] in EXPERT_LEAVES


def expert_range(mesh, num_experts: int, ep_axis: str = "model"
                 ) -> Tuple[int, int]:
    """The experts ``[lo, hi)`` this rank holds."""
    tp = mesh.shape[ep_axis]
    if num_experts % tp:
        raise ValueError(f"{num_experts} experts not divisible by axis "
                         f"{ep_axis}={tp}")
    m = grp.rank(mesh.axis(ep_axis))
    per = num_experts // tp
    return m * per, (m + 1) * per


def ep_shard(params, mesh, ep_axis: str = "model"):
    """``params`` (every expert) with each expert weight cut to this
    rank's `expert_range` (a copy, so the full tensor can be freed)."""
    def cut(path, t):
        if not _is_expert(path):
            return t
        lo, hi = expert_range(mesh, t.shape[0], ep_axis)
        return t[lo:hi].clone()
    return _map_with_path(params, cut)


def ep_gather(tree, mesh, ep_axis: str = "model"):
    """The inverse of `ep_shard`: every expert weight gathered over the
    axis in axis order, on every rank. Collective over ``ep_axis``."""
    axis = mesh.axis(ep_axis)
    return _map_with_path(
        tree, lambda path, t: grp.all_gather(t, axis) if _is_expert(path)
        else t)


def map_ep(tree, expert, replicated):
    """``expert(leaf)`` on every expert weight, ``replicated(leaf)`` on
    every other leaf, in the same order on every rank."""
    return _map_with_path(
        tree, lambda path, t: expert(t) if _is_expert(path)
        else replicated(t))


def ep_split(tree):
    """``(replicated, experts)``: two trees of ``tree``'s structure, each
    with the other's leaves set to ``None`` (an empty node)."""
    return (map_ep(tree, lambda t: None, lambda t: t),
            map_ep(tree, lambda t: t, lambda t: None))
