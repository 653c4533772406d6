"""Hierarchical collective compositions over N mesh axes (port of
``repro/core/collectives/hierarchical.py``).

The reference runs these inside ``shard_map``, ``levels`` naming mesh
axes. The port runs them inside every rank, and ``levels`` are
``(sub-group, size)`` pairs, innermost first: each sub-group a
`repro_torch.core.collectives.group.Axis` of a `RankMesh` (or any
process group). ``jnp.pad`` becomes ``F.pad`` on the flat buffer; the
``[:out_elems]`` truncation stays. The reference's text follows.

The production-library schedule for multi-level all-reduce (HiCCL, NCCL
tree/ring hybrids, MagPIe/Cheetah-style multi-level collectives):
reduce-scatter INWARD level by level (the fastest links carry the full
buffer, each slower tier only the shrinking shard), all-reduce at the
OUTERMOST level (the machine-spanning links move just the
1/prod(inner fan-outs) shard), then all-gather back OUTWARD. Each phase
picks its own {algorithm, segments} from a per-level decision source, so
every tier tunes against its own fabric profile (intra-host ICI vs
intra-pod vs cross-pod DCN).

``levels`` are innermost first: ``(axis_name, axis_size)`` pairs.
``level_keys`` address the decision source's tables per level —
positional indices by default, or names ("intra_pod") when the
artifact's naming is known. The exact byte flow (padding on the way in,
truncation on the way out) comes from
``repro_torch.core.analytical.hierarchy.padded_allreduce_schedule`` — the same
schedule `Communicator.plan` expands, so the rendered plan can never
disagree with the executed lookups.

Beyond all-reduce, reduce-scatter and all-gather also compose over N
axes:

  * ``multilevel_reduce_scatter`` — reduce-scatter innermost-out: the
    cross-level shard at rank (outer o, ..., inner i) is global chunk
    ``i * prod(outer sizes) + ... + o`` (inner-major), each
    1/prod(sizes) of the buffer, fully summed;
  * ``multilevel_all_gather`` — all-gather outermost-in: the exact
    inverse, reassembling those chunks into the full buffer in original
    order.

Functions run inside every rank of the mesh, the same convention as
``repro_torch.core.collectives.algorithms``. The compositions
are exact for op="add": reduce-scatter partial sums are disjoint, so the
outer phases and the gathers reassemble the same floating-point values a
flat schedule would produce per shard.

The two-axis spellings (``hierarchical_all_reduce`` & co.) are the
N=2 special case, kept as the stable entry points for existing callers.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch.nn.functional as F

from repro_torch import pytree
from repro_torch.core.analytical.hierarchy import padded_allreduce_schedule
from repro_torch.core.collectives.algorithms import _flatten_pad
from repro_torch.core.collectives.dispatch import (
    CollectiveSpec,
    DecisionSource,
    apply_collective,
)


def _level_spec(decision, level, op: str, nbytes: int, p: int
                ) -> CollectiveSpec:
    """Per-level lookup when the source is hierarchical; flat sources (or
    None -> XLA) answer for every level."""
    if decision is None:
        return CollectiveSpec("xla", 1)
    if hasattr(decision, "spec_for_level"):
        return decision.spec_for_level(level, op, nbytes, p)
    return decision.spec_for(op, nbytes, p)


def _keys(levels: Sequence[Tuple[str, int]], level_keys) -> list:
    if level_keys is None:
        return list(range(len(levels)))
    keys = list(level_keys)
    assert len(keys) == len(levels), \
        f"{len(keys)} level keys for {len(levels)} levels"
    return keys


# ---------------------------------------------------------------------------
# N-level compositions
# ---------------------------------------------------------------------------
def multilevel_all_reduce(
    x,
    levels: Sequence[Tuple[str, int]],
    decision: Optional[DecisionSource] = None,
    *,
    op: str = "add",
    level_keys: Optional[Sequence] = None,
):
    """reduce-scatter inward -> all-reduce at the top -> all-gather outward
    over any number of mesh axes (``levels`` innermost first).

    One level degenerates to a flat tuned all-reduce on that axis. The
    phase-by-phase element counts — including the zero-padding each
    inward reduce-scatter introduces and the matching truncation on the
    way out — walk ``padded_allreduce_schedule``, so the decision lookups
    here are byte-identical to the plan `Communicator.explain` renders.
    """
    assert levels, "need at least one level"
    keys = _keys(levels, level_keys)
    itemsize = x.element_size()
    shape = x.shape
    flat = x.reshape(-1)
    for lvl, phase_op, in_elems, out_elems in padded_allreduce_schedule(
            [p for _, p in levels], flat.numel()):
        axis, p = levels[lvl]
        key = keys[lvl]
        if phase_op == "reduce_scatter" and flat.numel() < in_elems:
            flat = F.pad(flat, (0, in_elems - flat.numel()))
        spec = _level_spec(decision, key, phase_op, in_elems * itemsize, p)
        flat = apply_collective(phase_op, flat, axis, p, spec,
                                reduce_op=op).reshape(-1)
        if phase_op == "all_gather" and flat.numel() > out_elems:
            flat = flat[:out_elems]
    return flat.reshape(shape)


def multilevel_reduce_scatter(
    x,
    levels: Sequence[Tuple[str, int]],
    decision: Optional[DecisionSource] = None,
    *,
    op: str = "add",
    level_keys: Optional[Sequence] = None,
):
    """reduce-scatter at every level, innermost first.

    Returns this rank's flat 1/prod(sizes) shard of the global sum. With
    levels innermost-first ``(i, ..., o)``, rank (o, ..., i) holds global
    chunk ``i * prod(outer sizes) + ... + o`` (inner-major) of the
    (zero-padded) flattened buffer — the layout
    ``multilevel_all_gather`` inverts. The innermost phase carries the
    full buffer on the fast links; each outer tier only ever sees the
    already-scattered partials.
    """
    assert levels, "need at least one level"
    keys = _keys(levels, level_keys)
    itemsize = x.element_size()
    total = 1
    for _, p in levels:
        total *= p
    flat, _, _ = _flatten_pad(x, total)
    for (axis, p), key in zip(levels, keys):
        spec = _level_spec(decision, key, "reduce_scatter",
                           flat.numel() * itemsize, p)
        flat = apply_collective("reduce_scatter", flat, axis, p, spec,
                                reduce_op=op).reshape(-1)
    return flat


def multilevel_all_gather(
    x,
    levels: Sequence[Tuple[str, int]],
    decision: Optional[DecisionSource] = None,
    *,
    level_keys: Optional[Sequence] = None,
):
    """all-gather at every level, outermost first.

    The inverse of ``multilevel_reduce_scatter``: flat per-rank shards
    come back as the full prod(sizes)-times-larger concatenation, chunks
    ordered inner-major. The outer tiers move only the small shards
    across the slow links before the fast inner links fan the
    tier-complete chunks out.
    """
    assert levels, "need at least one level"
    keys = _keys(levels, level_keys)
    itemsize = x.element_size()
    flat = x.reshape(-1)
    for (axis, p), key in reversed(list(zip(levels, keys))):
        spec = _level_spec(decision, key, "all_gather",
                           flat.numel() * itemsize, p)
        flat = apply_collective("all_gather", flat, axis, p,
                                spec).reshape(-1)
    return flat


def sync_gradients_multilevel(
    grads,
    levels: Sequence[Tuple[str, int]],
    decision: Optional[DecisionSource] = None,
    *,
    mean: bool = True,
    level_keys: Optional[Sequence] = None,
):
    """N-level all-reduce of every gradient leaf — the multi-tier
    replacement for flat sync + per-axis psum. Runs inside every rank of
    the mesh."""
    denom = 1
    for _, p in levels:
        denom *= p

    def sync_leaf(g):
        out = multilevel_all_reduce(g, levels, decision,
                                    level_keys=level_keys)
        if mean:
            out = out / denom
        return out

    return pytree.tree_map(sync_leaf, grads)


# ---------------------------------------------------------------------------
# two-axis spellings (the stable N=2 entry points)
# ---------------------------------------------------------------------------
def hierarchical_all_reduce(
    x,
    inner_axis: str,
    inner_size: int,
    outer_axis: str,
    outer_size: int,
    decision: Optional[DecisionSource] = None,
    *,
    op: str = "add",
    inner_level=0,
    outer_level=-1,
):
    """reduce-scatter(inner) -> all-reduce(outer) -> all-gather(inner).

    ``inner_level``/``outer_level`` address the decision source's levels —
    positional by default (first = fastest links, last = machine-spanning),
    or by name ("intra_pod") when the artifact's naming is known.
    """
    return multilevel_all_reduce(
        x, [(inner_axis, inner_size), (outer_axis, outer_size)], decision,
        op=op, level_keys=[inner_level, outer_level])


def hierarchical_reduce_scatter(
    x,
    inner_axis: str,
    inner_size: int,
    outer_axis: str,
    outer_size: int,
    decision: Optional[DecisionSource] = None,
    *,
    op: str = "add",
    inner_level=0,
    outer_level=-1,
):
    """reduce-scatter(inner) -> reduce-scatter(outer); see
    ``multilevel_reduce_scatter`` for the chunk layout."""
    return multilevel_reduce_scatter(
        x, [(inner_axis, inner_size), (outer_axis, outer_size)], decision,
        op=op, level_keys=[inner_level, outer_level])


def hierarchical_all_gather(
    x,
    inner_axis: str,
    inner_size: int,
    outer_axis: str,
    outer_size: int,
    decision: Optional[DecisionSource] = None,
    *,
    inner_level=0,
    outer_level=-1,
):
    """all-gather(outer) -> all-gather(inner); the exact inverse of
    ``hierarchical_reduce_scatter``."""
    return multilevel_all_gather(
        x, [(inner_axis, inner_size), (outer_axis, outer_size)], decision,
        level_keys=[inner_level, outer_level])


def sync_gradients_hierarchical(
    grads,
    inner_axis: str,
    inner_size: int,
    outer_axis: str,
    outer_size: int,
    decision: Optional[DecisionSource] = None,
    *,
    mean: bool = True,
    inner_level=0,
    outer_level=-1,
):
    """Two-level all-reduce of every gradient leaf — the multi-pod
    replacement for flat sync + cross-pod psum. Runs inside every rank
    of the mesh."""
    return sync_gradients_multilevel(
        grads, [(inner_axis, inner_size), (outer_axis, outer_size)],
        decision, mean=mean, level_keys=[inner_level, outer_level])
