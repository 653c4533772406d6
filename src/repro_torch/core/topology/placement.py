"""A copy of ``repro/core/topology/placement.py``. ``MeshMapping.apply``
and ``build_mesh`` rebuild the port's mesh, a
`repro_torch.core.collectives.group.RankMesh`, whose "devices" are the
default group's ranks sorted by rank. The reference's text follows.

Tuned logical→physical mesh mapping: device placement as a search
dimension.

`make_production_mesh` used to take the mesh axis order as given, so
which physical fabric tier each logical axis rides was fixed input — a
wrong assignment pays DCN latency for every gradient byte no matter how
well the per-collective algorithms are tuned. The exemplars (lingvo
``partitioning.py``, JAX ``mesh_utils.py``) instead rank logical axes by
network intensity and map the hottest axis onto the highest-bandwidth
physical plane, including the contiguous/transposed device-assignment
tricks. This module makes that choice searchable and reproducible:

  * `MeshMapping` — one candidate logical→physical assignment: the mesh
    axis names and shape (construction order, outermost first) plus a
    flattened ``device_order`` (which physical device fills each mesh
    slot, indices into the id-sorted device list). Placement lives
    ENTIRELY in ``device_order`` — axis names and shape stay canonical,
    so every consumer keyed on axis names keeps working unchanged.
  * `enumerate_mappings` — candidate generation: the machine's tier
    fan-outs (plus any model-parallel factor below them) are prime-split
    into physical factors, and every distinct innermost-first ordering
    of those factors that tiles the mesh axes becomes one candidate
    (the mesh_utils transpose trick generalized), pruned by symmetry —
    two orderings that only swap same-size factors on the same tier are
    one candidate, and candidates repeating an already-seen per-axis
    tier signature are dropped.
  * `price_mapping` — each candidate priced on its FULL tuned workload:
    the N-level `padded_allreduce_schedule` gradient sync over the sync
    axes and the KB-regime decode all-reduces over the "model" axis,
    every phase costed through the existing
    `analytical/hierarchy.modeled_phase_cost` closure against the
    (probed) per-level `NetworkProfile`s. The identity mapping prices
    EXACTLY equal to the plain hierarchy walk — same closure, same
    per-level models — so placement search composes with, never forks
    from, the rest of the cost stack.
  * `sweep_mappings` — enumerate + price + argmin; the winner persists
    in ``TableMeta.mapping`` (``tune.tune_mesh_mapping``) so
    `Communicator.create` rebuilds the exact winning mesh at load
    (PICO: the choice must live in the artifact, not a launch script).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.analytical.base import Hockney
from repro_torch.core.analytical.hierarchy import (
    modeled_phase_cost,
    padded_allreduce_schedule,
)
from repro_torch.core.topology.model import SYNC_AXES, Topology
from repro_torch.core.tuning.simulator import NetworkProfile

#: KB-regime message sizes the decode workload prices (the small-message
#: end of the serving grid — one token's activations per fan-out)
DECODE_PRICE_SIZES = (1024, 4096, 16384, 65536)

#: gradient-leaf byte mix priced when the caller has no real tree: eight
#: representative leaves spanning bias-to-matmul scales
DEFAULT_GRAD_LEAF_BYTES = tuple(4096 * 4 ** i for i in range(8))


@dataclasses.dataclass(frozen=True)
class Workload:
    """What a mapping is priced on: the gradient-sync leaf mix (bytes,
    synced over every sync axis) and the decode message sizes (bytes,
    all-reduced over the "model" axis when the mesh carries one)."""

    grad_leaf_bytes: Tuple[int, ...] = DEFAULT_GRAD_LEAF_BYTES
    decode_bytes: Tuple[int, ...] = DECODE_PRICE_SIZES


@dataclasses.dataclass(frozen=True)
class MeshMapping:
    """One logical→physical assignment, serializable into an artifact.

    ``axes``/``shape`` are the mesh construction order (outermost
    first); ``device_order[i]`` is the physical device (index into the
    id-sorted device list) filling flat mesh slot ``i`` (row-major over
    ``shape``). ``tiers`` records which topology level each axis ended
    up riding (axis name -> level name, informational); ``cost`` the
    modeled workload seconds the sweep priced it at."""

    axes: Tuple[str, ...]
    shape: Tuple[int, ...]
    device_order: Tuple[int, ...]
    tiers: Optional[Dict[str, str]] = None
    cost: Optional[float] = None

    def __post_init__(self):
        n = 1
        for s in self.shape:
            n *= s
        if len(self.axes) != len(self.shape):
            raise ValueError(f"mapping has {len(self.axes)} axes but "
                             f"{len(self.shape)} shape entries")
        if sorted(self.device_order) != list(range(n)):
            raise ValueError(
                f"mapping device_order must be a permutation of 0..{n - 1}"
                f" (shape {self.shape}); got {len(self.device_order)} "
                "entries")

    @property
    def is_identity(self) -> bool:
        return tuple(self.device_order) == tuple(range(len(
            self.device_order)))

    def summary(self) -> str:
        """The one-line rendering ``describe()``/``--explain`` print."""
        order = "identity" if self.is_identity else "tuned-order"
        parts = [f"{a}->{(self.tiers or {}).get(a, '?')}"
                 for a in self.axes]
        cost = f" cost={self.cost * 1e6:.1f}us" \
            if self.cost is not None else ""
        return f"{order} ({', '.join(parts)}){cost}"

    # -- mesh (re)construction ----------------------------------------------
    def apply(self, mesh):
        """Rebuild ``mesh`` (a `group.RankMesh`) with this mapping's rank
        order — the load path of an artifact-carried mapping. The
        incoming mesh must be the same logical mesh (axis names + shape
        + rank count); mismatches raise with the offending values. The
        identity mapping returns the mesh untouched (mapping-free
        behaviour). Like any `RankMesh`, the rebuilt one is collective:
        every rank applies the mapping in lockstep."""
        got_axes = tuple(mesh.axis_names)
        if got_axes != self.axes:
            raise ValueError(
                f"artifact mapping is for mesh axes {self.axes} but the "
                f"launch built {got_axes}; rebuild the mesh with the "
                "mapping's axes (or retune with --tune-mapping)")
        got_shape = tuple(int(mesh.shape[a]) for a in self.axes)
        if got_shape != self.shape:
            raise ValueError(
                f"artifact mapping is for mesh shape {self.shape} but the "
                f"launch built {got_shape} over axes {self.axes}; the "
                "mapping was tuned for a different machine size")
        if self.is_identity:
            return mesh
        return self.build_mesh(np.asarray(mesh.ranks).reshape(-1),
                               device=getattr(mesh, "device", None),
                               timeout_s=getattr(mesh, "timeout_s", None))

    def build_mesh(self, devices=None, *, device=None, timeout_s=None):
        """The mapped `group.RankMesh` over ``devices`` (default: every
        rank of the default process group), sorted by rank then
        permuted by ``device_order``: flat slot ``i`` holds rank
        ``sorted(devices)[device_order[i]]``."""
        from repro_torch.core.collectives import group
        if devices is None:
            devices = range(group.size())
        devs = _sorted_devices(list(devices))
        if len(devs) != len(self.device_order):
            raise ValueError(
                f"mapping covers {len(self.device_order)} devices but "
                f"{len(devs)} are attached")
        order = [int(devs[phys]) for phys in self.device_order]
        kw = {} if timeout_s is None else {"timeout_s": timeout_s}
        return group.RankMesh(self.shape, self.axes, device=device,
                              device_order=order, **kw)

    # -- serialization (the TableMeta.mapping field) ------------------------
    def to_json(self) -> dict:
        d = {"axes": list(self.axes), "shape": list(self.shape),
             "device_order": [int(i) for i in self.device_order]}
        if self.tiers is not None:
            d["tiers"] = dict(self.tiers)
        if self.cost is not None:
            d["cost"] = float(self.cost)
        return d

    @classmethod
    def from_json(cls, d: dict) -> "MeshMapping":
        return cls(axes=tuple(d["axes"]), shape=tuple(int(s)
                                                      for s in d["shape"]),
                   device_order=tuple(int(i) for i in d["device_order"]),
                   tiers=dict(d["tiers"]) if d.get("tiers") else None,
                   cost=d.get("cost"))


def _sorted_devices(devices) -> list:
    """Canonical physical order: the ranks sorted (the reference sorts
    jax devices by id)."""
    return sorted(int(d) for d in devices)


def identity_mapping(axes: Sequence[str], shape: Sequence[int],
                     topology: Optional[Topology] = None,
                     ) -> MeshMapping:
    """Today's construction order as a MeshMapping (device_order is
    arange — exactly what ``group.RankMesh`` does by default)."""
    n = 1
    for s in shape:
        n *= int(s)
    m = MeshMapping(tuple(axes), tuple(int(s) for s in shape),
                    tuple(range(n)))
    if topology is not None:
        m = dataclasses.replace(m, tiers=_tier_names(topology, m))
    return m


# ---------------------------------------------------------------------------
# the physical machine: tier group sizes and per-axis effective tiers
# ---------------------------------------------------------------------------
def tier_group_sizes(topology: Topology, n_devices: int
                     ) -> Tuple[int, ...]:
    """Innermost-first physical group sizes: devices ``i`` and ``j``
    share a tier-k group (and every slower tier above it) iff
    ``i // g_k == j // g_k``. A model-parallel factor (``n_devices``
    exceeding the topology's sync total) sits INSIDE the innermost
    tier's groups — tensor-parallel ranks share the fastest links."""
    total = topology.total_size
    if n_devices % total:
        raise ValueError(
            f"{n_devices} devices do not tile the topology's "
            f"{total} sync ranks ({'x'.join(str(lv.size) for lv in reversed(topology.levels))})")
    mp = n_devices // total
    sizes, g = [], mp
    for lv in topology.levels:
        g *= lv.size
        sizes.append(g)
    return tuple(sizes)


def link_tier(groups: Sequence[int], devices: Sequence[int]) -> int:
    """The fabric tier a collective over ``devices`` (flat physical
    indices) synchronizes on: the innermost tier whose groups still
    contain ALL of them — any schedule over the set must cross that
    tier's links."""
    for k, g in enumerate(groups):
        if len({d // g for d in devices}) == 1:
            return k
    return len(groups) - 1


def axis_tiers(mapping: MeshMapping, topology: Topology
               ) -> Dict[str, int]:
    """Effective tier per mesh axis under ``mapping``: the worst
    `link_tier` over the axis's device lines (every combination of the
    other coordinates). Works for ARBITRARY device orders — scrambles
    included — not just factor permutations."""
    groups = tier_group_sizes(topology, len(mapping.device_order))
    grid = np.asarray(mapping.device_order).reshape(mapping.shape)
    out: Dict[str, int] = {}
    for d, axis in enumerate(mapping.axes):
        if mapping.shape[d] == 1:
            out[axis] = 0
            continue
        lines = np.moveaxis(grid, d, -1).reshape(-1, mapping.shape[d])
        out[axis] = max(link_tier(groups, line) for line in lines)
    return out


def _tier_names(topology: Topology, mapping: MeshMapping
                ) -> Dict[str, str]:
    names = topology.names()
    return {a: names[t] for a, t in axis_tiers(mapping, topology).items()}


# ---------------------------------------------------------------------------
# pricing: the full tuned workload through modeled_phase_cost
# ---------------------------------------------------------------------------
def profile_model(profile: NetworkProfile) -> Hockney:
    """The analytical model a level's (probed) NetworkProfile prices
    under — the same alpha/beta the residual and tuning stacks fit."""
    return Hockney(alpha=profile.launch, beta=profile.byte_time)


def price_mapping(topology: Topology, mapping: MeshMapping,
                  workload: Optional[Workload] = None) -> float:
    """Modeled seconds of the full tuned workload under ``mapping``.

    Gradient sync: every sync axis present on the mesh becomes one
    level of the N-level composition (innermost first), priced at the
    topology tier its device lines actually ride; each leaf walks the
    same `padded_allreduce_schedule` the executor dispatches, phase by
    phase through `modeled_phase_cost`. Decode: each KB-regime message
    is one flat all-reduce over the "model" axis at ITS mapped tier.
    Under the identity mapping every sync axis rides its own tier, so
    this reduces EXACTLY to the plain hierarchy walk."""
    workload = workload or Workload()
    tiers = axis_tiers(mapping, topology)
    total = 0.0

    sync = [a for a in SYNC_AXES if a in mapping.axes]
    if sync:
        sizes = [mapping.shape[mapping.axes.index(a)] for a in sync]
        levels = [(p, profile_model(topology.levels[tiers[a]].profile))
                  for a, p in zip(sync, sizes)]
        cost = modeled_phase_cost(levels)
        for m in workload.grad_leaf_bytes:
            for lvl, op, in_elems, _ in padded_allreduce_schedule(
                    sizes, int(m)):
                total += cost(lvl, op, in_elems)[0]

    if "model" in mapping.axes:
        p = mapping.shape[mapping.axes.index("model")]
        if p > 1:
            lv = [(p, profile_model(topology.levels[tiers["model"]]
                                    .profile))]
            cost = modeled_phase_cost(lv)
            for m in workload.decode_bytes:
                total += cost(0, "all_reduce", int(m))[0]
    return total


# ---------------------------------------------------------------------------
# candidate enumeration (factor permutations, symmetry-pruned)
# ---------------------------------------------------------------------------
def _prime_factors(n: int) -> List[int]:
    out, d = [], 2
    while n > 1:
        while n % d == 0:
            out.append(d)
            n //= d
        d += 1 if d == 2 else 2
    return out


def _physical_factors(topology: Topology, n_devices: int
                      ) -> List[Tuple[int, int]]:
    """Innermost-first ``(size, tier)`` prime factors of the machine: a
    model-parallel factor splits tier 0's groups from below, then each
    tier's fan-out. Their canonical order IS the identity layout."""
    total = topology.total_size
    if n_devices % total:
        raise ValueError(
            f"{n_devices} devices do not tile the topology's "
            f"{total} sync ranks "
            f"({'x'.join(str(lv.size) for lv in reversed(topology.levels))})")
    mp = n_devices // total
    factors = [(f, 0) for f in _prime_factors(mp)]
    for k, lv in enumerate(topology.levels):
        factors.extend((f, k) for f in _prime_factors(lv.size))
    return factors


def _distinct_orderings(factors: List[Tuple[int, int]]
                        ) -> List[List[Tuple[int, int]]]:
    """Distinct permutations of the (size, tier) multiset — swapping two
    equal factors on the same tier changes nothing, so only one
    representative survives (the symmetry pruning)."""
    out: List[List[Tuple[int, int]]] = []

    def rec(remaining: List[Tuple[int, int]],
            acc: List[Tuple[int, int]]):
        if not remaining:
            out.append(list(acc))
            return
        seen = set()
        for i, f in enumerate(remaining):
            if f in seen:
                continue
            seen.add(f)
            rec(remaining[:i] + remaining[i + 1:], acc + [f])

    rec(factors, [])
    return out


def _split_ordering(ordering: List[Tuple[int, int]],
                    sizes_in_first: List[int]
                    ) -> Optional[List[List[Tuple[int, int]]]]:
    """Tile an innermost-first factor ordering onto innermost-first axis
    sizes: each axis takes a contiguous run whose product matches its
    size exactly, or the ordering does not fit this mesh."""
    runs, i = [], 0
    for size in sizes_in_first:
        run, prod = [], 1
        while prod < size:
            if i >= len(ordering):
                return None
            prod *= ordering[i][0]
            run.append(ordering[i])
            i += 1
        if prod != size:
            return None
        runs.append(run)
    return runs if i == len(ordering) else None


def enumerate_mappings(topology: Topology, axes: Sequence[str],
                       shape: Sequence[int],
                       n_devices: Optional[int] = None
                       ) -> List[MeshMapping]:
    """Candidate logical→physical mappings for a mesh over ``topology``.

    Every distinct innermost-first ordering of the machine's prime
    physical factors that tiles the mesh axes becomes one candidate;
    orderings whose per-axis tier signature was already produced are
    dropped (pricing is a function of the signature, so they cannot
    beat the representative). The identity layout is always first."""
    axes = tuple(axes)
    shape = tuple(int(s) for s in shape)
    n = n_devices or int(np.prod(shape))
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} covers "
                         f"{int(np.prod(shape))} devices, not {n}")
    factors = _physical_factors(topology, n)
    sizes_in_first = list(reversed(shape))
    phys_shape = tuple(f for f, _ in reversed(factors))  # outermost first
    k = len(factors)
    base = np.arange(n).reshape(phys_shape) if k else np.arange(n)

    out: List[MeshMapping] = []
    seen_sig = set()
    orderings = _distinct_orderings(factors)
    # canonical order first, so the identity survives the signature prune
    orderings.sort(key=lambda o: o != factors)
    for ordering in orderings:
        if _split_ordering(ordering, sizes_in_first) is None:
            continue
        # transpose the physical grid so the ordering's factors become
        # the mesh dims (outermost first), then flatten row-major
        canon_idx = {}
        remaining = list(enumerate(factors))
        perm = []
        for f in reversed(ordering):                 # outermost first
            # equal factors are interchangeable; taking the outermost
            # remaining one makes the canonical ordering the identity
            j = max(i for i, (ci, cf) in enumerate(remaining)
                    if cf == f)
            ci, _ = remaining.pop(j)
            perm.append(k - 1 - ci)                  # canonical dim in base
        order = tuple(int(i) for i in
                      base.transpose(perm).reshape(-1))
        m = MeshMapping(axes, shape, order)
        sig = tuple(sorted(axis_tiers(m, topology).items()))
        if sig in seen_sig:
            continue
        seen_sig.add(sig)
        out.append(dataclasses.replace(m, tiers=_tier_names(topology, m)))
    if not any(c.is_identity for c in out):
        out.insert(0, identity_mapping(axes, shape, topology))
    return out


def sweep_mappings(topology: Topology, axes: Sequence[str],
                   shape: Sequence[int], *,
                   n_devices: Optional[int] = None,
                   workload: Optional[Workload] = None
                   ) -> Tuple[MeshMapping, List[MeshMapping]]:
    """Enumerate + price + argmin: ``(winner, all candidates)``, every
    candidate carrying its modeled cost. Ties prefer the identity (no
    reason to scramble devices for nothing), then the first candidate
    in enumeration order (deterministic)."""
    cands = [dataclasses.replace(c, cost=price_mapping(topology, c,
                                                       workload))
             for c in enumerate_mappings(topology, axes, shape,
                                         n_devices)]
    best = min(cands, key=lambda c: (c.cost, not c.is_identity))
    return best, cands
