"""`Communicator`: one tuned-collective API owning probe -> select ->
decide -> dispatch (port of ``repro/comms/communicator.py``).

The reference builds it over a ``jax.sharding.Mesh`` and runs the op
methods inside ``shard_map``. The port builds it over a
`repro_torch.core.collectives.group.RankMesh` and runs them inside every
rank: an axis name resolves to this rank's sub-group along that axis
(``mesh.axis(name)``), and each ``jax.lax.psum(out, outer)`` of the flat
path becomes ``group.psum`` over the outer axis's sub-group. Requests,
plans and trace spans carry axis names, as the reference's do.

The backward-overlapped release path (`release_sink`,
``_sync_release``, `sync_gradients_streamed`,
``explain_gradients(overlap_backward=True)``) walks the port's gradient
tree, whose ``layers`` are a list of per-layer dicts (the reference
stacks them): each release syncs one layer, whose tree has the
reference's structure, so the streamed plan is the reference's entry for
entry. The reference gets the overlap from XLA's scheduler; the port's
sink (``overlap=True``) hands each release to one `group.SyncThread` a
rank, which syncs the layers in release order on a CUDA stream of its
own while autograd runs the layers below, and returns the cotangent to
autograd untouched; `sync_gradients_streamed` joins the thread. Without
``overlap`` the sink syncs inside the backward and returns the synced
cotangent, as the reference's does. Both sum alike, so both give the
same bits. An artifact whose meta carries a tuned mesh mapping rebuilds
the `RankMesh` in the mapping's rank order (``MeshMapping.apply``), as
the reference rebuilds its ``Mesh``. The reference's text follows.

Constructed ONCE per launch, it resolves the whole decision stack that
call sites used to re-assemble by hand:

  1. **probe** — optionally time the live fabric
     (``repro_torch.comms.probe.probe_live_profile``);
  2. **select** — for a multi-backend schema-3 artifact, pick the
     `DecisionTable` whose recorded `NetworkProfile` best fits the probe
     (`MultiProfileArtifact.select`) instead of first-table-wins;
  3. **decide** — key every dispatch on a `CollectiveRequest` (the
     survey's richer feature vector), degrading to the legacy
     (op, nbytes, axis_size) 3-tuple for existing schema-2/3 artifacts;
  4. **dispatch** — execute the chosen {algorithm, segments} through the
     algorithm registry, flat or as an N-level hierarchical
     composition over the mesh's sync tiers (HiCCL / MagPIe-style).

Every decision is explainable: `explain(requests)` resolves through
EXACTLY the lookup path the executing ops use and returns a `PlanReport`
(PICO's explainability requirement).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

from repro_torch import pytree
from repro_torch.comms.bucketing import (
    BucketLayout,
    layer_slice_struct,
    split_release_tree,
)
from repro_torch.comms.report import PlanEntry, PlanReport
from repro_torch.comms.request import CollectiveRequest
from repro_torch.core.analytical.hierarchy import padded_allreduce_schedule
from repro_torch.core.collectives.algorithms import ALGORITHMS
from repro_torch.core.collectives import group as grp
from repro_torch.core.collectives.dispatch import CollectiveSpec, apply_collective
from repro_torch.core.collectives.hierarchical import (
    multilevel_all_gather,
    multilevel_all_reduce,
    multilevel_reduce_scatter,
    sync_gradients_multilevel,
)
from repro_torch.core.collectives.schedule import (
    build_pipeline_schedule,
    build_stream_schedule,
    execute_pipelined,
)
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import MetricsRegistry
#: gradient-sync mesh axes, innermost tier first — a mesh carrying any of
#: these is data-parallel over them ("data" inside the host/pod, "pod"
#: across pods, "dcn" across the WAN-class links)
from repro_torch.core.topology.model import SYNC_AXES

_XLA_SPEC = CollectiveSpec("xla", 1)

#: double-buffered permute streams per tier in the backward-overlapped
#: stream schedule — two in-flight chains so one bucket's stall doesn't
#: idle the tier (HiCCL striped pipelines)
N_STREAMS = 2


class _ReleaseSink:
    """Adopts gradient-release events during the backward.

    Installed via ``models.layers.release_scope`` around the forward and
    backward: each per-layer release point hands its cotangent here the
    moment autograd materializes it, and the sink syncs it through the
    communicator's full tuned composition (sum only: the data-parallel
    mean divides once at the end in ``sync_gradients_streamed``).
    ``events`` records the tags in release (backward) order, the deepest
    layer first; ``synced`` maps each tag to its summed tree.

    Without ``overlap`` the sync runs inside the backward and its result
    is the cotangent autograd carries on (the reference's form). With
    ``overlap`` the release hands the cotangent to one
    `group.SyncThread` (on ``device``'s own stream), returns it to
    autograd untouched, and `finish` joins the thread (``busy_s``: the
    thread's busy seconds). ``fingerprint``
    keeps `pytree.fingerprint` of each cotangent as released, before any
    sync (``fingerprints``)."""

    def __init__(self, comm: "Communicator", bucket_bytes: int = 0,
                 n_streams: int = N_STREAMS, *, overlap: bool = False,
                 device=None, fingerprint: bool = False):
        self.comm = comm
        self.bucket_bytes = int(bucket_bytes or 0)
        self.n_streams = int(n_streams)
        self.events: List[Tuple] = []
        self.synced: Dict[Tuple, object] = {}
        self.fingerprints: Optional[Dict[Tuple, list]] = {} \
            if fingerprint else None
        self.thread = grp.SyncThread(device) if overlap else None
        self.busy_s = 0.0

    def _sync(self, tag, r: int, ct, rec):
        if rec is None:
            out = self.comm._sync_release(ct, self.bucket_bytes)
        else:
            with obs_trace.installed(rec), rec.tags(release=r):
                out = self.comm._sync_release(ct, self.bucket_bytes)
        self.synced[tag] = out
        return out

    def release(self, tag, ct):
        self.events.append(tag)
        r = len(self.events) - 1
        if self.fingerprints is not None:
            self.fingerprints[tag] = pytree.fingerprint(ct)
        rec = obs_trace.active() or self.comm.trace
        if rec is not None:
            rec.note_release(tag, r, self.n_streams)
        if self.thread is None:
            return self._sync(tag, r, ct, rec)
        self.thread.submit(self._sync, tag, r, ct, rec)
        return ct

    def finish(self) -> Dict[Tuple, object]:
        """Wait for the overlapped syncs (a no-op without overlap);
        returns ``synced``."""
        if self.thread is not None:
            thread, self.thread = self.thread, None
            thread.join()
            self.busy_s = thread.busy_s
        return self.synced


def _supported(op: str, algorithm: str) -> bool:
    return algorithm in ALGORITHMS.get(op, {})


# ---------------------------------------------------------------------------
# decision policies (internal): each resolves one flat request
# ---------------------------------------------------------------------------
class _XlaPolicy:
    kind = "xla"

    def resolve(self, req: CollectiveRequest) -> PlanEntry:
        return PlanEntry(req, _XLA_SPEC, source="xla")

    def level_spec(self, level, op, nbytes, p) -> CollectiveSpec:
        return _XLA_SPEC

    def describe(self) -> str:
        return "xla"


class _StaticPolicy:
    """Fixed algorithm; segment count derived PER LEAF as
    ceil(nbytes / segment_bytes) — a 64 MB gradient pipelines in more
    slices than a 4 KB bias, which one frozen segment count cannot
    express."""

    kind = "static"

    def __init__(self, algorithm: str, segment_bytes: int = 0,
                 spec: Optional[CollectiveSpec] = None):
        self.algorithm = algorithm
        self.segment_bytes = max(0, int(segment_bytes))
        self.spec = spec.normalized() if spec else None

    def resolve(self, req: CollectiveRequest) -> PlanEntry:
        if self.spec is not None:
            spec, src = self.spec, "static"
        else:
            segments = 1 if not self.segment_bytes else max(
                1, math.ceil(req.nbytes / self.segment_bytes))
            spec, src = CollectiveSpec(self.algorithm, segments), "static"
        if not _supported(req.op, spec.algorithm):
            # a static gradient algorithm ("ring") need not exist for every
            # op the facade serves (e.g. broadcast); degrade loudly in the
            # plan rather than KeyError at trace time
            return PlanEntry(req, _XLA_SPEC, source="static(xla-fallback)")
        return PlanEntry(req, spec, source=src)

    def level_spec(self, level, op, nbytes, p) -> CollectiveSpec:
        return self.resolve(CollectiveRequest(op, nbytes, axis_size=p)).spec

    def describe(self) -> str:
        if self.spec is not None:
            return f"static:{self.spec.algorithm}/seg={self.spec.segments}"
        seg = f"/segment_bytes={self.segment_bytes}" if self.segment_bytes \
            else ""
        return f"static:{self.algorithm}{seg}"


class _TablePolicy:
    """One flat `DecisionTable` — schema-2, legacy, or the profile selected
    out of a multi-backend schema-3 artifact."""

    kind = "table"

    def __init__(self, table, profile_name: str = "default",
                 probed: bool = False):
        self.table = table
        self.profile_name = profile_name
        self.probed = probed

    def resolve(self, req: CollectiveRequest) -> PlanEntry:
        op, nbytes, p = req.key3()
        meth = self.table.decide(op, p, nbytes)
        spec = CollectiveSpec(meth.algorithm, meth.segments).normalized()
        tuner = self.table.meta.tuner if self.table.meta else "?"
        return PlanEntry(req, spec, source=f"table:{tuner}")

    def level_spec(self, level, op, nbytes, p) -> CollectiveSpec:
        return self.resolve(CollectiveRequest(op, nbytes, axis_size=p)).spec

    def describe(self) -> str:
        meta = self.table.meta
        sel = f", profile={self.profile_name}" + \
            (" [probed]" if self.probed else "") \
            if self.profile_name != "default" or self.probed else ""
        if meta:
            return (f"tuner={meta.tuner} n_experiments={meta.n_experiments} "
                    f"penalty={meta.penalty}{sel}")
        return f"table{sel}"


#: which topology level carries each mesh axis's collectives, for
#: artifacts whose levels use the canonical names
_AXIS_LEVEL = {"model": "intra_host", "data": "intra_pod",
               "pod": "cross_pod", "dcn": "cross_pod"}


def _meta_schedule(policy) -> Optional[dict]:
    """The tuned gradient-sync schedule an artifact carries (innermost
    table wins for hierarchical artifacts), or None — pre-schedule
    artifacts keep the sequential per-leaf path."""
    if policy.kind == "table":
        meta = policy.table.meta
        return meta.schedule if meta else None
    if policy.kind == "hier":
        for _, table in policy.hier.levels:
            if table.meta is not None and table.meta.schedule:
                return table.meta.schedule
    return None


def _meta_programs(policy) -> List[dict]:
    """Serialized synthesized programs the artifact carries (all levels
    of a hierarchical artifact), [] for pre-synthesis artifacts."""
    out: List[dict] = []
    if policy.kind == "table":
        meta = policy.table.meta
        out.extend(meta.programs or () if meta else ())
    elif policy.kind == "hier":
        for _, table in policy.hier.levels:
            if table.meta is not None and table.meta.programs:
                out.extend(table.meta.programs)
    return out


def _meta_mapping(policy) -> Optional[dict]:
    """The swept logical→physical mesh mapping an artifact carries
    (innermost table wins for hierarchical artifacts — the sweep stamps
    every level identically), or None — pre-placement artifacts leave
    the mesh in default device order."""
    if policy.kind == "table":
        meta = policy.table.meta
        return meta.mapping if meta else None
    if policy.kind == "hier":
        for _, table in policy.hier.levels:
            if table.meta is not None and table.meta.mapping:
                return table.meta.mapping
    return None


class _HierPolicy:
    """A `HierarchicalDecision`: one table per topology level. A flat
    request answers from the level that carries its mesh axis (a 3-level
    artifact's intra_host tier serves the "model" axis, not the data
    axis's intra_pod), falling back to the innermost table;
    ``level``-pinned requests and the composition phases address their
    own level."""

    kind = "hier"

    def __init__(self, hier, topology=None):
        self.hier = hier
        self.topology = topology

    def _level_name(self, level) -> str:
        names = self.hier.names()
        return names[level] if isinstance(level, int) else level

    def _level_for(self, req: CollectiveRequest) -> Union[int, str]:
        if req.level is not None:
            return req.level
        names = self.hier.names()
        axis = req.axis if isinstance(req.axis, str) else None
        if axis is not None:
            if self.topology is not None:
                for lv in self.topology.levels:
                    if lv.axis == axis and lv.name in names:
                        return lv.name
            mapped = _AXIS_LEVEL.get(axis)
            if mapped in names:
                return mapped
        return 0

    def level_keys(self, axes: Sequence[str]) -> List[Union[int, str]]:
        """Which artifact level answers each composition axis (innermost
        first). An attached `Topology` maps axes to levels exactly; a
        full-stack composition — the innermost-first sync tiers, as many
        axes as the artifact has levels (gradient sync by construction) —
        maps positionally; otherwise the canonical axis names decide,
        falling back to position with the composition's outermost axis
        pinned to the artifact's outermost level."""
        names = self.hier.names()
        full_stack = len(names) == len(axes) \
            and tuple(axes) == SYNC_AXES[:len(axes)]
        out: List[Union[int, str]] = []
        for i, ax in enumerate(axes):
            level: Optional[Union[int, str]] = None
            if self.topology is not None:
                for lv in self.topology.levels:
                    if lv.axis == ax and lv.name in names:
                        level = lv.name
                        break
            if level is None and full_stack:
                level = i
            if level is None:
                mapped = _AXIS_LEVEL.get(ax)
                if mapped in names:
                    level = mapped
                elif i == len(axes) - 1:
                    # a partial composition's outermost phase belongs on
                    # the machine-spanning table, wherever it sits
                    level = len(names) - 1
                else:
                    level = min(i, len(names) - 1)
            out.append(level)
        return out

    def resolve(self, req: CollectiveRequest) -> PlanEntry:
        level = self._level_for(req)
        op, nbytes, p = req.key3()
        spec = self.hier.spec_for_level(level, op, nbytes, p)
        name = self._level_name(level)
        return PlanEntry(req, spec, level=name, source=f"hier:{name}")

    def level_spec(self, level, op, nbytes, p) -> CollectiveSpec:
        return self.hier.spec_for_level(level, op, nbytes, p)

    def describe(self) -> str:
        return f"hierarchical, levels={self.hier.names()}"


# ---------------------------------------------------------------------------
class Communicator:
    """The single tuned-collective entry point.

    Build once per launch with :meth:`create` (or :meth:`from_config` from
    a `CollectiveConfig`), then call the op methods in every rank; they
    look up each `CollectiveRequest` at call time and execute the chosen
    wire schedule. `sync_gradients` is the tree-level gradient path that
    internally picks flat, psum-topped, or the full hierarchical
    composition.
    """

    def __init__(self, mesh=None, *, policy=None, topology=None,
                 probed=None, probed_topology=None,
                 a2a_algorithm: str = "xla",
                 artifact_path: Optional[str] = None,
                 bucket_bytes: int = 0, trace=None, mapping=None):
        self.mesh = mesh
        #: the artifact's tuned logical→physical `MeshMapping` (already
        #: applied to ``mesh`` by `create`), or None when the mesh
        #: stands in default rank order (mapping-free artifacts)
        self.mapping = mapping
        self.topology = topology
        #: optional `repro_torch.obs.TraceRecorder` — installed around every
        #: dispatch root so traced launches need no explicit scoping
        self.trace = trace
        #: runtime counters (decision-cache hits/misses, ...); the
        #: recorder keeps its own wire counters (bytes per tier)
        self.metrics = MetricsRegistry()
        self.probed = probed
        self.probed_topology = probed_topology
        self._policy = policy or _XlaPolicy()
        self._a2a = a2a_algorithm or "xla"
        self.artifact_path = artifact_path
        #: fusion-bucket budget for `sync_gradients` (0 = per-leaf path);
        #: resolved from the artifact's tuned schedule by `create`, or
        #: forced by the caller (--bucket-mb)
        self.bucket_bytes = int(bucket_bytes or 0)
        axes = set(mesh.axis_names) if mesh is not None else set()
        #: gradient-sync axes present on the mesh, innermost tier first
        self._sync_axes: Tuple[str, ...] = tuple(
            a for a in SYNC_AXES if a in axes)
        self._inner_axis = "data" if "data" in axes else None
        # decision-resolution caches: a 200-leaf tree re-traces the same
        # handful of (op, nbytes, dtype, axes) requests hundreds of times
        # per step trace; the policy lookup (table decide + level-key
        # mapping) is pure given the frozen policy, so memoize it
        self._plan_cache: Dict[CollectiveRequest, PlanEntry] = {}
        self._level_spec_cache: Dict[Tuple, CollectiveSpec] = {}
        self._level_keys_cache: Dict[Tuple[str, ...], List] = {}

    # -- construction -------------------------------------------------------
    @classmethod
    def create(cls, mesh=None, *, topology=None, artifact=None,
               probe: bool = False, static: Optional[CollectiveSpec] = None,
               algorithm: str = "xla", segment_bytes: int = 0,
               a2a_algorithm: str = "xla", probed=None,
               bucket_bytes: Optional[int] = None,
               trace=None) -> "Communicator":
        """Resolve the full decision stack once.

        artifact      a schema-2/3 artifact path or an already-loaded
                      DecisionTable / HierarchicalDecision /
                      MultiProfileArtifact;
        probe         probe the live fabric and select the matching table
                      from a multi-backend artifact (``probed`` injects a
                      pre-measured NetworkProfile instead, e.g. in tests).
                      On a multi-level mesh the probe times one
                      representative device pair PER LEVEL (intra-host /
                      intra-pod / cross-pod) and synthesizes a full
                      ``Topology`` (kept as ``probed_topology``, and used
                      as the level map when no explicit ``topology`` is
                      given); table selection matches against the
                      innermost level's profile — the fabric the old
                      2-device probe measured;
        static        a fixed CollectiveSpec for every request;
        algorithm / segment_bytes
                      config-style static policy: fixed algorithm, segment
                      count derived per message as ceil(nbytes/segment_bytes);
        bucket_bytes  fusion-bucket budget for the bucketed,
                      overlap-pipelined `sync_gradients`. None (default)
                      adopts the artifact's tuned schedule when it
                      carries one; an explicit int forces it (0 disables
                      — the sequential per-leaf path);
        trace         a `repro_torch.obs.TraceRecorder` (or True for a fresh
                      one) recording schedule-keyed spans for every
                      dispatch; None (default) keeps the traced paths
                      bit-identical to the uninstrumented runtime.
        """
        from repro_torch.core.topology.decision import (
            HierarchicalDecision,
            MultiProfileArtifact,
        )
        from repro_torch.core.tuning.decision import DecisionTable

        probed_topology = None
        if probe and probed is None:
            from repro_torch.comms.probe import (
                probe_live_profile,
                probe_mesh_topology,
            )
            probed_topology = probe_mesh_topology(mesh) \
                if mesh is not None else None
            if probed_topology is not None:
                probed = probed_topology.inner.profile
                if topology is None:
                    topology = probed_topology
            else:
                probed = probe_live_profile()

        path = None
        if isinstance(artifact, str):
            path = artifact
            artifact = MultiProfileArtifact.load(artifact)
        if isinstance(artifact, MultiProfileArtifact) \
                and artifact.kind == "hierarchical":
            artifact = HierarchicalDecision(artifact.profiles)

        if isinstance(artifact, HierarchicalDecision):
            policy = _HierPolicy(artifact, topology=topology)
        elif isinstance(artifact, MultiProfileArtifact):
            by_probe = probed is not None and any(
                t.meta and t.meta.profile for _, t in artifact.profiles)
            if probed is not None and not by_probe:
                # nothing to match against (legacy / meta-less artifact):
                # the first table is the only sensible choice — keep the
                # launch alive rather than failing an optional probe flag
                import warnings
                warnings.warn(
                    "--probe-fabric: no profile in the artifact records a "
                    "fabric to match against; using the first table",
                    RuntimeWarning, stacklevel=2)
            if by_probe:
                name, table = artifact.select(probed)
            else:
                name, table = artifact.select(None)
            policy = _TablePolicy(table, name, probed=by_probe)
        elif isinstance(artifact, DecisionTable):
            policy = _TablePolicy(artifact)
        elif artifact is not None:
            raise TypeError(f"unsupported decision artifact: "
                            f"{type(artifact).__name__}")
        elif static is not None:
            policy = _StaticPolicy(static.algorithm, spec=static)
        elif algorithm != "xla":
            policy = _StaticPolicy(algorithm, segment_bytes)
        else:
            policy = _XlaPolicy()
        if bucket_bytes is None:
            sched = _meta_schedule(policy)
            bucket_bytes = int(sched.get("bucket_bytes", 0)) if sched \
                else 0
        carried = _meta_programs(policy)
        if carried:
            # rebuild the artifact's synthesized programs so its
            # synth:<name> rows dispatch (each re-passes the verifier)
            from repro_torch.core.collectives import synth
            synth.adopt_programs(carried)
        mapping = None
        mapdoc = _meta_mapping(policy)
        if mapdoc:
            # rebuild the exact mesh the placement sweep priced: same
            # axes, same shape, the tuned rank order
            from repro_torch.core.topology.placement import MeshMapping
            mapping = MeshMapping.from_json(mapdoc)
            if mesh is not None:
                if tuple(mesh.axis_names) != mapping.axes:
                    # a different logical mesh (e.g. a pure-TP ("model",)
                    # mesh loading a train-tuned artifact): the mapping
                    # doesn't apply — keep the launch alive
                    import warnings
                    warnings.warn(
                        f"artifact's mesh mapping targets axes "
                        f"{mapping.axes} but this launch built "
                        f"{tuple(mesh.axis_names)}; leaving the mesh "
                        "in default device order", RuntimeWarning,
                        stacklevel=2)
                    mapping = None
                else:
                    # same axes but a different machine size is a real
                    # misconfiguration — apply() raises naming both
                    mesh = mapping.apply(mesh)
        if trace is True:
            trace = obs_trace.TraceRecorder()
        return cls(mesh, policy=policy, topology=topology, probed=probed,
                   probed_topology=probed_topology,
                   a2a_algorithm=a2a_algorithm, artifact_path=path,
                   bucket_bytes=bucket_bytes, trace=trace,
                   mapping=mapping)

    @classmethod
    def from_config(cls, coll, mesh=None, *, topology=None,
                    probe: bool = False, probed=None) -> "Communicator":
        """Build from a `CollectiveConfig` (the step builders' entry; read
        by attribute: ``decision``, ``algorithm``, ``segment_bytes``,
        ``a2a_algorithm``, ``bucket_bytes``)."""
        return cls.create(
            mesh, topology=topology, artifact=coll.decision, probe=probe,
            probed=probed, algorithm=coll.algorithm,
            segment_bytes=coll.segment_bytes,
            a2a_algorithm=coll.a2a_algorithm,
            bucket_bytes=coll.bucket_bytes)

    # -- introspection ------------------------------------------------------
    @property
    def is_tuned(self) -> bool:
        """True when gradient sync must run the tuned dispatch path:
        any non-XLA decision source, or a fusion-bucket budget (bucketed
        sync fuses leaves even under the XLA lowering)."""
        return self._policy.kind != "xla" or bool(self.bucket_bytes)

    @property
    def hierarchical(self) -> bool:
        return self._policy.kind == "hier"

    def describe(self) -> str:
        # "[probed]" appears only where the probe influenced selection
        # (_TablePolicy appends it itself) — a hierarchical or static
        # policy never consults the probe
        d = self._policy.describe()
        if self._a2a != "xla":
            d += f", a2a={self._a2a}"
        if self.bucket_bytes:
            d += f", bucket_bytes={self.bucket_bytes}"
        if self.mapping is not None:
            d += f", mapping={self.mapping.summary()}"
        return d

    # -- decision resolution ------------------------------------------------
    def _resolve(self, req: CollectiveRequest) -> PlanEntry:
        """One flat request -> the entry that will execute (memoized: the
        policy is frozen, so resolution is pure in the request)."""
        hit = self._plan_cache.get(req)
        if hit is not None:
            self.metrics.inc("decision_cache_hit", label="plan")
            return hit
        self.metrics.inc("decision_cache_miss", label="plan")
        if req.op == "all_to_all" and self._a2a != "xla":
            # an explicit a2a algorithm (CLI / config) overrides the table:
            # the user pinned the MoE dispatch schedule deliberately
            entry = PlanEntry(req, CollectiveSpec(self._a2a, 1),
                              source="static:a2a")
        else:
            entry = self._policy.resolve(req)
        self._plan_cache[req] = entry
        return entry

    def spec(self, req: CollectiveRequest) -> CollectiveSpec:
        """The {algorithm, segments} this communicator executes for a flat
        request — the lookup every op method performs."""
        return self._resolve(req).spec

    # legacy DecisionSource protocol (duck-typed): lets the Communicator
    # drop into the per-level slots of the hierarchical compositions
    def spec_for(self, op: str, nbytes: int, axis_size: int
                 ) -> CollectiveSpec:
        return self.spec(CollectiveRequest(op, nbytes, axis_size=axis_size))

    def spec_for_level(self, level, op: str, nbytes: int, axis_size: int
                       ) -> CollectiveSpec:
        key = (level, op, int(nbytes), int(axis_size))
        hit = self._level_spec_cache.get(key)
        if hit is None:
            self.metrics.inc("decision_cache_miss", label="level_spec")
            hit = self._policy.level_spec(level, op, nbytes, axis_size)
            self._level_spec_cache[key] = hit
        else:
            self.metrics.inc("decision_cache_hit", label="level_spec")
        return hit

    # -- planning / explainability ------------------------------------------
    def _axis_sizes(self, axes: Sequence[str]) -> List[int]:
        if self.mesh is None:
            raise ValueError("multi-axis request needs a mesh")
        return [self.mesh.shape[a] for a in axes]

    def _level_keys(self, axes: Sequence[str]) -> List:
        """The decision-level address each composition axis dispatches
        against (innermost first); flat policies answer every level, so
        positional indices suffice there. Memoized per axes tuple (the
        mapping walks the topology; per-leaf re-derivation is waste)."""
        key = tuple(axes)
        hit = self._level_keys_cache.get(key)
        if hit is None:
            self.metrics.inc("decision_cache_miss", label="level_keys")
            hit = self._policy.level_keys(axes) \
                if self._policy.kind == "hier" else list(range(len(axes)))
            self._level_keys_cache[key] = hit
        else:
            self.metrics.inc("decision_cache_hit", label="level_keys")
        return list(hit)

    def _composition_entries(self, req: CollectiveRequest
                             ) -> List[PlanEntry]:
        """A multi-axis request's phases, with the exact byte counts the
        N-level compositions look up: the all-reduce phases walk the same
        ``padded_allreduce_schedule`` as ``multilevel_all_reduce``, and
        the reduce-scatter / all-gather arms mirror
        ``multilevel_reduce_scatter`` / ``multilevel_all_gather``."""
        axes = list(req.axis)
        sizes = self._axis_sizes(axes)
        keys = self._level_keys(axes)
        itemsize = pytree.itemsize(req.dtype)
        n = req.nbytes // itemsize

        if req.op == "all_reduce":
            phases = [(op, in_elems, axes[lvl], sizes[lvl], keys[lvl])
                      for lvl, op, in_elems, _ in
                      padded_allreduce_schedule(sizes, n)]
        elif req.op == "reduce_scatter":
            total = math.prod(sizes)
            cur = n + (-n) % total
            phases = []
            for ax, p, key in zip(axes, sizes, keys):
                phases.append(("reduce_scatter", cur, ax, p, key))
                cur //= p
        elif req.op == "all_gather":
            cur = n
            phases = []
            for ax, p, key in reversed(list(zip(axes, sizes, keys))):
                phases.append(("all_gather", cur, ax, p, key))
                cur *= p
        else:
            raise ValueError(f"no multi-axis composition for {req.op!r}")

        return [self._level_entry(
            CollectiveRequest(op, elems * itemsize, axis=axis, axis_size=p,
                              dtype=req.dtype, reduce_op=req.reduce_op,
                              level=level), level)
            for op, elems, axis, p, level in phases]

    def _level_entry(self, req: CollectiveRequest, level) -> PlanEntry:
        if self._policy.kind == "hier":
            spec = self.spec_for_level(level, req.op, req.nbytes,
                                       req.axis_size)
            name = self._policy._level_name(level)
            return PlanEntry(req, spec, level=name, source=f"hier:{name}")
        return self._policy.resolve(req)

    def plan(self, req: CollectiveRequest) -> List[PlanEntry]:
        """The entries that will execute for one request, in order — a
        two-axis request expands to its composition phases."""
        if req.hierarchical:
            return self._composition_entries(req)
        return [self._resolve(req)]

    def _mapping_header(self) -> Optional[str]:
        """The plan-report context line a placement-tuned artifact adds:
        which physical layout the rendered decisions assume."""
        return None if self.mapping is None \
            else f"mesh mapping: {self.mapping.summary()}"

    def explain(self, requests: Sequence[CollectiveRequest]) -> PlanReport:
        """Resolve requests through the exact lookup path the executing
        ops use; renders the per-leaf {algorithm, segments, level} plan
        (headed by the active mesh mapping when the artifact carries
        one)."""
        entries: List[PlanEntry] = []
        for req in requests:
            entries.extend(self.plan(req))
        return PlanReport(entries, self._mapping_header())

    def gradient_requests(self, tree) -> List[CollectiveRequest]:
        """One request per gradient leaf, shaped the way `sync_gradients`
        will dispatch it (N-axis composition over every sync tier on a
        hierarchical multi-level communicator, flat otherwise)."""
        out = []
        hier = self.hierarchical and len(self._sync_axes) > 1
        axis = tuple(self._sync_axes) if hier else self._inner_axis
        p = self._data_parallel_size() if hier else self._inner_size()
        for leaf in pytree.leaves(tree):
            nbytes = math.prod(leaf.shape) * pytree.itemsize(leaf.dtype)
            out.append(CollectiveRequest(
                "all_reduce", nbytes, axis=axis, axis_size=p,
                dtype=pytree.dtype_name(leaf.dtype)))
        return out

    # -- bucketed, overlap-pipelined gradient sync --------------------------
    def _bucket_plan(self, tree, bucket_bytes: int):
        """The shared layout + pipeline schedule behind the bucketed
        `sync_gradients` AND `explain_gradients`: fusion buckets over
        the tree, one ``padded_allreduce_schedule`` phase chain per
        bucket, software-pipelined across the sync tiers. Returns
        ``(layout, active, schedule, axes, sizes, keys, hier)`` where
        ``active`` indexes the non-empty buckets the schedule covers."""
        layout = BucketLayout.plan(tree, bucket_bytes)
        active = [i for i, b in enumerate(layout.buckets) if b.elems]
        hier = self.hierarchical and len(self._sync_axes) > 1
        axes = tuple(self._sync_axes) if hier else (self._inner_axis,)
        sizes = self._axis_sizes(axes)
        keys = self._level_keys(axes)
        sched = build_pipeline_schedule(
            [layout.buckets[i].elems for i in active], sizes)
        return layout, active, sched, axes, sizes, keys, hier

    def _resolve_bucket_bytes(self, bucket_bytes: Optional[int]) -> int:
        return self.bucket_bytes if bucket_bytes is None \
            else int(bucket_bytes)

    def explain_gradients(self, tree, *,
                          bucket_bytes: Optional[int] = None,
                          overlap_backward: bool = False,
                          measured=None) -> PlanReport:
        """The gradient-sync plan, exactly as it will execute.

        Without bucketing (no tuned schedule in the artifact and no
        override): per leaf, the full composition's phases at EVERY
        level of a hierarchical decision, or the flat tuned all-reduce
        plus one psum hop per remaining sync tier. With bucketing: the
        pipelined schedule's entries in ISSUE order — bucket k's inward
        phase between bucket k-1's deeper phases — each tagged with its
        fusion bucket and pipeline step. With ``overlap_backward``: the
        backward-overlapped stream schedule — one release event per
        layer in backward order (deepest layer first), each entry tagged
        ``release=``/``stream=``/``step=`` from the double-buffered
        stream DAG, followed by the residual (embeddings, ...) sync.

        ``measured`` overlays recorded timings onto the plan: a
        `repro_torch.obs.TraceRecorder` (or its span list) from a traced or
        replayed execution of this same schedule, matched span-by-span
        in issue order; matched entries render ``measured=..us``
        (entries the recorder never saw — e.g. psum tops — stay
        bare)."""
        report = self._explain_gradients_plan(
            tree, bucket_bytes=bucket_bytes,
            overlap_backward=overlap_backward)
        report = dataclasses.replace(report,
                                     header=self._mapping_header())
        if measured is not None:
            spans = getattr(measured, "spans", measured)
            report = report.with_measured(spans)
        return report

    def _explain_gradients_plan(self, tree, *,
                                bucket_bytes: Optional[int] = None,
                                overlap_backward: bool = False
                                ) -> PlanReport:
        if overlap_backward:
            return self._explain_gradients_streamed(
                tree, self._resolve_bucket_bytes(bucket_bytes))
        bb = self._resolve_bucket_bytes(bucket_bytes)
        if not bb:
            entries: List[PlanEntry] = []
            for req in self.gradient_requests(tree):
                entries.extend(self.plan(req))
                if not req.hierarchical:
                    for outer in self._sync_axes[1:]:
                        psum_req = CollectiveRequest(
                            "all_reduce", req.nbytes, axis=outer,
                            axis_size=self.mesh.shape[outer],
                            dtype=req.dtype)
                        entries.append(PlanEntry(psum_req, _XLA_SPEC,
                                                 source="psum"))
            return PlanReport(entries)

        if self._inner_axis is None:
            raise ValueError("sync_gradients needs a mesh with a 'data' "
                             "axis")
        layout, active, sched, axes, sizes, keys, hier = \
            self._bucket_plan(tree, bb)
        entries = []
        for t in sched.tasks:
            bucket = layout.buckets[active[t.bucket]]
            itemsize = pytree.itemsize(bucket.dtype)
            key = keys[t.level]
            req = CollectiveRequest(
                t.op, t.in_elems * itemsize, axis=axes[t.level],
                axis_size=sizes[t.level], dtype=bucket.dtype,
                level=key if self._policy.kind == "hier" else None)
            entry = self._level_entry(req, key)
            entries.append(dataclasses.replace(
                entry, bucket=active[t.bucket], step=t.step))
        if not hier:
            # the flat path tops each bucket with one psum per remaining
            # sync tier, after its pipeline chain drains
            for bi in active:
                bucket = layout.buckets[bi]
                for outer in self._sync_axes[1:]:
                    req = CollectiveRequest(
                        "all_reduce", bucket.nbytes, axis=outer,
                        axis_size=self.mesh.shape[outer],
                        dtype=bucket.dtype)
                    entries.append(PlanEntry(req, _XLA_SPEC, source="psum",
                                             bucket=bi))
        return PlanReport(entries)

    # -- dispatch -----------------------------------------------------------
    def _inner_size(self) -> int:
        return self.mesh.shape[self._inner_axis] if self._inner_axis else 1

    def _data_parallel_size(self) -> int:
        n = 1
        for a in self._sync_axes:
            n *= self.mesh.shape[a]
        return n

    def _levels_for(self, axes: Sequence[str]
                    ) -> List[Tuple[grp.Axis, int]]:
        """(sub-group, size) of each named axis, as the compositions take
        their levels."""
        return [(self.mesh.axis(a), p)
                for a, p in zip(axes, self._axis_sizes(axes))]

    def _axis_and_size(self, axis) -> Tuple[str, int]:
        if axis is None:
            axis = self._inner_axis
        if axis is None or self.mesh is None:
            raise ValueError("collective needs an axis (no mesh/data axis "
                             "attached to this Communicator)")
        return axis, self.mesh.shape[axis]

    def _traced(self):
        """Install this communicator's recorder around a dispatch root.
        A no-op without one (`obs_trace.installed(None)` leaves any
        externally installed recorder capturing), so every root can wrap
        itself unconditionally at zero cost."""
        return obs_trace.installed(self.trace)

    def _dispatch_flat(self, op, x, axis, *, reduce_op="add"):
        axis, p = self._axis_and_size(axis)
        req = CollectiveRequest.for_array(op, x, axis, p,
                                          reduce_op=reduce_op)
        with self._traced():
            return apply_collective(op, x, self.mesh.axis(axis), p,
                                    self.spec(req), reduce_op=reduce_op)

    def all_reduce(self, x, axis=None, *, reduce_op: str = "add"):
        """Tuned all-reduce of this rank's buffer. A
        multi-axis ``axis=(inner, ..., outer)`` runs the N-level
        reduce-scatter / all-reduce / all-gather composition."""
        if isinstance(axis, tuple):
            with self._traced():
                return multilevel_all_reduce(
                    x, self._levels_for(axis), self, op=reduce_op,
                    level_keys=self._level_keys(axis))
        return self._dispatch_flat("all_reduce", x, axis,
                                   reduce_op=reduce_op)

    def reduce_scatter(self, x, axis=None, *, reduce_op: str = "add"):
        """Tuned reduce-scatter (this rank's 1/p shard). A multi-axis
        ``axis`` composes reduce-scatter over every level, innermost
        first."""
        if isinstance(axis, tuple):
            with self._traced():
                return multilevel_reduce_scatter(
                    x, self._levels_for(axis), self, op=reduce_op,
                    level_keys=self._level_keys(axis))
        return self._dispatch_flat("reduce_scatter", x, axis,
                                   reduce_op=reduce_op)

    def all_gather(self, x, axis=None):
        """Tuned all-gather (p-times-larger concatenation). A multi-axis
        ``axis`` composes all-gather outermost-first (the inverse of the
        multi-axis reduce-scatter)."""
        if isinstance(axis, tuple):
            with self._traced():
                return multilevel_all_gather(
                    x, self._levels_for(axis), self,
                    level_keys=self._level_keys(axis))
        return self._dispatch_flat("all_gather", x, axis)

    def all_to_all(self, x, axis=None):
        """Tuned all-to-all on a (p, chunk...) buffer."""
        return self._dispatch_flat("all_to_all", x, axis)

    def broadcast(self, x, axis=None):
        """Tuned broadcast from rank 0."""
        return self._dispatch_flat("broadcast", x, axis)

    def a2a_algorithm_for(self, nbytes: int, axis: str, axis_size: int
                          ) -> str:
        """The all-to-all algorithm name for a dispatch buffer — the MoE
        exchange keeps its own layout plumbing and only needs the name."""
        return self.spec(CollectiveRequest("all_to_all", nbytes, axis=axis,
                                           axis_size=axis_size)).algorithm

    # -- tree-level gradient sync -------------------------------------------
    def sync_gradients(self, grads, *, mean: bool = True,
                       bucket_bytes: Optional[int] = None):
        """All-reduce every gradient leaf with its tuned algorithm,
        picking the schedule the communicator resolved to: the full
        N-level composition on a multi-tier mesh with a hierarchical
        artifact, otherwise the flat tuned sync with a plain psum per
        remaining tier on top. Runs inside every rank of the mesh.

        With a fusion-bucket budget (``bucket_bytes`` here, the
        artifact's tuned schedule, or --bucket-mb), the tree is
        coalesced into dtype-homogeneous buckets — one tuned collective
        per bucket instead of one per leaf — and the buckets
        software-pipeline through the tiers (`execute_pipelined` over
        the same schedule `explain_gradients` renders). Per bucket the
        phase order matches the sequential composition exactly, so the
        result is bit-identical to syncing each bucket alone; vs the
        per-leaf path only the fusion boundaries (hence float reduction
        order) differ."""
        if self._inner_axis is None:
            raise ValueError("sync_gradients needs a mesh with a 'data' "
                             "axis")
        denom = self._data_parallel_size()
        inner = self._inner_axis

        bb = self._resolve_bucket_bytes(bucket_bytes)
        if bb:
            with self._traced():
                return self._sync_gradients_bucketed(grads, bb, mean=mean,
                                                     denom=denom)

        if self.hierarchical and len(self._sync_axes) > 1:
            with self._traced():
                return sync_gradients_multilevel(
                    grads, self._levels_for(self._sync_axes), self,
                    mean=mean,
                    level_keys=self._level_keys(self._sync_axes))

        def sync_leaf(g):
            out = self._dispatch_flat("all_reduce", g, inner)
            for outer in self._sync_axes[1:]:
                out = grp.psum(out, self.mesh.axis(outer))
            if mean:
                out = out / denom
            return out

        return pytree.tree_map(sync_leaf, grads)

    def _sync_gradients_bucketed(self, grads, bucket_bytes: int, *,
                                 mean: bool, denom: int):
        """The bucketed, overlap-pipelined sync: flatten -> pipelined
        per-bucket composition -> (psum top for flat policies) ->
        unflatten bit-identically."""
        layout, active, sched, axes, sizes, keys, hier = \
            self._bucket_plan(grads, bucket_bytes)
        flats = layout.flatten(grads)
        if active:
            out = execute_pipelined(
                [flats[i] for i in active], sched,
                self._levels_for(axes), self, level_keys=keys)
            if not hier:
                for outer in self._sync_axes[1:]:
                    out = [grp.psum(f, self.mesh.axis(outer)) for f in out]
            if mean:
                out = [f / denom for f in out]
            for i, f in zip(active, out):
                flats[i] = f
        return layout.unflatten(flats)

    # -- backward-overlapped (streamed) gradient sync -----------------------
    def release_sink(self, bucket_bytes: Optional[int] = None,
                     n_streams: int = N_STREAMS, *, overlap: bool = False,
                     device=None, fingerprint: bool = False
                     ) -> _ReleaseSink:
        """A fresh gradient-release sink for one backward-overlapped
        step: install it with ``models.layers.release_scope`` around the
        forward and backward, then finish with
        :meth:`sync_gradients_streamed`. ``overlap`` syncs on a thread
        of this rank (on ``device``'s own CUDA stream) while the
        backward runs; see `_ReleaseSink`."""
        return _ReleaseSink(self, self._resolve_bucket_bytes(bucket_bytes),
                            n_streams, overlap=overlap, device=device,
                            fingerprint=fingerprint)

    def _sync_release(self, grads, bucket_bytes: int):
        """Sync ONE release event's cotangent (sum, no mean) through the
        full shape-preserving composition (reduce-scatter in, all-reduce
        at the top, all-gather back out), so every rank's layer gradient
        arrives reduced. ``bucket_bytes <= 0`` fuses the whole layer
        into one bucket per dtype. Non-float leaves pass through
        untouched."""
        flat, treedef = pytree.flatten(grads)
        idx = [i for i, leaf in enumerate(flat)
               if leaf.is_floating_point()]
        if len(idx) == len(flat):
            return self._sync_gradients_bucketed(
                grads, int(bucket_bytes), mean=False, denom=1)
        sub = {str(i): flat[i] for i in idx}
        synced = self._sync_gradients_bucketed(
            sub, int(bucket_bytes), mean=False, denom=1)
        for i in idx:
            flat[i] = synced[str(i)]
        return treedef.unflatten(flat)

    def sync_gradients_streamed(self, grads, sink: Optional[_ReleaseSink],
                                *, mean: bool = True,
                                bucket_bytes: Optional[int] = None):
        """Finish a backward-overlapped gradient sync.

        Waits for the sink's syncs, puts each released layer's summed
        gradients in place of the local ones (cast to the local leaf's
        dtype, as autograd casts a cotangent that crosses a cast),
        divides them by the data-parallel size, and syncs the RESIDUAL
        (embeddings, final norm — everything outside the released
        top-level keys) through the ordinary :meth:`sync_gradients`
        path. With no sink or no recorded events (a model without
        release points), falls back to the plain full-tree sync —
        numerics are identical either way, only the overlap is lost."""
        synced = sink.finish() if sink is not None else {}
        if sink is None or not sink.events:
            return self.sync_gradients(grads, mean=mean,
                                       bucket_bytes=bucket_bytes)
        denom = self._data_parallel_size()
        released_keys = {t[0] for t in sink.events}
        out = {k: v for k, v in grads.items() if k not in released_keys}
        if out:
            out = self.sync_gradients(out, mean=mean,
                                      bucket_bytes=bucket_bytes)
        for key in released_keys:
            layers = list(grads[key])
            missing = [i for i in range(len(layers))
                       if (key, i) not in synced]
            if missing:
                raise ValueError(f"layers {missing} of {key!r} passed no "
                                 f"release point")
            for i, local in enumerate(layers):
                summed = pytree.tree_map(
                    lambda s, g: s.to(g.dtype), synced[(key, i)], local)
                layers[i] = pytree.tree_map(lambda g: g / denom, summed) \
                    if mean and denom > 1 else summed
            out[key] = layers
        return out

    def _explain_gradients_streamed(self, tree, bucket_bytes: int,
                                    n_streams: int = N_STREAMS
                                    ) -> PlanReport:
        """The backward-overlapped plan, in executed trace order: per
        release event (layer L-1 first — backward order) the release's
        full phase chain in its local pipeline order, tagged with the
        global stream schedule's (release, stream, step); then the
        residual sync's entries. The per-release collective specs are
        resolved through exactly the lookup path ``_sync_release``
        dispatches, so plan == executed for the streamed path too."""
        layers, residual = split_release_tree(tree)
        if layers is None:
            return self.explain_gradients(tree, bucket_bytes=bucket_bytes)
        if self._inner_axis is None:
            raise ValueError("sync_gradients needs a mesh with a 'data' "
                             "axis")
        n_layers = len(layers)
        slice_tree = layer_slice_struct(layers)
        # every release syncs an identical layer slice, so one local
        # bucket plan serves all of them
        layout, active, sched, axes, sizes, keys, hier = \
            self._bucket_plan(slice_tree, bucket_bytes)
        elems = [layout.buckets[i].elems for i in active]
        stream_sched = build_stream_schedule(
            elems * n_layers, sizes,
            releases=[r for r in range(n_layers) for _ in active],
            n_streams=n_streams)
        by_bp = {(t.bucket, t.phase): t for t in stream_sched.tasks}
        entries: List[PlanEntry] = []
        for r in range(n_layers):
            base = r * len(active)
            for t in sched.tasks:
                st = by_bp[(base + t.bucket, t.phase)]
                bucket = layout.buckets[active[t.bucket]]
                itemsize = pytree.itemsize(bucket.dtype)
                key = keys[t.level]
                req = CollectiveRequest(
                    t.op, t.in_elems * itemsize, axis=axes[t.level],
                    axis_size=sizes[t.level], dtype=bucket.dtype,
                    level=key if self._policy.kind == "hier" else None)
                entry = self._level_entry(req, key)
                entries.append(dataclasses.replace(
                    entry, bucket=base + t.bucket, step=st.step,
                    release=r, stream=st.stream))
            if not hier:
                for li, bi in enumerate(active):
                    bucket = layout.buckets[bi]
                    for outer in self._sync_axes[1:]:
                        req = CollectiveRequest(
                            "all_reduce", bucket.nbytes, axis=outer,
                            axis_size=self.mesh.shape[outer],
                            dtype=bucket.dtype)
                        entries.append(PlanEntry(
                            req, _XLA_SPEC, source="psum",
                            bucket=base + li, release=r,
                            stream=(base + li) % n_streams))
        if pytree.leaves(residual):
            entries.extend(self.explain_gradients(
                residual, bucket_bytes=bucket_bytes).entries)
        return PlanReport(entries)
