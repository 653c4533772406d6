"""A copy of ``repro/core/topology/tune.py``. The reference's text
follows.

Per-level tuning: one TuningSession per topology level.

Instead of sweeping the flat {op, p, m} grid at the machine's total size —
where every measurement pays the slowest link — each level tunes over ITS
OWN profile at ITS OWN fan-out. For the canonical composition
(reduce-scatter inner, all-reduce outer, all-gather inner) the inner
levels tune the scatter/gather ops and the outermost level tunes
all-reduce, so the per-level search space is a thin slice of the flat one
(Fast Tuning of Intra-Cluster Collective Communications).

The ground-truth timing helpers mirror ``NetworkSimulator`` per level:
a flat collective over the whole machine runs on the topology's
``flat_profile`` (its rounds synchronize on the slowest links), while the
hierarchical composition charges each phase to its level's simulator.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.analytical.hierarchy import (
    allreduce_phases,
    backward_overlapped_schedule,
    overlapped_allreduce_schedule,
    padded_allreduce_schedule,
)
from repro_torch.core.topology.decision import HierarchicalDecision
from repro_torch.core.topology.model import SYNC_AXES, Topology
from repro_torch.core.topology.placement import (
    MeshMapping,
    Workload,
    sweep_mappings,
)
from repro_torch.core.tuning.decision import TableMeta
from repro_torch.core.tuning.executor import SimulatorBackend
from repro_torch.core.tuning.session import TunerReport, TuningSession
from repro_torch.core.tuning.simulator import NetworkSimulator
from repro_torch.core.tuning.space import MESSAGE_SIZES, Method, methods_for
from repro_torch.core.tuning.tuners import make_tuner

#: ops each phase of the hierarchical composition needs tuned: every
#: non-top level (inner AND middle tiers of a 3-level stack) carries a
#: reduce-scatter on the way in and an all-gather on the way out (plus
#: all_reduce so the level can also serve flat requests); only the
#: outermost level runs the top all-reduce
INNER_OPS = ("reduce_scatter", "all_gather", "all_reduce")
OUTER_OPS = ("all_reduce",)


def tune_topology(
    topology: Topology,
    *,
    ms: Sequence[int] = MESSAGE_SIZES,
    tuners: Sequence[str] = ("exhaustive",),
    trials: int = 3,
    backend_factory: Optional[Callable] = None,
    schedule_leaf_bytes: Optional[Sequence[int]] = None,
    tune_mapping: bool = False,
    mapping_workload: Optional[Workload] = None,
) -> Tuple[HierarchicalDecision, Dict[str, List[TunerReport]]]:
    """Run a TuningSession per level and keep each level's best table.

    ``backend_factory(level) -> backend`` swaps in real measurement
    backends (DeviceBackend per fabric tier); the default simulates each
    level's own NetworkProfile. Returns the HierarchicalDecision plus the
    per-level TunerReports (the survey's budget/penalty axes, now per
    level).

    ``schedule_leaf_bytes`` (a representative gradient-leaf byte mix)
    additionally tunes the bucketed overlap schedule against the
    pipelined cost model (`tune_overlap_schedule`) and stamps the
    winning ``bucket_bytes`` into the artifact's meta, so consumers
    bucket + pipeline by default.

    ``tune_mapping`` additionally sweeps the logical→physical placement
    (`tune_mesh_mapping`) over the topology's own mesh axes and stamps
    the winning `MeshMapping` into the artifact's meta, so
    `Communicator.create` rebuilds the winning mesh at load.
    """
    levels, reports = [], {}
    for i, lv in enumerate(topology.levels):
        ops = OUTER_OPS if i == len(topology.levels) - 1 and i > 0 \
            else INNER_OPS
        backend = backend_factory(lv) if backend_factory else \
            SimulatorBackend(NetworkSimulator(lv.profile))
        session = TuningSession(backend, trials=trials)
        reps = session.fit_all([make_tuner(n, ops, (lv.size,), ms)
                                for n in tuners])
        best = TuningSession.best(reps)
        levels.append((lv.name, best.table))
        reports[lv.name] = reps
    decision = HierarchicalDecision(levels)
    if schedule_leaf_bytes is not None:
        tune_overlap_schedule(topology, decision, schedule_leaf_bytes)
    if tune_mapping:
        tune_mesh_mapping(topology, decision, workload=mapping_workload)
    return decision, reports


# ---------------------------------------------------------------------------
# ground-truth timing of flat vs hierarchical schedules on a topology
# ---------------------------------------------------------------------------
def flat_time(topology: Topology, op: str, method: Method, m: int) -> float:
    """Expected time of a flat ``op`` over all ranks on the bottleneck
    profile."""
    sim = NetworkSimulator(topology.flat_profile())
    return sim.expected_time(op, method.algorithm, topology.total_size, m,
                             method.segments)


def _phases(topology: Topology, m: int):
    """(level, op, nbytes) per sequential phase — the byte flow comes from
    the cost model's shared schedule, so simulator timing, decision lookup
    and analytical costs can never disagree about it."""
    sizes = [lv.size for lv in topology.levels]
    return [(topology.levels[i], op, nbytes)
            for i, op, nbytes in allreduce_phases(sizes, m)]


def hierarchical_allreduce_time(
    topology: Topology,
    methods: Dict[Tuple[str, str], Method],
    m: int,
) -> float:
    """Expected time of the hierarchical all-reduce composition under the
    per-phase ``methods`` map ((level_name, op) -> Method)."""
    sims = {lv.name: NetworkSimulator(lv.profile) for lv in topology.levels}
    t = 0.0
    for lv, op, nbytes in _phases(topology, m):
        meth = methods[(lv.name, op)]
        t += sims[lv.name].expected_time(op, meth.algorithm, lv.size,
                                         nbytes, meth.segments)
    return t


def decided_hierarchical_methods(
    decision: HierarchicalDecision, topology: Topology, m: int
) -> Dict[Tuple[str, str], Method]:
    """The (level, op) -> Method map a HierarchicalDecision picks for an
    m-byte all-reduce over the topology."""
    out: Dict[Tuple[str, str], Method] = {}
    for lv, op, nbytes in _phases(topology, m):
        spec = decision.spec_for_level(lv.name, op, int(nbytes), lv.size)
        out[(lv.name, op)] = Method(spec.algorithm, spec.segments)
    return out


def optimal_hierarchical_allreduce_time(topology: Topology, m: int) -> float:
    """True optimum of the hierarchical composition: per-phase argmin (the
    phases are sequential, so the composition's optimum is the sum of
    each phase's optimum)."""
    sims = {lv.name: NetworkSimulator(lv.profile) for lv in topology.levels}
    total = 0.0
    for lv, op, nbytes in _phases(topology, m):
        _, t = sims[lv.name].optimal(op, lv.size, nbytes,
                                     methods_for(op, include_xla=False, p=lv.size))
        total += t
    return total


# ---------------------------------------------------------------------------
# bucketed + overlap-pipelined gradient sync (survey §4.1 / CCTP)
# ---------------------------------------------------------------------------
#: fusion-bucket budget candidates swept by ``tune_overlap_schedule``
BUCKET_BYTES_CANDIDATES = tuple((256 << 10) * 2 ** i for i in range(9))


def _decided_phase_cost(topology: Topology,
                        decision: HierarchicalDecision):
    """``phase_cost(level, op, nbytes) -> (seconds, segments)`` pricing
    each tier phase on ITS level's simulator under the decision's tuned
    {algorithm, segments} — the ground-truth mirror of what the
    pipelined executor dispatches."""
    sims = {lv.name: NetworkSimulator(lv.profile)
            for lv in topology.levels}

    def phase_cost(level: int, op: str, nbytes: int):
        lv = topology.levels[level]
        spec = decision.spec_for_level(lv.name, op, int(nbytes), lv.size)
        t = sims[lv.name].expected_time(op, spec.algorithm, lv.size,
                                        nbytes, spec.segments)
        return t, max(1, spec.segments)

    return phase_cost


#: public name: the telemetry residuals (`repro.obs.residuals`) price a
#: live Communicator's schedule with this closure (the Communicator
#: duck-types as the decision via ``spec_for_level``)
decided_phase_cost = _decided_phase_cost


def sequential_sync_time(topology: Topology,
                         decision: HierarchicalDecision,
                         chunk_bytes: Sequence[int]) -> float:
    """Expected time of syncing ``chunk_bytes`` buffers (leaves or
    fusion buckets) one after another, each through the strictly
    sequential hierarchical composition — the pre-pipelining baseline.

    Per-phase pricing is EXACTLY `pipelined_sync_time`'s (same padded
    ``padded_allreduce_schedule`` byte flow, same per-level simulator
    and tuned spec), so sequential-vs-pipelined comparisons measure
    scheduling, never a byte-accounting convention."""
    sizes = [lv.size for lv in topology.levels]
    cost = _decided_phase_cost(topology, decision)
    total = 0.0
    for m in chunk_bytes:
        for lvl, op, in_bytes, _ in padded_allreduce_schedule(sizes,
                                                              int(m)):
            total += cost(lvl, op, in_bytes)[0]
    return total


def pipelined_sync_time(topology: Topology,
                        decision: HierarchicalDecision,
                        bucket_bytes_list: Sequence[int]) -> float:
    """Expected makespan of the bucketed, overlap-pipelined sync: the
    buckets flow through the tiers as a software pipeline
    (``overlapped_allreduce_schedule`` over the same task DAG the
    executor walks), so tier i+1's phases hide under tier i's."""
    sizes = [lv.size for lv in topology.levels]
    makespan, _ = overlapped_allreduce_schedule(
        sizes, [int(b) for b in bucket_bytes_list],
        _decided_phase_cost(topology, decision))
    return makespan


def streamed_sync_time(topology: Topology,
                       decision: HierarchicalDecision,
                       bucket_bytes_list: Sequence[int],
                       compute_times: Sequence[float],
                       *, n_streams: int = 2) -> float:
    """Expected makespan (from backward-compute start) of the
    backward-overlapped streamed sync: bucket k's phase chain issues
    once ``compute_times[0..k]`` of backward compute have produced its
    gradients (release order — the deepest layer first), flowing
    through ``n_streams`` double-buffered permute wires per tier
    (``backward_overlapped_schedule`` over the same
    ``build_stream_schedule`` DAG the executor issues). Per-phase
    pricing is EXACTLY `pipelined_sync_time`'s, so streamed-vs-pipelined
    comparisons measure overlap, never a byte-accounting convention."""
    sizes = [lv.size for lv in topology.levels]
    makespan, _ = backward_overlapped_schedule(
        sizes, [int(b) for b in bucket_bytes_list],
        _decided_phase_cost(topology, decision),
        releases=list(range(len(bucket_bytes_list))),
        ready_times=_cumsum(compute_times), n_streams=n_streams)
    return makespan


def _cumsum(xs: Sequence[float]) -> List[float]:
    out, acc = [], 0.0
    for x in xs:
        acc += float(x)
        out.append(acc)
    return out


def tune_overlap_schedule(
    topology: Topology,
    decision: HierarchicalDecision,
    leaf_bytes: Sequence[int],
    *,
    leaf_dtypes: Optional[Sequence[str]] = None,
    candidates: Sequence[int] = BUCKET_BYTES_CANDIDATES,
    attach: bool = True,
) -> Tuple[int, float]:
    """Sweep the fusion-bucket budget against the pipelined cost model
    and return ``(bucket_bytes, modeled_seconds)`` for the best one.

    Too-small buckets pay per-collective launch latency; too-large ones
    lose the overlap window (the survey's §4.1.3 sweet spot).
    ``leaf_dtypes`` prices a mixed-dtype tree exactly as the execution
    layout will split it (buckets are dtype-homogeneous); omitted, the
    mix is treated as one homogeneous stream. With ``attach=True`` the
    winning schedule is stamped into every level table's meta
    (``{"bucket_bytes": ..., "pipeline": True}``), so the persisted
    schema-3 artifact carries it and `Communicator.create` buckets +
    pipelines by default; artifacts without the field keep today's
    sequential per-leaf path.
    """
    from repro_torch.core.collectives.schedule import coalesce_bytes

    best: Optional[Tuple[int, float]] = None
    for bb in candidates:
        t = pipelined_sync_time(
            topology, decision,
            coalesce_bytes(leaf_bytes, bb, dtypes=leaf_dtypes))
        if best is None or t < best[1]:
            best = (int(bb), t)
    assert best is not None, "no bucket-bytes candidates"
    if attach:
        for _, table in decision.levels:
            if table.meta is None:
                table.meta = TableMeta()
            table.meta.schedule = {"bucket_bytes": best[0],
                                   "pipeline": True}
    return best


def tune_mesh_mapping(
    topology: Topology,
    decision: Optional[HierarchicalDecision] = None,
    *,
    axes: Optional[Sequence[str]] = None,
    shape: Optional[Sequence[int]] = None,
    n_devices: Optional[int] = None,
    workload: Optional[Workload] = None,
    attach: bool = True,
) -> MeshMapping:
    """Sweep candidate logical→physical mappings (`sweep_mappings`) and
    return the winner, its modeled workload cost attached.

    ``axes``/``shape`` default to the topology's own mesh axes in
    construction order (outermost first) — the mesh `tune_topology`'s
    artifact will be loaded against; pass them explicitly when the
    launch mesh carries extra axes (e.g. an inner "model" axis the sync
    topology doesn't know about, with ``n_devices`` covering the model
    ranks). With ``attach=True`` and a decision, the winner is stamped
    into every level table's meta (``TableMeta.mapping``) so the
    persisted artifact carries it and `Communicator.create` rebuilds
    the exact winning mesh; artifacts without the field keep today's
    default device order.
    """
    if axes is None:
        axes = [lv.axis or SYNC_AXES[i]
                for i, lv in enumerate(topology.levels)][::-1]
    if shape is None:
        shape = [lv.size for lv in topology.levels][::-1]
    best, _ = sweep_mappings(topology, axes, shape,
                             n_devices=n_devices, workload=workload)
    if attach and decision is not None:
        doc = best.to_json()
        for _, table in decision.levels:
            if table.meta is None:
                table.meta = TableMeta()
            table.meta.mapping = doc
    return best


def optimal_machine_allreduce_time(topology: Topology, m: int) -> float:
    """The oracle both strategies are penalized against: the better of the
    best flat schedule and the best hierarchical composition."""
    best_flat = min(flat_time(topology, "all_reduce", meth, m)
                    for meth in methods_for("all_reduce", include_xla=False,
                                            p=topology.total_size))
    if len(topology.levels) == 1:
        return best_flat
    return min(best_flat, optimal_hierarchical_allreduce_time(topology, m))
