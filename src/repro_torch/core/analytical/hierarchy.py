"""A copy of ``repro/core/analytical/hierarchy.py``. The reference's
text follows.

Hierarchical cost model: per-level costs summed across the composition.

Extends ``collective_cost`` to the topology-aware schedule (reduce-scatter
up the levels, all-reduce at the top, all-gather back down). Each phase is
costed under ITS level's communication model — the analytical mirror of
what the per-level tuner measures — so model-predicted decisions can be
compared level by level against empirical ones, exactly as the survey
pits §3.1 models against §3.2 experiments, now with the network-specific
structure the survey calls out as the missing axis.

``levels`` are innermost first: ``(p, CommModel)`` pairs, optionally with
per-level gamma.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.analytical.base import CommModel, VPU_GAMMA
from repro_torch.core.analytical.costs import collective_cost


def allreduce_phases(sizes: Sequence[int], m: float
                     ) -> List[Tuple[int, str, float]]:
    """The hierarchical all-reduce's phase schedule: ``(level_index, op,
    nbytes)`` per sequential phase — reduce-scatter up the levels (bytes
    shrink by each fan-out), all-reduce at the top, all-gather back down
    (on the per-rank shard, the simulator's and cost model's convention).

    Single source of truth for the byte flow: the simulator-timing,
    decision-lookup and cost-model walks all iterate this schedule.
    Handles any level count (1 level degenerates to one flat all-reduce).
    """
    assert sizes, "need at least one level"
    phases: List[Tuple[int, str, float]] = []
    bytes_here = float(m)
    shards: List[Tuple[int, float]] = []
    for i, p in enumerate(sizes[:-1]):
        phases.append((i, "reduce_scatter", bytes_here))
        bytes_here /= p
        shards.append((i, bytes_here))
    phases.append((len(sizes) - 1, "all_reduce", bytes_here))
    for i, shard in reversed(shards):
        phases.append((i, "all_gather", shard))
    return phases


def padded_allreduce_schedule(sizes: Sequence[int], n_elems: int
                              ) -> List[Tuple[int, str, int, int]]:
    """The EXACT integer schedule the N-level all-reduce composition
    executes: ``(level_index, op, in_elems, out_elems)`` per sequential
    phase, innermost levels first on the way up and last on the way down.

    ``in_elems`` is the element count the phase moves — the zero-padded
    buffer entering each reduce-scatter (padded up to a multiple of that
    level's fan-out), the per-rank shard for the top all-reduce and for
    each all-gather. ``out_elems`` is the buffer the phase leaves behind
    AFTER the composition's bookkeeping: the 1/p shard after a
    reduce-scatter, and the gathered buffer truncated back to the length
    that entered the matching reduce-scatter (padding introduced on the
    way up is stripped on the way down, so the final buffer is exactly
    ``n_elems``).

    This is the integer mirror of :func:`allreduce_phases` — the executor
    (``repro_torch.core.collectives.hierarchical``) and the plan expansion
    (``Communicator.plan``) both walk it, so the rendered plan can never
    disagree with the executed byte counts.
    """
    assert sizes, "need at least one level"
    phases: List[Tuple[int, str, int, int]] = []
    stack: List[Tuple[int, int, int]] = []      # (level, pre_pad, padded)
    elems = int(n_elems)
    for i, p in enumerate(sizes[:-1]):
        padded = elems + (-elems) % p
        phases.append((i, "reduce_scatter", padded, padded // p))
        stack.append((i, elems, padded))
        elems = padded // p
    phases.append((len(sizes) - 1, "all_reduce", elems, elems))
    for i, pre_pad, padded in reversed(stack):
        phases.append((i, "all_gather", padded // sizes[i], pre_pad))
    return phases


def hierarchical_allreduce_cost(
    levels: Sequence[Tuple[int, CommModel]],
    m: float,
    methods: Optional[Dict[Tuple[int, str], Tuple[str, int]]] = None,
    *,
    gamma: float = VPU_GAMMA,
) -> float:
    """Predicted wall time of the hierarchical all-reduce.

    ``methods`` maps (level_index, op) -> (algorithm, segments); omitted
    entries use the per-level model-optimal pick (``best_hierarchical``'s
    behaviour). Message bytes shrink by each level's fan-out on the way
    up; the all-gather phase is costed on the per-rank shard, matching the
    simulator's convention.
    """
    return _compose(levels, m, methods, gamma)[0]


def best_hierarchical(
    levels: Sequence[Tuple[int, CommModel]],
    m: float,
    *,
    gamma: float = VPU_GAMMA,
) -> Tuple[float, Dict[Tuple[int, str], Tuple[str, int]]]:
    """(predicted time, per-phase picks) with every phase chosen by the
    model — the analytical counterpart of a per-level tuning run."""
    t, picks = _compose(levels, m, None, gamma)
    return t, picks


def _phase(op: str, model: CommModel, p: int, m: float,
           method: Optional[Tuple[str, int]], gamma: float
           ) -> Tuple[float, Tuple[str, int]]:
    if method is not None:
        algo, segs = method
        return collective_cost(op, algo, model, p, m, segments=segs,
                               gamma=gamma), method
    from repro_torch.core.analytical.costs import best_algorithm
    algo, segs, t = best_algorithm(op, model, p, m, gamma=gamma)
    return t, (algo, segs)


def _compose(levels, m, methods, gamma):
    methods = methods or {}
    total = 0.0
    picks: Dict[Tuple[int, str], Tuple[str, int]] = {}
    for i, op, nbytes in allreduce_phases([p for p, _ in levels], m):
        p, model = levels[i]
        t, pick = _phase(op, model, p, nbytes, methods.get((i, op)), gamma)
        total += t
        picks[(i, op)] = pick
    return total, picks


# ---------------------------------------------------------------------------
# overlap-pipelined schedules (survey §4.1, CCTP tiling + pipelining)
# ---------------------------------------------------------------------------
def modeled_phase_cost(
    levels: Sequence[Tuple[int, CommModel]],
    methods: Optional[Dict[Tuple[int, str], Tuple[str, int]]] = None,
    *,
    gamma: float = VPU_GAMMA,
):
    """``phase_cost(level, op, nbytes) -> (seconds, segments)`` under the
    per-level communication models — THE pricing closure of
    `overlapped_allreduce_time` and `backward_overlapped_time`, exported
    so the telemetry residuals (`repro.obs.residuals`, not ported yet)
    price the same schedule with the same closure and reproduce those totals exactly.
    ``methods`` maps (level, op) -> (algorithm, segments); omitted
    entries use the per-level model-optimal pick."""
    def phase_cost(level, op, nbytes):
        p, model = levels[level]
        t, (_, segs) = _phase(op, model, p, float(nbytes),
                              (methods or {}).get((level, op)), gamma)
        return t, segs

    return phase_cost


def overlapped_allreduce_schedule(
    sizes: Sequence[int],
    bucket_elems: Sequence[int],
    phase_cost,
):
    """Timed walk of the bucketed pipeline: ``(makespan_seconds, timed)``.

    ``sizes`` are the per-tier fan-outs (innermost first),
    ``bucket_elems`` the fusion-bucket element counts, and
    ``phase_cost(level, op, in_elems) -> (seconds, n_segments)`` prices
    one tier phase under that tier's communication model (a simulator,
    `collective_cost`, or live measurements) and reports its tuned
    segment count.

    The tasks come from the SAME ``build_pipeline_schedule`` the
    executor and the plan renderer walk; timing obeys the DAG at
    SEGMENT granularity: each tier is one serial wire, a phase's tuned
    segments occupy it back to back, and segment s of phase p may start
    only once the segment of phase p-1 covering the same data fraction
    has finished. The makespan is therefore pipeline fill plus a steady
    state paced by the busiest tier chain — ``max`` over tiers of
    per-bucket occupancy — instead of the sequential sum of phases.

    ``timed`` is ``[(task, start, finish)]`` in issue order; the
    makespan of a single bucket degenerates to the sequential
    sum-of-phases (`hierarchical_allreduce_cost`'s convention).
    """
    from repro_torch.core.collectives.schedule import build_pipeline_schedule

    sched = build_pipeline_schedule(bucket_elems, sizes)
    wire_free = [0.0] * len(sizes)            # one serial wire per tier
    seg_finish: Dict[Tuple[int, int], List[float]] = {}
    timed = []
    for t in sched.tasks:
        total, nseg = phase_cost(t.level, t.op, t.in_elems)
        nseg = max(1, int(nseg))
        d = total / nseg
        prev = seg_finish.get((t.bucket, t.phase - 1))
        free = wire_free[t.level]
        finishes: List[float] = []
        start0 = None
        for s in range(nseg):
            ready = 0.0
            if prev is not None:
                # the predecessor segment covering this segment's data
                idx = min(len(prev) - 1, ((s + 1) * len(prev) - 1) // nseg)
                ready = prev[idx]
            start = max(free, ready)
            if start0 is None:
                start0 = start
            free = start + d
            finishes.append(free)
        wire_free[t.level] = free
        seg_finish[(t.bucket, t.phase)] = finishes
        timed.append((t, start0 or 0.0, free))
    makespan = max((fin for _, _, fin in timed), default=0.0)
    return makespan, timed


def overlapped_allreduce_time(
    levels: Sequence[Tuple[int, CommModel]],
    bucket_bytes: Sequence[float],
    methods: Optional[Dict[Tuple[int, str], Tuple[str, int]]] = None,
    *,
    gamma: float = VPU_GAMMA,
) -> float:
    """Predicted makespan of the bucketed, overlap-pipelined all-reduce
    under the per-level communication models — the pipelined counterpart
    of `hierarchical_allreduce_cost`. ``methods`` maps (level, op) ->
    (algorithm, segments); omitted entries use the per-level
    model-optimal pick."""
    return overlapped_allreduce_schedule(
        [p for p, _ in levels], [int(b) for b in bucket_bytes],
        modeled_phase_cost(levels, methods, gamma=gamma))[0]


def backward_overlapped_schedule(
    sizes: Sequence[int],
    bucket_elems: Sequence[int],
    phase_cost,
    *,
    releases: Optional[Sequence[int]] = None,
    ready_times: Optional[Sequence[float]] = None,
    n_streams: int = 2,
):
    """Timed walk of the backward-overlapped stream schedule:
    ``(makespan_seconds, timed)``, measured from backward-compute start.

    The compute-overlapped counterpart of
    `overlapped_allreduce_schedule`: the tasks come from the SAME
    ``build_stream_schedule`` the executor issues and the plan renderer
    tags, and two things change in the timing walk —

      * each tier owns ``n_streams`` serial wires (double-buffered
        permute streams), a task occupying the ``(level, stream)`` wire
        its bucket was scheduled onto;
      * a bucket's first phase has a READY FLOOR:
        ``ready_times[releases[k]]`` is the wall-clock moment backward
        compute materializes that release's gradients, so communication
        overlaps compute instead of starting after it — the exposed
        communication is ``max(0, makespan - total_compute)`` rather
        than the full comm time.

    ``timed`` is ``[(task, start, finish)]`` in issue order. With
    ``n_streams=1`` and zero ready times this reproduces
    `overlapped_allreduce_schedule` exactly.
    """
    from repro_torch.core.collectives.schedule import build_stream_schedule

    sched = build_stream_schedule(bucket_elems, sizes, releases=releases,
                                  n_streams=n_streams)
    wire_free: Dict[Tuple[int, int], float] = {}
    seg_finish: Dict[Tuple[int, int], List[float]] = {}
    timed = []
    # The stream tasks are listed bucket-major (release order) but ISSUE
    # in step order — walking them bucket-major would let an early
    # bucket's late phases grab a wire before a later bucket's first
    # phase, serializing the pipeline the schedule explicitly permits.
    for t in sorted(sched.tasks, key=lambda t: (t.step, t.bucket,
                                                t.phase)):
        total, nseg = phase_cost(t.level, t.op, t.in_elems)
        nseg = max(1, int(nseg))
        d = total / nseg
        prev = seg_finish.get((t.bucket, t.phase - 1))
        free = wire_free.get((t.level, t.stream), 0.0)
        floor = 0.0
        if t.phase == 0 and ready_times is not None:
            floor = float(ready_times[t.release])
        finishes: List[float] = []
        start0 = None
        for s in range(nseg):
            ready = floor
            if prev is not None:
                idx = min(len(prev) - 1, ((s + 1) * len(prev) - 1) // nseg)
                ready = max(ready, prev[idx])
            start = max(free, ready)
            if start0 is None:
                start0 = start
            free = start + d
            finishes.append(free)
        wire_free[(t.level, t.stream)] = free
        seg_finish[(t.bucket, t.phase)] = finishes
        timed.append((t, start0 or 0.0, free))
    makespan = max((fin for _, _, fin in timed), default=0.0)
    return makespan, timed


def backward_overlapped_time(
    levels: Sequence[Tuple[int, CommModel]],
    bucket_bytes: Sequence[float],
    compute_times: Sequence[float],
    methods: Optional[Dict[Tuple[int, str], Tuple[str, int]]] = None,
    *,
    n_streams: int = 2,
    gamma: float = VPU_GAMMA,
) -> float:
    """Predicted makespan (from backward start) of the
    backward-overlapped streamed sync: bucket k (release order — the
    deepest layer's gradients first) becomes ready once
    ``compute_times[0..k]`` of backward compute have elapsed, then its
    phase chain flows through the double-buffered stream wires. The
    exposed communication is ``makespan - sum(compute_times)`` when
    positive — comm fully hidden under compute costs nothing."""
    assert len(compute_times) == len(bucket_bytes), \
        "one backward-compute slice per release bucket"
    ready, acc = [], 0.0
    for c in compute_times:
        acc += float(c)
        ready.append(acc)
    return backward_overlapped_schedule(
        [p for p, _ in levels], [int(b) for b in bucket_bytes],
        modeled_phase_cost(levels, methods, gamma=gamma),
        releases=list(range(len(bucket_bytes))), ready_times=ready,
        n_streams=n_streams)[0]


def flat_vs_hierarchical(
    flat_model: CommModel,
    levels: Sequence[Tuple[int, CommModel]],
    m: float,
    *,
    flat_algorithm: str = "ring",
    gamma: float = VPU_GAMMA,
) -> Tuple[float, float]:
    """(flat predicted time, hierarchical predicted time) for an m-byte
    all-reduce — the model's answer to "is the hierarchy worth it here"."""
    p_total = 1
    for p, _ in levels:
        p_total *= p
    flat = collective_cost("all_reduce", flat_algorithm, flat_model,
                           p_total, m, gamma=gamma)
    hier, _ = best_hierarchical(levels, m, gamma=gamma)
    return flat, hier
