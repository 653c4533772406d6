"""Segment-level pipelined schedules for bucketed multi-tier gradient sync
(port of ``repro/core/collectives/schedule.py``).

The builders (`pack_buckets`, `coalesce_bytes`, `build_pipeline_schedule`,
`build_stream_schedule`) are pure Python and copied. `execute_pipelined`
runs inside every rank instead of inside ``shard_map``; it keeps the
reference's issue order and tag pushing, and pads with ``F.pad``. The
reference's text follows.

``multilevel_all_reduce`` runs its N tier phases strictly sequentially:
the DCN links idle while the ICI reduce-scatters, and vice versa. The
survey's §4.1 (CCTP tiling + pipelining) and HiCCL's striped multi-level
pipelines both hide tier i+1 under tier i by splitting the work into
tiles that flow through the tiers like a software pipeline. This module
is that schedule, made explicit:

  * the gradient tree is coalesced into fusion BUCKETS (one tuned
    collective per bucket instead of one per leaf — ``coalesce_bytes``
    is the shared greedy packing rule, ``repro_torch.comms.bucketing`` the
    tree-aware layout built on it);
  * each bucket walks the same ``padded_allreduce_schedule`` phase list
    the sequential composition executes, but the phases of DIFFERENT
    buckets overlap: bucket k's tier-0 reduce-scatter issues while
    bucket k-1 runs its tier-1 phase, and the all-gathers drain back in
    reverse;
  * the dependencies are an explicit DAG over `SegmentTask`s —
    ``(k, p) <- (k, p-1)`` is the data edge (a bucket's phases are
    sequential), ``(k, p) <- (k-1, p)`` the wire edge (a tier's links
    carry one bucket's phase at a time) — and the pipeline step of every
    task is the DAG's longest path, ``step = bucket + phase``.

``build_pipeline_schedule`` is the single source of the task order: the
executor (`execute_pipelined`) walks it to issue collectives, the plan
renderer (`Communicator.explain_gradients`) walks it to print the
schedule, and the cost model
(`repro_torch.core.analytical.hierarchy.overlapped_allreduce_schedule`) walks
it to predict the makespan — plan == executed == modeled by
construction.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch.nn.functional as F

from repro_torch.core.analytical.hierarchy import padded_allreduce_schedule
from repro_torch.core.collectives.dispatch import apply_collective
from repro_torch.obs import trace as obs_trace


def pack_buckets(leaves: Sequence[Tuple[int, str]], bucket_bytes: int
                 ) -> List[Tuple[str, List[int]]]:
    """THE greedy fusion-bucket packing rule, shared by the executing
    layout (`repro_torch.comms.bucketing.BucketLayout`) and the cost model
    (`coalesce_bytes`), so the schedule that gets priced is the schedule
    that runs.

    ``leaves`` are (nbytes, dtype) in tree order. Buckets are
    dtype-homogeneous: each dtype keeps its own open bucket, a leaf
    joins it unless that would push past ``bucket_bytes`` (then the
    bucket closes and a fresh one opens). A leaf larger than the budget
    gets a bucket of its own (leaves are never split — unflattening
    must stay exact); zero-byte leaves slot into the open bucket
    without contributing bytes. ``bucket_bytes <= 0`` fuses everything
    (per dtype) into one bucket. Returns ``(dtype, leaf indices)`` per
    bucket, in bucket-open order."""
    open_by_dtype = {}
    buckets: List[List] = []              # [dtype, [leaf indices], bytes]
    for i, (nbytes, dtype) in enumerate(leaves):
        nbytes = int(nbytes)
        bi = open_by_dtype.get(dtype)
        if bi is not None and nbytes and bucket_bytes > 0 \
                and buckets[bi][2] + nbytes > bucket_bytes:
            bi = None                     # budget exceeded: close it
        if bi is None:
            buckets.append([dtype, [], 0])
            bi = len(buckets) - 1
            open_by_dtype[dtype] = bi
        buckets[bi][1].append(i)
        buckets[bi][2] += nbytes
    return [(dt, idxs) for dt, idxs, _ in buckets]


def coalesce_bytes(leaf_nbytes: Sequence[int], bucket_bytes: int,
                   dtypes: Optional[Sequence[str]] = None) -> List[int]:
    """Per-bucket byte counts for a leaf mix — `pack_buckets` with the
    empty buckets dropped (they never reach the wire). ``dtypes`` prices
    a mixed-dtype tree exactly as the execution layout will split it;
    omitted, all leaves share one stream (a homogeneous fp32 mix)."""
    if dtypes is None:
        dtypes = ["="] * len(leaf_nbytes)
    sizes = [int(n) for n in leaf_nbytes]
    out = []
    for _, idxs in pack_buckets(list(zip(sizes, dtypes)), bucket_bytes):
        total = sum(sizes[i] for i in idxs)
        if total:
            out.append(total)
    return out


@dataclasses.dataclass(frozen=True)
class SegmentTask:
    """One tier phase of one bucket — the schedulable unit. The task's
    tuned segment count (resolved per level at dispatch) further splits
    it into wire segments; ``deps`` are (bucket, phase) edges."""

    bucket: int
    phase: int              # index into the bucket's phase list
    level: int              # tier index, innermost first
    op: str                 # reduce_scatter | all_reduce | all_gather
    in_elems: int           # elements entering the phase (padded)
    out_elems: int          # elements the phase leaves behind
    step: int               # pipeline step (longest path in the DAG)
    deps: Tuple[Tuple[int, int], ...]


@dataclasses.dataclass(frozen=True)
class PipelineSchedule:
    """The issue-ordered task list plus its shape. ``tasks`` are sorted
    by (step, bucket): within a pipeline step the draining buckets (the
    ones deepest into the composition) issue first."""

    sizes: Tuple[int, ...]          # per-tier fan-outs, innermost first
    bucket_elems: Tuple[int, ...]
    tasks: Tuple[SegmentTask, ...]

    @property
    def n_phases(self) -> int:
        return 2 * len(self.sizes) - 1

    @property
    def n_steps(self) -> int:
        return 1 + max((t.step for t in self.tasks), default=-1)

    def render(self, indent: str = "  ") -> str:
        """The pipeline as a step-by-step diagram (one line per task in
        issue order)."""
        lines = []
        for t in self.tasks:
            lines.append(
                f"{indent}step {t.step:3d}  bucket {t.bucket:3d}  "
                f"tier {t.level}  {t.op:14s} {t.in_elems:>10d} elems")
        return "\n".join(lines)


def build_pipeline_schedule(bucket_elems: Sequence[int],
                            sizes: Sequence[int]) -> PipelineSchedule:
    """The pipelined schedule for ``bucket_elems`` fusion buckets over
    tiers of fan-out ``sizes`` (innermost first).

    Every bucket's phase list is EXACTLY ``padded_allreduce_schedule`` —
    the sequential composition's byte flow — so per bucket the executed
    numerics are unchanged; only the interleaving across buckets is new.
    One tier degenerates to the bucket-sequential schedule (no overlap
    to exploit, but still one fused collective per bucket).
    """
    assert sizes, "need at least one tier"
    tasks: List[SegmentTask] = []
    for k, elems in enumerate(bucket_elems):
        for p_idx, (lvl, op, in_e, out_e) in enumerate(
                padded_allreduce_schedule(list(sizes), int(elems))):
            deps: List[Tuple[int, int]] = []
            if p_idx:
                deps.append((k, p_idx - 1))   # data: my previous phase
            if k:
                deps.append((k - 1, p_idx))   # wire: tier busy until then
            tasks.append(SegmentTask(
                bucket=k, phase=p_idx, level=lvl, op=op, in_elems=in_e,
                out_elems=out_e, step=k + p_idx, deps=tuple(deps)))
    tasks.sort(key=lambda t: (t.step, t.bucket))
    return PipelineSchedule(tuple(int(s) for s in sizes),
                            tuple(int(e) for e in bucket_elems),
                            tuple(tasks))


@dataclasses.dataclass(frozen=True)
class StreamTask(SegmentTask):
    """A `SegmentTask` scheduled onto one of ``n_streams`` double-buffered
    collective-permute streams, gated on a gradient-release event: the
    bucket's first phase cannot issue before backward compute has
    produced its gradients (``release`` = the event's index in backward
    order), and a stream carries one bucket's phase per tier at a time
    (the wire edge skips to ``bucket - n_streams``)."""

    stream: int = 0
    release: int = 0


@dataclasses.dataclass(frozen=True)
class StreamSchedule(PipelineSchedule):
    """Readiness-ordered stream schedule. Unlike `PipelineSchedule`,
    ``tasks`` stay in release-major (bucket-major) order — the executed
    trace order is each release event's full phase chain, issued inside
    that layer's backward rule; ``step``/``stream`` are the scheduling
    metadata the cost model and renderer consume."""

    n_streams: int = 2
    releases: Tuple[int, ...] = ()

    def render(self, indent: str = "  ") -> str:
        lines = []
        for t in self.tasks:
            lines.append(
                f"{indent}step {t.step:3d}  release {t.release:3d}  "
                f"stream {t.stream}  bucket {t.bucket:3d}  tier {t.level}"
                f"  {t.op:14s} {t.in_elems:>10d} elems")
        return "\n".join(lines)


def build_stream_schedule(bucket_elems: Sequence[int],
                          sizes: Sequence[int],
                          *,
                          releases: Optional[Sequence[int]] = None,
                          n_streams: int = 2) -> StreamSchedule:
    """The backward-overlapped stream schedule: ``bucket_elems`` fusion
    buckets (in release order — backward produces the LAST layer's
    gradients first, so bucket 0 is the deepest layer), each walking the
    sequential ``padded_allreduce_schedule`` phases, scheduled onto
    ``n_streams`` double-buffered streams per tier.

    ``releases[k]`` is the pipeline step at which bucket k's gradients
    materialize (default: bucket k releases at step k — one layer's
    backward compute per step). The DAG replaces the pipeline's wire
    edge ``(k-1, p)`` with ``(k - n_streams, p)``: with two streams a
    tier keeps two ppermute chains in flight, so a stall in one bucket's
    chain doesn't idle the tier. The step recurrence is the DAG's
    longest path with the release event as phase 0's ready floor::

        step[k][0] = max(releases[k], step[k-n_streams][0] + 1)
        step[k][p] = max(step[k][p-1] + 1, step[k-n_streams][p] + 1)

    With ``n_streams=1`` and ``releases=range`` this degenerates exactly
    to `build_pipeline_schedule`'s ``step = bucket + phase``. Per bucket
    the phase list (and therefore every floating-point value) is
    unchanged.
    """
    assert sizes, "need at least one tier"
    assert n_streams >= 1
    if releases is None:
        releases = list(range(len(bucket_elems)))
    assert len(releases) == len(bucket_elems)
    tasks: List[StreamTask] = []
    step: dict = {}
    for k, elems in enumerate(bucket_elems):
        for p_idx, (lvl, op, in_e, out_e) in enumerate(
                padded_allreduce_schedule(list(sizes), int(elems))):
            deps: List[Tuple[int, int]] = []
            s = int(releases[k]) if p_idx == 0 else 0
            if p_idx:
                deps.append((k, p_idx - 1))           # data edge
                s = max(s, step[(k, p_idx - 1)] + 1)
            if k >= n_streams:
                deps.append((k - n_streams, p_idx))   # wire edge (stream)
                s = max(s, step[(k - n_streams, p_idx)] + 1)
            step[(k, p_idx)] = s
            tasks.append(StreamTask(
                bucket=k, phase=p_idx, level=lvl, op=op, in_elems=in_e,
                out_elems=out_e, step=s, deps=tuple(deps),
                stream=k % n_streams, release=int(releases[k])))
    return StreamSchedule(tuple(int(s) for s in sizes),
                          tuple(int(e) for e in bucket_elems),
                          tuple(tasks), n_streams=int(n_streams),
                          releases=tuple(int(r) for r in releases))


def execute_pipelined(
    buckets,
    schedule: PipelineSchedule,
    levels: Sequence[Tuple[str, int]],
    decision=None,
    *,
    op: str = "add",
    level_keys: Optional[Sequence] = None,
):
    """Run the pipelined schedule over flat fusion buffers, inside every
    rank of the mesh.

    ``buckets`` are 1-D arrays (one per schedule bucket, matching
    ``schedule.bucket_elems``); ``levels`` are (axis, size) innermost
    first; ``decision`` / ``level_keys`` address per-level specs exactly
    as ``multilevel_all_reduce`` does. Collectives are issued in the
    schedule's pipeline order — bucket k's inward phase between bucket
    k-1's deeper phases. (The port issues each collective to its end
    before the next: the order is the reference's, the overlap that XLA's
    scheduler finds in it is not reproduced.) Per bucket the phase order (and
    therefore every floating-point value) is identical to the
    sequential ``multilevel_all_reduce`` of that bucket.
    """
    from repro_torch.core.collectives.hierarchical import _keys, _level_spec

    assert len(buckets) == len(schedule.bucket_elems), \
        f"{len(buckets)} buffers for {len(schedule.bucket_elems)} buckets"
    keys = _keys(levels, level_keys)
    rec = obs_trace.active()
    state = [b.reshape(-1) for b in buckets]
    for t in schedule.tasks:
        axis, p = levels[t.level]
        flat = state[t.bucket]
        if t.op == "reduce_scatter" and flat.numel() < t.in_elems:
            flat = F.pad(flat, (0, t.in_elems - flat.numel()))
        spec = _level_spec(decision, keys[t.level], t.op,
                           t.in_elems * flat.element_size(), p)
        if rec is None:
            flat = apply_collective(t.op, flat, axis, p, spec,
                                    reduce_op=op).reshape(-1)
        else:
            # push the schedule-task identity so the recorded span joins
            # 1:1 against the rendered plan and the analytical walk
            with rec.tags(bucket=t.bucket, phase=t.phase, level=t.level,
                          step=t.step):
                flat = apply_collective(t.op, flat, axis, p, spec,
                                        reduce_op=op).reshape(-1)
        if t.op == "all_gather" and flat.numel() > t.out_elems:
            flat = flat[:t.out_elems]
        state[t.bucket] = flat
    return state
