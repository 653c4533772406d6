"""Standalone per-task measurement of the gradient-sync schedule (port
of ``repro/obs/replay.py``).

The reference re-executes each schedule task as its own small jitted
``shard_map`` program, because a compiled train step has nothing to
wall-clock per task. The port's ranks dispatch eagerly, but the
overlapped step's spans interleave with the backward and with each
other, so per-task occupancy is measured the same way: every task of the
schedule the step ran — same bucket plan, same release order, same
per-level {algorithm, segments} lookups — runs again, one at a time,
through ``dispatch.apply_collective`` on the `RankMesh`, in every rank
in the same order (each task is a collective). A task's time is the
slowest rank's (``group.max_over_ranks``), best of ``trials``. The
resulting spans carry the full global stream tags, ready for the
residual join and the Perfetto export. Without a bucket budget the sync
runs leaf by leaf, and so does the walk of the residual (the
reference's walk fuses it into one bucket, whose spans would not line up
with the per-leaf plan).

On ranks of one card the measured times are the schedule's trips
through the arena transport, not a GPU fabric
(``core/collectives/group.py``).
"""
from __future__ import annotations

import time
from typing import List, Optional

import torch

from repro_torch import pytree
from repro_torch.core.collectives import group as grp
from repro_torch.core.collectives.dispatch import apply_collective
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.trace import Span


class ScheduleRunner:
    """Executes one schedule task for real on a `RankMesh`, in every rank,
    and returns the slowest rank's wall seconds (best of ``trials``).
    The operand of each (op, elems, dtype) is made once, on the mesh's
    device; tracing is suspended around execution so the replayed
    collectives are not re-recorded through the dispatch hook."""

    def __init__(self, mesh, *, clock=None, trials: int = 1):
        self.mesh = mesh
        self.clock = clock or time.perf_counter
        self.trials = max(1, int(trials))
        self._cache = {}

    def _operand(self, elems, dtype):
        key = (int(elems), str(dtype))
        x = self._cache.get(key)
        if x is None:
            x = torch.zeros((int(elems),), dtype=getattr(torch, str(dtype)),
                            device=self.mesh.device or "cpu")
            self._cache[key] = x
        return x

    def __call__(self, op, elems, dtype, axis, axis_size, spec) -> float:
        x = self._operand(elems, dtype)
        group = self.mesh.axis(axis)
        best = float("inf")
        with obs_trace.suspended():
            for _ in range(self.trials):
                grp.barrier(group)
                t0 = self.clock()
                obs_trace.ready(apply_collective(op, x, group, int(axis_size),
                                                 spec, reduce_op="add"))
                dt = self.clock() - t0
                best = min(best, grp.max_over_ranks([dt])[0])
        return best


def measure_gradient_schedule(
    comm,
    tree,
    *,
    overlap_backward: bool = False,
    bucket_bytes: Optional[int] = None,
    n_streams: Optional[int] = None,
    runner=None,
    trials: int = 1,
    clock=None,
) -> List[Span]:
    """Measure every task of ``comm``'s gradient-sync schedule over
    ``tree``, one standalone execution per task, in issue order.

    The walk mirrors ``Communicator._explain_gradients_streamed`` /
    ``_bucket_plan`` exactly — with ``overlap_backward`` each release's
    local phase chain is tagged with the GLOBAL stream schedule's
    (bucket, step, release, stream), then the residual sync's pipeline
    tasks follow with local tags — so the spans line up 1:1 with
    `explain_gradients`' entries (`PlanReport.with_measured`) and with
    the residual report's task keys. ``runner(op, elems, dtype, axis,
    axis_size, spec) -> seconds`` replaces the real executor (tests);
    the default is a `ScheduleRunner` on the communicator's mesh.
    Span start times are a sequential cursor (task k+1 starts where
    task k ended): per-tier OCCUPANCY is what the residual join
    consumes, not cross-task concurrency."""
    from repro_torch.comms.bucketing import split_released
    from repro_torch.comms.communicator import N_STREAMS
    from repro_torch.core.collectives.hierarchical import _level_spec

    n_streams = n_streams or N_STREAMS
    bb = comm._resolve_bucket_bytes(bucket_bytes)
    if runner is None:
        runner = ScheduleRunner(comm.mesh, clock=clock, trials=trials)

    spans: List[Span] = []
    cursor = 0.0

    def run_task(t, layout, active, axes, sizes, keys, **tags):
        nonlocal cursor
        bobj = layout.buckets[active[t.bucket]]
        itemsize = pytree.itemsize(bobj.dtype)
        axis, p = axes[t.level], sizes[t.level]
        spec = _level_spec(comm, keys[t.level], t.op,
                           t.in_elems * itemsize, p)
        dur = float(runner(t.op, t.in_elems, bobj.dtype, axis, p, spec))
        spans.append(Span(
            kind="collective", op=t.op, nbytes=t.in_elems * itemsize,
            axis=axis, axis_size=p, dtype=bobj.dtype,
            algorithm=spec.algorithm, segments=int(spec.segments),
            level=t.level, phase=t.phase, concrete=True,
            t_start=cursor, t_end=cursor + dur, **tags))
        cursor += dur

    stacks, residual = split_released(tree) if overlap_backward \
        else ([], tree)
    if stacks:
        releases, by_bp = comm._release_schedule(stacks, bb, n_streams)
        for r, (plan, base) in enumerate(releases):
            layout, active, sched, axes, sizes, keys, _hier = plan
            for t in sched.tasks:
                st = by_bp[(base + t.bucket, t.phase)]
                run_task(t, layout, active, axes, sizes, keys,
                         bucket=base + t.bucket, step=st.step,
                         release=r, stream=st.stream)
    if residual is None or not pytree.leaves(residual):
        return spans
    if bb:
        layout, active, sched, axes, sizes, keys, _hier = \
            comm._bucket_plan(residual, bb)
        for t in sched.tasks:
            run_task(t, layout, active, axes, sizes, keys,
                     bucket=active[t.bucket], step=t.step)
        return spans
    # no bucket budget: the sync (and its plan) runs leaf by leaf, each
    # leaf's phases those of a one-leaf bucket, untagged
    for leaf in pytree.leaves(residual):
        layout, active, sched, axes, sizes, keys, _hier = \
            comm._bucket_plan([leaf], 0)
        for t in sched.tasks:
            run_task(t, layout, active, axes, sizes, keys)
    return spans
