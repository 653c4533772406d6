"""Measured-vs-modeled residuals over the gradient-sync schedule (port
of ``repro/obs/residuals.py``: plain Python over the recorded spans).

The port's released subtree is a list of per-layer trees (the
reference stacks them), so ``gradient_residual_report`` counts the
layers as the list's length and plans one element's slice; everything
else is the reference's. The reference's text follows.

The executor, the plan renderer and the cost model all walk the same
task list (plan == executed == modeled by construction), so a recorded
span per schedule task can be joined 1:1 against the analytical walk's
per-task prediction. This module is that join: per-task residuals,
per-tier wire occupancy (measured vs modeled), exposed communication,
and a scalar DRIFT statistic that plugs straight into
``TuningSession.retune_if_drifted(drift=...)`` as the telemetry-driven
alternative to sentinel probes (STAR-MPI's runtime observation, survey
§3.2 — the fabric is watched while training runs, not re-swept offline).

The modeled side is priced by the SAME closures the tuning stack uses —
`repro_torch.core.analytical.hierarchy.modeled_phase_cost` for CommModel
levels (so `modeled_gradient_report(...).modeled_makespan` reproduces
``backward_overlapped_time`` exactly), or the per-level simulators via
``repro_torch.core.topology.tune.decided_phase_cost`` for a live
`Communicator` + `Topology` (the Communicator itself duck-types as the
decision, so the priced {algorithm, segments} are the dispatched ones).

Drift is scale-invariant on purpose: per-tier occupancy ratios
``r = measured / modeled`` are normalized by their median, and drift is
the largest deviation from that reference. A uniformly mismatched clock
(every tier 2x the model — the model's units were just off) yields zero
drift; ONE tier slowing down relative to the others — the re-tune
trigger that matters — stands out immediately.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence

from repro_torch.obs.trace import Span

#: tier display names when no topology supplies real ones
def _default_names(n: int) -> List[str]:
    return [f"tier{i}" for i in range(n)]


@dataclasses.dataclass(frozen=True)
class TaskResidual:
    """One schedule task's prediction joined with its recorded span
    (``measured_seconds`` is None when no span matched — e.g. a modeled
    walk with no trace attached)."""

    bucket: int
    phase: int
    level: int
    level_name: str
    op: str
    nbytes: int
    step: int
    release: Optional[int]
    stream: Optional[int]
    modeled_start: float
    modeled_finish: float
    measured_seconds: Optional[float] = None

    @property
    def modeled_seconds(self) -> float:
        return self.modeled_finish - self.modeled_start

    @property
    def residual_seconds(self) -> Optional[float]:
        return None if self.measured_seconds is None \
            else self.measured_seconds - self.modeled_seconds


@dataclasses.dataclass
class ResidualReport:
    """Per-task residuals plus the per-tier rollups the re-tune decision
    consumes."""

    tasks: List[TaskResidual]
    modeled_makespan: float
    compute_total: float = 0.0
    n_streams: int = 2
    level_names: Optional[List[str]] = None

    @property
    def modeled_exposed(self) -> float:
        """Modeled exposed communication: makespan minus the backward
        compute it hides under (`backward_overlapped_time`'s
        convention)."""
        return max(0.0, self.modeled_makespan - self.compute_total)

    def _names(self) -> List[str]:
        n = 1 + max((t.level for t in self.tasks), default=0)
        names = self.level_names or _default_names(n)
        return list(names)

    def modeled_occupancy(self) -> Dict[str, float]:
        """Seconds each tier's wires carry traffic under the model."""
        names = self._names()
        out = {n: 0.0 for n in names}
        for t in self.tasks:
            out[names[t.level]] += t.modeled_seconds
        return out

    def measured_occupancy(self) -> Dict[str, float]:
        """Seconds of recorded span time per tier (matched tasks only)."""
        names = self._names()
        out = {n: 0.0 for n in names}
        for t in self.tasks:
            if t.measured_seconds is not None:
                out[names[t.level]] += t.measured_seconds
        return out

    def occupancy_ratios(self) -> Dict[str, float]:
        """Per-tier measured/modeled wire occupancy, for tiers with both
        sides non-zero."""
        mod = self.modeled_occupancy()
        meas = self.measured_occupancy()
        return {n: meas[n] / mod[n] for n in mod
                if mod[n] > 0.0 and meas[n] > 0.0}

    def drift(self) -> float:
        """Scale-invariant per-tier drift: the largest deviation of a
        tier's measured/modeled occupancy ratio from the MEDIAN tier's
        ratio. Zero when no tier was measured; zero when every tier is
        off by the same factor (calibration, not drift); large when one
        tier's fabric degrades relative to the others. Feed it to
        ``TuningSession.retune_if_drifted(threshold, drift=...)``."""
        ratios = sorted(self.occupancy_ratios().values())
        if not ratios:
            return 0.0
        n = len(ratios)
        ref = ratios[n // 2] if n % 2 else \
            0.5 * (ratios[n // 2 - 1] + ratios[n // 2])
        if ref <= 0.0:
            return 0.0
        if n == 1:
            # one tier has no peers to drift against: fall back to the
            # absolute deviation from the model
            return abs(ratios[0] - 1.0)
        return max(abs(r / ref - 1.0) for r in ratios)

    def measured_tasks(self) -> int:
        return sum(1 for t in self.tasks if t.measured_seconds is not None)

    def render(self, indent: str = "  ") -> str:
        us = 1e6
        lines = [f"{indent}modeled makespan {self.modeled_makespan * us:10.1f} us"
                 f"   compute {self.compute_total * us:10.1f} us"
                 f"   exposed comm {self.modeled_exposed * us:10.1f} us",
                 f"{indent}tasks {len(self.tasks)}"
                 f" (measured {self.measured_tasks()})"
                 f"   drift {self.drift():.3f}"]
        mod = self.modeled_occupancy()
        meas = self.measured_occupancy()
        ratios = self.occupancy_ratios()
        for name in mod:
            r = f"{ratios[name]:6.2f}x" if name in ratios else "     --"
            lines.append(f"{indent}{name:12s} wire occupancy: modeled "
                         f"{mod[name] * us:10.1f} us  measured "
                         f"{meas[name] * us:10.1f} us  ratio {r}")
        return "\n".join(lines)

    def to_json(self) -> dict:
        return {
            "modeled_makespan_s": self.modeled_makespan,
            "compute_total_s": self.compute_total,
            "modeled_exposed_s": self.modeled_exposed,
            "n_streams": self.n_streams,
            "drift": self.drift(),
            "modeled_occupancy_s": self.modeled_occupancy(),
            "measured_occupancy_s": self.measured_occupancy(),
            "occupancy_ratios": self.occupancy_ratios(),
            "tasks": [dataclasses.asdict(t) for t in self.tasks],
        }

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1, sort_keys=True)


# ---------------------------------------------------------------------------
# building reports
# ---------------------------------------------------------------------------
def residual_report(
    sizes: Sequence[int],
    bucket_nbytes: Sequence[int],
    phase_cost,
    *,
    releases: Optional[Sequence[int]] = None,
    ready_times: Optional[Sequence[float]] = None,
    n_streams: int = 2,
    spans: Optional[Sequence[Span]] = None,
    level_names: Optional[Sequence[str]] = None,
    compute_total: Optional[float] = None,
) -> ResidualReport:
    """The core join: run `backward_overlapped_schedule`'s timed walk
    over the stream schedule (the modeled side) and attach recorded
    spans by their global ``(bucket, phase)`` schedule-task key (the
    measured side — run `trace.assign_stream_tags` first so the sink's
    local bucket tags are lifted onto the global schedule).

    ``bucket_nbytes`` are BYTE counts (`phase_cost` prices bytes — the
    ``streamed_sync_time`` convention); ``compute_total`` defaults to
    the last ready time (total backward compute)."""
    from repro_torch.core.analytical.hierarchy import backward_overlapped_schedule

    makespan, timed = backward_overlapped_schedule(
        list(sizes), [int(b) for b in bucket_nbytes], phase_cost,
        releases=list(releases) if releases is not None else None,
        ready_times=list(ready_times) if ready_times is not None else None,
        n_streams=n_streams)
    by_key: Dict = {}
    for s in spans or ():
        if s.kind == "collective" and s.release is not None:
            by_key[(s.bucket, s.phase)] = s
    names = list(level_names) if level_names is not None \
        else _default_names(len(sizes))
    tasks = []
    for t, start, fin in timed:
        s = by_key.get((t.bucket, t.phase))
        tasks.append(TaskResidual(
            bucket=t.bucket, phase=t.phase, level=t.level,
            level_name=names[t.level], op=t.op, nbytes=int(t.in_elems),
            step=t.step, release=getattr(t, "release", None),
            stream=getattr(t, "stream", None),
            modeled_start=start, modeled_finish=fin,
            measured_seconds=s.seconds if s is not None else None))
    if compute_total is None:
        compute_total = float(ready_times[-1]) if ready_times else 0.0
    return ResidualReport(tasks=tasks, modeled_makespan=makespan,
                          compute_total=float(compute_total),
                          n_streams=int(n_streams), level_names=names)


def modeled_gradient_report(
    levels,
    bucket_bytes: Sequence[int],
    compute_times: Sequence[float],
    methods=None,
    *,
    n_streams: int = 2,
    gamma: Optional[float] = None,
    spans: Optional[Sequence[Span]] = None,
    level_names: Optional[Sequence[str]] = None,
) -> ResidualReport:
    """Residual report priced under per-level `CommModel`s — the same
    ``(levels, bucket_bytes, compute_times)`` signature and the same
    pricing closure as ``backward_overlapped_time``, so the report's
    ``modeled_makespan`` reproduces that prediction EXACTLY."""
    from repro_torch.core.analytical.base import VPU_GAMMA
    from repro_torch.core.analytical.hierarchy import modeled_phase_cost

    ready, acc = [], 0.0
    for c in compute_times:
        acc += float(c)
        ready.append(acc)
    return residual_report(
        [p for p, _ in levels], [int(b) for b in bucket_bytes],
        modeled_phase_cost(levels, methods,
                           gamma=VPU_GAMMA if gamma is None else gamma),
        releases=list(range(len(bucket_bytes))), ready_times=ready,
        n_streams=n_streams, spans=spans, level_names=level_names)


def gradient_residual_report(
    comm,
    tree,
    *,
    recorder=None,
    spans: Optional[Sequence[Span]] = None,
    topology=None,
    bucket_bytes: Optional[int] = None,
    compute_times: Optional[Sequence[float]] = None,
    overlap_backward: bool = True,
    n_streams: Optional[int] = None,
) -> ResidualReport:
    """Residual report for a live `Communicator`'s gradient sync over
    ``tree``: the modeled side prices the EXACT stream schedule
    ``_explain_gradients_streamed`` renders (same bucket plan, same
    release order) on the topology's per-level simulators, with the
    communicator itself resolving {algorithm, segments} — so the priced
    schedule is the dispatched one. The measured side is ``recorder``
    (its spans are stream-tagged in place) or pre-tagged ``spans`` from
    `repro_torch.obs.replay`. ``compute_times`` are per-release backward
    compute slices (ready floors); omitted, communication is priced
    from time zero with zero compute to hide under."""
    from repro_torch import pytree
    from repro_torch.comms.bucketing import split_released
    from repro_torch.comms.communicator import N_STREAMS
    from repro_torch.core.topology.tune import decided_phase_cost
    from repro_torch.obs import trace as obs_trace

    topo = topology or comm.topology or comm.probed_topology
    if topo is None:
        raise ValueError("residual report needs a Topology (explicit, "
                         "attached, or probed) for the modeled side")
    if recorder is not None:
        n_streams = n_streams or int(recorder.meta.get("n_streams", 0)) \
            or None
        spans = obs_trace.assign_stream_tags(recorder)
    n_streams = n_streams or N_STREAMS
    bb = comm._resolve_bucket_bytes(bucket_bytes)

    stacks, _residual = split_released(tree) if overlap_backward \
        else ([], tree)
    plans = [plan for plan, _ in comm._release_schedule(
        stacks, bb, n_streams)[0]] if stacks \
        else [comm._bucket_plan(tree, bb)]
    n_layers, sizes = len(plans), plans[0][4]
    if len(sizes) != len(topo.levels):
        raise ValueError(
            f"topology has {len(topo.levels)} levels but the sync "
            f"composition spans {len(sizes)} tiers — attach the topology "
            f"the mesh actually syncs over")
    nbytes, releases = [], []
    for r, (layout, active, *_) in enumerate(plans):
        nbytes += [layout.buckets[i].elems
                   * pytree.itemsize(layout.buckets[i].dtype)
                   for i in active]
        releases += [r] * len(active)
    if compute_times is not None:
        assert len(compute_times) == n_layers, \
            "one backward-compute slice per release"
        ready, acc = [], 0.0
        for c in compute_times:
            acc += float(c)
            ready.append(acc)
        compute_total = acc
    else:
        ready, compute_total = None, 0.0
    return residual_report(
        sizes, nbytes, decided_phase_cost(topo, comm),
        releases=releases, ready_times=ready, n_streams=n_streams,
        spans=spans, level_names=[lv.name for lv in topo.levels],
        compute_total=compute_total)


def spans_from_timed(timed, *, level_scale: Optional[Dict[int, float]] = None
                     ) -> List[Span]:
    """Synthesize measured-style spans from a timed schedule walk
    (``backward_overlapped_schedule``'s ``[(task, start, finish)]``) —
    the benchmark's calibration path (a noise-sampled walk joined
    against the expected-time walk) and the drift tests' synthetic
    fabric (``level_scale`` stretches one tier's durations, modeling a
    degraded link)."""
    out = []
    for t, start, fin in timed:
        scale = (level_scale or {}).get(t.level, 1.0)
        out.append(Span(
            kind="collective", op=t.op, nbytes=int(t.in_elems),
            level=t.level, bucket=t.bucket, phase=t.phase, step=t.step,
            release=getattr(t, "release", 0),
            stream=getattr(t, "stream", 0), concrete=True,
            t_start=start, t_end=start + (fin - start) * scale))
    return out
