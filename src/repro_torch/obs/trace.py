"""Schedule-keyed trace spans for the tuned-collective runtime (port of
``repro/obs/trace.py``).

The reference waits for a span's output with ``jax.block_until_ready``
and tells a traced call (a ``jax.core.Tracer`` under ``jit``/``shard_map``,
recorded with ``concrete=False`` and zero duration) from an eager one.
In the port every call runs eagerly inside its rank, so every span is
concrete: its end is read once the output is ready, after synchronizing
the CUDA stream that computed it (a CPU output is ready when the call
returns; the backward-overlapped sync's thread has a stream of its own,
so its spans do not wait for the backward). A span's ``axis`` is the
axis NAME (the port dispatches over a named
`repro_torch.core.collectives.group.Axis`), as in the reference. The
reference's text follows.

PICO's argument (PAPERS.md) is that performance insight must be
STRUCTURED — attributed to the schedule that executed, not dumped as
wall-clock totals. Because this repo's executor, plan renderer and cost
model all walk the same task list (plan == executed == modeled, see
``core/collectives/schedule``), a span recorded per schedule task can be
joined 1:1 against both the rendered `PlanEntry` and the analytical
prediction — that join is `repro.obs.residuals`.

The recorder follows the ``grad_release`` sink pattern exactly: a
module-global hook that is ``None`` by default, checked with one load at
the dispatch choke point (`core.collectives.dispatch.apply_collective`).
With no recorder installed the traced code paths are bit-identical to
the uninstrumented runtime — the instrumentation adds a single
``is None`` branch and nothing else.

Spans carry the exact schedule-task identity the `PlanEntry` tags:
(bucket, phase, level, step, release, stream). The executor stamps the
local tags as it issues (`execute_pipelined` pushes bucket/phase/level/
step, the release sink pushes the release index); the global
stream-schedule tags are assigned afterwards by `assign_stream_tags`,
which rebuilds ``build_stream_schedule`` over the recorded releases —
the step recurrence is element-count independent, so the recorded spans
get the SAME (step, stream) the plan renderer prints.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Union

import torch

from repro_torch import pytree
from repro_torch.obs.metrics import MetricsRegistry


def ready(out):
    """Wait until ``out`` (a tensor) is computed: synchronize the current
    CUDA stream of its device, the one that computed it; a CPU tensor is
    ready already. Returns ``out``."""
    if isinstance(out, torch.Tensor) and out.device.type == "cuda":
        torch.cuda.current_stream(out.device).synchronize()
    return out


@dataclasses.dataclass
class Span:
    """One recorded event. ``kind`` is "collective" (a dispatched
    schedule task) or "compute" (the backward-compute gap between two
    gradient releases, recorded by the release sink). The schedule tags
    mirror `repro_torch.comms.report.PlanEntry`; ``bucket``/``step``/``stream``
    are LOCAL until `assign_stream_tags` lifts them onto the global
    stream schedule."""

    kind: str = "collective"
    op: str = ""
    nbytes: int = 0
    axis: Optional[str] = None
    axis_size: int = 0
    dtype: str = ""
    algorithm: str = ""
    segments: int = 1
    bucket: Optional[int] = None
    phase: Optional[int] = None
    level: Optional[int] = None
    step: Optional[int] = None
    release: Optional[int] = None
    stream: Optional[int] = None
    concrete: bool = False      # timed for real vs structural (trace time)
    t_start: float = 0.0
    t_end: float = 0.0

    @property
    def seconds(self) -> float:
        return max(0.0, self.t_end - self.t_start)

    def key(self):
        """The schedule-task join key shared with the analytical walk."""
        return (self.bucket, self.phase)

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


class FakeClock:
    """A deterministic ``perf_counter`` stand-in: every call returns the
    current time, then advances it by ``step`` (and `advance` jumps it
    explicitly). Shared by the TraceRecorder tests and the
    `repro_torch.comms.probe` timing tests — the last call sites that used to
    hard-code ``time.perf_counter``."""

    def __init__(self, step: float = 0.0, start: float = 0.0):
        self.now = float(start)
        self.step = float(step)

    def __call__(self) -> float:
        t = self.now
        self.now += self.step
        return t

    def advance(self, dt: float) -> None:
        self.now += float(dt)


class TraceRecorder:
    """Records spans for every collective the runtime dispatches while
    the recorder is installed (`installed`, or ``Communicator.create(
    trace=...)``). ``clock`` injects a fake timer (tests)."""

    def __init__(self, clock=None):
        self.clock = clock or time.perf_counter
        self.spans: List[Span] = []
        self.counters = MetricsRegistry()
        self.meta: Dict[str, Any] = {}
        self._tags: Dict[str, Any] = {}
        self._mark: Optional[float] = None   # end of the last dispatch

    # -- tag stack (the executor pushes schedule-task identity) -------------
    @contextlib.contextmanager
    def tags(self, **kw):
        saved = self._tags
        self._tags = {**saved, **kw}
        try:
            yield self
        finally:
            self._tags = saved

    # -- recording ----------------------------------------------------------
    def run_collective(self, fn, op: str, x, axis: str, axis_size: int,
                       spec, kw: Dict[str, Any]):
        """Dispatch one collective and record its span. Called by
        ``apply_collective`` ONLY when a recorder is installed."""
        span = Span(
            kind="collective", op=op,
            nbytes=int(x.numel()) * x.element_size(),
            axis=getattr(axis, "name", axis), axis_size=int(axis_size),
            dtype=pytree.dtype_name(x.dtype), algorithm=spec.algorithm,
            segments=int(spec.segments), concrete=True,
            **{k: self._tags.get(k) for k in
               ("bucket", "phase", "level", "step", "release", "stream")})
        t0 = self.clock()
        if op in ("all_reduce", "reduce_scatter", "reduce"):
            out = fn(x, axis, axis_size, segments=spec.segments,
                     op=kw.get("reduce_op", "add"))
        else:
            out = fn(x, axis, axis_size, segments=spec.segments)
        ready(out)
        t1 = self.clock()
        span.t_start, span.t_end = t0, t1
        self.spans.append(span)
        self._mark = t1
        self.counters.inc("collective_bytes", span.nbytes, label=span.axis)
        self.counters.inc("collectives", label=spec.algorithm)
        return out

    def note_release(self, tag, release: int, n_streams: int) -> None:
        """Record the backward-compute gap since the previous dispatch as
        a compute span — the release sink calls this the moment backward
        compute hands over a layer's gradients."""
        self.meta["n_streams"] = int(n_streams)
        t = self.clock()
        if self._mark is not None and t > self._mark:
            self.spans.append(Span(kind="compute", op=str(tag[0]) if tag
                                   else "compute", release=int(release),
                                   concrete=True, t_start=self._mark,
                                   t_end=t))
        self._mark = t
        self.counters.inc("releases")

    # -- views --------------------------------------------------------------
    def collective_spans(self) -> List[Span]:
        return [s for s in self.spans if s.kind == "collective"]

    def clear(self) -> None:
        self.spans = []
        self._tags = {}
        self._mark = None

    # ``with recorder:`` installs it globally for the block
    def __enter__(self) -> "TraceRecorder":
        self._cm = installed(self)
        return self._cm.__enter__()

    def __exit__(self, *exc):
        return self._cm.__exit__(*exc)


# ---------------------------------------------------------------------------
# the module-global hook (grad_release-sink pattern)
# ---------------------------------------------------------------------------
_ACTIVE: Optional[TraceRecorder] = None


def active() -> Optional[TraceRecorder]:
    """The installed recorder, or None (the common, zero-overhead case)."""
    return _ACTIVE


@contextlib.contextmanager
def installed(recorder: Optional[TraceRecorder]):
    """Install ``recorder`` as the global trace hook for the block.
    ``None`` is a no-op — an already-installed recorder keeps capturing,
    so ``Communicator`` methods can wrap themselves unconditionally."""
    global _ACTIVE
    if recorder is None:
        yield _ACTIVE
        return
    prev = _ACTIVE
    _ACTIVE = recorder
    try:
        yield recorder
    finally:
        _ACTIVE = prev


@contextlib.contextmanager
def suspended():
    """Force tracing OFF for the block — replay measurement re-executes
    schedule tasks and must not re-record them through the dispatch
    hook."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = None
    try:
        yield
    finally:
        _ACTIVE = prev


# ---------------------------------------------------------------------------
# lifting executor-local tags onto the global stream schedule
# ---------------------------------------------------------------------------
def assign_stream_tags(spans: Union[TraceRecorder, Sequence[Span]],
                       n_streams: Optional[int] = None) -> List[Span]:
    """Rewrite release-tagged spans' (bucket, step, stream) from the
    GLOBAL backward-overlapped stream schedule, in place.

    The release sink dispatches each release through its LOCAL bucket
    plan (bucket 0..n_active-1, pipeline step = bucket + phase), exactly
    as ``_sync_release`` executes; the plan renderer instead tags the
    global ``build_stream_schedule`` over all releases. The global step
    recurrence is element-count independent, so rebuilding the stream
    schedule over the recorded (release, bucket, phase) triples — with
    dummy element counts — reproduces the renderer's step/stream tags
    without duplicating the recurrence. Returns the full span list
    (modified in place); spans without a release tag (the residual sync)
    are left untouched."""
    if isinstance(spans, TraceRecorder):
        n_streams = n_streams or int(spans.meta.get("n_streams", 0)) or None
        spans = spans.spans
    out = list(spans)
    rel = [s for s in out if s.kind == "collective" and s.release is not None]
    if not rel:
        return out
    n_streams = n_streams or 2
    order: List[int] = []
    groups: Dict[int, List[Span]] = {}
    for s in rel:
        if s.release not in groups:
            groups[s.release] = []
            order.append(s.release)
        groups[s.release].append(s)
    n_levels = max(s.level for s in rel if s.level is not None) + 1
    per = max(len({s.bucket for s in g}) for g in groups.values())
    releases = [r for r in order for _ in range(per)]

    from repro_torch.core.collectives.schedule import build_stream_schedule
    sched = build_stream_schedule([1] * len(releases), [2] * n_levels,
                                  releases=releases, n_streams=n_streams)
    by_bp = {(t.bucket, t.phase): t for t in sched.tasks}
    for i, r in enumerate(order):
        for s in groups[r]:
            t = by_bp[(i * per + s.bucket, s.phase)]
            s.bucket = i * per + s.bucket
            s.step = t.step
            s.stream = t.stream
    return out
