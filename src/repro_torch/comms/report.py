"""A copy of ``repro/comms/report.py``. The reference's text follows.

`PlanReport`: the explainable side of every `Communicator` dispatch.

PICO's argument (PAPERS.md) is that a tuned runtime must be able to say
WHY it picked a schedule. `Communicator.explain` resolves a list of
`CollectiveRequest`s through exactly the lookup path the executing ops
use and renders the per-leaf {algorithm, segments, level} choices — the
serve launcher's decode-plan output and the dry-run's collective section
are both this report.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from repro_torch.core.collectives.dispatch import CollectiveSpec
from repro_torch.comms.request import CollectiveRequest


@dataclasses.dataclass(frozen=True)
class PlanEntry:
    """One resolved dispatch decision: what executes, and why.

    ``bucket``/``step`` are set only by the bucketed overlap-pipelined
    gradient sync: which fusion bucket the entry belongs to, and the
    pipeline step it issues in (entries of the same step run on
    different tiers concurrently). ``release``/``stream`` are set only
    by the backward-overlapped stream schedule: the gradient-release
    event (backward order — release 0 is the deepest layer) that gates
    the entry, and the double-buffered permute stream carrying it."""

    request: CollectiveRequest
    spec: CollectiveSpec
    level: Optional[str] = None   # topology level name, hierarchical only
    source: str = "xla"           # "xla" | "static" | "table:<name>" | ...
    bucket: Optional[int] = None  # fusion-bucket index (pipelined sync)
    step: Optional[int] = None    # pipeline step (pipelined sync)
    release: Optional[int] = None  # grad-release event (streamed sync)
    stream: Optional[int] = None   # permute stream (streamed sync)
    measured_us: Optional[float] = None  # recorded span (measured overlay)

    def render(self) -> str:
        lvl = f" level={self.level}" if self.level else ""
        pipe = f" bucket={self.bucket} step={self.step}" \
            if self.bucket is not None else ""
        if self.release is not None:
            pipe += f" release={self.release} stream={self.stream}"
        meas = f" measured={self.measured_us:.1f}us" \
            if self.measured_us is not None else ""
        synth = ""
        if self.spec.algorithm.startswith("synth:"):
            synth = self._synth_steps()
        return (f"{self.request.op:14s} {self.request.nbytes:>10d} B "
                f"p={self.request.axis_size:<4d}-> "
                f"{self.spec.algorithm}{synth} segments={self.spec.segments}"
                f"{lvl}{pipe}{meas} [{self.source}]")

    def _synth_steps(self) -> str:
        """Step count of the synthesized program this entry dispatches —
        the same materialization the executing op performs, so when a
        nearest-on-grid decision falls back to the any-p family at this
        fan-out, the rendered program names the fallback."""
        from repro_torch.core.collectives import synth as _synth
        name = self.spec.algorithm[len("synth:"):]
        try:
            prog = _synth._dispatch_program(
                self.request.op, name, self.request.axis_size)
        except Exception:                   # invalid at this fan-out
            return " (steps=?)"
        via = "" if prog.name == name else f" via {prog.name}"
        return f" (steps={prog.n_steps}{via})"


@dataclasses.dataclass
class PlanReport:
    """Ordered dispatch decisions for a set of requests. A hierarchical
    composition expands to one entry per phase, in execution order.

    ``header`` is an optional context line rendered above the entries —
    the Communicator stamps its active mesh mapping there, so a plan
    printed from a placement-tuned artifact says which physical layout
    the decisions assume."""

    entries: List[PlanEntry]
    header: Optional[str] = None

    def __iter__(self):
        return iter(self.entries)

    def __len__(self):
        return len(self.entries)

    def specs(self) -> List[CollectiveSpec]:
        return [e.spec for e in self.entries]

    def render(self, indent: str = "  ") -> str:
        lines = [indent + self.header] if self.header else []
        lines.extend(indent + e.render() for e in self.entries)
        return "\n".join(lines)

    def with_measured(self, spans) -> "PlanReport":
        """Overlay recorded spans (`repro_torch.obs.trace.Span`, duck-typed)
        onto the plan: spans and entries are matched SEQUENTIALLY on
        ``(op, nbytes, axis)`` — both sides are in issue order by
        construction, and the key skips plan entries the recorder never
        dispatched (the flat path's psum tops run through
        ``group.psum``, not the tuned dispatch). Unmatched entries
        keep ``measured_us=None``."""
        spans = [s for s in spans
                 if getattr(s, "kind", "collective") == "collective"]
        out: List[PlanEntry] = []
        i = 0
        for e in self.entries:
            s = spans[i] if i < len(spans) else None
            if s is not None and s.op == e.request.op \
                    and int(s.nbytes) == int(e.request.nbytes) \
                    and s.axis == e.request.axis:
                out.append(dataclasses.replace(
                    e, measured_us=(s.t_end - s.t_start) * 1e6))
                i += 1
            else:
                out.append(e)
        return PlanReport(out, self.header)

    def to_json(self) -> List[dict]:
        return [{
            "op": e.request.op, "nbytes": e.request.nbytes,
            "axis_size": e.request.axis_size, "dtype": e.request.dtype,
            "algorithm": e.spec.algorithm, "segments": e.spec.segments,
            "level": e.level, "source": e.source,
            "bucket": e.bucket, "step": e.step,
            "release": e.release, "stream": e.stream,
            "measured_us": e.measured_us,
        } for e in self.entries]


def render_metrics(registry, indent: str = "  ") -> str:
    """Render a `repro_torch.obs.MetricsRegistry` (the Communicator's
    ``metrics``, a TraceRecorder's ``counters``) one counter per line —
    the dry-run / --explain counterpart of `PlanReport.render`."""
    lines = []
    for name, label, value in registry.items():
        tag = f"{{{label}}}" if label else ""
        val = f"{int(value)}" if float(value).is_integer() else f"{value:g}"
        lines.append(f"{indent}{name}{tag} = {val}")
    return "\n".join(lines)
