"""Trace and summary artifacts (port of ``repro/obs/export.py``; the
same documents from the port's spans and counters). The reference's text
follows.

`chrome_trace` converts recorded spans into Chrome trace-event JSON
(load it in Perfetto / ``chrome://tracing``): one track per
``(tier, stream)`` wire — exactly the serial resources the cost model's
timed walk occupies — plus a compute track built from the release sink's
backward-compute gaps, so the rendered timeline is the same picture
``backward_overlapped_schedule`` predicts and the residual report
scores. `summary` bundles the counters, the residual rollup, and any
launcher extras into one flat JSON document (the ``--trace-dir``
artifact format documented in ``examples/artifacts/README.md``).
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import Span, TraceRecorder


def _track_name(span: Span, level_names: Optional[Sequence[str]]) -> str:
    if span.kind == "compute":
        return "compute"
    if span.level is None:
        return "collectives"
    name = level_names[span.level] if level_names is not None \
        and span.level < len(level_names) else f"tier{span.level}"
    return f"{name} s{span.stream}" if span.stream is not None else name


def chrome_trace(spans, *, level_names: Optional[Sequence[str]] = None
                 ) -> Dict:
    """Spans -> a Chrome trace-event document (``traceEvents`` with one
    complete ("X") event per span, microsecond timestamps relative to
    the first span, one named thread per wire/compute track)."""
    if isinstance(spans, TraceRecorder):
        spans = spans.spans
    spans = list(spans)
    t0 = min((s.t_start for s in spans), default=0.0)
    tids: Dict[str, int] = {}
    events: List[Dict] = []
    for s in spans:
        track = _track_name(s, level_names)
        if track not in tids:
            tids[track] = len(tids)
            events.append({"ph": "M", "pid": 0, "tid": tids[track],
                           "name": "thread_name",
                           "args": {"name": track}})
        name = s.op if s.kind == "compute" \
            else f"{s.op} b{s.bucket}.p{s.phase}"
        ev = {"ph": "X", "pid": 0, "tid": tids[track], "name": name,
              "ts": (s.t_start - t0) * 1e6,
              "dur": max(0.0, s.t_end - s.t_start) * 1e6,
              "cat": s.kind}
        if s.kind == "collective":
            ev["args"] = {"nbytes": s.nbytes, "axis": s.axis,
                          "axis_size": s.axis_size,
                          "algorithm": s.algorithm, "segments": s.segments,
                          "bucket": s.bucket, "phase": s.phase,
                          "step": s.step, "release": s.release,
                          "stream": s.stream, "concrete": s.concrete}
        elif s.release is not None:
            ev["args"] = {"release": s.release}
        events.append(ev)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, spans, *,
                       level_names: Optional[Sequence[str]] = None) -> None:
    with open(path, "w") as f:
        json.dump(chrome_trace(spans, level_names=level_names), f)


def summary(*, counters: Optional[MetricsRegistry] = None,
            residuals=None, extra: Optional[Dict] = None) -> Dict:
    """One flat summary document: counters (`MetricsRegistry.to_json`),
    the residual rollup (`ResidualReport.to_json` minus the per-task
    list — that detail lives in the trace), and launcher extras."""
    out: Dict = {}
    if counters is not None:
        out["counters"] = counters.to_json()
    if residuals is not None:
        r = residuals.to_json()
        r.pop("tasks", None)
        out["residuals"] = r
        out["drift"] = r["drift"]
    if extra:
        out.update(extra)
    return out


def write_summary(path: str, *, counters: Optional[MetricsRegistry] = None,
                  residuals=None, extra: Optional[Dict] = None) -> None:
    with open(path, "w") as f:
        json.dump(summary(counters=counters, residuals=residuals,
                          extra=extra), f, indent=1, sort_keys=True)
