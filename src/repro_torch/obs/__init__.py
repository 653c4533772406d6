"""Telemetry of the port (port of ``repro.obs``): schedule-keyed trace
spans (`trace`), counters (`metrics`) and the ``--trace-dir`` summary
(`export`, ``write_summary`` only).

As in the reference, this package root pulls in ONLY `trace` and
`metrics`, which depend on nothing inside ``repro_torch.core``: the
dispatch layer (`core.collectives.dispatch`) imports the trace hook.
``residuals`` and ``replay`` are not ported yet.
"""
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import (
    FakeClock,
    Span,
    TraceRecorder,
    active,
    assign_stream_tags,
    installed,
    suspended,
)

__all__ = [
    "MetricsRegistry", "FakeClock", "Span", "TraceRecorder",
    "active", "assign_stream_tags", "installed", "suspended",
]
