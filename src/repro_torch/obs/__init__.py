"""Telemetry of the port (port of ``repro.obs``): schedule-keyed trace
spans (`trace`), counters (`metrics`), measured-vs-modeled residuals
(`residuals`), Perfetto/summary artifacts (`export`) and standalone
per-task schedule measurement (`replay`).

As in the reference, this package root pulls in ONLY `trace` and
`metrics`, which depend on nothing inside ``repro_torch.core``: the
dispatch layer (`core.collectives.dispatch`) imports the trace hook, so
anything heavier here would be a cycle. `residuals`, `export` and
`replay` load lazily on first attribute access (or via an explicit
submodule import).
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
    "residuals", "export", "replay",
]


def __getattr__(name):
    if name in ("residuals", "export", "replay"):
        import importlib
        return importlib.import_module(f"repro_torch.obs.{name}")
    raise AttributeError(f"module 'repro_torch.obs' has no attribute "
                         f"{name!r}")
