"""A copy of ``repro/obs/metrics.py``. The reference's text follows.

Lightweight counters for the tuned-collective runtime.

A `MetricsRegistry` is a flat ``(name, label) -> float`` accumulator —
bytes moved per tier, collectives issued per algorithm, decision-cache
hits and misses. It is deliberately dumb: no locks, no histograms, no
export protocol — the counters exist so a launch (or a test) can ask
"how many table lookups did this step trace actually perform" without
instrumenting call sites by hand. `repro_torch.comms.report.render_metrics`
renders one, and the summary artifact (`obs.export`) embeds one.
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple


class MetricsRegistry:
    """Labelled monotonic counters. ``label`` partitions a counter by a
    low-cardinality dimension (a tier's axis name, an algorithm name, a
    cache name); the empty label is the plain unpartitioned counter."""

    def __init__(self):
        self._counts: Dict[Tuple[str, str], float] = {}

    def inc(self, name: str, value: float = 1, *, label: str = "") -> None:
        key = (name, str(label))
        self._counts[key] = self._counts.get(key, 0.0) + float(value)

    def get(self, name: str, *, label: str = "") -> float:
        return self._counts.get((name, str(label)), 0.0)

    def total(self, name: str) -> float:
        """Sum of a counter across all its labels."""
        return sum(v for (n, _), v in self._counts.items() if n == name)

    def items(self) -> Iterator[Tuple[str, str, float]]:
        """(name, label, value), sorted for stable rendering."""
        for (name, label) in sorted(self._counts):
            yield name, label, self._counts[(name, label)]

    def merge(self, other: "MetricsRegistry") -> "MetricsRegistry":
        for name, label, value in other.items():
            self.inc(name, value, label=label)
        return self

    def __len__(self) -> int:
        return len(self._counts)

    def __bool__(self) -> bool:
        return bool(self._counts)

    def to_json(self) -> Dict[str, float]:
        """``{"name{label}": value}`` — the summary-artifact encoding."""
        out: Dict[str, float] = {}
        for name, label, value in self.items():
            key = f"{name}{{{label}}}" if label else name
            out[key] = value
        return out
