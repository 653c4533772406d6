"""Tuned-collective dispatch primitives (port of
``repro/core/collectives/dispatch.py``).

`CollectiveSpec` is the paper's 2-tuple (§3: "the simplest of the parameter
space consists of 2-tuples {algorithm, segment size}"). A `DecisionSource`
maps (op, message bytes, axis size) -> CollectiveSpec; it may be a static
config or a decision table produced by a tuner in
``repro_torch.core.tuning``.

The reference's trace branch (a span recorded around each dispatch when
an ``obs.trace`` recorder is installed) is left out until ``obs/trace`` is
ported; ``apply_collective`` is the reference's uninstrumented path.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.collectives import algorithms as alg


@dataclasses.dataclass(frozen=True)
class CollectiveSpec:
    algorithm: str = "xla"
    segments: int = 1

    def normalized(self) -> "CollectiveSpec":
        return CollectiveSpec(self.algorithm, max(1, int(self.segments)))


class DecisionSource:
    """Maps (op, nbytes, axis_size) -> CollectiveSpec."""

    def spec_for(self, op: str, nbytes: int, axis_size: int) -> CollectiveSpec:
        raise NotImplementedError


class StaticDecision(DecisionSource):
    def __init__(self, spec: CollectiveSpec):
        self.spec = spec.normalized()

    def spec_for(self, op, nbytes, axis_size):
        return self.spec


def apply_collective(op: str, x, axis, axis_size: int,
                     spec: CollectiveSpec, **kw):
    """Run ``op`` with the algorithm and segments of ``spec`` inside this
    rank (``axis`` is the process group, ``None`` for the default one)."""
    fn = alg.get(op, spec.algorithm)
    if op in ("all_reduce", "reduce_scatter", "reduce"):
        return fn(x, axis, axis_size, segments=spec.segments,
                  op=kw.get("reduce_op", "add"))
    return fn(x, axis, axis_size, segments=spec.segments)
