"""Tuned-collective dispatch primitives (port of
``repro/core/collectives/dispatch.py``).

`CollectiveSpec` is the paper's 2-tuple (§3: "the simplest of the parameter
space consists of 2-tuples {algorithm, segment size}"). A `DecisionSource`
maps (op, message bytes, axis size) -> CollectiveSpec; it may be a static
config or a decision table produced by a tuner in
``repro_torch.core.tuning``.

This module is an implementation detail of
`repro_torch.comms.Communicator`, the one tuned-collective entry point,
and of the artifact loaders in ``repro_torch.core.topology``.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.collectives import algorithms as alg
from repro_torch.obs import trace as obs_trace


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
    rank (``axis`` is the process group: a named mesh `group.Axis`, or
    ``None`` for the default one)."""
    fn = alg.get(op, spec.algorithm)
    rec = obs_trace.active()
    if rec is not None:
        # trace mode: the recorder dispatches and records the span; with
        # no recorder installed (the common case) this is one dead branch
        # and the path below is byte-for-byte the uninstrumented dispatch
        return rec.run_collective(fn, op, x, axis, axis_size, spec, kw)
    if op in ("all_reduce", "reduce_scatter", "reduce"):
        return fn(x, axis, axis_size, segments=spec.segments,
                  op=kw.get("reduce_op", "add"))
    return fn(x, axis, axis_size, segments=spec.segments)
