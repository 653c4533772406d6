"""The tuning parameter space (survey §3): the 3-d experiment grid
{op, processes, message size} and the 2-tuple output {algorithm, segments}.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence

from repro_torch.core.collectives.algorithms import ALGORITHMS

OPS: tuple = ("all_reduce", "reduce_scatter", "all_gather", "broadcast",
              "all_to_all")

#: tunable (non-xla) algorithms per op
TUNABLE: Dict[str, List[str]] = {
    op: [a for a in algos] for op, algos in ALGORITHMS.items()
    if op in OPS
}

SEGMENT_CANDIDATES = (1, 2, 4, 8, 16, 32, 64)

#: the small-message decode regime: per-token serving collectives (TP logits
#: all-gather, residual all-reduce at batch x d_model) are KB-scale, where
#: latency dominates and the optimal algorithm flips vs the MB training
#: regime — powers of two from 1 KB to 1 MB
DECODE_MESSAGE_SIZES = tuple(1024 * 2 ** i for i in range(11))

#: default experiment grid (bytes) — the coarse powers-of-four sweep from
#: 256 B to 64 MB, densified with the decode regime so every KB-scale
#: serving message resolves to a nearby tuned point instead of snapping
#: across the latency/bandwidth knee
MESSAGE_SIZES = tuple(sorted(set(256 * 4 ** i for i in range(10))
                             | set(DECODE_MESSAGE_SIZES)))

PROCESS_COUNTS = (2, 4, 8, 16, 32, 64, 128, 256)

#: which algorithms support segmentation
SEGMENTED = {
    ("all_reduce", "ring"),
    ("broadcast", "chain"),
    ("broadcast", "pipelined_binary"),
}


@dataclasses.dataclass(frozen=True)
class Point:
    """One cell of the 3-d experiment grid."""
    op: str
    p: int
    m: int                      # message bytes


@dataclasses.dataclass(frozen=True)
class Method:
    """The survey's output 2-tuple."""
    algorithm: str
    segments: int = 1


def methods_for(op: str, include_xla: bool = True,
                p: Optional[int] = None) -> List[Method]:
    """Candidate (algorithm, segments) tuples for one op.

    When the concrete fan-out ``p`` is given, the pareto-front
    programs registered by the synthesizer (``collectives/synth.py``)
    at (op, p) join the menu as ``synth:<name>`` candidates, so every
    tuner ranks hand-written and synthesized schedules on equal
    footing.  With no registrations (the default state) the menu is
    unchanged.
    """
    out = []
    for a in TUNABLE[op]:
        if not include_xla and a == "xla":
            continue
        segs = SEGMENT_CANDIDATES if (op, a) in SEGMENTED else (1,)
        out.extend(Method(a, s) for s in segs)
    if p is not None:
        from repro_torch.core.collectives import synth
        out.extend(Method(f"synth:{name}", 1)
                   for name in synth.registered(op, p))
    return out


def grid(ops: Sequence[str] = OPS,
         ps: Sequence[int] = PROCESS_COUNTS,
         ms: Sequence[int] = MESSAGE_SIZES) -> List[Point]:
    return [Point(o, p, m) for o, p, m in itertools.product(ops, ps, ms)]
