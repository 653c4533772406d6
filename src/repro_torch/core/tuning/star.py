"""STAR-MPI-style dynamic self-tuning (survey §3.2.3): delayed finalization
of the collective routine. Per context (op, p, message bucket) the tuner
alternates between

  measure-select — round-robin over candidate methods, k trials each, then
  commit to the best observed;
  monitor-adapt  — EWMA-track the committed method; if performance degrades
  past a threshold (environment drift), re-enter measure-select.

"Algorithm grouping" (§3.2.3) prunes the candidate list with the analytical
models before any measurement is spent.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.analytical.base import DEFAULT_HOCKNEY
from repro_torch.core.analytical.costs import collective_cost
from repro_torch.core.tuning.space import Method, methods_for


def _bucket(m: int) -> int:
    return int(math.log2(max(m, 1)))


@dataclasses.dataclass
class _Ctx:
    candidates: List[Method]
    stage: str = "measure"          # measure | monitor
    cand_idx: int = 0
    trial: int = 0
    sums: Dict[int, float] = dataclasses.field(default_factory=dict)
    counts: Dict[int, int] = dataclasses.field(default_factory=dict)
    committed: Optional[Method] = None
    baseline: float = 0.0           # committed method's measured mean
    ewma: float = 0.0
    n_adaptations: int = 0


class StarTuner:
    def __init__(self, *, trials_per_candidate: int = 3,
                 degrade_threshold: float = 1.3, ewma_alpha: float = 0.25,
                 group_with_model: bool = True, group_keep: int = 4):
        self.k = trials_per_candidate
        self.th = degrade_threshold
        self.alpha = ewma_alpha
        self.group = group_with_model
        self.group_keep = group_keep
        self.ctxs: Dict[tuple, _Ctx] = {}
        self.total_overhead_calls = 0

    def _ctx(self, op: str, p: int, m: int) -> _Ctx:
        key = (op, p, _bucket(m))
        if key not in self.ctxs:
            cands = methods_for(op, include_xla=False, p=p)
            if self.group:
                # algorithm grouping: keep the model-predicted top-k methods
                cands = sorted(
                    cands,
                    key=lambda me: collective_cost(
                        op, me.algorithm, DEFAULT_HOCKNEY, p, m,
                        segments=me.segments))[:self.group_keep]
            self.ctxs[key] = _Ctx(candidates=cands)
        return self.ctxs[key]

    def select(self, op: str, p: int, m: int) -> Method:
        """The method this invocation should use."""
        c = self._ctx(op, p, m)
        if c.stage == "measure":
            self.total_overhead_calls += 1
            return c.candidates[c.cand_idx]
        return c.committed

    def record(self, op: str, p: int, m: int, seconds: float):
        """Feed back the observed duration of the method from select()."""
        c = self._ctx(op, p, m)
        if c.stage == "measure":
            c.sums[c.cand_idx] = c.sums.get(c.cand_idx, 0.0) + seconds
            c.counts[c.cand_idx] = c.counts.get(c.cand_idx, 0) + 1
            c.trial += 1
            if c.trial >= self.k:
                c.trial = 0
                c.cand_idx += 1
                if c.cand_idx >= len(c.candidates):
                    means = {i: c.sums[i] / c.counts[i] for i in c.sums}
                    best = min(means, key=means.get)
                    c.committed = c.candidates[best]
                    c.baseline = means[best]
                    c.ewma = means[best]
                    c.stage = "monitor"
        else:
            c.ewma = (1 - self.alpha) * c.ewma + self.alpha * seconds
            if c.ewma > self.th * c.baseline:
                # drift detected: re-enter measure-select
                c.stage = "measure"
                c.cand_idx = 0
                c.trial = 0
                c.sums.clear()
                c.counts.clear()
                c.n_adaptations += 1

    def committed(self, op: str, p: int, m: int) -> Optional[Method]:
        c = self._ctx(op, p, m)
        return c.committed if c.stage == "monitor" else None
