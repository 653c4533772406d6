"""Rule-based dynamic feedback control (survey §3.4.5, Fagg et al. —
"Flexible collective communication tuning architecture applied to Open
MPI"): a rule TABLE of (predicate over standardized parameters ->
terminal = {algorithm, segments}), revised each iteration window from
measured performance, with NO offline training phase.

Rules are ordered; the first matching predicate fires. The feedback loop
keeps per-rule EWMA of observed times and, at window boundaries, replaces
the terminal of under-performing rules with the best method observed in an
epsilon-exploration pool — the survey's "modify or develop the rule table
according to the measured performance data".
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.tuning.space import Method, methods_for


@dataclasses.dataclass
class Rule:
    """predicate over (op, p, m); terminal = Method."""

    name: str
    predicate: Callable[[str, int, int], bool]
    terminal: Method
    ewma: float = float("nan")
    n_obs: int = 0


def default_rule_table(op: str) -> List[Rule]:
    """Seed table over the standardized parameters the survey names
    (communicator size x message size buckets), terminals = conventional
    MPI defaults. The feedback loop revises terminals per bucket; the
    PREDICATES stay fixed — the survey's §3.4.6 "static rule set"
    limitation is structural and kept on purpose."""
    meths = methods_for(op, include_xla=False)

    def has(algo, segments=1):
        for m in meths:
            if m.algorithm == algo and m.segments == segments:
                return m
        for m in meths:
            if m.algorithm == algo:
                return m
        return meths[0]

    small_default = {
        "all_reduce": has("recursive_doubling"),
        "broadcast": has("binomial"),
        "all_gather": has("recursive_doubling"),
        "reduce_scatter": has("recursive_halving"),
        "all_to_all": has("bruck"),
    }.get(op, meths[0])
    large_default = {
        "all_reduce": has("ring"),
        "broadcast": has("van_de_geijn"),
        "all_gather": has("ring"),
        "reduce_scatter": has("ring"),
        "all_to_all": has("pairwise"),
    }.get(op, meths[0])

    rules = []
    p_edges = [(0, 8), (8, 32), (32, 128), (128, 1 << 30)]
    m_edges = [(0, 1 << 16), (1 << 16, 4 << 20), (4 << 20, 1 << 62)]
    for plo, phi in p_edges:
        for mlo, mhi in m_edges:
            term = small_default if mhi <= (1 << 16) else large_default

            def pred(o, pp, mm, _plo=plo, _phi=phi, _mlo=mlo, _mhi=mhi):
                return _plo < pp <= _phi and _mlo <= mm < _mhi

            rules.append(Rule(f"p{phi}_m{mhi}", pred, term))
    rules.append(Rule("fallback", lambda o, pp, mm: True, large_default))
    return rules


class FeedbackController:
    """Per-op rule tables + epsilon-greedy revision at window boundaries."""

    def __init__(self, *, window: int = 32, epsilon: float = 0.15,
                 ewma_alpha: float = 0.3, degrade: float = 1.2, seed: int = 0):
        self.window = window
        self.epsilon = epsilon
        self.alpha = ewma_alpha
        self.degrade = degrade
        self.rng = np.random.default_rng(seed)
        self.tables: Dict[str, List[Rule]] = {}
        self._probe: Dict[tuple, Dict[Method, list]] = {}
        self._tick: Dict[str, int] = {}
        self.revisions = 0

    def _table(self, op):
        if op not in self.tables:
            self.tables[op] = default_rule_table(op)
            self._tick[op] = 0
        return self.tables[op]

    def _rule_for(self, op, p, m) -> Rule:
        for rule in self._table(op):
            if rule.predicate(op, p, m):
                return rule
        return self._table(op)[-1]

    def select(self, op: str, p: int, m: int) -> Method:
        rule = self._rule_for(op, p, m)
        if self.rng.random() < self.epsilon:
            # exploration probe
            cands = methods_for(op, include_xla=False, p=p)
            meth = cands[self.rng.integers(len(cands))]
            self._last = (op, p, m, meth, True)
            return meth
        self._last = (op, p, m, rule.terminal, False)
        return rule.terminal

    def record(self, seconds: float):
        op, p, m, meth, probe = self._last
        key = (op, self._rule_for(op, p, m).name)
        self._probe.setdefault(key, {}).setdefault((p, m), {}) \
            .setdefault(meth, []).append(seconds)
        rule = self._rule_for(op, p, m)
        if not probe:
            rule.ewma = (seconds if math.isnan(rule.ewma)
                         else (1 - self.alpha) * rule.ewma
                         + self.alpha * seconds)
            rule.n_obs += 1
        self._tick[op] += 1
        if self._tick[op] % self.window == 0:
            self._revise(op)

    def _revise(self, op: str):
        """Window boundary: re-point each rule at the method with the best
        POINT-NORMALIZED time. Raw means would mix message scales within a
        bucket (a bad method probed at 4 MB looks faster than a good one
        probed at 64 MB); normalizing per grid point removes the scale."""
        for rule in self._table(op):
            key = (op, rule.name)
            obs = self._probe.get(key, {})
            if not obs:
                continue
            ratios: Dict[Method, list] = {}
            for point, per_meth in obs.items():
                means = {meth: float(np.mean(ts))
                         for meth, ts in per_meth.items() if ts}
                if len(means) < 2:
                    continue
                floor = min(means.values())
                for meth, t in means.items():
                    ratios.setdefault(meth, []).append(t / floor)
            scores = {meth: float(np.mean(rs)) for meth, rs in ratios.items()
                      if len(rs) >= 1}
            if not scores:
                continue
            best = min(scores, key=scores.get)
            cur = scores.get(rule.terminal)
            if best != rule.terminal and (
                    cur is None or scores[best] * self.degrade < cur):
                rule.terminal = best
                self.revisions += 1
            # sliding evidence window per point
            for point, per_meth in obs.items():
                for meth in list(per_meth):
                    per_meth[meth] = per_meth[meth][-self.window:]
