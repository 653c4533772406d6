"""The unified Tuner interface (port of ``repro/core/tuning/tuners.py``;
the tuner modules are copies of the reference's numpy modules).

Every survey family — exhaustive/thinned AEOS sweeps (§3.2), SMGD heuristic
search (§3.2.2), STAR-style delayed finalization (§3.2.3), quad/oct-tree
decision-map encodings (§3.3), C4.5 trees, L1 regression, bagged ensembles
and the sigmoid ANN (§3.4), rule-table feedback control (§3.4.5), and the
full UMTAC architecture (§5) — implements

    fit(session: TuningSession) -> DecisionTable

with all measurements flowing through the session's shared cache, so tuners
are comparable on the survey's cost axis (``TunerReport.n_experiments``)
and a cheap tuner run after an expensive one costs nothing new. On a
`DeviceBackend` each trial is the maximum over the ranks, and every random
source is seeded, so the adaptive families (``star``, ``feedback``) choose
the same next probe in every rank.

The returned DecisionTable carries TableMeta provenance (tuner name, probed
grid, backend profile) and serializes to the reference's JSON artifact.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Protocol, Sequence

from repro_torch.core.tuning.decision import DecisionTable, TableMeta
from repro_torch.core.tuning.exhaustive import tune_exhaustive
from repro_torch.core.tuning.heuristic import tune_heuristic
from repro_torch.core.tuning.session import TuningSession
from repro_torch.core.tuning.space import (
    MESSAGE_SIZES,
    OPS,
    PROCESS_COUNTS,
    Method,
    methods_for,
)


class Tuner(Protocol):
    """What TuningSession.fit_all drives."""

    name: str

    def fit(self, session: TuningSession) -> DecisionTable:
        ...


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------
def _profile_meta(session: TuningSession) -> tuple:
    sim = getattr(session.backend, "sim", None)
    if sim is not None:
        return "simulator", dataclasses.asdict(sim.profile)
    return type(session.backend).__name__, None


def _meta(name: str, session: TuningSession, ops, ps, ms) -> TableMeta:
    backend, profile = _profile_meta(session)
    from repro_torch.core.collectives import synth
    return TableMeta(tuner=name, ops=tuple(ops), ps=tuple(ps), ms=tuple(ms),
                     backend=backend, profile=profile,
                     # synthesized candidates the rows may reference ride
                     # along in the artifact (None when none registered)
                     programs=synth.programs_to_json(ops, ps))


def _densify(decide: Callable[[str, int, int], Method],
             ops, ps, ms) -> Dict[tuple, Method]:
    return {(o, p, m): decide(o, p, m) for o in ops for p in ps for m in ms}


def _base_table(session: TuningSession, ops, ps, ms,
                trials: Optional[int]) -> tuple:
    """Experimental-argmin table + dataset (cache-shared across tuners)."""
    ex = session.executor(trials)
    table, ds, _ = tune_exhaustive(ex, ops, ps, ms)
    return table, ds


class _GridTuner:
    """Base: a tuner probing an explicit (ops, ps, ms) grid."""

    name = "grid"

    def __init__(self, ops: Sequence[str] = OPS,
                 ps: Sequence[int] = PROCESS_COUNTS,
                 ms: Sequence[int] = MESSAGE_SIZES,
                 trials: Optional[int] = None):
        self.ops, self.ps, self.ms = tuple(ops), tuple(ps), tuple(ms)
        self.trials = trials

    def _finish(self, session, table: Dict[tuple, Method]) -> DecisionTable:
        return DecisionTable(table, meta=_meta(self.name, session, self.ops,
                                               self.ps, self.ms))


# ---------------------------------------------------------------------------
# empirical sweeps (§3.2)
# ---------------------------------------------------------------------------
class ExhaustiveTuner(_GridTuner):
    name = "exhaustive"

    def fit(self, session: TuningSession) -> DecisionTable:
        table, _ = _base_table(session, self.ops, self.ps, self.ms,
                               self.trials)
        return self._finish(session, table.table)


class ThinnedTuner(_GridTuner):
    """Grid thinning + nearest-grid interpolation (§3.2.1)."""

    name = "thinned"

    def __init__(self, *args, m_stride: int = 2, p_stride: int = 1, **kw):
        super().__init__(*args, **kw)
        self.m_stride, self.p_stride = m_stride, p_stride

    def fit(self, session: TuningSession) -> DecisionTable:
        ps = self.ps[::self.p_stride]
        ms = self.ms[::self.m_stride]
        table, _ = _base_table(session, self.ops, ps, ms, self.trials)
        # densify through the nearest-grid lookup so the artifact covers the
        # full grid even though only the thinned points were measured; meta
        # records the THINNED grid (the points actually probed)
        dense = _densify(table.decide, self.ops, self.ps, self.ms)
        return DecisionTable(dense,
                             meta=_meta(self.name, session, self.ops, ps, ms))


class HeuristicTuner(_GridTuner):
    """Vadhiyar-style (S)MGD hill-descent over the segment axis."""

    name = "smgd"

    def __init__(self, *args, scanning: bool = True, **kw):
        super().__init__(*args, **kw)
        self.scanning = scanning
        self.name = "smgd" if scanning else "mgd"

    def fit(self, session: TuningSession) -> DecisionTable:
        table, _ = tune_heuristic(session.executor(self.trials), self.ops,
                                  self.ps, self.ms, scanning=self.scanning,
                                  trials=self.trials or 2)
        return self._finish(session, table.table)


# ---------------------------------------------------------------------------
# learning tuners (§3.4): predictor -> argmin densified over the grid
# ---------------------------------------------------------------------------
class RegressionTuner(_GridTuner):
    name = "regression"

    def __init__(self, *args, lam: float = 1e-3, iters: int = 800, **kw):
        super().__init__(*args, **kw)
        self.lam, self.iters = lam, iters

    def fit(self, session: TuningSession) -> DecisionTable:
        from repro_torch.core.tuning.regression import RegressionSelector
        _, ds = _base_table(session, self.ops, self.ps, self.ms, self.trials)
        rs = RegressionSelector.fit(ds, lam=self.lam, iters=self.iters)
        return self._finish(session,
                            _densify(rs.decide, self.ops, self.ps, self.ms))


class ANNTuner(_GridTuner):
    name = "ann"

    def __init__(self, *args, hidden: int = 10, epochs: int = 600,
                 seed: int = 0, **kw):
        super().__init__(*args, **kw)
        self.hidden, self.epochs, self.seed = hidden, epochs, seed

    def fit(self, session: TuningSession) -> DecisionTable:
        from repro_torch.core.tuning.ann import ANNSelector
        _, ds = _base_table(session, self.ops, self.ps, self.ms, self.trials)
        ann = ANNSelector.fit(ds, hidden=self.hidden, epochs=self.epochs,
                              seed=self.seed)
        return self._finish(session,
                            _densify(ann.decide, self.ops, self.ps, self.ms))


class EnsembleTuner(_GridTuner):
    """Bagged L1 regressors per (op, algorithm) — UMTAC Model Boost (§5.2 E)
    as a standalone selector."""

    name = "ensemble"

    def __init__(self, *args, n_members: int = 6, lam: float = 1e-3,
                 iters: int = 600, seed: int = 0, **kw):
        super().__init__(*args, **kw)
        self.n_members, self.lam, self.iters, self.seed = (
            n_members, lam, iters, seed)

    def fit(self, session: TuningSession) -> DecisionTable:
        import numpy as np
        from repro_torch.core.tuning.ensemble import bag
        from repro_torch.core.tuning.regression import expand_features
        _, ds = _base_table(session, self.ops, self.ps, self.ms, self.trials)
        groups: Dict[tuple, list] = {}
        for r in ds.rows:
            groups.setdefault((r.op, r.algorithm), []).append(r)
        models = {}
        for key, rows in groups.items():
            X = np.stack([expand_features(r.p, r.m, r.segments)
                          for r in rows])
            y = np.array([r.time for r in rows])
            models[key] = bag(X, y, n_members=self.n_members, lam=self.lam,
                              iters=self.iters, seed=self.seed)

        def decide(op, p, m):
            best, bt = Method("xla", 1), float("inf")
            for meth in methods_for(op, include_xla=False, p=p):
                mdl = models.get((op, meth.algorithm))
                if mdl is None:
                    continue
                t = float(mdl.predict(
                    expand_features(p, m, meth.segments)[None])[0])
                if t < bt:
                    best, bt = meth, t
            return best

        return self._finish(session,
                            _densify(decide, self.ops, self.ps, self.ms))


# ---------------------------------------------------------------------------
# decision-map compressors (§3.3, §3.4.1): exhaustive base, compressed lookup
# ---------------------------------------------------------------------------
class DecisionTreeTuner(_GridTuner):
    name = "decision_tree"

    def __init__(self, *args, min_weight: int = 1, confidence: float = 1.0,
                 **kw):
        super().__init__(*args, **kw)
        self.min_weight, self.confidence = min_weight, confidence

    def fit(self, session: TuningSession) -> DecisionTable:
        from repro_torch.core.tuning.decision_tree import DTreeDecision
        base, _ = _base_table(session, self.ops, self.ps, self.ms,
                              self.trials)
        dt = DTreeDecision.fit(base, self.ops, min_weight=self.min_weight,
                               confidence=self.confidence)
        return self._finish(session,
                            _densify(dt.decide, self.ops, self.ps, self.ms))


class QuadTreeTuner(_GridTuner):
    name = "quadtree"

    def __init__(self, *args, max_depth: Optional[int] = None,
                 accuracy: float = 1.0, **kw):
        super().__init__(*args, **kw)
        self.max_depth, self.accuracy = max_depth, accuracy

    def fit(self, session: TuningSession) -> DecisionTable:
        from repro_torch.core.tuning.quadtree import QuadTreeDecision
        base, _ = _base_table(session, self.ops, self.ps, self.ms,
                              self.trials)
        qt = QuadTreeDecision.fit(base, self.ops, max_depth=self.max_depth,
                                  accuracy=self.accuracy)
        return self._finish(session,
                            _densify(qt.decide, self.ops, self.ps, self.ms))


class OctreeTuner(_GridTuner):
    name = "octree"

    def __init__(self, *args, max_depth: Optional[int] = None,
                 accuracy: float = 1.0, **kw):
        super().__init__(*args, **kw)
        self.max_depth, self.accuracy = max_depth, accuracy

    def fit(self, session: TuningSession) -> DecisionTable:
        from repro_torch.core.tuning.octree import OctreeDecision
        base, _ = _base_table(session, self.ops, self.ps, self.ms,
                              self.trials)
        oc = OctreeDecision.fit(base, self.ops, max_depth=self.max_depth,
                                accuracy=self.accuracy)
        return self._finish(session,
                            _densify(oc.decide, self.ops, self.ps, self.ms))


# ---------------------------------------------------------------------------
# online tuners (§3.2.3, §3.4.5): replayed to convergence over the grid
# ---------------------------------------------------------------------------
class StarTuner(_GridTuner):
    """STAR-MPI delayed finalization, replayed until every grid context
    commits (fresh samples per invocation, shared with the cache)."""

    name = "star"

    def __init__(self, *args, trials_per_candidate: int = 2,
                 max_invocations: int = 200, **kw):
        super().__init__(*args, **kw)
        self.k = trials_per_candidate
        self.max_invocations = max_invocations

    def fit(self, session: TuningSession) -> DecisionTable:
        from repro_torch.core.tuning.star import StarTuner as _Star
        table: Dict[tuple, Method] = {}
        for o in self.ops:
            for p in self.ps:
                for m in self.ms:
                    star = _Star(trials_per_candidate=self.k)
                    committed = None
                    for _ in range(self.max_invocations):
                        meth = star.select(o, p, m)
                        star.record(o, p, m,
                                    session.fresh_sample(o, p, m, meth))
                        committed = star.committed(o, p, m)
                        if committed is not None:
                            break
                    table[(o, p, m)] = committed or star.select(o, p, m)
        return self._finish(session, table)


class FeedbackTuner(_GridTuner):
    """Fagg-style rule-table feedback control, replayed for a fixed number
    of rounds; the artifact is the revised rule table evaluated per point."""

    name = "feedback"

    def __init__(self, *args, rounds: int = 60, epsilon: float = 0.3,
                 window: int = 24, seed: int = 0, **kw):
        super().__init__(*args, **kw)
        self.rounds, self.epsilon, self.window, self.seed = (
            rounds, epsilon, window, seed)

    def fit(self, session: TuningSession) -> DecisionTable:
        from repro_torch.core.tuning.feedback import FeedbackController
        fc = FeedbackController(window=self.window, epsilon=self.epsilon,
                                seed=self.seed)
        pts = [(o, p, m) for o in self.ops for p in self.ps for m in self.ms]
        for _ in range(self.rounds):
            for (o, p, m) in pts:
                meth = fc.select(o, p, m)
                fc.record(session.fresh_sample(o, p, m, meth))
        table = {(o, p, m): fc._rule_for(o, p, m).terminal
                 for (o, p, m) in pts}
        return self._finish(session, table)


# ---------------------------------------------------------------------------
# the full UMTAC architecture (§5)
# ---------------------------------------------------------------------------
class UMTACTuner(_GridTuner):
    name = "umtac"

    def __init__(self, *args, p: Optional[int] = None, profiles=None,
                 lam: float = 1e-3, **kw):
        super().__init__(*args, **kw)
        self.p = p
        self.profiles = profiles
        self.lam = lam

    def fit(self, session: TuningSession) -> DecisionTable:
        from repro_torch.core.tuning.umtac import UMTAC, KernelProfile
        profiles = self.profiles or [
            KernelProfile(f"grid_{op}", op, max(self.ms))
            for op in self.ops]
        um = UMTAC(session.executor(self.trials), lam=self.lam)
        res = um.run(profiles, p=self.p or max(self.ps), ops=self.ops,
                     ps=self.ps, ms=self.ms)
        res.decision.meta = _meta(self.name, session, self.ops, self.ps,
                                  self.ms)
        return res.decision


#: registry for CLI / example use
TUNERS: Dict[str, type] = {
    "exhaustive": ExhaustiveTuner,
    "thinned": ThinnedTuner,
    "smgd": HeuristicTuner,
    "regression": RegressionTuner,
    "ann": ANNTuner,
    "ensemble": EnsembleTuner,
    "decision_tree": DecisionTreeTuner,
    "quadtree": QuadTreeTuner,
    "octree": OctreeTuner,
    "star": StarTuner,
    "feedback": FeedbackTuner,
    "umtac": UMTACTuner,
}


def make_tuner(name: str, *args, **kw) -> Tuner:
    if name not in TUNERS:
        raise KeyError(f"unknown tuner {name!r}; have {sorted(TUNERS)}")
    return TUNERS[name](*args, **kw)
