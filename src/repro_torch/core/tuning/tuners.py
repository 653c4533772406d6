"""The unified Tuner interface (port of ``repro/core/tuning/tuners.py``).

Every tuner implements

    fit(session: TuningSession) -> DecisionTable

with all measurements flowing through the session's shared cache, so tuners
are comparable on the survey's cost axis (``TunerReport.n_experiments``)
and a cheap tuner run after an expensive one costs nothing new.

The port has the tuners whose modules are ported: the exhaustive and
thinned AEOS sweeps (§3.2) and the SMGD heuristic search (§3.2.2). The
reference's regression, ANN, ensemble, decision-tree, quad/oct-tree,
STAR, feedback and UMTAC tuners are still to port (ROADMAP.md Queue 1);
``make_tuner`` raises ``KeyError`` for their names, as for any unknown
name.

The returned DecisionTable carries TableMeta provenance (tuner name, probed
grid, backend profile) and serializes to the reference's JSON artifact.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Protocol, Sequence

from repro_torch.core.tuning.decision import DecisionTable, TableMeta
from repro_torch.core.tuning.exhaustive import tune_exhaustive
from repro_torch.core.tuning.heuristic import tune_heuristic
from repro_torch.core.tuning.session import TuningSession
from repro_torch.core.tuning.space import (
    MESSAGE_SIZES,
    OPS,
    PROCESS_COUNTS,
    Method,
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


#: registry for CLI / example use
TUNERS: Dict[str, type] = {
    "exhaustive": ExhaustiveTuner,
    "thinned": ThinnedTuner,
    "smgd": HeuristicTuner,
}


def make_tuner(name: str, *args, **kw) -> Tuner:
    if name not in TUNERS:
        raise KeyError(f"unknown tuner {name!r}; have {sorted(TUNERS)}")
    return TUNERS[name](*args, **kw)
