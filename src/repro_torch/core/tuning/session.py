"""TuningSession: the orchestrator of the unified autotuning pipeline.

The survey's core economics problem is that the experiment grid
{op, p, m} x {algorithm, segments} is combinatorially infeasible to sweep
per tuner ("months of brute force"). The session attacks it three ways:

  * a measurement cache deduplicating (op, p, m, algorithm, segments)
    probes ACROSS tuners — running the regression tuner after the
    exhaustive tuner costs zero new experiments, because both read the same
    probe set;
  * warm start: the cache serializes to JSON, so a re-tune on an unchanged
    fabric reuses yesterday's measurements;
  * drift-aware incremental re-tuning: a handful of sentinel probes are
    re-measured fresh and compared against the cached means; only when the
    fabric has actually drifted is the cache invalidated and re-measured.

``fit_all`` runs any set of Tuner implementations over the shared cache and
reports each one's measurement budget (the survey's cost axis) next to its
achieved penalty, then ``best`` picks the artifact to persist.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.tuning.decision import DecisionTable
from repro_torch.core.tuning.executor import (
    BenchmarkExecutor,
    Dataset,
    Measurement,
    SimulatorBackend,
)
from repro_torch.core.tuning.space import Method

#: cache key: one probed configuration
Key = Tuple[str, int, int, str, int]

CACHE_SCHEMA = 1


@dataclasses.dataclass
class TunerReport:
    """One tuner's outcome on the session's cost/quality axes."""

    name: str
    table: DecisionTable
    n_requested: int        # samples the tuner asked for
    n_experiments: int      # samples that actually ran (cache misses)
    cache_hits: int         # samples served from the shared cache
    fit_seconds: float
    penalty: Optional[float] = None   # empirical mean penalty vs dataset opt


class _SessionBackend:
    """Backend shim routing BenchmarkExecutor probes through the cache, so
    the legacy ``tune_*(executor, ...)`` entry points share measurements."""

    def __init__(self, session: "TuningSession"):
        self.session = session

    def measure(self, op, p, m, method: Method, trials=3) -> List[float]:
        return self.session.measure(op, p, m, method, trials=trials)


class TuningSession:
    def __init__(self, backend=None, *, trials: int = 3):
        self.backend = backend or SimulatorBackend()
        self.trials = trials
        self._cache: Dict[Key, List[float]] = {}
        self.n_requested = 0      # samples asked for (incl. cache hits)
        self.n_experiments = 0    # samples actually measured
        self.cache_hits = 0       # samples served from cache

    # -- measurement cache --------------------------------------------------
    def measure(self, op: str, p: int, m: int, method: Method,
                trials: Optional[int] = None) -> List[float]:
        """Return ``trials`` samples for the configuration, measuring only
        the shortfall the cache cannot serve."""
        t = trials or self.trials
        key = (op, int(p), int(m), method.algorithm, int(method.segments))
        have = self._cache.setdefault(key, [])
        if len(have) < t:
            need = t - len(have)
            have.extend(self.backend.measure(op, p, m, method, trials=need))
            self.n_experiments += need
            self.cache_hits += t - need
        else:
            self.cache_hits += t
        self.n_requested += t
        return list(have[:t])

    def fresh_sample(self, op: str, p: int, m: int, method: Method) -> float:
        """One NEW sample appended to the cache entry (online tuners need a
        fresh observation per invocation, not a replay of the cache)."""
        key = (op, int(p), int(m), method.algorithm, int(method.segments))
        t = self.backend.measure(op, p, m, method, trials=1)[0]
        self._cache.setdefault(key, []).append(t)
        self.n_requested += 1
        self.n_experiments += 1
        return t

    def executor(self, trials: Optional[int] = None) -> BenchmarkExecutor:
        """A BenchmarkExecutor whose probes flow through this cache — hands
        the legacy tuner entry points (tune_exhaustive, UMTAC, ...) the
        shared measurement set."""
        return BenchmarkExecutor(_SessionBackend(self),
                                 trials=trials or self.trials)

    def dataset(self) -> Dataset:
        """Every cached sample as a Dataset (the learning tuners' input)."""
        rows = [Measurement(op, p, m, a, s, t)
                for (op, p, m, a, s), ts in self._cache.items() for t in ts]
        return Dataset(rows)

    def __len__(self):
        return sum(len(ts) for ts in self._cache.values())

    # -- warm start ---------------------------------------------------------
    def save_measurements(self, path: str):
        rows = [{"op": op, "p": p, "m": m, "algorithm": a, "segments": s,
                 "times": ts}
                for (op, p, m, a, s), ts in sorted(self._cache.items())]
        with open(path, "w") as f:
            json.dump({"schema": CACHE_SCHEMA, "rows": rows}, f)

    def load_measurements(self, path: str):
        """Warm-start the cache from a previous session's probe set."""
        with open(path) as f:
            doc = json.load(f)
        if not isinstance(doc, dict) or doc.get("schema") != CACHE_SCHEMA:
            raise ValueError(
                f"unsupported measurement cache schema in {path!r}: "
                f"expected {CACHE_SCHEMA}, got "
                f"{doc.get('schema') if isinstance(doc, dict) else type(doc)}")
        for r in doc["rows"]:
            key = (r["op"], int(r["p"]), int(r["m"]), r["algorithm"],
                   int(r["segments"]))
            have = self._cache.setdefault(key, [])
            have.extend(float(t) for t in r["times"])

    # -- drift handling -----------------------------------------------------
    def probe_drift(self, n_probes: int = 8, *, seed: int = 0) -> float:
        """Mean relative deviation of fresh sentinel measurements vs the
        cached means. Mean, not median: drift that hits only part of the
        space (a bandwidth collapse leaves latency-dominated small-message
        probes unchanged) must still register. The probes refresh their
        cache entries in place."""
        keys = sorted(self._cache)
        if not keys:
            return 0.0
        rng = np.random.default_rng(seed)
        picks = [keys[i] for i in
                 rng.choice(len(keys), size=min(n_probes, len(keys)),
                            replace=False)]
        devs = []
        for (op, p, m, a, s) in picks:
            old = float(np.mean(self._cache[(op, p, m, a, s)]))
            fresh = self.backend.measure(op, p, m, Method(a, s),
                                         trials=self.trials)
            self.n_requested += self.trials
            self.n_experiments += self.trials
            new = float(np.mean(fresh))
            # keep the history: the fresh samples join the entry (the whole
            # cache is dropped anyway if drift is confirmed)
            self._cache[(op, p, m, a, s)].extend(fresh)
            devs.append(abs(new - old) / max(old, 1e-12))
        return float(np.mean(devs))

    def retune_if_drifted(self, threshold: float = 0.2, *,
                          n_probes: int = 8, seed: int = 0,
                          drift: Optional[float] = None) -> bool:
        """§3.2.3 environment drift: if sentinel probes deviate beyond the
        threshold, drop the stale cache so the next fit re-measures. Returns
        True when a re-tune was triggered.

        ``drift`` substitutes an externally observed statistic for the
        sentinel probes — the telemetry path: a production step's
        per-tier residual drift (`repro_torch.obs.residuals.ResidualReport
        .drift`) costs zero extra experiments, where sentinel probing
        spends ``n_probes * trials`` of measurement budget (STAR-MPI's
        runtime observation vs offline re-sweeps)."""
        observed = float(drift) if drift is not None \
            else self.probe_drift(n_probes, seed=seed)
        if observed <= threshold:
            return False
        self._cache.clear()
        return True

    # -- orchestration ------------------------------------------------------
    def fit_all(self, tuners: Sequence, *,
                evaluate: bool = True) -> List[TunerReport]:
        """Fit each tuner against the shared cache; report budget + penalty."""
        reports = []
        for tuner in tuners:
            req0, exp0, hit0 = (self.n_requested, self.n_experiments,
                                self.cache_hits)
            t0 = time.perf_counter()
            table = tuner.fit(self)
            dt = time.perf_counter() - t0
            rep = TunerReport(
                name=tuner.name, table=table,
                n_requested=self.n_requested - req0,
                n_experiments=self.n_experiments - exp0,
                cache_hits=self.cache_hits - hit0,
                fit_seconds=dt,
            )
            if table.meta is not None:
                # artifact provenance: the total measurements BACKING the
                # table (a cache-riding tuner's table is still built on the
                # session's probes); the tuner's marginal cost lives in the
                # report, not the artifact
                table.meta.n_experiments = self.n_experiments
            reports.append(rep)
        if evaluate:
            ds = self.dataset()
            for rep in reports:
                rep.penalty = empirical_penalty(rep.table.decide, ds)
                if rep.table.meta is not None:
                    rep.table.meta.penalty = rep.penalty
        return reports

    @staticmethod
    def best(reports: Sequence[TunerReport]) -> TunerReport:
        """Lowest achieved penalty; measurement budget breaks ties."""
        scored = [r for r in reports if r.penalty is not None]
        if not scored:
            return min(reports, key=lambda r: r.n_experiments)
        return min(scored, key=lambda r: (r.penalty, r.n_experiments))


def empirical_penalty(decide, dataset: Dataset) -> Optional[float]:
    """Backend-agnostic survey metric: mean (t_chosen - t_opt) / t_opt over
    the measured grid points, using the dataset's own mean times as ground
    truth (no simulator oracle needed — works for DeviceBackend too).
    Points whose chosen method was never measured are skipped; None (not a
    perfect 0.0) when no decision could be evaluated at all, so ``best``
    never crowns an unevaluated table."""
    means = dataset.mean_times()
    total = n = 0.0
    for (op, p, m), (_, t_opt) in dataset.best().items():
        meth = decide(op, p, m)
        key = (op, p, m, meth.algorithm, meth.segments)
        if key not in means:
            continue
        total += (means[key] - t_opt) / max(t_opt, 1e-12)
        n += 1
    return total / n if n else None
