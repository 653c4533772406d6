"""Decision functions: the tuners' output artifact.

A decision function maps a grid Point (op, p, m) to a Method {algorithm,
segments}. `DecisionTable` is the dense-map form every tuner can emit;
`mean_penalty` is the survey's evaluation metric (time of chosen method vs
experimental optimum). The table serializes to a versioned JSON artifact
carrying its provenance (tuner, experiment grid, backend profile,
measurement budget) so a tuning run done once can be shipped to every
launcher — the survey's answer to combinatorially infeasible brute force.
"""
from __future__ import annotations

import bisect
import dataclasses
import json
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.tuning.space import Method, Point, methods_for

#: bump when the on-disk layout changes; load() rejects anything else
SCHEMA_VERSION = 2


@dataclasses.dataclass
class TableMeta:
    """Provenance of a tuned DecisionTable.

    ops/ps/ms record the experiment grid the tuner actually probed (decisions
    off-grid are nearest-neighbour extrapolations); profile is the
    NetworkProfile (or backend description) the measurements came from, so a
    runtime can detect it is loading a table tuned for a different fabric.

    schedule optionally carries the tuned gradient-sync schedule, e.g.
    ``{"bucket_bytes": 4194304, "pipeline": true}`` — the fusion-bucket
    budget and whether tier phases software-pipeline across buckets.
    Absent (every pre-existing artifact), consumers run the sequential
    per-leaf path, so the on-disk schema stays backward-compatible in
    both directions.

    programs optionally carries the synthesized step programs
    (``collectives/synth.py`` pareto fronts, serialized via
    ``Program.to_json``) whose ``synth:<name>`` algorithms the rows may
    reference, so ``Communicator.create`` can rebuild and dispatch them
    at load.  Absent, nothing changes — same compatibility contract as
    ``schedule``.

    mapping optionally carries the swept logical→physical mesh mapping
    (``topology/placement.MeshMapping.to_json``: axes, shape, flattened
    device order, per-axis tiers, modeled cost) so ``Communicator.create``
    can rebuild the exact winning mesh at load. Absent, meshes build in
    default device order — same compatibility contract as ``schedule``.
    """

    tuner: str = "unknown"
    ops: Tuple[str, ...] = ()
    ps: Tuple[int, ...] = ()
    ms: Tuple[int, ...] = ()
    n_experiments: int = 0
    penalty: Optional[float] = None
    backend: str = "simulator"
    profile: Optional[dict] = None
    schedule: Optional[dict] = None
    programs: Optional[List[dict]] = None
    mapping: Optional[dict] = None

    def to_json(self) -> dict:
        d = {
            "tuner": self.tuner, "ops": list(self.ops),
            "ps": list(self.ps), "ms": list(self.ms),
            "n_experiments": self.n_experiments, "penalty": self.penalty,
            "backend": self.backend, "profile": self.profile,
            "schedule": self.schedule,
        }
        if self.programs is not None:
            # only stamped when synthesis ran, so program-free artifacts
            # stay byte-identical to the previous schema generation
            d["programs"] = self.programs
        if self.mapping is not None:
            # only stamped when the placement sweep ran — same contract
            d["mapping"] = self.mapping
        return d

    @classmethod
    def from_json(cls, d: dict) -> "TableMeta":
        return cls(
            tuner=d.get("tuner", "unknown"),
            ops=tuple(d.get("ops", ())), ps=tuple(d.get("ps", ())),
            ms=tuple(d.get("ms", ())),
            n_experiments=int(d.get("n_experiments", 0)),
            penalty=d.get("penalty"),
            backend=d.get("backend", "simulator"),
            profile=d.get("profile"),
            schedule=d.get("schedule"),
            programs=d.get("programs"),
            mapping=d.get("mapping"),
        )


def rows_to_json(table: Dict[Tuple[str, int, int], Method]) -> List[dict]:
    """The artifact row format, shared by every schema generation (the
    schema-3 multi-profile container reuses it per named profile)."""
    return [{"op": op, "p": p, "m": m,
             "algorithm": meth.algorithm, "segments": meth.segments}
            for (op, p, m), meth in sorted(table.items())]


def rows_from_json(rows: List[dict], path: str
                   ) -> Dict[Tuple[str, int, int], Method]:
    try:
        return {(r["op"], int(r["p"]), int(r["m"])):
                Method(r["algorithm"], int(r["segments"])) for r in rows}
    except (KeyError, TypeError, ValueError) as e:
        raise ValueError(
            f"corrupt DecisionTable row in {path!r}: {e}") from e


@dataclasses.dataclass
class DecisionTable:
    """Dense decision map keyed by (op, p, m)."""

    table: Dict[Tuple[str, int, int], Method]
    meta: Optional[TableMeta] = None

    def decide(self, op: str, p: int, m: int) -> Method:
        key = (op, p, m)
        if key in self.table:
            return self.table[key]
        # nearest-on-grid lookup (interpolation along m and p, §3.2.1)
        cand = [(pp, mm) for (oo, pp, mm) in self.table if oo == op]
        if not cand:
            return Method("xla", 1)
        ps = sorted({c[0] for c in cand})
        p_near = min(ps, key=lambda v: abs(v - p))
        ms = sorted({mm for (pp, mm) in cand if pp == p_near})
        i = bisect.bisect_right(ms, m)
        m_near = ms[max(0, i - 1)]
        return self.table.get((op, p_near, m_near), Method("xla", 1))

    def as_fn(self) -> Callable[[str, int, int], Tuple[str, int]]:
        def fn(op, nbytes, p):
            meth = self.decide(op, p, nbytes)
            return meth.algorithm, meth.segments
        return fn

    # -- serialization ------------------------------------------------------
    def save(self, path: str):
        doc = {"schema": SCHEMA_VERSION,
               "meta": self.meta.to_json() if self.meta else None,
               "rows": rows_to_json(self.table)}
        with open(path, "w") as f:
            json.dump(doc, f, indent=1)

    @classmethod
    def load(cls, path: str) -> "DecisionTable":
        with open(path) as f:
            doc = json.load(f)
        if isinstance(doc, list):        # legacy pre-versioned artifact
            rows, meta = doc, None
        elif isinstance(doc, dict):
            schema = doc.get("schema")
            if schema != SCHEMA_VERSION:
                raise ValueError(
                    f"unsupported DecisionTable schema in {path!r}: "
                    f"expected {SCHEMA_VERSION}, got {schema!r}")
            rows = doc.get("rows")
            if not isinstance(rows, list):
                raise ValueError(f"corrupt DecisionTable in {path!r}: "
                                 "'rows' missing or not a list")
            meta = TableMeta.from_json(doc["meta"]) if doc.get("meta") \
                else None
        else:
            raise ValueError(f"corrupt DecisionTable in {path!r}: "
                             f"top level is {type(doc).__name__}")
        return cls(rows_from_json(rows, path), meta=meta)


def mean_penalty(
    decide: Callable[[str, int, int], Method],
    simulator,
    points: List[Point],
    *,
    include_xla: bool = False,
) -> float:
    """Survey metric: mean of (t_chosen - t_opt) / t_opt over grid points."""
    total = 0.0
    for pt in points:
        meths = methods_for(pt.op, include_xla=include_xla, p=pt.p)
        _, t_opt = simulator.optimal(pt.op, pt.p, pt.m, meths)
        chosen = decide(pt.op, pt.p, pt.m)
        t = simulator.expected_time(pt.op, chosen.algorithm, pt.p, pt.m,
                                    chosen.segments)
        total += (t - t_opt) / t_opt
    return total / max(len(points), 1)
