"""A copy of ``repro/core/topology/decision.py``. The reference's text
follows.

Hierarchical decisions and the schema-3 multi-profile artifact.

Schema 3 packs SEVERAL named DecisionTables into one JSON document:

    {"schema": 3, "kind": "hierarchical" | "multi_profile",
     "profiles": [{"name": ..., "meta": {...}, "rows": [...]}, ...]}

Two consumers share the container:

  * `HierarchicalDecision` — one table per topology level (innermost
    first), produced by running a TuningSession per level; the launchers'
    hierarchical gradient sync asks it for per-level specs.
  * plain multi-backend artifacts — one table per fabric (simulator seeds,
    DeviceBackend hosts); `MultiProfileArtifact.select` picks the table
    whose recorded NetworkProfile best matches the runtime's probed
    profile, so one shipped file serves heterogeneous fleets.

Schema-2 and legacy single-table artifacts still load everywhere: they
present as a single profile named "default".
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import List, Optional, Sequence, Tuple, Union

from repro_torch.core.collectives.dispatch import CollectiveSpec, DecisionSource
from repro_torch.core.tuning.decision import (
    SCHEMA_VERSION,
    DecisionTable,
    TableMeta,
    rows_from_json,
    rows_to_json,
)
from repro_torch.core.tuning.simulator import NetworkProfile

MULTI_SCHEMA_VERSION = 3

#: profile fields that describe the fabric (matching ignores the rng seed)
_MATCH_FIELDS = ("launch", "byte_time", "small_gap_factor", "small_knee",
                 "gamma", "incast_factor")


def profile_distance(a: Optional[dict], b: Optional[dict]) -> float:
    """Mean |log-ratio| over the fabric-describing numeric fields — 0 for
    identical fabrics, ~0.7 for a 2x bandwidth difference. Missing
    profiles are infinitely far (never silently matched)."""
    if not a or not b:
        return math.inf
    devs = []
    for k in _MATCH_FIELDS:
        va, vb = a.get(k), b.get(k)
        if va is None or vb is None:
            continue
        # probe-fit profiles can clamp a field (e.g. launch) to exactly 0;
        # a tiny floor keeps the distance finite so one degenerate field
        # penalizes the match instead of poisoning it
        va = max(float(va), 1e-12)
        vb = max(float(vb), 1e-12)
        devs.append(abs(math.log(va / vb)))
    return sum(devs) / len(devs) if devs else math.inf


def _as_profile_dict(profile) -> Optional[dict]:
    if profile is None:
        return None
    if isinstance(profile, NetworkProfile):
        return dataclasses.asdict(profile)
    return dict(profile)


class MultiProfileArtifact:
    """Ordered named DecisionTables in one schema-3 document."""

    def __init__(self, profiles: Sequence[Tuple[str, DecisionTable]],
                 kind: str = "multi_profile"):
        assert profiles, "an artifact needs at least one profile"
        self.profiles: List[Tuple[str, DecisionTable]] = list(profiles)
        self.kind = kind

    def names(self) -> List[str]:
        return [n for n, _ in self.profiles]

    def __getitem__(self, name: str) -> DecisionTable:
        for n, t in self.profiles:
            if n == name:
                return t
        raise KeyError(f"no profile {name!r}; have {self.names()}")

    def __len__(self):
        return len(self.profiles)

    def select(self, probed=None) -> Tuple[str, DecisionTable]:
        """The (name, table) whose recorded fabric best matches ``probed``
        (a NetworkProfile or its dict). With no probe, the first profile
        wins. Raises when a probe is given but no profile carries fabric
        metadata to match against."""
        if probed is None:
            return self.profiles[0]
        probe = _as_profile_dict(probed)
        scored = [(profile_distance(
            t.meta.profile if t.meta else None, probe), n, t)
            for n, t in self.profiles]
        d, name, table = min(scored, key=lambda s: s[0])
        if math.isinf(d):
            raise ValueError(
                "no profile in the artifact records a fabric to match "
                f"against; have {self.names()}")
        return name, table

    # -- serialization ------------------------------------------------------
    def save(self, path: str):
        doc = {"schema": MULTI_SCHEMA_VERSION, "kind": self.kind,
               "profiles": [
                   {"name": n,
                    "meta": t.meta.to_json() if t.meta else None,
                    "rows": rows_to_json(t.table)}
                   for n, t in self.profiles]}
        with open(path, "w") as f:
            json.dump(doc, f, indent=1)

    @classmethod
    def load(cls, path: str) -> "MultiProfileArtifact":
        with open(path) as f:
            doc = json.load(f)
        if isinstance(doc, list):            # legacy pre-versioned table
            return cls([("default",
                         DecisionTable(rows_from_json(doc, path)))])
        if not isinstance(doc, dict):
            raise ValueError(f"corrupt artifact in {path!r}: top level is "
                             f"{type(doc).__name__}")
        schema = doc.get("schema")
        if schema == SCHEMA_VERSION:         # single-profile schema 2
            rows = doc.get("rows")
            if not isinstance(rows, list):
                raise ValueError(f"corrupt DecisionTable in {path!r}: "
                                 "'rows' missing or not a list")
            meta = TableMeta.from_json(doc["meta"]) if doc.get("meta") \
                else None
            return cls([("default",
                         DecisionTable(rows_from_json(rows, path),
                                       meta=meta))])
        if schema != MULTI_SCHEMA_VERSION:
            raise ValueError(
                f"unsupported artifact schema in {path!r}: expected "
                f"{SCHEMA_VERSION} or {MULTI_SCHEMA_VERSION}, got "
                f"{schema!r}")
        profiles = doc.get("profiles")
        if not isinstance(profiles, list) or not profiles:
            raise ValueError(f"corrupt artifact in {path!r}: 'profiles' "
                             "missing or empty")
        out = []
        for prof in profiles:
            meta = TableMeta.from_json(prof["meta"]) if prof.get("meta") \
                else None
            out.append((prof.get("name", "default"),
                        DecisionTable(rows_from_json(
                            prof.get("rows", []), path), meta=meta)))
        return cls(out, kind=doc.get("kind", "multi_profile"))


class HierarchicalDecision(DecisionSource):
    """One DecisionTable per topology level, innermost first.

    ``spec_for_level`` is the hierarchical composition's entry point;
    ``spec_for`` (the flat DecisionSource protocol) answers from the
    innermost table, so a HierarchicalDecision drops into any slot a
    flat DecisionSource fits.
    """

    def __init__(self, levels: Sequence[Tuple[str, DecisionTable]]):
        assert levels, "a HierarchicalDecision needs at least one level"
        self.levels: List[Tuple[str, DecisionTable]] = list(levels)

    def names(self) -> List[str]:
        return [n for n, _ in self.levels]

    def table_for(self, level: Union[int, str]) -> DecisionTable:
        if isinstance(level, int):
            return self.levels[level][1]
        for n, t in self.levels:
            if n == level:
                return t
        raise KeyError(f"no level {level!r}; have {self.names()}")

    def spec_for_level(self, level: Union[int, str], op: str, nbytes: int,
                       axis_size: int) -> CollectiveSpec:
        meth = self.table_for(level).decide(op, axis_size, nbytes)
        return CollectiveSpec(meth.algorithm, meth.segments).normalized()

    def spec_for(self, op, nbytes, axis_size) -> CollectiveSpec:
        return self.spec_for_level(0, op, nbytes, axis_size)

    # -- serialization ------------------------------------------------------
    def save(self, path: str):
        MultiProfileArtifact(self.levels, kind="hierarchical").save(path)

    @classmethod
    def load(cls, path: str) -> "HierarchicalDecision":
        art = MultiProfileArtifact.load(path)
        return cls(art.profiles)


def load_decision(path: str, *, probed=None
                  ) -> Union[DecisionTable, HierarchicalDecision]:
    """Load any decision artifact generation.

    Schema-3 "hierarchical" -> HierarchicalDecision (all levels); schema-3
    "multi_profile" -> the single DecisionTable matching the runtime's
    ``probed`` fabric (first profile when no probe); schema-2 / legacy ->
    the DecisionTable, unchanged.
    """
    art = MultiProfileArtifact.load(path)
    if art.kind == "hierarchical":
        return HierarchicalDecision(art.profiles)
    _, table = art.select(probed)
    return table
