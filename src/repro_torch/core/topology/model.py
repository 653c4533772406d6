"""A copy of ``repro/core/topology/model.py``. Its default level profiles
are the reference's TPU-calibrated ones and say nothing about the
port's ranks on one card; a probed profile does
(``repro_torch.comms.probe``). The reference's text follows.

Topology model: the machine's network hierarchy as tunable levels.

The survey's parameter space explodes with scale; its biggest structural
lever is that real fabrics are hierarchical — intra-host links, intra-pod
ICI and cross-pod DCN differ by an order of magnitude or more in both
latency and bandwidth. A `Topology` is an ordered stack of `MeshLevel`s
(innermost first), each carrying its own `NetworkProfile` and device
fan-out, so tuning can run PER LEVEL over that level's profile instead of
over one flat table that mis-tunes every multi-pod mesh (Barchet-Estefanel
& Mounié: per-level tuning slashes the search space while improving
decisions).

A Topology is derivable two ways:
  * from a mesh spec (``Topology.from_spec("2x16x16")`` — outermost first,
    like a mesh shape) with the default per-level profiles below;
  * from probe measurements (``probe_profile``), fitting launch latency and
    byte time to observed point-to-point times per level.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.analytical.base import ICI_BETA
from repro_torch.core.tuning.simulator import NetworkProfile

#: canonical level names, innermost first
LEVEL_NAMES = ("intra_host", "intra_pod", "cross_pod")

#: mesh axes carrying the gradient-sync tiers, innermost first: a 2-level
#: topology rides ("data", "pod"), the full 3-level stack adds "dcn"
SYNC_AXES = ("data", "pod", "dcn")


def level_names_for(n: int) -> Tuple[str, ...]:
    """Canonical names for ``n`` stacked tiers, innermost first: one tier
    is the ICI baseline ("intra_pod"); deeper stacks pull in "intra_host"
    below and "cross_pod" above. Single source of the rule shared by
    ``Topology.from_spec``, ``launch.mesh.local_topology`` and the
    per-level live probe."""
    if not 1 <= n <= len(LEVEL_NAMES):
        raise ValueError(f"{n} levels; supported 1..{len(LEVEL_NAMES)}")
    return ("intra_pod",) if n == 1 else LEVEL_NAMES[len(LEVEL_NAMES) - n:]

#: default per-level fabrics: intra-host is a short hop at double ICI
#: bandwidth; intra-pod is the v5e ICI baseline; cross-pod is DCN — an
#: order of magnitude slower per byte, several microseconds to launch.
DEFAULT_LEVEL_PROFILES: Dict[str, NetworkProfile] = {
    "intra_host": NetworkProfile(launch=0.6e-6, byte_time=ICI_BETA / 2,
                                 small_knee=4096.0),
    "intra_pod": NetworkProfile(),
    "cross_pod": NetworkProfile(launch=8.0e-6, byte_time=ICI_BETA * 20,
                                small_gap_factor=1.2, incast_factor=0.5),
}


@dataclasses.dataclass(frozen=True)
class MeshLevel:
    """One rung of the hierarchy: ``size`` devices per group joined by links
    described by ``profile``; ``axis`` names the mesh axis that carries this
    level's collectives (None for levels not mapped onto a mesh)."""

    name: str
    size: int
    profile: NetworkProfile
    axis: Optional[str] = None

    def to_json(self) -> dict:
        return {"name": self.name, "size": self.size, "axis": self.axis,
                "profile": dataclasses.asdict(self.profile)}

    @classmethod
    def from_json(cls, d: dict) -> "MeshLevel":
        return cls(name=d["name"], size=int(d["size"]),
                   profile=NetworkProfile(**d.get("profile", {})),
                   axis=d.get("axis"))


@dataclasses.dataclass(frozen=True)
class Topology:
    """Ordered mesh levels, INNERMOST first (levels[0] has the fastest
    links; levels[-1] spans the whole machine)."""

    levels: Tuple[MeshLevel, ...]

    def __post_init__(self):
        assert self.levels, "a Topology needs at least one level"

    @property
    def total_size(self) -> int:
        n = 1
        for lv in self.levels:
            n *= lv.size
        return n

    @property
    def inner(self) -> MeshLevel:
        return self.levels[0]

    @property
    def outer(self) -> MeshLevel:
        return self.levels[-1]

    def level(self, key) -> MeshLevel:
        if isinstance(key, int):
            return self.levels[key]
        for lv in self.levels:
            if lv.name == key:
                return lv
        raise KeyError(f"no level {key!r}; have "
                       f"{[lv.name for lv in self.levels]}")

    def names(self) -> Tuple[str, ...]:
        return tuple(lv.name for lv in self.levels)

    def flat_profile(self) -> NetworkProfile:
        """The fabric a FLAT (hierarchy-blind) collective experiences: its
        sequential rounds synchronize on the slowest link they cross, which
        on a multi-level machine is the outermost level's."""
        return self.outer.profile

    # -- construction -------------------------------------------------------
    @classmethod
    def single_level(cls, size: int,
                     profile: Optional[NetworkProfile] = None,
                     *, name: str = "intra_pod",
                     axis: Optional[str] = "data") -> "Topology":
        return cls((MeshLevel(name, size,
                              profile or DEFAULT_LEVEL_PROFILES[name],
                              axis=axis),))

    @classmethod
    def two_level(cls, inner_size: int, outer_size: int, *,
                  inner_profile: Optional[NetworkProfile] = None,
                  outer_profile: Optional[NetworkProfile] = None,
                  inner_axis: Optional[str] = "data",
                  outer_axis: Optional[str] = "pod") -> "Topology":
        """The canonical multi-pod hierarchy: ICI inside, DCN across."""
        return cls((
            MeshLevel("intra_pod", inner_size,
                      inner_profile or DEFAULT_LEVEL_PROFILES["intra_pod"],
                      axis=inner_axis),
            MeshLevel("cross_pod", outer_size,
                      outer_profile or DEFAULT_LEVEL_PROFILES["cross_pod"],
                      axis=outer_axis),
        ))

    @classmethod
    def from_spec(cls, spec: str,
                  axes: Optional[Sequence[Optional[str]]] = None
                  ) -> "Topology":
        """Parse a mesh-shape-like spec, OUTERMOST first (``"2x16"`` = 2
        pods of 16; ``"2x2x2"`` = 2 DCN slices of 2 pods of 2). Level
        names are assigned innermost-out from LEVEL_NAMES; profiles come
        from DEFAULT_LEVEL_PROFILES. Default axes are the gradient-sync
        tiers, innermost first ("data" inside the host, "pod" across
        pods, "dcn" across the WAN-class links) — pass ``axes``
        explicitly for topologies whose innermost tier carries tensor
        parallelism ("model") instead."""
        sizes = [int(tok) for tok in spec.lower().split("x")]
        if not sizes or any(s < 1 for s in sizes):
            raise ValueError(f"bad topology spec {spec!r}")
        if len(sizes) > len(LEVEL_NAMES):
            raise ValueError(f"topology spec {spec!r} has {len(sizes)} "
                             f"levels; at most {len(LEVEL_NAMES)} supported")
        sizes = sizes[::-1]                       # innermost first
        names = level_names_for(len(sizes))
        if axes is None:
            axes = SYNC_AXES[:len(sizes)]
        return cls(tuple(
            MeshLevel(n, s, DEFAULT_LEVEL_PROFILES[n], axis=a)
            for n, s, a in zip(names, sizes, axes)))

    # -- serialization ------------------------------------------------------
    def to_json(self) -> dict:
        return {"levels": [lv.to_json() for lv in self.levels]}

    @classmethod
    def from_json(cls, d: dict) -> "Topology":
        return cls(tuple(MeshLevel.from_json(l) for l in d["levels"]))

    def save(self, path: str):
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1)

    @classmethod
    def load(cls, path: str) -> "Topology":
        with open(path) as f:
            return cls.from_json(json.load(f))


# ---------------------------------------------------------------------------
# probe-derived profiles
# ---------------------------------------------------------------------------
PROBE_SIZES = tuple(1 << s for s in range(14, 25, 2))   # 16 KiB .. 16 MiB


def fit_profile(ms: Sequence[float], ts: Sequence[float],
                base: Optional[NetworkProfile] = None) -> NetworkProfile:
    """Fit ``t = launch + byte_time * m`` to probe measurements (sizes
    above the packetization knee, so the linear model holds). The fit
    minimizes RELATIVE error — measurement noise is multiplicative, so a
    plain least squares would let the largest transfers drown the launch
    latency. Non-probed fields keep ``base``'s values."""
    t = np.asarray(ts, float)
    A = np.stack([np.ones(len(ms)), np.asarray(ms, float)], axis=1)
    (launch, byte_time), *_ = np.linalg.lstsq(
        A / t[:, None], np.ones(len(ms)), rcond=None)
    base = base or NetworkProfile()
    return dataclasses.replace(base, launch=max(float(launch), 0.0),
                               byte_time=max(float(byte_time), 0.0))


def probe_profile(measure: Callable[[int], float],
                  ms: Sequence[int] = PROBE_SIZES,
                  base: Optional[NetworkProfile] = None) -> NetworkProfile:
    """Derive a level's NetworkProfile from live probes. ``measure(m)``
    returns the seconds one m-byte point-to-point transfer takes on that
    level's links (e.g. a 2-rank binomial broadcast)."""
    return fit_profile(ms, [float(measure(m)) for m in ms], base=base)


def probe_topology(levels: Sequence[Sequence],
                   ms: Sequence[int] = PROBE_SIZES) -> Topology:
    """Build a Topology by probing each level: ``levels`` is innermost-first
    ``(name, size, measure_fn)`` triples, or ``(name, size, measure_fn,
    axis)`` quadruples when the caller knows which mesh axis carries the
    level (the per-level live probe, ``repro_torch.comms.probe``, does)."""
    out = []
    for entry in levels:
        name, size, measure = entry[0], entry[1], entry[2]
        axis = entry[3] if len(entry) > 3 else None
        base = DEFAULT_LEVEL_PROFILES.get(name)
        out.append(MeshLevel(name, size, probe_profile(measure, ms, base),
                             axis=axis))
    return Topology(tuple(out))
