"""Live-fabric probing: artifact selection and per-level topology synthesis
(port of ``repro/comms/probe.py``).

The reference times a jitted ``shard_map``'d ``ppermute`` round between
two devices. The port times a ping-pong between two ranks of the
default group over ``group.ppermute``: on one card the ranks are
processes on one device, and a payload crosses through the axis's
arena in device memory (CUDA IPC), a copy in and a copy out ordered by a
host signal; on the CPU, the ``gloo`` wire. So each probed profile
describes that transport (``FABRICS``), not a GPU fabric, and
`describe_topology` says which wherever a profile is printed.

Every rank runs the probe in lockstep (the calls are the same on every
rank); ranks outside the timed pair take no part in its exchanges, and
each timed size is agreed as the maximum over the ranks, so every rank
fits the same profile. The injection hooks (``clock``, ``pingpong``,
``timer``) are the reference's, so tests run on a `FakeClock` without a
process group. The reference's text follows.

A multi-backend (schema-3 "multi_profile") artifact ships one
`DecisionTable` per fabric it was tuned on. Selecting the right table at
launch needs a probe of the fabric the process actually runs on:
``probe_live_profile`` times m-byte point-to-point transfers between two
ranks and fits ``t = launch + byte_time * m`` through
``repro_torch.core.topology.fit_profile`` — the same relative-least-squares
fit the offline tuning pipeline uses, so `MultiProfileArtifact.select`'s
profile distance compares like with like.

On a multi-level mesh one pair is not enough: the links an intra-host
pair crosses say nothing about the DCN. ``level_probe_pairs`` reads the
mesh's rank coordinates and picks one REPRESENTATIVE pair per sync
tier — two ranks adjacent along the innermost data axis (intra-host),
along "pod" (intra-pod), along "dcn" (cross-pod) — and
``probe_mesh_topology`` times each pair and feeds the per-level measure
functions straight into ``repro_torch.core.topology.probe_topology``.
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.collectives import group as grp
from repro_torch.core.topology.model import (
    PROBE_SIZES,
    SYNC_AXES,
    Topology,
    fit_profile,
    level_names_for,
    probe_topology,
)
from repro_torch.core.tuning.simulator import NetworkProfile
from repro_torch.obs.trace import ready

#: what every profile this module fits describes, by the device the
#: ranks hold their buffers on
FABRICS = {"cuda": "cuda-ipc", "cpu": "host-staged"}


def _pingpong(ms: int, ranks=None, device=None):
    """A 2-rank exchange of an m-byte buffer over ``group.ppermute`` (one
    round each way, so the measured wall time is 2 transfers + dispatch).
    Ranks outside the pair return at once."""
    n = max(1, ms // 4)                      # float32 elements
    a, b = ranks if ranks is not None else (0, 1)
    perm = [(a, b), (b, a)]

    def fn(x):
        return grp.ppermute(grp.ppermute(x, perm), perm)

    x = torch.zeros((n,), dtype=torch.float32, device=grp.device_of(device))
    return fn, x


def _agree(t: float) -> float:
    """The pair's time on every rank: the maximum over the ranks of the
    default group (outside a group, this process's own reading)."""
    if dist.is_available() and dist.is_initialized():
        return grp.max_over_ranks([t])[0]
    return t


def _time_pair(rank_a, rank_b, m: int, trials: int = 3, *,
               clock: Optional[Callable[[], float]] = None,
               pingpong: Optional[Callable] = None,
               device=None) -> float:
    """Seconds one m-byte one-way transfer takes between two ranks
    (best of ``trials`` timed pingpong rounds, halved). ``clock`` and
    ``pingpong`` inject a fake timer / exchange (tests drive the timing
    path deterministically — e.g. `repro_torch.obs.FakeClock`)."""
    clock = clock or time.perf_counter
    if pingpong is None:
        fn, x = _pingpong(m, ranks=(rank_a, rank_b), device=device)
    else:
        fn, x = pingpong(m, ranks=(rank_a, rank_b))
    ready(fn(x))                             # warm
    best = float("inf")
    for _ in range(trials):
        t0 = clock()
        ready(fn(x))
        best = min(best, clock() - t0)
    return _agree(best / 2.0)                # per one-way transfer


def probe_live_profile(ms: Sequence[int] = PROBE_SIZES, *,
                       trials: int = 3,
                       base: Optional[NetworkProfile] = None,
                       ranks=None, device=None,
                       clock: Optional[Callable[[], float]] = None,
                       pingpong: Optional[Callable] = None
                       ) -> Optional[NetworkProfile]:
    """Probe the live fabric between one rank pair (ranks 0 and 1 of the
    default group by default).

    Returns the fitted `NetworkProfile`, or None when there is no pair
    to time (no process group, or one rank). ``clock``/``pingpong``
    thread through to `_time_pair` (injectable timing, tests).
    """
    if ranks is None:
        if not (dist.is_available() and dist.is_initialized()) \
                or grp.size() < 2:
            return None
        ranks = (0, 1)
    kw = _inject_kwargs(clock, pingpong, device)
    ts = [_time_pair(ranks[0], ranks[1], m, trials, **kw) for m in ms]
    return fit_profile(list(ms), ts, base=base)


def _inject_kwargs(clock, pingpong, device=None) -> dict:
    """Forward clock/pingpong/device to `_time_pair` only when actually
    set, so tests that replace `_time_pair` wholesale (positional
    signature) keep working alongside the injectable-timing path."""
    kw = {}
    if clock is not None:
        kw["clock"] = clock
    if pingpong is not None:
        kw["pingpong"] = pingpong
    if device is not None:
        kw["device"] = device
    return kw


# ---------------------------------------------------------------------------
# per-level probing over a mesh's rank coordinates
# ---------------------------------------------------------------------------
def level_probe_pairs(mesh) -> List[Tuple[str, str, int, Tuple]]:
    """One representative rank pair per sync tier of ``mesh``.

    Reads the mesh's rank-coordinate grid (``mesh.ranks``, the
    reference's ``mesh.devices``) and returns innermost-first
    ``(level_name, axis, axis_size, (rank_a, rank_b))`` — rank_a is the
    origin, rank_b its neighbour ALONG THAT AXIS ONLY. Size-1 axes carry
    no link and are skipped; a mesh without sync axes (or None) yields
    [].

    Sync axes follow the mesh's own nesting order, innermost
    (fastest-varying) axis first — not the canonical SYNC_AXES tuple.
    """
    if mesh is None:
        return []
    axes = [a for a in reversed(tuple(mesh.axis_names))
            if a in SYNC_AXES]
    ranks = np.asarray(mesh.ranks)
    order = list(mesh.axis_names)
    origin = (0,) * ranks.ndim
    present = [(a, ranks.shape[order.index(a)]) for a in axes]
    names = level_names_for(len([1 for _, s in present if s > 1]) or 1)
    out: List[Tuple[str, str, int, Tuple]] = []
    name_i = 0
    for axis, size in present:
        if size < 2:
            continue
        neighbour = list(origin)
        neighbour[order.index(axis)] = 1
        out.append((names[name_i], axis, size,
                    (int(ranks[origin]), int(ranks[tuple(neighbour)]))))
        name_i += 1
    return out


def probe_mesh_topology(mesh, ms: Sequence[int] = PROBE_SIZES, *,
                        trials: int = 3,
                        timer: Optional[Callable] = None,
                        clock: Optional[Callable[[], float]] = None,
                        pingpong: Optional[Callable] = None
                        ) -> Optional[Topology]:
    """Probe every sync tier of ``mesh`` and synthesize a `Topology`.

    For each tier, ``level_probe_pairs`` picks its representative rank
    pair and a per-level measure function times that pair; the measures
    feed straight into ``repro_torch.core.topology.probe_topology``,
    which fits one `NetworkProfile` per level. The resulting levels carry
    their mesh axis. ``timer(rank_a, rank_b, m) -> seconds`` replaces
    the real pingpong (tests); returns None when no tier has a pair to
    time. Buffers live on ``mesh.device``."""
    pairs = level_probe_pairs(mesh)
    if not pairs:
        return None
    kw = _inject_kwargs(clock, pingpong, getattr(mesh, "device", None))
    time_pair = timer if timer is not None else \
        (lambda a, b, m: _time_pair(a, b, m, trials, **kw))

    def make_measure(rank_a, rank_b):
        return lambda m: time_pair(rank_a, rank_b, m)

    levels = [(name, size, make_measure(a, b), axis)
              for name, axis, size, (a, b) in pairs]
    return probe_topology(levels, ms)


def describe_topology(topology: Topology,
                      fabric: str = FABRICS["cpu"]) -> str:
    """One line per probed level, each naming the fabric it measured."""
    return "\n".join(
        f"{fabric} level {lv.name} (axis {lv.axis}, {lv.size} ranks): "
        f"launch {lv.profile.launch * 1e6:.1f} us, byte time "
        f"{lv.profile.byte_time * 1e9:.4f} ns/B"
        for lv in topology.levels)
