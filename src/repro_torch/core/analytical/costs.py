"""A copy of ``repro/core/analytical/costs.py``. The reference's text
follows.

Per-(collective, algorithm) cost formulas under a communication model
(survey Table 3 and standard literature), plus closed-form optimal segment
sizes obtained by d/d(m_s) = 0 exactly as the survey derives them.

All sizes in bytes, times in seconds. ``p`` = axis size, ``m`` = total
message bytes (the full buffer for allreduce/broadcast; the per-rank shard
for allgather; the full (p*chunk) buffer for all_to_all), ``gamma`` =
reduction seconds/byte, ``segments`` = survey segmentation count.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np

from repro_torch.core.analytical.base import CommModel, Hockney, LogGP, VPU_GAMMA


def _log2(p: int) -> int:
    return max(1, int(round(math.log2(p))))


def collective_cost(
    op: str,
    algorithm: str,
    model: CommModel,
    p: int,
    m: float,
    *,
    segments: int = 1,
    gamma: float = VPU_GAMMA,
) -> float:
    """Predicted wall time of one collective invocation."""
    if algorithm.startswith("synth:"):
        # synthesized step program: alpha-beta-gamma over its exact
        # per-step wire/combine chunks (lazy import: synth prices
        # itself back through this module)
        from repro_torch.core.collectives import synth
        return synth.program_cost(op, algorithm[len("synth:"):], model,
                                  p, m, gamma=gamma)
    t = model.p2p
    lg = _log2(p)
    ns = max(1, segments)

    if op == "all_reduce":
        if algorithm == "ring":
            # reduce-scatter + allgather, 2(p-1) rounds of m/p, pipelined in
            # ns segments (Table 3 "Ring with segmentation")
            ms = m / p / ns
            rounds = (p - 1 + (ns - 1))          # pipeline depth per phase
            return (2 * rounds * t(ms)
                    + (p - 1) * gamma * (m / p))
        if algorithm == "recursive_doubling":
            return lg * (t(m) + gamma * m)
        if algorithm == "rabenseifner":
            # recursive halving RS (+gamma) + recursive doubling AG
            rs = sum(t(m / 2 ** (s + 1)) + gamma * m / 2 ** (s + 1)
                     for s in range(lg))
            ag = sum(t(m / 2 ** (s + 1)) for s in range(lg))
            return rs + ag
        if algorithm == "reduce_bcast":
            return 2 * lg * t(m) + lg * gamma * m
        if algorithm == "allgather_reduce":
            return lg * t(m * 2 ** 0) + (p - 1) * (t(m)) + gamma * p * m
        if algorithm == "xla":
            # assume XLA picks ~ring for large, ~tree for small
            return min(collective_cost(op, "ring", model, p, m, gamma=gamma),
                       collective_cost(op, "recursive_doubling", model, p, m,
                                       gamma=gamma))

    if op == "reduce_scatter":
        if algorithm == "ring":
            return (p - 1) * (t(m / p) + gamma * (m / p))
        if algorithm == "recursive_halving":
            return sum(t(m / 2 ** (s + 1)) + gamma * m / 2 ** (s + 1)
                       for s in range(lg))
        if algorithm == "xla":
            return min(
                collective_cost(op, "ring", model, p, m, gamma=gamma),
                collective_cost(op, "recursive_halving", model, p, m,
                                gamma=gamma))

    if op == "all_gather":
        # m = per-rank shard bytes; total gathered = p*m
        if algorithm == "ring":
            return (p - 1) * t(m)
        if algorithm == "recursive_doubling":
            return sum(t(m * 2 ** s) for s in range(lg))
        if algorithm == "bruck":
            return sum(t(m * 2 ** s) for s in range(lg))
        if algorithm == "gather_bcast":
            return lg * t(p * m) * 2
        if algorithm == "xla":
            return min(collective_cost(op, "ring", model, p, m, gamma=gamma),
                       collective_cost(op, "recursive_doubling", model, p, m,
                                       gamma=gamma))

    if op == "broadcast":
        if algorithm == "binomial":
            return lg * t(m)
        if algorithm == "binary_tree":
            return 2 * lg * t(m)
        if algorithm == "pipelined_binary":
            ms = m / ns
            return (2 * lg - 1 + ns) * t(ms)
        if algorithm == "flat_tree":
            return (p - 1) * t(m)
        if algorithm == "chain":
            ms = m / ns
            return (p - 2 + ns) * t(ms)
        if algorithm == "van_de_geijn":
            scatter = sum(t(m / 2 ** (s + 1)) for s in range(lg))
            ag = (p - 1) * t(m / p)
            return scatter + ag
        if algorithm == "xla":
            return min(collective_cost(op, "binomial", model, p, m,
                                       gamma=gamma),
                       collective_cost(op, "van_de_geijn", model, p, m,
                                       gamma=gamma))

    if op == "all_to_all":
        # m = total local buffer (p chunks of m/p)
        if algorithm == "pairwise":
            return (p - 1) * t(m / p)
        if algorithm == "bruck":
            return lg * t(m / 2)
        if algorithm == "xla":
            return min(collective_cost(op, "pairwise", model, p, m,
                                       gamma=gamma),
                       collective_cost(op, "bruck", model, p, m, gamma=gamma))

    if op == "reduce":
        if algorithm == "binomial":
            return lg * (t(m) + gamma * m)

    if op == "barrier":
        if algorithm == "dissemination":
            return lg * t(8)
        if algorithm == "linear":
            return (p - 1) * t(8) + lg * t(8)

    raise KeyError(f"no cost formula for {op}/{algorithm}")


# ---------------------------------------------------------------------------
# Survey Table 3 exact expressions (segmented ring allreduce)
# ---------------------------------------------------------------------------
def table3_ring_segmented_time(model: CommModel, p: int, m: float,
                               m_s: float, *, gamma: float = VPU_GAMMA
                               ) -> float:
    """Table 3, 'Ring with seg. + Hockney':
    T = (P + n_s - 2)(alpha + beta m_s + gamma m_s) + (P-1)(alpha + beta m/P)
    with n_s = m / m_s. Works for any model via t(m_s) ~ alpha + beta m_s.
    """
    n_s = m / m_s
    return ((p + n_s - 2) * (model.p2p(m_s) + gamma * m_s)
            + (p - 1) * model.p2p(m / p))


# ---------------------------------------------------------------------------
# Optimal segment size (survey Table 3, derived via d/d m_s = 0)
# ---------------------------------------------------------------------------
def optimal_segment_size(
    op: str, algorithm: str, model: CommModel, p: int, m: float,
    *, gamma: float = VPU_GAMMA,
) -> Optional[float]:
    """Closed-form m_s* in bytes, or None when the algorithm is unsegmented."""
    if op == "all_reduce" and algorithm == "ring":
        if isinstance(model, Hockney):
            # Table 3: m_s = sqrt(m * alpha / ((P-2)(beta+gamma)))
            if p <= 2:
                return None
            return math.sqrt(m * model.alpha / ((p - 2) * (model.beta + gamma)))
        if isinstance(model, LogGP):
            if p <= 2:
                return None
            g_, o_, G = model.g, model.o, model.G
            # Table 3, two-case form
            ms = math.sqrt(m * max(g_ - G, 1e-30) / ((p - 2) * G))
            if g_ >= o_ + gamma * ms:
                return ms
            denom = (p - 2) * G - gamma
            if denom <= 0:
                return None
            return math.sqrt(m * max(o_ - G, 1e-30) / denom)
    if op == "broadcast" and algorithm == "chain":
        if isinstance(model, Hockney):
            # T(ms) = (p - 2 + m/ms)(alpha + beta*ms); dT/dms = 0 ->
            # ms = sqrt(m * alpha / ((p-2) * beta))
            if p <= 2:
                return math.sqrt(m * model.alpha / model.beta)
            return math.sqrt(m * model.alpha / ((p - 2) * model.beta))
    return None


def numeric_optimal_segments(
    op: str, algorithm: str, model: CommModel, p: int, m: float,
    *, gamma: float = VPU_GAMMA, candidates=(1, 2, 4, 8, 16, 32, 64),
) -> int:
    """Brute-force the segment count grid — what AEOS would do (§3.2)."""
    best, best_t = 1, float("inf")
    for ns in candidates:
        try:
            tt = collective_cost(op, algorithm, model, p, m, segments=ns,
                                 gamma=gamma)
        except KeyError:
            continue
        if tt < best_t:
            best, best_t = ns, tt
    return best


def best_algorithm(
    op: str, model: CommModel, p: int, m: float, *,
    gamma: float = VPU_GAMMA, algorithms=None,
) -> tuple:
    """Model-predicted (algorithm, segments, time) — §3.1.1 tuning recipe."""
    from repro_torch.core.collectives.algorithms import ALGORITHMS
    algos = algorithms or [a for a in ALGORITHMS[op] if a != "xla"]
    best = None
    for a in algos:
        ns = numeric_optimal_segments(op, a, model, p, m, gamma=gamma)
        tt = collective_cost(op, a, model, p, m, segments=ns, gamma=gamma)
        if best is None or tt < best[2]:
            best = (a, ns, tt)
    return best
