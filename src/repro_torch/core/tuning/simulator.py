"""Ground-truth network simulator.

This container has no multi-chip interconnect, so wire time is simulated —
the hardware gate the repro band predicts. The simulator is deliberately
RICHER than the analytical formulas the tuners use (per-link congestion,
super-linear small-message gap, incast penalties, multiplicative noise), so
the survey's phenomena reproduce: Hockney/LogGP underestimate congested
cases (§3.1.2), empirical tuners beat pure models, and dynamic tuners must
re-adapt when the environment drifts.

Round structure per algorithm mirrors the real implementations in
``repro_torch.core.collectives.algorithms`` (same round counts, same bytes), so a
decision learned on the simulator is a decision about the real schedules.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.analytical.base import ICI_ALPHA, ICI_BETA, VPU_GAMMA


@dataclasses.dataclass
class NetworkProfile:
    """The "true" network the tuners try to learn."""

    launch: float = 1.1e-6          # per-round launch latency (s)
    byte_time: float = ICI_BETA     # 1/bandwidth (s/B)
    small_gap_factor: float = 1.5   # packetization penalty below knee
    small_knee: float = 8192.0      # bytes
    gamma: float = VPU_GAMMA        # reduce combine (s/B)
    incast_factor: float = 0.35     # extra cost per concurrent incast flow
    noise_sigma: float = 0.04       # lognormal multiplicative noise
    seed: int = 0

    def link_time(self, nbytes: float, contention: float = 1.0) -> float:
        bt = self.byte_time * (self.small_gap_factor
                               if nbytes < self.small_knee else 1.0)
        return self.launch + nbytes * bt * max(contention, 1.0)


def _log2(p: int) -> int:
    return max(1, int(round(math.log2(p))))


def _rounds(op: str, algo: str, p: int, m: float, segments: int
            ) -> List[Tuple[float, float, float]]:
    """[(bytes_on_wire, contention, combine_bytes)] per sequential round."""
    if algo.startswith("synth:"):
        # synthesized step program: one round per step, exact chunk counts
        from repro_torch.core.collectives import synth
        return synth.rounds_for(op, algo[len("synth:"):], p, m)
    lg = _log2(p)
    ns = max(1, segments)
    R: List[Tuple[float, float, float]] = []

    if op == "all_reduce":
        if algo == "ring":
            ms = m / p / ns
            for _ in range(2 * (p - 1 + ns - 1)):
                R.append((ms, 1.0, ms / 2))
        elif algo == "recursive_doubling":
            for _ in range(lg):
                R.append((m, 1.0, m))
        elif algo == "rabenseifner":
            for s in range(lg):
                R.append((m / 2 ** (s + 1), 1.0, m / 2 ** (s + 1)))
            for s in reversed(range(lg)):
                R.append((m / 2 ** (s + 1), 1.0, 0.0))
        elif algo == "reduce_bcast":
            for _ in range(lg):
                R.append((m, 1.0, m))
            for _ in range(lg):
                R.append((m, 1.0, 0.0))
        elif algo == "allgather_reduce":
            for s in range(lg):
                R.append((m * 2 ** s, 1.0 + 0.2 * s, 0.0))
            R.append((0.0, 1.0, p * m))
        elif algo == "xla":
            return _rounds(op, "ring" if m >= 1 << 16 else
                           "recursive_doubling", p, m, 1)
        else:
            raise KeyError(algo)

    elif op == "reduce_scatter":
        if algo == "ring":
            for _ in range(p - 1):
                R.append((m / p, 1.0, m / p))
        elif algo == "recursive_halving":
            for s in range(lg):
                R.append((m / 2 ** (s + 1), 1.0, m / 2 ** (s + 1)))
        elif algo == "xla":
            return _rounds(op, "ring" if m >= 1 << 16 else
                           "recursive_halving", p, m, 1)
        else:
            raise KeyError(algo)

    elif op == "all_gather":
        # m = per-rank shard
        if algo == "ring":
            for _ in range(p - 1):
                R.append((m, 1.0, 0.0))
        elif algo == "recursive_doubling":
            for s in range(lg):
                # doubling volume stresses bisection links -> congestion
                R.append((m * 2 ** s, 1.0 + 0.25 * s, 0.0))
        elif algo == "bruck":
            for s in range(lg):
                R.append((m * 2 ** s, 1.0 + 0.25 * s, 0.0))
        elif algo == "gather_bcast":
            for _ in range(lg):
                R.append((p * m, 1.3, 0.0))
            for _ in range(lg):
                R.append((p * m, 1.0, 0.0))
        elif algo == "xla":
            return _rounds(op, "ring" if m * p >= 1 << 18 else
                           "recursive_doubling", p, m, 1)
        else:
            raise KeyError(algo)

    elif op == "broadcast":
        if algo == "binomial":
            for _ in range(lg):
                R.append((m, 1.0, 0.0))
        elif algo == "binary_tree":
            # two sequential child sends per level
            for _ in range(2 * lg):
                R.append((m, 1.0, 0.0))
        elif algo == "pipelined_binary":
            ms = m / ns
            for _ in range(2 * lg - 1 + ns):
                R.append((ms, 1.0, 0.0))
        elif algo == "flat_tree":
            for _ in range(p - 1):
                R.append((m, 1.0, 0.0))      # root link serializes: p-1 rounds
        elif algo == "chain":
            ms = m / ns
            for _ in range(p - 2 + ns):
                R.append((ms, 1.0, 0.0))
        elif algo == "van_de_geijn":
            for s in range(lg):
                R.append((m / 2 ** (s + 1), 1.0, 0.0))
            for _ in range(p - 1):
                R.append((m / p, 1.0, 0.0))
        elif algo == "xla":
            return _rounds(op, "binomial" if m < 1 << 18 else
                           "van_de_geijn", p, m, 1)
        else:
            raise KeyError(algo)

    elif op == "all_to_all":
        # m = full local buffer (p chunks)
        if algo == "pairwise":
            for _ in range(p - 1):
                R.append((m / p, 1.0, 0.0))
        elif algo == "bruck":
            for _ in range(lg):
                R.append((m / 2, 1.15, 0.0))
        elif algo == "xla":
            return _rounds(op, "bruck" if m < 1 << 16 else "pairwise",
                           p, m, 1)
        else:
            raise KeyError(algo)

    else:
        raise KeyError(op)
    return R


class NetworkSimulator:
    """Measures collective time under a NetworkProfile, with noise."""

    def __init__(self, profile: Optional[NetworkProfile] = None):
        self.profile = profile or NetworkProfile()
        self._rng = np.random.default_rng(self.profile.seed)
        self.n_measurements = 0

    def expected_time(self, op: str, algo: str, p: int, m: float,
                      segments: int = 1) -> float:
        pr = self.profile
        t = 0.0
        for nbytes, cont, comb in _rounds(op, algo, p, m, segments):
            t += pr.link_time(nbytes, cont) + pr.gamma * comb
        # incast penalty on rooted/converging patterns
        if algo in ("flat_tree", "gather_bcast", "allgather_reduce"):
            t *= 1.0 + pr.incast_factor
        return t

    def measure(self, op: str, algo: str, p: int, m: float,
                segments: int = 1, trials: int = 1):
        """Noisy measurements (list of seconds)."""
        base = self.expected_time(op, algo, p, m, segments)
        noise = self._rng.lognormal(0.0, self.profile.noise_sigma,
                                    size=trials)
        self.n_measurements += trials
        return (base * noise).tolist()

    def optimal(self, op: str, p: int, m: float, methods) -> tuple:
        """(method, expected time) with the lowest TRUE expected time."""
        best, bt = None, float("inf")
        for meth in methods:
            t = self.expected_time(op, meth.algorithm, p, m, meth.segments)
            if t < bt:
                best, bt = meth, t
        return best, bt


def drifted(profile: NetworkProfile, *, byte_time_mult=1.0,
            launch_mult=1.0, congestion_add=0.0, seed=None) -> NetworkProfile:
    """Environment drift for dynamic-adaptation experiments (§3.2.3)."""
    return dataclasses.replace(
        profile,
        byte_time=profile.byte_time * byte_time_mult,
        launch=profile.launch * launch_mult,
        incast_factor=profile.incast_factor + congestion_add,
        seed=profile.seed if seed is None else seed,
    )
