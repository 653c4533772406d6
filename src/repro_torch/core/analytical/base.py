"""Parallel communication models (survey §3.1).

A copy of ``repro/core/analytical/base.py``. Its TPU-calibrated
constants (``ICI_ALPHA``, ``ICI_BETA``, ``VPU_GAMMA``) stay only so that
the simulator's artifacts match the reference's byte for byte: they say
nothing about an H100. The reference's text follows.

Each model predicts the elapsed time T(m) to move an m-byte message between
two endpoints; collective cost formulas (costs.py) compose these per round.

TPU-adapted parameter meanings (DESIGN.md §5): alpha/L ~ per-hop ICI launch
latency, beta/G ~ 1/link bandwidth (~50 GB/s), o ~ core dispatch overhead,
gamma ~ VPU reduction time per byte.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np


class CommModel:
    name: str = "base"

    def p2p(self, m: float) -> float:
        """Seconds to transfer an m-byte message."""
        raise NotImplementedError

    def params(self) -> dict:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Hockney(CommModel):
    """T = alpha + beta * m."""

    alpha: float
    beta: float
    name: str = "hockney"

    def p2p(self, m):
        return self.alpha + self.beta * m

    def params(self):
        return {"alpha": self.alpha, "beta": self.beta}


@dataclasses.dataclass(frozen=True)
class LogP(CommModel):
    """T = L + 2o (constant per message; gap g bounds in-flight rate)."""

    L: float
    o: float
    g: float
    name: str = "logp"

    def p2p(self, m):
        del m  # LogP's known blind spot for long messages (§3.1.2)
        return self.L + 2 * self.o

    def params(self):
        return {"L": self.L, "o": self.o, "g": self.g}


@dataclasses.dataclass(frozen=True)
class LogGP(CommModel):
    """T = L + 2o + (m - 1) G."""

    L: float
    o: float
    g: float
    G: float
    name: str = "loggp"

    def p2p(self, m):
        return self.L + 2 * self.o + max(m - 1, 0) * self.G

    def params(self):
        return {"L": self.L, "o": self.o, "g": self.g, "G": self.G}


@dataclasses.dataclass(frozen=True)
class PLogP(CommModel):
    """T = L + g(m) with message-size-dependent gap; g is a piecewise-linear
    interpolation over (sizes, gaps) knots — the model family's answer to
    non-linear networks (§3.1)."""

    L: float
    sizes: tuple          # knot message sizes (bytes), ascending
    gaps: tuple           # g(m) at knots (seconds)
    name: str = "plogp"

    def gap(self, m):
        return float(np.interp(m, self.sizes, self.gaps))

    def p2p(self, m):
        return self.L + self.gap(m)

    def params(self):
        return {"L": self.L, "sizes": self.sizes, "gaps": self.gaps}


# TPU v5e ICI defaults (DESIGN.md §5): 50 GB/s links, ~1 us hop latency.
ICI_ALPHA = 1.0e-6
ICI_BETA = 1.0 / 50e9
VPU_GAMMA = 1.0 / 400e9   # bytes/s elementwise combine on the VPU

DEFAULT_HOCKNEY = Hockney(alpha=ICI_ALPHA, beta=ICI_BETA)
DEFAULT_LOGGP = LogGP(L=ICI_ALPHA * 0.6, o=ICI_ALPHA * 0.2, g=ICI_ALPHA * 0.4,
                      G=ICI_BETA)


def default_plogp() -> PLogP:
    """Small messages pay a super-linear gap (packetization), large messages
    converge to the link bandwidth."""
    sizes = (0, 256, 1024, 8192, 65536, 1 << 20, 16 << 20)
    gaps = tuple(1.2e-6 + m * ICI_BETA * (1.35 if m < 8192 else 1.0)
                 for m in sizes)
    return PLogP(L=0.4e-6, sizes=sizes, gaps=gaps)


MODEL_FAMILIES = ("hockney", "logp", "loggp", "plogp")
