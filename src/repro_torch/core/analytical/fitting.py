"""A copy of ``repro/core/analytical/fitting.py``. The reference's text
follows.

Model parameter estimation from measurements (survey §3.1.1):
least-squares fits of Hockney / LogGP, knot extraction for PLogP — the
logp_mpi / NETPIPE role in our stack.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from repro_torch.core.analytical.base import Hockney, LogGP, PLogP


def fit_hockney(sizes: Sequence[float], times: Sequence[float]) -> Hockney:
    """alpha + beta*m by linear least squares."""
    A = np.stack([np.ones_like(np.asarray(sizes, float)),
                  np.asarray(sizes, float)], axis=1)
    coef, *_ = np.linalg.lstsq(A, np.asarray(times, float), rcond=None)
    alpha, beta = float(max(coef[0], 1e-12)), float(max(coef[1], 1e-15))
    return Hockney(alpha=alpha, beta=beta)


def fit_loggp(sizes: Sequence[float], times: Sequence[float],
              *, overhead_fraction: float = 0.25) -> LogGP:
    """T = (L + 2o) + (m-1) G: the intercept cannot separate L from o without
    the logp_mpi round-trip experiments, so we apportion by a conventional
    overhead fraction (documented limitation, survey §3.1.2)."""
    h = fit_hockney(sizes, times)
    intercept = h.alpha
    o = intercept * overhead_fraction / 2
    L = intercept - 2 * o
    return LogGP(L=float(L), o=float(o), g=float(intercept / 2),
                 G=float(h.beta))


def fit_plogp(sizes: Sequence[float], times: Sequence[float],
              *, n_knots: int = 8) -> PLogP:
    """Piecewise-linear gap table at log-spaced knots."""
    sizes = np.asarray(sizes, float)
    times = np.asarray(times, float)
    order = np.argsort(sizes)
    sizes, times = sizes[order], times[order]
    L = float(max(times.min() * 0.3, 1e-9))
    knots = np.unique(np.geomspace(max(sizes.min(), 1), sizes.max(),
                                   n_knots).round())
    gaps = np.interp(knots, sizes, times) - L
    return PLogP(L=L, sizes=tuple(knots.tolist()),
                 gaps=tuple(np.maximum(gaps, 1e-9).tolist()))


def prediction_error(model, sizes, times) -> float:
    """Mean relative |err| of a fitted model on held-out points."""
    pred = np.array([model.p2p(m) for m in sizes])
    times = np.asarray(times, float)
    return float(np.mean(np.abs(pred - times) / np.maximum(times, 1e-12)))


def select_best_model(sizes, times, holdout_sizes, holdout_times):
    """Query all model families and keep the best predictor (§3.1.2:
    'selecting the best model among a number of different models')."""
    fits = {
        "hockney": fit_hockney(sizes, times),
        "loggp": fit_loggp(sizes, times),
        "plogp": fit_plogp(sizes, times),
    }
    errs = {k: prediction_error(v, holdout_sizes, holdout_times)
            for k, v in fits.items()}
    best = min(errs, key=errs.get)
    return fits[best], errs
