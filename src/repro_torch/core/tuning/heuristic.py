"""Heuristic search over the method space (survey §3.2.2): Modified Gradient
Descent (MGD) and Scanning MGD (SMGD) from Vadhiyar et al. — hill-descent
over the segment-size axis with restarts, spending far fewer experiments
than the exhaustive sweep.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.tuning.decision import DecisionTable
from repro_torch.core.tuning.executor import BenchmarkExecutor
from repro_torch.core.tuning.space import (
    MESSAGE_SIZES,
    OPS,
    PROCESS_COUNTS,
    SEGMENT_CANDIDATES,
    SEGMENTED,
    Method,
    TUNABLE,
)


def _measure(executor, op, p, m, meth, trials=3) -> float:
    return float(np.mean(executor.backend.measure(op, p, m, meth,
                                                  trials=trials)))


def mgd_segments(executor, op, algo, p, m, *, start_idx: int = 0,
                 trials: int = 2) -> Tuple[int, float, int]:
    """Hill-descent along the segment axis. Returns (segments, time, evals)."""
    cands = list(SEGMENT_CANDIDATES)
    i = start_idx
    evals = 0
    cur = _measure(executor, op, p, m, Method(algo, cands[i]), trials)
    evals += 1
    while True:
        best_j, best_t = i, cur
        for j in (i - 1, i + 1):
            if 0 <= j < len(cands):
                t = _measure(executor, op, p, m, Method(algo, cands[j]),
                             trials)
                evals += 1
                if t < best_t:
                    best_j, best_t = j, t
        if best_j == i:
            return cands[i], cur, evals
        i, cur = best_j, best_t


def smgd_segments(executor, op, algo, p, m, *, scan_stride: int = 3,
                  trials: int = 2) -> Tuple[int, float, int]:
    """Scanning MGD: coarse scan picks the basin, then local descent —
    defends against the multi-modal surfaces plain MGD falls into."""
    cands = list(SEGMENT_CANDIDATES)
    evals = 0
    best_i, best_t = 0, float("inf")
    for i in range(0, len(cands), scan_stride):
        t = _measure(executor, op, p, m, Method(algo, cands[i]), trials)
        evals += 1
        if t < best_t:
            best_i, best_t = i, t
    seg, t, e = mgd_segments(executor, op, algo, p, m, start_idx=best_i,
                             trials=trials)
    return seg, t, evals + e


def tune_heuristic(
    executor: Optional[BenchmarkExecutor] = None,
    ops=OPS, ps=PROCESS_COUNTS, ms=MESSAGE_SIZES,
    *, scanning: bool = True, trials: int = 2,
) -> tuple:
    """Full-grid tuner with SMGD over segments. Returns
    (DecisionTable, n_evals) — compare n_evals with the exhaustive count."""
    executor = executor or BenchmarkExecutor()
    search = smgd_segments if scanning else mgd_segments
    table = {}
    total_evals = 0
    for op in ops:
        for p in ps:
            for m in ms:
                best, best_t = None, float("inf")
                for algo in TUNABLE[op]:
                    if algo == "xla":
                        continue
                    if (op, algo) in SEGMENTED:
                        seg, t, e = search(executor, op, algo, p, m,
                                           trials=trials)
                        total_evals += e
                    else:
                        seg = 1
                        t = _measure(executor, op, p, m, Method(algo, 1),
                                     trials)
                        total_evals += 1
                    if t < best_t:
                        best, best_t = Method(algo, seg), t
                table[(op, p, m)] = best
    return DecisionTable(table), total_evals
