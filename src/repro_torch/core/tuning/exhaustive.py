"""AEOS-style empirical tuning (survey §3.2): exhaustive parameter sweep
over the experiment grid, decision = experimental argmin, with optional
grid-thinning + interpolation to cut experiment cost.
"""
from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.core.tuning.decision import DecisionTable
from repro_torch.core.tuning.executor import BenchmarkExecutor, Dataset
from repro_torch.core.tuning.space import MESSAGE_SIZES, OPS, PROCESS_COUNTS


def tune_exhaustive(
    executor: Optional[BenchmarkExecutor] = None,
    ops: Sequence[str] = OPS,
    ps: Sequence[int] = PROCESS_COUNTS,
    ms: Sequence[int] = MESSAGE_SIZES,
    *,
    dataset: Optional[Dataset] = None,
) -> tuple:
    """Returns (DecisionTable, Dataset, n_experiments)."""
    executor = executor or BenchmarkExecutor()
    if dataset is None:
        dataset = executor.run_grid(ops, ps, ms)
    table = {k: meth for k, (meth, _) in dataset.best().items()}
    return DecisionTable(table), dataset, executor.n_experiments


def tune_thinned(
    executor: Optional[BenchmarkExecutor] = None,
    ops: Sequence[str] = OPS,
    ps: Sequence[int] = PROCESS_COUNTS,
    ms: Sequence[int] = MESSAGE_SIZES,
    *,
    m_stride: int = 2,
    p_stride: int = 2,
) -> tuple:
    """Thin the grid (§3.2.1 'interpolation along one or two axes') — the
    DecisionTable's nearest-grid lookup interpolates the holes."""
    executor = executor or BenchmarkExecutor()
    ms_thin = tuple(ms[::m_stride])
    ps_thin = tuple(ps[::p_stride])
    return tune_exhaustive(executor, ops, ps_thin, ms_thin)
