"""Benchmark Executor (UMTAC component B): drives the experiment phases of
§3.2.1 over a backend and accumulates the measurement dataset (port of
``repro/core/tuning/executor.py``).

Backends:
  * SimulatorBackend — the NetworkSimulator (a copy of the reference's).
  * DeviceBackend   — wall-clock timing of the port's algorithm
    implementations inside every rank of a process group. With the ranks
    as processes on one card (``collectives/group.py``) it measures the
    schedule and the arena transport (device copies, one host signal a
    round), not a GPU fabric, as the reference's CPU measurements
    measure schedule overhead, not wire time.
"""
from __future__ import annotations

import dataclasses
import time as _time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.collectives import algorithms as alg
from repro_torch.core.collectives import group as grp
from repro_torch.core.tuning.simulator import NetworkSimulator
from repro_torch.core.tuning.space import (
    MESSAGE_SIZES,
    OPS,
    PROCESS_COUNTS,
    Method,
    Point,
    methods_for,
)
from repro_torch.kernels import segment_reduce


@dataclasses.dataclass(frozen=True)
class Measurement:
    op: str
    p: int
    m: int
    algorithm: str
    segments: int
    time: float


class Dataset:
    def __init__(self, rows: Optional[List[Measurement]] = None):
        self.rows: List[Measurement] = rows or []

    def add(self, row: Measurement):
        self.rows.append(row)

    def __len__(self):
        return len(self.rows)

    def best(self) -> Dict[Tuple[str, int, int], Tuple[Method, float]]:
        """Experimental optimum per grid point (mean over repeated trials)."""
        acc: Dict[tuple, List[float]] = {}
        for r in self.rows:
            acc.setdefault((r.op, r.p, r.m, r.algorithm, r.segments),
                           []).append(r.time)
        out: Dict[Tuple[str, int, int], Tuple[Method, float]] = {}
        for (op, p, m, a, s), ts in acc.items():
            t = float(np.mean(ts))
            key = (op, p, m)
            if key not in out or t < out[key][1]:
                out[key] = (Method(a, s), t)
        return out

    def mean_times(self) -> Dict[tuple, float]:
        acc: Dict[tuple, List[float]] = {}
        for r in self.rows:
            acc.setdefault((r.op, r.p, r.m, r.algorithm, r.segments),
                           []).append(r.time)
        return {k: float(np.mean(v)) for k, v in acc.items()}

    def to_arrays(self):
        """Feature matrix for the learning tuners."""
        ops = sorted({r.op for r in self.rows})
        algs = sorted({r.algorithm for r in self.rows})
        op_id = {o: i for i, o in enumerate(ops)}
        alg_id = {a: i for i, a in enumerate(algs)}
        X = np.array([[op_id[r.op], r.p, r.m, alg_id[r.algorithm],
                       r.segments] for r in self.rows], float)
        y = np.array([r.time for r in self.rows], float)
        return X, y, {"ops": ops, "algorithms": algs}


class SimulatorBackend:
    def __init__(self, simulator: Optional[NetworkSimulator] = None):
        self.sim = simulator or NetworkSimulator()

    def measure(self, op, p, m, method: Method, trials=3) -> List[float]:
        return self.sim.measure(op, method.algorithm, p, m, method.segments,
                                trials=trials)


class DeviceBackend:
    """Times the real collective implementations inside every rank.

    Built and called in each rank of the group, in lockstep: every probe
    is a collective. A run goes: barrier, start time, the algorithm,
    ``torch.cuda.synchronize()`` (on the card), end time. A trial's time
    is the maximum over ranks, reduced through the group, so every rank
    holds the same samples and its session, tuner and artifact decide
    the same way; rank 0 keeps and writes them. The first run of each
    (op, method, size) is a warm-up, as the reference's compile run.

    ``runs`` and ``launches`` count, per (op, algorithm, segments), the
    algorithm's runs in this rank and the ``segment_combine`` launches
    they made (warm-up included).
    """

    def __init__(self, axis=None, device=None):
        self.axis = axis
        self.p = grp.size(axis)
        self.device = grp.device_of(device)
        self._inputs: dict = {}
        self._warm: set = set()
        self.runs: Dict[tuple, int] = {}
        self.launches: Dict[tuple, int] = {}

    def _input(self, n_elems: int):
        if n_elems not in self._inputs:
            self._inputs[n_elems] = torch.ones((n_elems,), dtype=torch.float32,
                                               device=self.device)
        return self._inputs[n_elems]

    def _run(self, op, method: Method, x) -> float:
        f = alg.get(op, method.algorithm)
        key = (op, method.algorithm, method.segments)
        before = segment_reduce.launches
        grp.barrier(self.axis)
        t0 = _time.perf_counter()
        if op in ("all_reduce", "reduce_scatter"):
            f(x, self.axis, self.p, op="add", segments=method.segments)
        else:
            f(x, self.axis, self.p, segments=method.segments)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = _time.perf_counter() - t0
        self.runs[key] = self.runs.get(key, 0) + 1
        self.launches[key] = (self.launches.get(key, 0)
                              + segment_reduce.launches - before)
        return dt

    def measure(self, op, p, m, method: Method, trials=3) -> List[float]:
        assert p == self.p, "DeviceBackend measures at the real rank count"
        n_elems = max(1, int(m) // 4)
        x = self._input(n_elems)
        if (op, method, n_elems) not in self._warm:
            self._run(op, method, x)
            self._warm.add((op, method, n_elems))
        out = [self._run(op, method, x) for _ in range(trials)]
        return grp.max_over_ranks(out, self.axis)


class BenchmarkExecutor:
    """Runs the §3.2.1 experiment phases and returns the Dataset."""

    def __init__(self, backend=None, trials: int = 3):
        self.backend = backend or SimulatorBackend()
        self.trials = trials
        self.n_experiments = 0

    def run_point(self, ds: Dataset, pt: Point,
                  methods: Optional[Sequence[Method]] = None):
        for meth in (methods or methods_for(pt.op, include_xla=False, p=pt.p)):
            for t in self.backend.measure(pt.op, pt.p, pt.m, meth,
                                          trials=self.trials):
                ds.add(Measurement(pt.op, pt.p, pt.m, meth.algorithm,
                                   meth.segments, t))
                self.n_experiments += 1

    def run_grid(
        self,
        ops: Sequence[str] = OPS,
        ps: Sequence[int] = PROCESS_COUNTS,
        ms: Sequence[int] = MESSAGE_SIZES,
    ) -> Dataset:
        ds = Dataset()
        for op in ops:
            for p in ps:
                for m in ms:
                    self.run_point(ds, Point(op, p, m))
        return ds
