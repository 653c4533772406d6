"""The port's cost models (``core/analytical/{costs,fitting,hierarchy}.py``,
copies of the reference's numpy modules) against the JAX package's: the
same inputs give the same floats (``==``, no tolerance) over the grids
of ``tests/test_analytical.py`` and the hierarchy's schedules."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import analytical as ja  # noqa: E402
from repro.core.analytical import costs as jcosts  # noqa: E402
from repro.core.analytical import hierarchy as jh  # noqa: E402
from repro_torch.core import analytical as ta  # noqa: E402
from repro_torch.core.analytical import costs as tcosts  # noqa: E402
from repro_torch.core.analytical import hierarchy as th  # noqa: E402
from repro_torch.core.collectives import algorithms as talg  # noqa: E402
from repro.core.collectives import algorithms as jalg  # noqa: E402

PS = (2, 4, 8, 16)
MS = (1024, 4096, 1 << 20, 64 << 20)
GAMMA = 2.5e-12


def _models(pkg):
    return {"hockney": pkg.DEFAULT_HOCKNEY, "loggp": pkg.DEFAULT_LOGGP,
            "plogp": pkg.default_plogp(),
            "custom": pkg.Hockney(alpha=1e-6, beta=2e-11)}


def _cases():
    out = []
    for op, algos in jalg.ALGORITHMS.items():
        for algo in algos:
            if algo != "xla" and op != "barrier":
                out.append((op, algo))
    return out


def test_algorithm_registries_name_the_same_algorithms():
    assert {op: list(a) for op, a in talg.ALGORITHMS.items()} == \
        {op: list(a) for op, a in jalg.ALGORITHMS.items()}


@pytest.mark.parametrize("model", ["hockney", "loggp", "plogp", "custom"])
@pytest.mark.parametrize("op,algo", _cases())
def test_collective_cost_equals_reference(op, algo, model):
    mj, mt = _models(ja)[model], _models(ta)[model]
    for p in PS:
        for m in MS:
            for segs in (1, 4):
                try:
                    want = jcosts.collective_cost(op, algo, mj, p, m,
                                                  segments=segs, gamma=GAMMA)
                except (KeyError, AssertionError, ValueError) as e:
                    with pytest.raises(type(e)):
                        tcosts.collective_cost(op, algo, mt, p, m,
                                               segments=segs, gamma=GAMMA)
                    continue
                assert tcosts.collective_cost(
                    op, algo, mt, p, m, segments=segs, gamma=GAMMA) == want


@pytest.mark.parametrize("op", ["all_reduce", "broadcast", "all_gather",
                                "reduce_scatter", "all_to_all"])
def test_selection_and_segments_equal_reference(op):
    for name in ("hockney", "loggp", "plogp"):
        mj, mt = _models(ja)[name], _models(ta)[name]
        for p in (4, 16):
            for m in (1024, 64 << 20):
                assert ta.best_algorithm(op, mt, p, m) == \
                    ja.best_algorithm(op, mj, p, m)
                for algo in jalg.ALGORITHMS[op]:
                    assert ta.numeric_optimal_segments(op, algo, mt, p, m) \
                        == ja.numeric_optimal_segments(op, algo, mj, p, m)
                    assert ta.optimal_segment_size(op, algo, mt, p, m) == \
                        ja.optimal_segment_size(op, algo, mj, p, m)


def test_table3_time_equals_reference():
    for p in (4, 16):
        for ms in np.geomspace(64, 64 << 20, 50):
            assert ta.table3_ring_segmented_time(
                ta.DEFAULT_HOCKNEY, p, 64 << 20, ms, gamma=GAMMA) == \
                ja.table3_ring_segmented_time(
                    ja.DEFAULT_HOCKNEY, p, 64 << 20, ms, gamma=GAMMA)


def test_fits_equal_reference():
    sizes = np.geomspace(64, 1 << 24, 30)
    true = ja.Hockney(alpha=2.3e-6, beta=3.1e-11)
    times = [true.p2p(m) for m in sizes]
    assert vars(ta.fit_hockney(sizes, times)) == \
        vars(ja.fit_hockney(sizes, times))
    assert vars(ta.fit_loggp(sizes, times)) == \
        vars(ja.fit_loggp(sizes, times))
    rng = np.random.default_rng(0)
    nl = np.array([1e-6 + 3e-6 * np.log2(max(m / 64, 1)) + m * 2e-11
                   for m in sizes])
    pj, pt = ja.fit_plogp(sizes, nl), ta.fit_plogp(sizes, nl)
    assert [pt.p2p(m) for m in sizes] == [pj.p2p(m) for m in sizes]
    idx = rng.permutation(len(sizes))
    tr, ho = idx[:15], idx[15:]
    mj, ej = ja.select_best_model(sizes[tr], nl[tr], sizes[ho], nl[ho])
    mt, et = ta.select_best_model(sizes[tr], nl[tr], sizes[ho], nl[ho])
    assert (mt.name, et) == (mj.name, ej)
    assert ta.prediction_error(pt, sizes, nl) == \
        ja.prediction_error(pj, sizes, nl)


@pytest.mark.parametrize("sizes", [[4], [2, 2], [4, 2], [2, 2, 2],
                                   [3, 4], [2, 4, 8]])
def test_hierarchy_schedules_equal_reference(sizes):
    for n in (1, 7, 1000, 1 << 20):
        assert th.padded_allreduce_schedule(sizes, n) == \
            jh.padded_allreduce_schedule(sizes, n)
        assert th.allreduce_phases(sizes, n * 4.0) == \
            jh.allreduce_phases(sizes, n * 4.0)
    levels_j = [(p, ja.DEFAULT_HOCKNEY) for p in sizes]
    levels_t = [(p, ta.DEFAULT_HOCKNEY) for p in sizes]
    for m in (4096.0, float(64 << 20)):
        assert th.hierarchical_allreduce_cost(levels_t, m) == \
            jh.hierarchical_allreduce_cost(levels_j, m)
        assert th.best_hierarchical(levels_t, m) == \
            jh.best_hierarchical(levels_j, m)
        cj = jh.modeled_phase_cost(levels_j)
        ct = th.modeled_phase_cost(levels_t)
        for lvl in range(len(sizes)):
            for op in ("reduce_scatter", "all_reduce", "all_gather"):
                assert ct(lvl, op, m) == cj(lvl, op, m)
    for buckets in ([4000.0], [16384.0, 68.0, float(1 << 18)]):
        assert th.overlapped_allreduce_time(levels_t, buckets) == \
            jh.overlapped_allreduce_time(levels_j, buckets)
        for n_layers in (1, 3):
            bb, ct_ = buckets * n_layers, [2e-5] * len(buckets) * n_layers
            assert th.backward_overlapped_time(
                levels_t, bb, ct_, n_streams=2) == \
                jh.backward_overlapped_time(levels_j, bb, ct_, n_streams=2)
    for m in (4096.0, float(64 << 20)):
        assert th.flat_vs_hierarchical(ta.DEFAULT_LOGGP, levels_t, m) == \
            jh.flat_vs_hierarchical(ja.DEFAULT_LOGGP, levels_j, m)
