"""The port's tuned mesh placement and per-level tuning against the JAX
package's.

``core/topology/placement.py`` and ``core/topology/tune.py`` are copies
of the reference's numpy modules: on the same topology both packages
must enumerate the same candidates, price them at the same floats, pick
the same winner and write the same per-level artifact byte for byte
(``tune_topology`` with the reference example's gradient-leaf mix and
``tune_mapping=True``). ``MeshMapping.apply`` rebuilds the port's
`group.RankMesh`: its refusals are held here on a stand-in mesh, the
rebuilt mesh itself in the multi-rank runs of
``tests/test_torch_communicator.py``.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import topology as jtopo  # noqa: E402
from repro.core.topology import placement as jplace  # noqa: E402
from repro.core.tuning.space import (  # noqa: E402
    DECODE_MESSAGE_SIZES, MESSAGE_SIZES, Method)
from repro_torch.core import topology as ttopo  # noqa: E402
from repro_torch.core.topology import placement as tplace  # noqa: E402
from repro.core.collectives import synth as jsynth  # noqa: E402
from repro_torch.core.collectives import synth as tsynth  # noqa: E402

from test_torch_gradsync import FakeRankMesh  # noqa: E402

#: (spec, mesh axes outermost first, extra model-parallel factor)
MESHES = [("2x4", ("pod", "data"), 1), ("2x2x2", ("dcn", "pod", "data"), 1),
          ("4x2", ("pod", "data"), 1), ("2x3x4", ("dcn", "pod", "data"), 1),
          ("2x2", ("pod", "data", "model"), 2)]
# examples/autotune_collectives.py's gradient-leaf mix and grid
LEAF_MIX = [4 << 20, 64 << 10, 64 << 10, 16 << 10] * 6
EX_MS = tuple(sorted(set(1024 * 4 ** i for i in range(7))
                     | set(DECODE_MESSAGE_SIZES)))


@pytest.fixture(autouse=True)
def empty_synth_registries():
    """Both packages' synthesized-program registries empty for the test
    and put back after it: programs another test in this process
    registered would ride in one package's artifacts only."""
    saved = [(m, {k: dict(v) for k, v in m._REGISTRY.items()},
              dict(m._FRONTS)) for m in (jsynth, tsynth)]
    for m, _, _ in saved:
        m.clear_registry()
    yield
    for m, reg, fronts in saved:
        m._REGISTRY.clear()
        m._REGISTRY.update(reg)
        m._FRONTS.clear()
        m._FRONTS.update(fronts)


def _shape(spec, axes, mp):
    shape = tuple(int(t) for t in spec.split("x"))
    return shape + (mp,) if "model" in axes else shape


def _random_topologies(pkg, seed, n=4):
    """Seeded random hierarchies (the reference tests' recipe): sizes in
    2..4, fabrics slower outward."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        sizes = [int(rng.integers(2, 5)) for _ in range(int(rng.integers(
            2, 4)))]
        topo = pkg.Topology.from_spec("x".join(str(s)
                                               for s in reversed(sizes)))
        levels, scale = [], 1.0
        for lv in topo.levels:
            scale *= float(rng.uniform(1.5, 20.0))
            prof = dataclasses.replace(
                lv.profile, launch=lv.profile.launch * scale,
                byte_time=lv.profile.byte_time * scale)
            levels.append(dataclasses.replace(lv, profile=prof))
        out.append(pkg.Topology(tuple(levels)))
    return out


@pytest.mark.parametrize("spec,axes,mp", MESHES)
def test_candidates_prices_and_winner_match(spec, axes, mp):
    shape = _shape(spec, axes, mp)
    tj, tt = jtopo.Topology.from_spec(spec), ttopo.Topology.from_spec(spec)
    wl = (jplace.Workload(), tplace.Workload())
    if "model" in axes:
        wl = (jplace.Workload(decode_bytes=(1024, 65536)),
              tplace.Workload(decode_bytes=(1024, 65536)))
    cj = jplace.enumerate_mappings(tj, axes, shape)
    ct = tplace.enumerate_mappings(tt, axes, shape)
    assert [c.to_json() for c in ct] == [c.to_json() for c in cj]
    assert ct[0].is_identity
    for a, b in zip(cj, ct):
        assert tplace.axis_tiers(b, tt) == jplace.axis_tiers(a, tj)
        assert tplace.price_mapping(tt, b, wl[1]) == \
            jplace.price_mapping(tj, a, wl[0])
        assert b.summary() == a.summary()
    bj, allj = jplace.sweep_mappings(tj, axes, shape, workload=wl[0])
    bt, allt = tplace.sweep_mappings(tt, axes, shape, workload=wl[1])
    assert bt.to_json() == bj.to_json()
    assert [c.to_json() for c in allt] == [c.to_json() for c in allj]
    assert tplace.tier_group_sizes(tt, int(np.prod(shape))) == \
        jplace.tier_group_sizes(tj, int(np.prod(shape)))


def test_random_topologies_and_scrambles_price_alike():
    orders = [(0, 7, 3, 4, 5, 2, 6, 1), (3, 2, 1, 0, 7, 6, 5, 4)]
    for tj, tt in zip(_random_topologies(jtopo, 7),
                      _random_topologies(ttopo, 7)):
        shape = tuple(lv.size for lv in tj.levels)[::-1]
        axes = ("dcn", "pod", "data")[-len(shape):]
        bj, _ = jplace.sweep_mappings(tj, axes, shape)
        bt, _ = tplace.sweep_mappings(tt, axes, shape)
        assert bt.to_json() == bj.to_json()
    tj, tt = jtopo.Topology.from_spec("2x2x2"), \
        ttopo.Topology.from_spec("2x2x2")
    for order in orders:
        mj = jplace.MeshMapping(("dcn", "pod", "data"), (2, 2, 2), order)
        mt = tplace.MeshMapping(("dcn", "pod", "data"), (2, 2, 2), order)
        assert tplace.axis_tiers(mt, tt) == jplace.axis_tiers(mj, tj)
        assert tplace.price_mapping(tt, mt) == jplace.price_mapping(tj, mj)


def test_mapping_json_round_trips_across_packages():
    best, _ = tplace.sweep_mappings(ttopo.Topology.from_spec("2x2x2"),
                                    ("dcn", "pod", "data"), (2, 2, 2))
    doc = json.loads(json.dumps(best.to_json()))
    assert tplace.MeshMapping.from_json(doc) == best
    assert jplace.MeshMapping.from_json(doc).to_json() == best.to_json()
    ident = tplace.identity_mapping(("pod", "data"), (2, 4))
    assert ident.is_identity and ident.to_json() == \
        jplace.identity_mapping(("pod", "data"), (2, 4)).to_json()
    with pytest.raises(ValueError, match="permutation"):
        tplace.MeshMapping(("data",), (2,), (0, 0))
    with pytest.raises(ValueError, match="axes"):
        tplace.MeshMapping(("data", "pod"), (2,), (0, 1))


def test_apply_keeps_the_reference_checks():
    mesh = FakeRankMesh(pod=2, data=2)
    ident = tplace.identity_mapping(("pod", "data"), (2, 2))
    assert ident.apply(mesh) is mesh
    with pytest.raises(ValueError, match="mesh axes"):
        tplace.identity_mapping(("dcn", "data"), (2, 2)).apply(mesh)
    with pytest.raises(ValueError, match="different machine size"):
        tplace.identity_mapping(("pod", "data"), (2, 4)).apply(mesh)
    with pytest.raises(ValueError, match="mapping covers 4 devices but "
                                         "3 are attached"):
        tplace.MeshMapping(("pod", "data"), (2, 2),
                           (0, 2, 1, 3)).build_mesh([0, 1, 2])


def _tune_json(pkg, topo_pkg, topo, tmp_path, tag, **kw):
    hier, reports = topo_pkg.tune_topology(topo, **kw)
    path = tmp_path / f"{tag}.json"
    hier.save(str(path))
    reps = {name: [(r.name, r.n_experiments, r.cache_hits, r.penalty)
                   for r in rs] for name, rs in reports.items()}
    return path.read_bytes(), reps, hier


@pytest.mark.parametrize("spec,kw", [
    ("two_level", {}),
    ("two_level", {"schedule_leaf_bytes": LEAF_MIX, "tune_mapping": True}),
    ("2x2x2", {"schedule_leaf_bytes": LEAF_MIX, "tune_mapping": True}),
])
def test_tune_topology_writes_the_reference_artifact(spec, kw, tmp_path):
    out = {}
    for name, pkg in (("jax", jtopo), ("torch", ttopo)):
        topo = pkg.Topology.two_level(4, 2) if spec == "two_level" \
            else pkg.Topology.from_spec(spec)
        out[name] = _tune_json(pkg, pkg, topo, tmp_path, name, ms=EX_MS,
                               **kw)
    assert out["torch"][0] == out["jax"][0]
    assert out["torch"][1] == out["jax"][1]
    doc = json.loads(out["torch"][0])
    metas = [p["meta"] for p in doc["profiles"]]
    if kw.get("tune_mapping"):
        assert all(m["mapping"] == metas[0]["mapping"] for m in metas)
        assert metas[0]["schedule"]["bucket_bytes"] > 0
    else:
        assert all("mapping" not in m for m in metas)


def test_timing_helpers_match():
    """flat vs hierarchical ground truth, the decided methods and the
    sync-time models of tune.py, float for float."""
    from repro.core.collectives.schedule import coalesce_bytes as jcb
    from repro_torch.core.collectives.schedule import coalesce_bytes as tcb
    for spec in ("2x4", "2x2x2"):
        tj, tt = jtopo.Topology.from_spec(spec), \
            ttopo.Topology.from_spec(spec)
        hj, _ = jtopo.tune_topology(tj, ms=MESSAGE_SIZES[::3])
        ht, _ = ttopo.tune_topology(tt, ms=MESSAGE_SIZES[::3])
        for m in (4096, 1 << 20, 4 << 20):
            dj = jtopo.decided_hierarchical_methods(hj, tj, m)
            dt = ttopo.decided_hierarchical_methods(ht, tt, m)
            assert {k: (x.algorithm, x.segments) for k, x in dt.items()} \
                == {k: (x.algorithm, x.segments) for k, x in dj.items()}
            assert ttopo.hierarchical_allreduce_time(tt, dt, m) == \
                jtopo.hierarchical_allreduce_time(tj, dj, m)
            for meth in (Method("ring", 2), Method("xla", 1)):
                assert ttopo.flat_time(tt, "all_reduce", meth, m) == \
                    jtopo.flat_time(tj, "all_reduce", meth, m)
            assert ttopo.optimal_machine_allreduce_time(tt, m) == \
                jtopo.optimal_machine_allreduce_time(tj, m)
            assert ttopo.optimal_hierarchical_allreduce_time(tt, m) == \
                jtopo.optimal_hierarchical_allreduce_time(tj, m)
        assert ttopo.sequential_sync_time(tt, ht, LEAF_MIX) == \
            jtopo.sequential_sync_time(tj, hj, LEAF_MIX)
        buckets = tcb(LEAF_MIX, 1 << 20)
        assert buckets == jcb(LEAF_MIX, 1 << 20)
        assert ttopo.pipelined_sync_time(tt, ht, buckets) == \
            jtopo.pipelined_sync_time(tj, hj, buckets)
        compute = [1e-4 * (i + 1) for i in range(len(buckets))]
        assert ttopo.streamed_sync_time(tt, ht, buckets, compute) == \
            jtopo.streamed_sync_time(tj, hj, buckets, compute)
        assert ttopo.tune_overlap_schedule(tt, ht, LEAF_MIX) == \
            jtopo.tune_overlap_schedule(tj, hj, LEAF_MIX)
        assert ttopo.tune_mesh_mapping(tt, ht).to_json() == \
            jtopo.tune_mesh_mapping(tj, hj).to_json()
        assert ttopo.BUCKET_BYTES_CANDIDATES == jtopo.BUCKET_BYTES_CANDIDATES
