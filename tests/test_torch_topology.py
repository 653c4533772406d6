"""The port's topology model and decision artifacts
(``core/topology/{model,decision}.py``, copies of the reference's numpy
modules) against the JAX package's.

* All four committed ``examples/artifacts/*.json`` load in both
  packages. The three decision artifacts resolve the same
  {algorithm, segments} at every (level, op, p, bytes) point: the tuned
  grid, off-grid sizes (the nearest-point fallback), and every phase size
  that smollm-135m's and the test trees' gradients send on the 2x2,
  2x2x2 and ("data",) meshes. The measurement cache loads as the same
  samples, and as a decision artifact both packages refuse it alike.
* `Topology` (specs, JSON), `fit_profile`, `probe_profile`,
  `probe_topology`, `profile_distance` and `MultiProfileArtifact.select`
  give the reference's values.
"""
import glob
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import topology as jt  # noqa: E402
from repro.core.tuning import session as jsession  # noqa: E402
from repro.core.tuning.simulator import NetworkProfile as JProf  # noqa: E402
from repro.core.tuning.space import MESSAGE_SIZES  # noqa: E402
from repro_torch.core import topology as tt  # noqa: E402
from repro_torch.core.tuning import session as tsession  # noqa: E402
from repro_torch.core.tuning.simulator import NetworkProfile as TProf  # noqa: E402,E501

ROOT = os.path.join(os.path.dirname(__file__), "..")
ARTIFACTS = sorted(glob.glob(os.path.join(ROOT, "examples", "artifacts",
                                          "*.json")))
DECISIONS = [p for p in ARTIFACTS if "measurements" not in p]
OPS = ("all_reduce", "reduce_scatter", "all_gather", "broadcast",
       "all_to_all")


def _grid_bytes():
    """Tuned sizes, off-grid sizes, and the phase sizes of the meshes'
    gradient syncs (smollm-135m's largest leaves split at p = 2, 4, 8)."""
    out = set(MESSAGE_SIZES)
    out.update({1, 3, 100, 5000, 3 << 20, 1 << 30})
    for n in (28311552, 2654208, 1327104, 884736, 576, 1000, 1639680):
        for div in (1, 2, 4, 8):
            out.add(4 * -(-n // div))
    return sorted(out)


def test_every_committed_artifact_is_covered():
    assert {os.path.basename(p) for p in ARTIFACTS} == {
        "hierarchical_decision.json", "hierarchical_decision_3level.json",
        "tuned_decision.json", "tuned_measurements.json"}


@pytest.mark.parametrize("path", DECISIONS, ids=os.path.basename)
def test_artifact_resolves_the_same_spec_everywhere(path):
    ja, ta = jt.MultiProfileArtifact.load(path), \
        tt.MultiProfileArtifact.load(path)
    assert (ta.kind, ta.names()) == (ja.kind, ja.names())
    jd, td = jt.load_decision(path), tt.load_decision(path)
    assert type(td).__name__ == type(jd).__name__
    levels = ja.names() if ja.kind == "hierarchical" else [None]
    n = 0
    for level in levels:
        jtab = ja[level] if level else jd
        ttab = ta[level] if level else td
        assert ttab.meta.to_json() == jtab.meta.to_json()
        for op in OPS:
            for p in (2, 4, 8, 16):
                for m in _grid_bytes():
                    try:
                        want = jtab.decide(op, p, m)
                    except KeyError:
                        with pytest.raises(KeyError):
                            ttab.decide(op, p, m)
                        continue
                    got = ttab.decide(op, p, m)
                    assert (got.algorithm, got.segments) == \
                        (want.algorithm, want.segments), (level, op, p, m)
                    if level:
                        assert td.spec_for_level(level, op, m, p) == \
                            td.spec_for_level(levels.index(level), op, m, p)
                        js = jd.spec_for_level(level, op, m, p)
                        ts = td.spec_for_level(level, op, m, p)
                        assert (ts.algorithm, ts.segments) == \
                            (js.algorithm, js.segments)
                    n += 1
    assert n >= 900


def test_measurement_cache_loads_as_the_same_samples(tmp_path):
    path = [p for p in ARTIFACTS if "measurements" in p][0]
    from repro.core.tuning import SimulatorBackend as JSB
    from repro.core.tuning import NetworkSimulator as JNS
    from repro_torch.core.tuning import SimulatorBackend as TSB
    from repro_torch.core.tuning import NetworkSimulator as TNS
    js = jsession.TuningSession(JSB(JNS(JProf())))
    ts = tsession.TuningSession(TSB(TNS(TProf())))
    js.load_measurements(path)
    ts.load_measurements(path)
    assert len(ts) == len(js) > 1000
    for pkg, s in (("j", js), ("t", ts)):
        s.save_measurements(str(tmp_path / f"{pkg}.json"))
    assert (tmp_path / "j.json").read_bytes() == \
        (tmp_path / "t.json").read_bytes()
    # not a decision artifact, in either package
    for mod in (jt, tt):
        with pytest.raises(ValueError, match="unsupported artifact schema"):
            mod.MultiProfileArtifact.load(path)


@pytest.mark.parametrize("spec", ["8", "2x4", "2x2", "2x2x2", "4x16"])
def test_topology_from_spec_equals_reference(spec, tmp_path):
    j, t = jt.Topology.from_spec(spec), tt.Topology.from_spec(spec)
    assert t.to_json() == j.to_json()
    assert (t.names(), t.total_size, t.inner.name, t.outer.name) == \
        (j.names(), j.total_size, j.inner.name, j.outer.name)
    t.save(str(tmp_path / "t.json"))
    assert jt.Topology.load(str(tmp_path / "t.json")).to_json() == j.to_json()
    assert tt.Topology.from_spec(spec, axes=["model"] + [None] * 2) \
        .to_json() == jt.Topology.from_spec(
            spec, axes=["model"] + [None] * 2).to_json()


def test_topology_constructors_and_errors_equal_reference():
    assert tt.Topology.single_level(8).to_json() == \
        jt.Topology.single_level(8).to_json()
    assert tt.Topology.two_level(4, 2).to_json() == \
        jt.Topology.two_level(4, 2).to_json()
    assert [tt.level_names_for(n) for n in (1, 2, 3)] == \
        [jt.level_names_for(n) for n in (1, 2, 3)]
    assert tt.SYNC_AXES == jt.SYNC_AXES
    for bad in ("2x2x2x2", "0x2"):
        for mod in (jt, tt):
            with pytest.raises(ValueError):
                mod.Topology.from_spec(bad)
    with pytest.raises(KeyError):
        tt.Topology.from_spec("2x2").level("intra_host")


def test_profile_fits_equal_reference():
    ms = list(tt.model.PROBE_SIZES)
    ts = [3e-6 + 2e-10 * m * (1 + 0.01 * i) for i, m in enumerate(ms)]
    assert vars(tt.fit_profile(ms, ts)) == vars(jt.fit_profile(ms, ts))

    def measure(m):
        return 5e-6 + 1e-9 * m
    assert vars(tt.probe_profile(measure)) == vars(jt.probe_profile(measure))
    levels = [("intra_pod", 4, measure, "data"),
              ("cross_pod", 2, lambda m: 2 * measure(m))]
    assert tt.probe_topology(levels).to_json() == \
        jt.probe_topology(levels).to_json()


def test_profile_selection_equals_reference(tmp_path):
    from repro.core.tuning.decision import DecisionTable as JDT
    from repro.core.tuning.decision import TableMeta as JMeta
    from repro.core.tuning.space import Method
    slow = dict(vars(JProf(launch=8e-6, byte_time=8e-9)))
    fast = dict(vars(JProf(launch=0.6e-6, byte_time=4e-10)))
    art = jt.MultiProfileArtifact([
        (name, JDT({("all_reduce", 4, 1024): Method(algo, 1)},
                   meta=JMeta(tuner="exhaustive", profile=prof)))
        for name, algo, prof in (("dcn", "ring", slow),
                                 ("ici", "recursive_doubling", fast))])
    path = str(tmp_path / "multi.json")
    art.save(path)
    ta, ja = tt.MultiProfileArtifact.load(path), \
        jt.MultiProfileArtifact.load(path)
    for probe in (None, fast, slow, dict(fast, launch=0.0)):
        assert ta.select(probe)[0] == ja.select(probe)[0]
        assert tt.profile_distance(fast, probe) == \
            jt.profile_distance(fast, probe)
    ta.save(str(tmp_path / "again.json"))
    assert json.loads((tmp_path / "again.json").read_text()) == \
        json.loads((tmp_path / "multi.json").read_text())
    assert np.isinf(tt.profile_distance(None, fast))
