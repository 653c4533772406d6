"""The port's `Communicator` against the JAX package's.

Single process (``tests/test_communicator.py`` mirrored): decision
resolution over every artifact generation, the static policy's
per-leaf segments, probe selection, the hierarchical plan expansion,
``describe()`` and ``explain()`` text equal to the reference's, the
adoption of an artifact's tuned mesh mapping (``tests/test_placement.py``
mirrored), and the backward-overlapped entry points, which no longer
raise.

Multi-rank: the same numpy gradients and buffers through the reference
(one subprocess with ``--xla_force_host_platform_device_count=8``:
``Communicator.create(mesh, artifact=...)`` inside ``shard_map``, one
jit per case, a `TraceRecorder` on a `FakeClock`) and through the port
(one spawned 4-rank ``gloo`` group holding both meshes, the same program
in every rank). Cases: a 2x2 ``("pod", "data")`` mesh and a 4-rank
``("data",)`` mesh, each with the hierarchical artifact per leaf and
bucketed, the flat tuned artifact per leaf and bucketed, and ``"xla"``;
the program runs ``sync_gradients`` (mean and sum), every op method,
the multi-axis compositions and ``multilevel_*`` directly. Tolerances:
bit-equal wherever no ``"xla"`` spec or psum top enters (every other
algorithm gives the reference's bits); ``rtol=1e-6`` in fp32 where one
does (gloo sums in another order than XLA). The recorded spans equal
the reference's (all but the times: the port's are concrete, each one
clock step), ``explain_gradients`` renders the reference's text and
equals the port's spans entry for entry, and the port's untraced sync
gives the traced sync's bits. Remapped meshes: the same 2x2 and
``("data",)`` meshes with artifacts that carry a scrambled mesh mapping
(the reference runs ``shard_map`` over the mapped ``comm.mesh``; each
port rank takes its slot's inputs, and the results are stacked in slot
order). A 2x2x2 case with the 3-level artifact, plain and remapped (the
first non-identity candidate of ``enumerate_mappings`` and a scramble),
runs under ``slow``.
"""
import dataclasses
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.comms import CollectiveRequest as JReq  # noqa: E402
from repro.comms import Communicator as JComm  # noqa: E402
from repro.configs.base import CollectiveConfig  # noqa: E402
from repro.core.topology.decision import HierarchicalDecision as JHD  # noqa: E402,E501
from repro.core.tuning.decision import DecisionTable as JDT  # noqa: E402
from repro.core.tuning.decision import TableMeta as JMeta  # noqa: E402
from repro.core.tuning.simulator import NetworkProfile as JProf  # noqa: E402
from repro.core.tuning.space import Method  # noqa: E402
from repro_torch import pytree  # noqa: E402
from repro_torch.comms import CollectiveRequest as TReq  # noqa: E402
from repro_torch.comms import Communicator as TComm  # noqa: E402
from repro_torch.comms import MultiProfileArtifact as TMPA  # noqa: E402
from repro_torch.core.collectives import group as grp  # noqa: E402
from repro_torch.core.tuning.simulator import NetworkProfile as TProf  # noqa: E402,E501

from test_torch_gradsync import FakeRankMesh  # noqa: E402
from test_torch_gradsync import restore_synth_registries  # noqa: E402,F401

HERE = os.path.dirname(__file__)
ROOT = os.path.join(HERE, "..")
ARTIFACTS = os.path.join(ROOT, "examples", "artifacts")
HIER = os.path.join(ARTIFACTS, "hierarchical_decision.json")
HIER3 = os.path.join(ARTIFACTS, "hierarchical_decision_3level.json")
FLAT = os.path.join(ARTIFACTS, "tuned_decision.json")
RTOL = 1e-6                 # fp32, where an "xla" sum enters


def _table(path, op="all_reduce", p=4, m=1024, algo="ring", seg=2,
           profile=None):
    JDT({(op, p, m): Method(algo, seg)},
        meta=JMeta(tuner="exhaustive", profile=profile)).save(path)
    return path


def _both(**kw):
    return JComm.create(**kw), TComm.create(**kw)


def _spec(comm, req_cls, *a, **kw):
    s = comm.spec(req_cls(*a, **kw))
    return (s.algorithm, s.segments)


# ---------------------------------------------------------------------------
# single process: resolution, policies, text
# ---------------------------------------------------------------------------
def test_static_segments_derived_per_leaf():
    for seg_bytes in (0, 4096):
        cfg = CollectiveConfig(algorithm="ring", segment_bytes=seg_bytes)
        jc, tc = JComm.from_config(cfg), TComm.from_config(cfg)
        for n in (16, 4097, 1 << 20):
            assert _spec(tc, TReq, "all_reduce", n, axis_size=4) == \
                _spec(jc, JReq, "all_reduce", n, axis_size=4)
        assert tc.describe() == jc.describe()
    assert _spec(tc, TReq, "all_reduce", 1 << 20, axis_size=4) == \
        ("ring", 256)


def test_static_algorithm_degrades_and_xla_is_untuned():
    cfg = CollectiveConfig(algorithm="ring")
    tc = TComm.from_config(cfg)
    entry = tc.plan(TReq("broadcast", 1024, axis_size=4))[0]
    assert entry.spec.algorithm == "xla" and "fallback" in entry.source
    assert entry.render() == JComm.from_config(cfg).plan(
        JReq("broadcast", 1024, axis_size=4))[0].render()
    xla = TComm.from_config(CollectiveConfig())
    assert not xla.is_tuned and xla.describe() == "xla"
    assert TComm.create(static=TComm.create().spec(
        TReq("all_reduce", 8))).describe() == "static:xla/seg=1"


def test_artifact_generations_resolve_as_the_reference(tmp_path):
    flat = _table(str(tmp_path / "flat.json"), algo="rabenseifner", seg=4)
    legacy = str(tmp_path / "legacy.json")
    with open(legacy, "w") as f:
        json.dump([{"op": "all_reduce", "p": 4, "m": 1024,
                    "algorithm": "ring", "segments": 2}], f)
    for path in (flat, legacy, FLAT, HIER, HIER3):
        jc, tc = _both(artifact=path)
        assert tc.describe() == jc.describe()
        assert (tc.is_tuned, tc.hierarchical, tc.bucket_bytes) == \
            (jc.is_tuned, jc.hierarchical, jc.bucket_bytes)
        for op in ("all_reduce", "all_gather", "reduce_scatter",
                   "all_to_all", "broadcast"):
            for p in (2, 4):
                for m in (1024, 4096 + 4, 1 << 20):
                    for axis in (None, "data", "pod", "model"):
                        kw = dict(axis_size=p, axis=axis, dtype="bfloat16")
                        assert _spec(tc, TReq, op, m, **kw) == \
                            _spec(jc, JReq, op, m, **kw)
    req = TReq("all_reduce", 1024, axis="data", axis_size=4,
               dtype="bfloat16")
    assert req.key3() == ("all_reduce", 1024, 4)


def test_hierarchical_levels_resolve_as_the_reference(tmp_path):
    JHD([("intra_host", JDT({("all_gather", 2, 1024): Method("bruck", 1)})),
         ("intra_pod", JDT({("all_gather", 2, 1024): Method("ring", 1)})),
         ("cross_pod", JDT({("all_reduce", 2, 1024):
                            Method("recursive_doubling", 1)}))]
        ).save(str(tmp_path / "h.json"))
    jc, tc = _both(artifact=str(tmp_path / "h.json"))
    for axis in ("model", "data", "pod", None):
        assert _spec(tc, TReq, "all_gather", 1024, axis=axis,
                     axis_size=2) == _spec(jc, JReq, "all_gather", 1024,
                                           axis=axis, axis_size=2)
    assert _spec(tc, TReq, "all_gather", 1024, axis="model",
                 axis_size=2) == ("bruck", 1)
    for level in ("intra_host", "intra_pod", "cross_pod", 0, 2):
        t = tc.spec_for_level(level, "all_reduce", 1024, 2)
        j = jc.spec_for_level(level, "all_reduce", 1024, 2)
        assert (t.algorithm, t.segments) == (j.algorithm, j.segments)
    pinned = TReq("all_reduce", 1024, axis_size=2, level="cross_pod")
    assert tc.spec(pinned).algorithm == "recursive_doubling"
    preloaded = TComm.create(artifact=TMPA.load(str(tmp_path / "h.json")))
    assert preloaded.hierarchical
    assert tc.metrics.total("decision_cache_miss") > 0


def test_probe_selection_as_the_reference(tmp_path):
    from repro.core.topology.decision import MultiProfileArtifact as JMPA
    slow = JProf(launch=8e-6, byte_time=8e-9)
    fast = JProf(launch=0.6e-6, byte_time=4e-10)
    JMPA([("dcn", JDT({("all_reduce", 4, 1024):
                       Method("recursive_doubling", 1)},
                      meta=JMeta(tuner="exhaustive",
                                 profile=dict(vars(slow))))),
          ("ici", JDT({("all_reduce", 4, 1024): Method("ring", 2)},
                      meta=JMeta(tuner="exhaustive",
                                 profile=dict(vars(fast)))))]
         ).save(str(tmp_path / "multi.json"))
    path = str(tmp_path / "multi.json")
    first = TComm.create(artifact=path)
    assert first.spec(TReq("all_reduce", 1024, axis_size=4)).algorithm == \
        "recursive_doubling"
    probed = TComm.create(artifact=path, probe=True,
                          probed=TProf(**vars(fast)))
    assert probed.describe() == JComm.create(
        artifact=path, probe=True, probed=fast).describe()
    assert "ici" in probed.describe() and "probed" in probed.describe()
    legacy = _table(str(tmp_path / "legacy.json"))
    with pytest.warns(RuntimeWarning, match="no profile"):
        comm = TComm.create(artifact=legacy, probe=True,
                            probed=TProf(launch=1e-5, byte_time=1e-9))
    assert "probed" not in comm.describe()


def test_explain_text_equals_reference():
    """A two-axis request expands to its composition phases with the
    padded byte counts; the rendered plans of every artifact equal the
    reference's."""
    from test_gradsync_pipeline import fake_mesh
    reqs = [("all_reduce", 37 * 4, ("data", "pod"), 8),
            ("reduce_scatter", 1000 * 4, ("data", "pod"), 8),
            ("all_gather", 1000 * 4, ("data", "pod"), 8),
            ("all_reduce", 1 << 20, "data", 4),
            ("all_gather", 4096, "pod", 2),
            ("broadcast", 4096, "data", 4)]
    for path in (HIER, HIER3, FLAT, None):
        jc = JComm.create(fake_mesh(pod=2, data=4), artifact=path)
        tc = TComm.create(FakeRankMesh(pod=2, data=4), artifact=path)
        jr = jc.explain([JReq(op, n, axis=a, axis_size=p)
                         for op, n, a, p in reqs])
        tr = tc.explain([TReq(op, n, axis=a, axis_size=p)
                         for op, n, a, p in reqs])
        assert tr.render() == jr.render()
        assert tr.to_json() == jr.to_json()
    entries = tc.plan(TReq("all_reduce", 37 * 4, axis=("data", "pod"),
                           axis_size=8))
    assert [e.request.op for e in entries] == \
        ["reduce_scatter", "all_reduce", "all_gather"]
    assert entries[0].request.nbytes == 40 * 4


def test_gradient_requests_spell_dtypes_as_the_reference():
    from test_gradsync_pipeline import fake_mesh
    tree = {"w": torch.zeros(3, 4), "b": torch.zeros(5, dtype=torch.bfloat16)}
    jtree = {"w": np.zeros((3, 4), np.float32),
             "b": np.zeros(5, np.float32)}
    tc = TComm.create(FakeRankMesh(pod=2, data=2), artifact=HIER)
    jc = JComm.create(fake_mesh(pod=2, data=2), artifact=HIER)
    got = tc.gradient_requests(tree)
    assert [(r.op, r.nbytes, r.axis, r.axis_size, r.dtype) for r in got] == \
        [("all_reduce", 10, ("data", "pod"), 4, "bfloat16"),
         ("all_reduce", 48, ("data", "pod"), 4, "float32")]
    assert vars(got[1]) == vars(jc.gradient_requests(jtree)[1])
    x = torch.zeros(7, dtype=torch.bfloat16)
    assert TReq.for_array("all_gather", x, "data", 2).describe() == \
        "all_gather[bfloat16] 14 B over data(2)"


def test_later_parts_raise_with_their_roadmap_step(tmp_path):
    """The backward-overlapped path (ROADMAP.md Queue 1 step 9a) is
    ported: none of its entry points raises any more (its parity tests
    are ``tests/test_torch_overlap.py``). A mesh without a 'data' axis
    still has no gradient sync."""
    tc = TComm.create(FakeRankMesh(pod=2, data=2), artifact=HIER)
    sink = tc.release_sink()
    assert sink.events == [] and sink.thread is None
    assert tc.sync_gradients_streamed({}, None) == {}
    assert tc._sync_release({}, 0) == {}
    plan = tc.explain_gradients({"w": torch.zeros(2)},
                                overlap_backward=True)
    assert [e.request.op for e in plan.entries] == \
        [e.request.op for e in tc.explain_gradients(
            {"w": torch.zeros(2)}).entries]
    with pytest.raises(ValueError, match="'data' axis"):
        TComm.create(FakeRankMesh(pod=2), artifact=HIER).sync_gradients(
            {"w": torch.zeros(2)})


# ---------------------------------------------------------------------------
# a tuned mesh mapping in the artifact (tests/test_placement.py mirrored)
# ---------------------------------------------------------------------------
def _mapped_table(pkg_dt, pkg_meta, mapping):
    return pkg_dt({("all_reduce", 2, 1024): Method("ring", 1)},
                  meta=pkg_meta(tuner="handmade", mapping=mapping.to_json()))


def test_communicator_adopts_identity_mapping_and_renders_it():
    """The same mesh axes: the mapping is installed (identity leaves the
    mesh object untouched), and describe() and the plan reports say
    so, in the reference's text."""
    from test_gradsync_pipeline import fake_mesh
    from repro_torch.core.topology import identity_mapping
    from repro_torch.core.tuning import DecisionTable as TDT, TableMeta as TM
    ident = dataclasses.replace(
        identity_mapping(("dcn", "pod", "data"), (2, 2, 2)), cost=1e-3,
        tiers={"data": "intra_host", "pod": "intra_pod",
               "dcn": "cross_pod"})
    mesh = FakeRankMesh(dcn=2, pod=2, data=2)
    tc = TComm.create(mesh, artifact=_mapped_table(TDT, TM, ident))
    jc = JComm.create(fake_mesh(dcn=2, pod=2, data=2),
                      artifact=_mapped_table(JDT, JMeta, ident))
    assert tc.mapping == ident and tc.mesh is mesh
    assert "mapping=identity" in tc.describe()
    assert tc.describe() == jc.describe()
    plan = tc.explain_gradients({"w": pytree.LeafStruct((64,),
                                                        torch.float32)})
    assert plan.header == "mesh mapping: " + ident.summary()
    assert plan.render().splitlines()[0].strip().startswith("mesh mapping:")
    req = [TReq("all_reduce", 1024, axis="data", axis_size=2)]
    assert tc.explain(req).render() == jc.explain(
        [JReq("all_reduce", 1024, axis="data", axis_size=2)]).render()


def test_communicator_skips_mapping_for_different_mesh_axes():
    """A mesh of other axes (a pure-TP ``("model",)`` mesh loading a
    train-tuned artifact): warn and keep the mesh."""
    from repro_torch.core.topology import identity_mapping
    from repro_torch.core.tuning import DecisionTable as TDT, TableMeta as TM
    mesh = FakeRankMesh(model=2)
    ident = identity_mapping(("dcn", "pod", "data"), (2, 2, 2))
    with pytest.warns(RuntimeWarning, match="mesh mapping"):
        tc = TComm.create(mesh, artifact=_mapped_table(TDT, TM, ident))
    assert tc.mapping is None and tc.mesh is mesh
    assert "mapping=" not in tc.describe()


def test_communicator_rejects_mapping_for_wrong_machine_size(tmp_path):
    from repro_torch.core.topology import identity_mapping
    from repro_torch.core.tuning import DecisionTable as TDT, TableMeta as TM
    wrong = identity_mapping(("dcn", "pod", "data"), (2, 2, 4))
    with pytest.raises(ValueError, match="different machine size"):
        TComm.create(FakeRankMesh(dcn=2, pod=2, data=2),
                     artifact=_mapped_table(TDT, TM, wrong))
    # from a file: the schema-3 artifact with the mapping in a level's meta
    doc = json.load(open(HIER))
    doc["profiles"][0]["meta"]["mapping"] = wrong.to_json()
    path = str(tmp_path / "mapped.json")
    json.dump(doc, open(path, "w"))
    with pytest.raises(ValueError, match="different machine size"):
        TComm.create(FakeRankMesh(dcn=2, pod=2, data=2), artifact=path)
    assert TComm.create(artifact=path).mapping == wrong     # no mesh yet


# ---------------------------------------------------------------------------
# multi-rank: the reference inside shard_map, the port in every rank
# ---------------------------------------------------------------------------
LEAF_SHAPES = {"z/w": (33, 7), "z/a": (5,), "b/0": (3, 5), "b/1": (7,),
               "b/2": (2, 3, 4), "a": (1,)}
N_X = 1003
MESHES = {"2x2": ((2, 2), ("pod", "data")), "d4": ((4,), ("data",)),
          "2x2x2": ((2, 2, 2), ("dcn", "pod", "data"))}
# remapped meshes: the same meshes, the artifact carrying a tuned mapping
# (slot i holds rank order[i]). 2x2 and d4 scramble the rank order so
# that a sub-group's member order differs from its axis order; 2x2x2
# takes the first non-identity candidate of enumerate_mappings (the
# chip's case) and a scramble
MESHES.update({"2x2m": MESHES["2x2"], "d4m": MESHES["d4"],
               "2x2x2m": MESHES["2x2x2"]})
ORDER_2X2 = (3, 1, 2, 0)
ORDER_D4 = (2, 0, 3, 1)
ORDER_2X2X2_CAND = (0, 1, 4, 5, 2, 3, 6, 7)
ORDER_2X2X2 = (5, 2, 7, 0, 3, 6, 1, 4)
CASES = {
    "2x2": [("hier", HIER, 0), ("hier_b", HIER, 1024), ("flat", FLAT, 0),
            ("flat_b", FLAT, 2048), ("xla", None, 0)],
    "d4": [("hier", HIER, 0), ("flat", FLAT, 0), ("flat_b", FLAT, 2048),
           ("xla", None, 0)],
    "2x2x2": [("hier3", HIER3, 0), ("hier3_sched", HIER3, None),
              ("hier3_b", HIER3, 1024), ("xla", None, 0)],
    "2x2m": [("hier", ("map", HIER, ORDER_2X2), 0),
             ("hier_b", ("map", HIER, ORDER_2X2), 1024),
             ("flat", ("map", FLAT, ORDER_2X2), 0)],
    "d4m": [("flat_b", ("map", FLAT, ORDER_D4), 2048)],
    "2x2x2m": [("hier3_sched", ("map", HIER3, ORDER_2X2X2_CAND), None),
               ("hier3", ("map", HIER3, ORDER_2X2X2), 0),
               ("hier3_b", ("map", HIER3, ORDER_2X2X2), 1024)],
}


def _mapped_artifact(src, order, axes, shape, dst):
    """``src`` with a `MeshMapping` of ``order`` stamped into its meta
    (every level's, for a schema-3 artifact), written to ``dst``."""
    from repro_torch.core.topology import MeshMapping
    doc = json.load(open(src))
    mapping = MeshMapping(tuple(axes), tuple(shape), tuple(order)).to_json()
    for meta in ([p["meta"] for p in doc["profiles"]] if "profiles" in doc
                 else [doc["meta"]]):
        meta["mapping"] = mapping
    json.dump(doc, open(dst, "w"))
    return dst


def _resolve(tmp, mesh_name, cases):
    """The cases with each ``("map", src, order)`` artifact written out."""
    shape, axes = MESHES[mesh_name]
    out = []
    for name, art, bb in cases:
        if isinstance(art, tuple):
            art = _mapped_artifact(art[1], art[2], axes, shape,
                                   str(tmp / f"{mesh_name}_{name}.json"))
        out.append((name, art, bb))
    return out


def _tree_of(flat):
    """The nested test tree (dict keys not in sorted order, a list) from
    its path -> leaf map."""
    return {"z": {"w": flat["z/w"], "a": flat["z/a"]},
            "b": [flat["b/0"], flat["b/1"], flat["b/2"]],
            "a": flat["a"]}


def _paths():
    return ["a", "b/0", "b/1", "b/2", "z/a", "z/w"]   # flatten order


def _inputs(world, data_size, seed):
    rng = np.random.default_rng(seed)
    out = {f"tree|{k}": rng.normal(size=(world,) + s).astype(np.float32)
           for k, s in LEAF_SHAPES.items()}
    out["x"] = rng.normal(size=(world, N_X)).astype(np.float32)
    out["x4"] = rng.normal(size=(world, data_size, 5)).astype(np.float32)
    return out


REF_SCRIPT = r"""
import json, os, sys
cfg = json.load(open(sys.argv[1]))
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro import compat
from repro.comms import CollectiveRequest, Communicator
from repro.core.collectives.hierarchical import (
    hierarchical_all_reduce, multilevel_all_gather, multilevel_reduce_scatter)
from repro.obs import FakeClock, TraceRecorder, installed

def tree_of(f):
    return {"z": {"w": f["z/w"], "a": f["z/a"]},
            "b": [f["b/0"], f["b/1"], f["b/2"]], "a": f["a"]}

SPAN_KEYS = ("kind", "op", "nbytes", "axis", "axis_size", "dtype",
             "algorithm", "segments", "bucket", "phase", "level", "step",
             "release", "stream")
outs, meta = {}, {}
for mesh_name, cases in cfg["cases"].items():
    shape, axes = cfg["meshes"][mesh_name]
    world = int(np.prod(shape))
    mesh = compat.mesh_from_devices(
        np.array(jax.devices()[:world]).reshape(shape), tuple(axes))
    data = dict(np.load(cfg["inputs"][mesh_name]))
    tree = tree_of({k.split("|", 1)[1]: jnp.asarray(v)
                    for k, v in data.items() if k.startswith("tree|")})
    lead = P(tuple(axes)) if len(axes) > 1 else P(axes[0])
    multi = len(axes) > 1
    haxes = tuple(reversed(axes))       # innermost first
    for name, artifact, bb in cases:
        rec = TraceRecorder(clock=FakeClock(step=1.0))
        comm = Communicator.create(mesh, artifact=artifact,
                                   bucket_bytes=bb, trace=rec)

        def body(t, x, x4, comm=comm):
            t = jax.tree.map(lambda a: a[0], t)
            x, x4 = x[0], x4[0]
            o = {"sync": comm.sync_gradients(t),
                 "sync_sum": comm.sync_gradients(t, mean=False),
                 "ar": comm.all_reduce(x, "data"),
                 "rs": comm.reduce_scatter(x, "data"),
                 "ag": comm.all_gather(x, "data"),
                 "bc": comm.broadcast(x, "data"),
                 "a2a": comm.all_to_all(x4, "data")}
            if multi:
                o["har"] = comm.all_reduce(x, haxes)
                o["hrs"] = comm.reduce_scatter(x, haxes)
                o["hag"] = comm.all_gather(o["hrs"], haxes)
                levels = [(a, mesh.shape[a]) for a in haxes]
                o["ml_rs_xla"] = multilevel_reduce_scatter(x, levels, None)
                with installed(rec):
                    o["ml_ag"] = multilevel_all_gather(x, levels, comm)
                    o["h2"] = hierarchical_all_reduce(
                        x, haxes[0], mesh.shape[haxes[0]], haxes[-1],
                        mesh.shape[haxes[-1]], comm)
            return jax.tree.map(lambda a: a[None], o)

        got = jax.jit(compat.shard_map(
            body, mesh=comm.mesh, in_specs=(lead, lead, lead),
            out_specs=lead,
            check_vma=False))(tree, jnp.asarray(data["x"]),
                              jnp.asarray(data["x4"]))
        for key, val in got.items():
            if key.startswith("sync"):
                for path, leaf in zip(
                        ["a", "b/0", "b/1", "b/2", "z/a", "z/w"],
                        jax.tree.leaves(val)):
                    outs[f"{mesh_name}|{name}|{key}|{path}"] = \
                        np.asarray(leaf)
            else:
                outs[f"{mesh_name}|{name}|{key}"] = np.asarray(val)
        local = jax.tree.map(lambda a: jax.ShapeDtypeStruct(
            a.shape[1:], a.dtype), tree)
        reqs = [CollectiveRequest("all_reduce", 4 * 1003, axis="data",
                                  axis_size=mesh.shape["data"])]
        if multi:
            reqs.append(CollectiveRequest("all_reduce", 4 * 1003, axis=haxes,
                                          axis_size=world))
        meta[f"{mesh_name}|{name}"] = {
            "describe": comm.describe(),
            "plan": comm.explain_gradients(local).render(),
            "explain": comm.explain(reqs).render(),
            "spans": [[getattr(s, k) for k in SPAN_KEYS] for s in rec.spans]}
np.savez(cfg["out"], **outs)
json.dump(meta, open(cfg["meta"], "w"))
print("cases", len(meta))
"""

SPAN_KEYS = ("kind", "op", "nbytes", "axis", "axis_size", "dtype",
             "algorithm", "segments", "bucket", "phase", "level", "step",
             "release", "stream")


def _port_cases(mesh_names, cases, meshes, inputs, out_dir):
    """Inside each rank of the group: every case of every mesh (the
    meshes built in the same order on every rank); outputs to
    ``port_r<rank>.npz``, and from rank 0 the spans, plans and which
    outputs an ``"xla"`` spec or psum top entered."""
    from repro_torch.core.collectives.hierarchical import (
        hierarchical_all_reduce, multilevel_all_gather,
        multilevel_reduce_scatter)
    from repro_torch.obs import FakeClock, TraceRecorder
    r = grp.rank()
    outs, meta = {}, {}
    for bad in (((3,), ("data",)), ((2, 2), ("data", "data")),
                ((4,), ("pod", "data"))):
        try:                    # refused before any group is created
            grp.RankMesh(*bad)
        except ValueError:
            continue
        raise AssertionError(f"RankMesh{bad} was not refused")
    for mesh_name in mesh_names:
        shape, axes = meshes[mesh_name]
        mesh = grp.RankMesh(shape, axes, device="cpu")
        data = dict(np.load(inputs[mesh_name]))
        multi = len(axes) > 1
        haxes = tuple(reversed(axes))
        for name, artifact, bb in cases[mesh_name]:
            rec = TraceRecorder(clock=FakeClock(step=1.0))
            comm = TComm.create(mesh, artifact=artifact, bucket_bytes=bb,
                                trace=rec)
            # a mapped artifact rebuilt the mesh: this rank holds the
            # slot the mapping gives it, and takes that slot's inputs
            slots = comm.mesh.ranks.reshape(-1).tolist()
            if comm.mapping is not None:
                assert comm.mesh is not mesh
                assert slots == list(comm.mapping.device_order)
            me = slots.index(r)
            coords = np.unravel_index(me, shape)
            assert [grp.rank(comm.mesh.axis(a)) for a in axes] == \
                [int(c) for c in coords]
            tree = _tree_of({k.split("|", 1)[1]: torch.from_numpy(v[me])
                             for k, v in data.items()
                             if k.startswith("tree|")})
            x, x4 = torch.from_numpy(data["x"][me]), \
                torch.from_numpy(data["x4"][me])
            o, xla_in = {}, {}
            psum_tops = not comm.hierarchical and len(comm._sync_axes) > 1

            def run(key, fn, psum=False):
                n0 = len(rec.spans)
                o[key] = fn()
                xla_in[key] = psum or any(s.algorithm == "xla"
                                          for s in rec.spans[n0:])

            run("sync", lambda: comm.sync_gradients(tree), psum_tops)
            run("sync_sum", lambda: comm.sync_gradients(tree, mean=False),
                psum_tops)
            run("ar", lambda: comm.all_reduce(x, "data"))
            run("rs", lambda: comm.reduce_scatter(x, "data"))
            run("ag", lambda: comm.all_gather(x, "data"))
            run("bc", lambda: comm.broadcast(x, "data"))
            run("a2a", lambda: comm.all_to_all(x4, "data"))
            if multi:
                run("har", lambda: comm.all_reduce(x, haxes))
                run("hrs", lambda: comm.reduce_scatter(x, haxes))
                run("hag", lambda: comm.all_gather(o["hrs"], haxes))
                levels = comm._levels_for(haxes)
                # direct calls, untraced, then traced as in the reference
                o["ml_rs_xla"] = multilevel_reduce_scatter(x, levels, None)
                xla_in["ml_rs_xla"] = True
                with comm._traced():
                    run("ml_ag", lambda: multilevel_all_gather(
                        x, levels, comm))
                    run("h2", lambda: hierarchical_all_reduce(
                        x, levels[0][0], levels[0][1], levels[-1][0],
                        levels[-1][1], comm))
            spans = list(rec.spans)
            comm.trace = None
            untraced = comm.sync_gradients(tree)
            same = all(torch.equal(a, b) for a, b in zip(
                pytree.leaves(untraced), pytree.leaves(o["sync"])))
            for key, val in o.items():
                if key.startswith("sync"):
                    for path, leaf in zip(_paths(), pytree.leaves(val)):
                        outs[f"{mesh_name}|{name}|{key}|{path}"] = \
                            leaf.numpy()
                else:
                    outs[f"{mesh_name}|{name}|{key}"] = val.numpy()
            local = pytree.tree_map(lambda t: pytree.LeafStruct(
                tuple(t.shape), t.dtype), tree)
            reqs = [TReq("all_reduce", 4 * N_X, axis="data",
                         axis_size=mesh.shape["data"])]
            if multi:
                reqs.append(TReq("all_reduce", 4 * N_X, axis=haxes,
                                 axis_size=mesh.size))
            plan = comm.explain_gradients(local)
            meta[f"{mesh_name}|{name}"] = {
                "describe": comm.describe(), "plan": plan.render(),
                "explain": comm.explain(reqs).render(),
                "spans": [[getattr(s, k) for k in SPAN_KEYS]
                          for s in spans],
                "times": [s.t_end - s.t_start for s in spans],
                "concrete": all(s.concrete for s in spans),
                "plan_dispatched": [
                    [e.request.op, e.request.nbytes, e.request.axis,
                     e.spec.algorithm, e.spec.segments, e.bucket, e.step]
                    for e in plan.entries if e.source != "psum"],
                "untraced_bits_equal": same, "xla_in": xla_in,
                "slots": slots}
    np.savez(os.path.join(out_dir, f"port_r{r}.npz"), **outs)
    if r == 0:
        with open(os.path.join(out_dir, "meta.json"), "w") as f:
            json.dump(meta, f)


def _run_both(tmp, mesh_names, world):
    """The reference subprocess and the port's group, side by side."""
    cfg = {"meshes": {m: MESHES[m] for m in mesh_names},
           "cases": {m: _resolve(tmp, m, CASES[m]) for m in mesh_names},
           "inputs": {},
           "out": str(tmp / "ref.npz"), "meta": str(tmp / "ref.json")}
    for i, m in enumerate(mesh_names):
        shape, axes = MESHES[m]
        path = str(tmp / f"inputs_{m}.npz")
        np.savez(path, **_inputs(world, shape[axes.index("data")], 40 + i))
        cfg["inputs"][m] = path
    (tmp / "cfg.json").write_text(json.dumps(cfg))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    ref_proc = subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT, str(tmp / "cfg.json")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT)
    try:
        port_dir = tmp / "port"
        port_dir.mkdir()
        grp.spawn(_port_cases, world,
                  (list(mesh_names), cfg["cases"], cfg["meshes"],
                   cfg["inputs"], str(port_dir)), timeout_s=300)
        out, err = ref_proc.communicate(timeout=600)
    finally:
        ref_proc.kill()
    assert ref_proc.returncode == 0, out + err[-4000:]
    port = [dict(np.load(port_dir / f"port_r{r}.npz")) for r in range(world)]
    return types.SimpleNamespace(
        ref=dict(np.load(cfg["out"])), ref_meta=json.load(open(cfg["meta"])),
        port=port, port_meta=json.load(open(port_dir / "meta.json")),
        inputs={m: dict(np.load(cfg["inputs"][m])) for m in mesh_names})


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return _run_both(tmp_path_factory.mktemp("communicator"),
                     ("2x2", "d4", "2x2m", "d4m"), 4)


def _case_keys(mesh_names):
    return [(m, name) for m in mesh_names for name, _, _ in CASES[m]]


def _check_case(run, mesh_name, name):
    meta_t = run.port_meta[f"{mesh_name}|{name}"]
    meta_j = run.ref_meta[f"{mesh_name}|{name}"]
    # plans, text and spans: the reference's
    for key in ("describe", "plan", "explain", "spans"):
        assert meta_t[key] == meta_j[key], key
    assert meta_t["spans"], "no span recorded"
    assert meta_t["concrete"] and set(meta_t["times"]) == {1.0}
    sync_spans = [s for s in meta_t["spans"]][:len(meta_t["plan_dispatched"])]
    assert [[s[1], s[2], s[3], s[6], s[7], s[8], s[11]]
            for s in sync_spans] == meta_t["plan_dispatched"]
    assert meta_t["untraced_bits_equal"]
    # outputs: bits, or rtol where an "xla" sum entered
    prefix = f"{mesh_name}|{name}|"
    keys = [k for k in run.ref if k.startswith(prefix)]
    assert keys and sorted(keys) == sorted(
        k for k in run.port[0] if k.startswith(prefix))
    for key in keys:
        want = run.ref[key]
        # slot order: slot i is the rank the mesh placed there
        got = np.stack([run.port[r][key] for r in meta_t["slots"]])
        assert got.shape == want.shape, (key, got.shape, want.shape)
        op = key.split("|")[2]
        if meta_t["xla_in"][op]:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL,
                                       err_msg=key)
        else:
            np.testing.assert_array_equal(got, want, err_msg=key)
    # and the sync is the mean over the ranks
    data = run.inputs[mesh_name]
    for path in _paths():
        mean = data[f"tree|{path}"].astype(np.float64).mean(0)
        got = run.port[0][f"{prefix}sync|{path}"]
        np.testing.assert_allclose(got, mean, rtol=0, atol=2e-6)


@pytest.mark.parametrize("mesh_name,name",
                         _case_keys(("2x2", "d4", "2x2m", "d4m")))
def test_communicator_matches_reference_on_four_ranks(four_ranks, mesh_name,
                                                      name):
    _check_case(four_ranks, mesh_name, name)


def test_non_xla_cases_are_bit_for_bit(four_ranks):
    """Every all-reduce phase of the hierarchical artifact is a
    hand-written or synthesized schedule: its syncs and all-reduce
    compositions are held bit for bit, not at rtol. (Its cross_pod table
    has all-reduce rows only, so a reduce-scatter or all-gather there is
    ``"xla"``.)"""
    xla_in = four_ranks.port_meta["2x2|hier"]["xla_in"]
    assert not any(xla_in[k] for k in ("sync", "sync_sum", "har", "h2"))
    assert xla_in["hrs"]
    assert four_ranks.port_meta["2x2|flat"]["xla_in"]["sync"]   # psum tops


def test_remapped_meshes_place_each_rank_at_its_slot(four_ranks):
    """A mapped artifact rebuilds the 4-rank mesh in the mapping's order
    (the rank at slot i is ``device_order[i]``; each rank's indices
    along the axes are its slot's, checked in every rank), describe()
    and the plan name the mapping (the results are held to the
    reference's slot for slot by the parametrized cases)."""
    for key, order in (("2x2m|hier", ORDER_2X2), ("2x2m|flat", ORDER_2X2),
                       ("d4m|flat_b", ORDER_D4)):
        meta = four_ranks.port_meta[key]
        assert meta["slots"] == list(order)
        assert "mapping=tuned-order" in meta["describe"]
        assert meta["plan"].splitlines()[0].strip().startswith(
            "mesh mapping:")
    for key in ("2x2|hier", "d4|flat"):
        assert four_ranks.port_meta[key]["slots"] == [0, 1, 2, 3]


@pytest.mark.slow
def test_communicator_matches_reference_on_2x2x2():
    import tempfile
    import pathlib
    with tempfile.TemporaryDirectory() as d:
        run = _run_both(pathlib.Path(d), ("2x2x2", "2x2x2m"), 8)
        for mesh_name, name in _case_keys(("2x2x2", "2x2x2m")):
            _check_case(run, mesh_name, name)
        assert run.port_meta["2x2x2m|hier3_sched"]["slots"] == \
            list(ORDER_2X2X2_CAND)
        assert run.port_meta["2x2x2m|hier3"]["slots"] == list(ORDER_2X2X2)
        assert not run.port_meta["2x2x2|hier3_sched"]["xla_in"]["sync"]


def test_measure_collectives_syncs_a_model_tree_from_an_artifact():
    """The entry point with the reference launcher's flags, on the host:
    4 ranks on ``--topology 2x2``, the hierarchical artifact, the
    reduced smollm-135m's whole tree in the port's layout, a forced
    bucket budget. Every variant is within the launcher's 2e-4 of the
    float64 mean, its spans equal its plan, and the bucketed buckets
    equal their sequential compositions bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.launch import measure_collectives as mc
    from repro_torch.models.registry import build_model
    res = mc.main(["--device", "cpu", "--topology", "2x2", "--tuning-table",
                   HIER, "--grad-arch", "smollm-135m", "--reduced",
                   "--bucket-mb", "0.25"])
    gs = res["grad_sync"]
    params = build_model(get_config("smollm-135m").reduced(),
                         device="cpu").init(torch.Generator().manual_seed(0))
    leaves = pytree.leaves(params)
    assert (res["ranks"], gs["mesh"], gs["leaves"], gs["elems"]) == \
        (4, {"pod": 2, "data": 2}, len(leaves),
         sum(t.numel() for t in leaves))
    assert list(gs["variants"]) == ["per_leaf", "bucketed", "xla"]
    for v in gs["variants"].values():
        assert v["max_abs_err"] <= mc.GRAD_TOL
        assert v["plan_matches_spans"] and v["trace_bits_equal"]
        assert v["runs"] == 1 + mc.GRAD_TRIALS == len(v["seconds"]) + 1
        assert v["launches"]["segment_combine"] == 0      # host tensors
    b = gs["variants"]["bucketed"]
    assert b["bucket_bytes"] == 1 << 18 and b["buckets"] > 1
    assert b["buckets_bit_equal"] == b["buckets"]
    assert gs["variants"]["per_leaf"]["plan_combines"] > 0
    assert "probed" not in res and "best" not in res    # no tuning sweep


def test_measure_collectives_grad_layers_cuts_the_tree_in_depth():
    """``--grad-layers 1``: the reduced smollm-135m's tree with one of
    its layers (the widths kept), synced within the launcher's 2e-4 of
    the float64 mean on 2 ranks."""
    from repro_torch.configs import get_config
    from repro_torch.launch import measure_collectives as mc
    from repro_torch.models.registry import build_model
    res = mc.main(["--device", "cpu", "--ranks", "2", "--topology", "2",
                   "--tuning-table", HIER, "--grad-arch", "smollm-135m",
                   "--reduced", "--grad-layers", "1"])
    gs = res["grad_sync"]
    cfg = get_config("smollm-135m").reduced().replace(num_layers=1)
    leaves = pytree.leaves(build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0)))
    assert (gs["leaves"], gs["elems"]) == \
        (len(leaves), sum(t.numel() for t in leaves))
    assert gs["elems"] < sum(t.numel() for t in pytree.leaves(
        build_model(get_config("smollm-135m").reduced(), device="cpu").init(
            torch.Generator().manual_seed(0))))
    for v in gs["variants"].values():
        assert v["max_abs_err"] <= mc.GRAD_TOL
