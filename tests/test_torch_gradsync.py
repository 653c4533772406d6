"""Bucketed and pipelined gradient sync of the port against the JAX
package, in one process.

* The schedule builders (`pack_buckets`, `coalesce_bytes`,
  `build_pipeline_schedule`, `build_stream_schedule`) return the
  reference's schedules, under hypothesis as in
  ``tests/test_gradsync_properties.py``.
* `repro_torch.pytree` flattens as ``jax.tree`` does (dicts in sorted key
  order), and `BucketLayout` gives the reference's buckets and
  round-trips bit-exactly, zero-size leaves and unsorted dict keys
  included.
* The Communicator's per-leaf and bucketed sync, over a fake mesh whose
  collectives are shape-correct stand-ins in both packages (the
  reference's ``fake_collectives`` of ``tests/conftest.py`` and its
  torch twin here): equal outputs bit for bit (every stand-in's sum has
  two terms, so its order cannot differ), equal recorded spans, and
  ``explain_gradients`` equal to the spans, entry for entry.

The real multi-rank executions are in ``tests/test_torch_communicator.py``.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.comms import BucketLayout as JLayout  # noqa: E402
from repro.comms import Communicator as JComm  # noqa: E402
from repro.core.collectives import schedule as jsched  # noqa: E402
from repro.obs import FakeClock as JClock  # noqa: E402
from repro.obs import TraceRecorder as JRec  # noqa: E402
from repro_torch import pytree  # noqa: E402
from repro_torch.comms import BucketLayout as TLayout  # noqa: E402
from repro_torch.comms import Communicator as TComm  # noqa: E402
from repro_torch.core.collectives import algorithms as talg  # noqa: E402
from repro_torch.core.collectives import group as grp  # noqa: E402
from repro_torch.core.collectives import schedule as tsched  # noqa: E402
from repro_torch.obs import FakeClock as TClock  # noqa: E402
from repro_torch.obs import TraceRecorder as TRec  # noqa: E402

from test_gradsync_pipeline import fake_mesh as jfake_mesh  # noqa: E402
from test_gradsync_pipeline import hier3  # noqa: E402

ARTIFACTS = "examples/artifacts"


@pytest.fixture(autouse=True)
def restore_synth_registries():
    """Building a Communicator from an artifact adopts its synthesized
    programs into the package's process-wide registry; put both
    packages' registries back afterwards, so the tuners of later tests in
    this process see the search space they would see alone."""
    from repro.core.collectives import synth as jsynth
    from repro_torch.core.collectives import synth as tsynth
    saved = [(m, {k: dict(v) for k, v in m._REGISTRY.items()},
              dict(m._FRONTS)) for m in (jsynth, tsynth)]
    yield
    for m, reg, fronts in saved:
        m._REGISTRY.clear()
        m._REGISTRY.update(reg)
        m._FRONTS.clear()
        m._FRONTS.update(fronts)


# ---------------------------------------------------------------------------
# schedule builders
# ---------------------------------------------------------------------------
def _tasks(sched):
    return [dataclasses.astuple(t) for t in sched.tasks]


leaves_st = st.lists(st.tuples(st.integers(0, 600),
                               st.sampled_from(["float32", "bfloat16",
                                                "int32"])),
                     min_size=0, max_size=12)
sizes_st = st.lists(st.sampled_from([2, 3, 4, 8]), min_size=1, max_size=3)


@given(leaves_st, st.integers(-4, 2048))
@settings(max_examples=60, deadline=None)
def test_pack_buckets_and_coalesce_bytes_equal_reference(leaves, bb):
    assert tsched.pack_buckets(leaves, bb) == jsched.pack_buckets(leaves, bb)
    nbytes = [n for n, _ in leaves]
    dts = [d for _, d in leaves]
    assert tsched.coalesce_bytes(nbytes, bb) == \
        jsched.coalesce_bytes(nbytes, bb)
    assert tsched.coalesce_bytes(nbytes, bb, dtypes=dts) == \
        jsched.coalesce_bytes(nbytes, bb, dtypes=dts)


@given(st.lists(st.integers(0, 5000), min_size=0, max_size=8), sizes_st)
@settings(max_examples=60, deadline=None)
def test_pipeline_schedule_equals_reference(bucket_elems, sizes):
    t = tsched.build_pipeline_schedule(bucket_elems, sizes)
    j = jsched.build_pipeline_schedule(bucket_elems, sizes)
    assert _tasks(t) == _tasks(j)
    assert (t.sizes, t.bucket_elems, t.n_phases, t.n_steps) == \
        (j.sizes, j.bucket_elems, j.n_phases, j.n_steps)
    assert t.render() == j.render()


@given(st.lists(st.integers(1, 5000), min_size=1, max_size=8), sizes_st,
       st.integers(1, 3), st.booleans())
@settings(max_examples=60, deadline=None)
def test_stream_schedule_equals_reference(bucket_elems, sizes, n_streams,
                                          late):
    releases = None
    if late:
        releases = [2 * k for k in range(len(bucket_elems))]
    t = tsched.build_stream_schedule(bucket_elems, sizes, releases=releases,
                                     n_streams=n_streams)
    j = jsched.build_stream_schedule(bucket_elems, sizes, releases=releases,
                                     n_streams=n_streams)
    assert _tasks(t) == _tasks(j)
    assert (t.n_streams, t.releases) == (j.n_streams, j.releases)
    assert t.render() == j.render()


# ---------------------------------------------------------------------------
# trees and bucket layouts
# ---------------------------------------------------------------------------
def np_tree(seed, shapes=((3, 5), (0, 4), (), (7,), (2, 2, 2), (1,))):
    """Nested dicts (keys NOT in sorted order), a list and a tuple, with a
    zero-size leaf and a scalar."""
    rng = np.random.default_rng(seed)
    leaf = [rng.normal(size=s).astype(np.float32) for s in shapes]
    return {"z": {"w": leaf[0], "empty": leaf[1]},
            "b": [leaf[2], (leaf[3], leaf[4])],
            "a": leaf[5]}


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def to_torch(tree):
    return pytree.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _np_leaves_torch(tree):
    return [t.numpy() for t in pytree.leaves(tree)]


def test_pytree_flattens_as_jax_tree():
    tree = np_tree(0)
    jl, jdef = jax.tree.flatten(tree)
    tl, tdef = pytree.flatten(tree)
    assert len(tl) == len(jl) == tdef.n_leaves
    assert all(a is b for a, b in zip(tl, jl))        # the same order
    back = tdef.unflatten(tl)
    assert jax.tree.structure(back) == jdef
    assert list(back) == ["a", "b", "z"]               # sorted, as jax
    with pytest.raises(ValueError, match="too many"):
        tdef.unflatten(tl + [tl[0]])
    assert pytree.leaves({"x": None, "y": [1, None]}) == [1]


@pytest.mark.parametrize("bb", [0, 1, 16, 40, 100, 1 << 20])
def test_bucket_layout_equals_reference_and_roundtrips(bb):
    tree = np_tree(1)
    jl, tl = JLayout.plan(to_jax(tree), bb), TLayout.plan(to_torch(tree), bb)
    assert [(b.dtype, [dataclasses.astuple(s) for s in b.slots], b.elems,
             b.nbytes) for b in tl.buckets] == \
        [(b.dtype, [dataclasses.astuple(s) for s in b.slots], b.elems,
          b.nbytes) for b in jl.buckets]
    tt = to_torch(tree)
    flats = tl.flatten(tt)
    for tf, jf in zip(flats, jl.flatten(to_jax(tree))):
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    back = tl.unflatten(flats)
    for a, b in zip(pytree.leaves(back), pytree.leaves(tt)):
        assert a.shape == b.shape and torch.equal(a, b)


def test_bucket_layout_keeps_dtype_streams_apart():
    tree = {"c": torch.zeros(8), "b": torch.zeros(4, dtype=torch.bfloat16),
            "a": torch.zeros(8)}
    jtree = {"c": jnp.zeros(8), "b": jnp.zeros(4, jnp.bfloat16),
             "a": jnp.zeros(8)}
    t, j = TLayout.plan(tree, 1 << 20), JLayout.plan(jtree, 1 << 20)
    assert [(b.dtype, b.nbytes) for b in t.buckets] == \
        [(b.dtype, b.nbytes) for b in j.buckets] == \
        [("float32", 64), ("bfloat16", 8)]


def test_layer_slice_struct_and_release_split_equal_reference():
    from repro.comms import bucketing as jb
    from repro_torch.comms import bucketing as tb
    tree = {"layers": {"w": np.zeros((3, 4, 2), np.float32),
                       "b": np.zeros((3, 2), np.float32)},
            "embed": np.zeros((5, 2), np.float32)}
    tl, trest = tb.split_release_tree(to_torch(tree))
    jl, jrest = jb.split_release_tree(to_jax(tree))
    assert list(trest) == list(jrest) == ["embed"]
    assert [(s.shape, pytree.dtype_name(s.dtype)) for s in
            pytree.leaves(tb.layer_slice_struct(tl))] == \
        [(s.shape, np.dtype(s.dtype).name) for s in
         jax.tree.leaves(jb.layer_slice_struct(jl))]
    assert tb.split_release_tree([1]) == (None, [1])


# ---------------------------------------------------------------------------
# the Communicator's sync over fake collectives, both packages
# ---------------------------------------------------------------------------
class FakeRankMesh:
    """The port's mesh stand-in: axis names, sizes and named axes with
    no process group behind them (the fake collectives never use it)."""

    def __init__(self, **sizes):
        self.axis_names = tuple(sizes)
        self.shape = dict(sizes)
        self.ranks = np.arange(math.prod(sizes.values())).reshape(
            tuple(sizes.values()))

    def axis(self, name):
        return grp.Axis(name, None, self.shape[name])


@pytest.fixture
def tfake_collectives(monkeypatch):
    """The torch twin of the reference's ``fake_collectives``."""
    def fake_get(op, algorithm):
        if op == "reduce_scatter":
            return lambda x, axis, p, segments=1, op="add": \
                x.reshape(p, -1).sum(0)
        if op in ("all_reduce", "reduce"):
            return lambda x, axis, p, segments=1, op="add": x * p
        if op == "all_gather":
            return lambda x, axis, p, segments=1: x.repeat(p)
        raise KeyError(op)

    monkeypatch.setattr(talg, "get", fake_get)


def _span_key(s):
    return (s.kind, s.op, s.nbytes, s.axis, s.axis_size, s.dtype,
            s.algorithm, s.segments, s.bucket, s.phase, s.level, s.step,
            s.release, s.stream)


def _artifact(name, tmp_path):
    """The artifact's path, for both packages (``hier3``: the reference
    test's hand-made 3-level decision, saved)."""
    if name == "hier3":
        path = str(tmp_path / "hier3.json")
        hier3().save(path)
        return path
    return f"{ARTIFACTS}/{name}"


CASES = [("hier3", dict(dcn=2, pod=2, data=2), 0),
         ("hier3", dict(dcn=2, pod=2, data=2), 96),
         ("hierarchical_decision_3level.json", dict(dcn=2, pod=2, data=2),
          None),
         ("hierarchical_decision_3level.json", dict(dcn=2, pod=2, data=2),
          0),
         ("hierarchical_decision.json", dict(pod=2, data=2), 0),
         ("hierarchical_decision.json", dict(pod=2, data=2), 64)]


@pytest.mark.parametrize("artifact,sizes,bb", CASES)
def test_sync_over_fake_collectives_equals_reference(
        artifact, sizes, bb, fake_collectives, tfake_collectives, tmp_path):
    """Per-leaf (bucket budget 0) and bucketed (the artifact's schedule
    or a forced budget): the same outputs, bit for bit; the same spans
    (``FakeClock``: each span exactly one clock step); each package's
    plan equal to its spans; the same plan text."""
    ja = ta = _artifact(artifact, tmp_path)
    jmesh = jfake_mesh(**{k: v for k, v in sizes.items()})
    jrec, trec = JRec(clock=JClock(step=1.0)), TRec(clock=TClock(step=1.0))
    jc = JComm.create(jmesh, artifact=ja, bucket_bytes=bb, trace=jrec)
    tc = TComm.create(FakeRankMesh(**sizes), artifact=ta, bucket_bytes=bb,
                      trace=trec)
    assert tc.describe() == jc.describe()
    tree = np_tree(7)
    jout = jc.sync_gradients(to_jax(tree))
    tout = tc.sync_gradients(to_torch(tree))
    for a, b in zip(_np_leaves_torch(tout), jax.tree.leaves(jout)):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert [_span_key(s) for s in trec.spans] == \
        [_span_key(s) for s in jrec.spans]
    assert trec.spans and all(s.concrete and s.t_end - s.t_start == 1.0
                              for s in trec.spans)
    jplan = jc.explain_gradients(to_jax(tree))
    tplan = tc.explain_gradients(to_torch(tree))
    assert tplan.render() == jplan.render()
    assert tplan.to_json() == jplan.to_json()
    assert [(e.request.op, e.request.nbytes, e.request.axis,
             e.spec.algorithm, e.spec.segments, e.bucket, e.step)
            for e in tplan.entries] == \
        [(s.op, s.nbytes, s.axis, s.algorithm, s.segments, s.bucket, s.step)
         for s in trec.spans]
    measured = tc.explain_gradients(to_torch(tree), measured=trec)
    assert measured.render() == jc.explain_gradients(
        to_jax(tree), measured=jrec).render().replace(
            "measured=0.0us", "measured=1000000.0us")
    assert tc.metrics.to_json().keys() == jc.metrics.to_json().keys()
