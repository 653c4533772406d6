"""The port's telemetry (``obs/{metrics,trace}.py``), the dispatch trace
branch and the probe's injectable timing, against the JAX package, in
one process.

* `MetricsRegistry` and ``render_metrics`` give the reference's counts
  and text; `FakeClock` its readings.
* `TraceRecorder` records the reference's spans with exact times on a
  `FakeClock` (each span one clock step): every call is concrete in the
  port. ``installed`` / ``active`` / ``suspended`` nest as the
  reference's; ``assign_stream_tags`` lifts the same tags.
* ``apply_collective`` with a recorder installed gives the same bits as
  without (a stand-in collective, no process group).
* The probe on a `FakeClock` with a fake exchange: ``_time_pair``,
  ``probe_live_profile`` and ``probe_mesh_topology`` fit the
  reference's profiles exactly; ``level_probe_pairs`` picks the
  reference's pairs on the same coordinate grids.
"""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.comms import probe as jprobe  # noqa: E402
from repro.comms.report import render_metrics as jrender  # noqa: E402
from repro.obs import trace as jtrace  # noqa: E402
from repro.obs.metrics import MetricsRegistry as JReg  # noqa: E402
from repro_torch.comms import probe as tprobe  # noqa: E402
from repro_torch.comms.report import render_metrics as trender  # noqa: E402
from repro_torch.core.collectives import algorithms as talg  # noqa: E402
from repro_torch.core.collectives import dispatch as tdispatch  # noqa: E402
from repro_torch.core.collectives import group as grp  # noqa: E402
from repro_torch.obs import trace as ttrace  # noqa: E402
from repro_torch.obs.metrics import MetricsRegistry as TReg  # noqa: E402


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------
def test_metrics_registry_equals_reference():
    regs = (JReg(), TReg())
    for reg in regs:
        reg.inc("collective_bytes", 4096, label="data")
        reg.inc("collective_bytes", 12.5, label="pod")
        reg.inc("collectives", label="ring")
        reg.inc("collectives", label="ring")
        reg.inc("releases")
    j, t = regs
    assert t.to_json() == j.to_json()
    assert list(t.items()) == list(j.items())
    assert (t.total("collective_bytes"), t.get("collectives", label="ring"),
            len(t), bool(t), bool(TReg())) == \
        (j.total("collective_bytes"), j.get("collectives", label="ring"),
         len(j), bool(j), bool(JReg()))
    assert trender(t) == jrender(j)
    assert t.merge(t).to_json() == j.merge(j).to_json()


def test_fake_clock_reads_as_the_reference():
    j, t = jtrace.FakeClock(step=0.5, start=2.0), \
        ttrace.FakeClock(step=0.5, start=2.0)
    reads = []
    for clock in (j, t):
        r = [clock(), clock()]
        clock.advance(3.0)
        r.append(clock())
        reads.append(r)
    assert reads[0] == reads[1] == [2.0, 2.5, 6.0]


# ---------------------------------------------------------------------------
# the recorder and the dispatch hook
# ---------------------------------------------------------------------------
def _fake_all_reduce(x, axis, p, segments=1, op="add"):
    return x * p


def _record(trace_mod, x, axis, rec):
    spec = SimpleNamespace(algorithm="ring", segments=2)
    with trace_mod.installed(rec):
        assert trace_mod.active() is rec
        with rec.tags(bucket=1, phase=0, level=2, step=3):
            out = rec.run_collective(_fake_all_reduce, "all_reduce", x,
                                     axis, 4, spec, {})
        with trace_mod.suspended():
            assert trace_mod.active() is None
        with trace_mod.installed(None):        # a no-op keeps the recorder
            assert trace_mod.active() is rec
    assert trace_mod.active() is None
    return out


def test_recorder_spans_equal_reference_with_exact_times():
    import jax.numpy as jnp
    x = np.arange(10, dtype=np.float32)
    jrec = jtrace.TraceRecorder(clock=jtrace.FakeClock(step=1.0))
    trec = ttrace.TraceRecorder(clock=ttrace.FakeClock(step=1.0))
    jout = _record(jtrace, jnp.asarray(x), "data", jrec)
    tout = _record(ttrace, torch.from_numpy(x),
                   grp.Axis("data", None, 4), trec)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    [js], [ts] = jrec.spans, trec.spans
    # every field but the timing: the reference's eager call is concrete
    # too (jnp operands), so its times read the same clock steps
    assert ts.to_json() == js.to_json()
    assert (ts.axis, ts.dtype, ts.nbytes, ts.concrete, ts.seconds) == \
        ("data", "float32", 40, True, 1.0)
    assert ts.key() == js.key() == (1, 0)
    assert trec.counters.to_json() == jrec.counters.to_json()
    assert trec.collective_spans() == trec.spans
    trec.clear()
    assert trec.spans == [] and trec._mark is None


def test_recorder_context_and_release_notes_equal_reference():
    recs = []
    for mod in (jtrace, ttrace):
        rec = mod.TraceRecorder(clock=mod.FakeClock(step=1.0))
        with rec:
            assert mod.active() is rec
            rec.note_release(("layers", 3), 0, 2)
            rec._mark = rec.clock() - 5.0
            rec.note_release(("layers", 2), 1, 2)
        assert mod.active() is None
        recs.append(rec)
    j, t = recs
    assert [s.to_json() for s in t.spans] == [s.to_json() for s in j.spans]
    assert t.meta == j.meta == {"n_streams": 2}


def test_assign_stream_tags_equals_reference():
    def spans(mod):
        out = []
        for release in (0, 1, 2):
            for bucket in (0, 1):
                for phase, level in ((0, 0), (1, 1), (2, 0)):
                    out.append(mod.Span(op="all_reduce", bucket=bucket,
                                        phase=phase, level=level,
                                        step=bucket + phase,
                                        release=release))
        out.append(mod.Span(op="all_reduce", nbytes=8))     # residual
        return out
    for n_streams in (1, 2, 3):
        j = jtrace.assign_stream_tags(spans(jtrace), n_streams)
        t = ttrace.assign_stream_tags(spans(ttrace), n_streams)
        assert [s.to_json() for s in t] == [s.to_json() for s in j]


def test_dispatch_trace_branch_gives_the_untraced_bits(monkeypatch):
    """``apply_collective`` with a recorder installed returns the bits of
    the plain dispatch and records one span."""
    calls = []

    def fake_get(op, algorithm):
        calls.append((op, algorithm))
        return lambda x, axis, p, segments=1, op="add": x * 3 + segments

    monkeypatch.setattr(talg, "get", fake_get)
    x = torch.randn(33)
    spec = tdispatch.CollectiveSpec("ring", 2)
    plain = tdispatch.apply_collective("all_reduce", x, None, 4, spec)
    rec = ttrace.TraceRecorder()
    with ttrace.installed(rec):
        traced = tdispatch.apply_collective("all_reduce", x, None, 4, spec)
    assert torch.equal(plain, traced) and len(rec.spans) == 1
    assert rec.spans[0].t_end >= rec.spans[0].t_start
    assert calls == [("all_reduce", "ring")] * 2


# ---------------------------------------------------------------------------
# the probe's injectable timing
# ---------------------------------------------------------------------------
def make_pingpong(clock, byte_time=1e-9, tensor=False):
    """A fake exchange whose wall time (read on ``clock``) grows with the
    message size (the reference test's, for either package)."""
    def pingpong(m, devices=None, ranks=None):
        def fn(x):
            clock.advance(m * byte_time)
            return x
        return fn, (torch.zeros(1) if tensor else np.float32(0.0))
    return pingpong


def test_time_pair_and_live_profile_equal_reference():
    m = 1 << 12
    cj, ct = jtrace.FakeClock(step=1e-6), ttrace.FakeClock(step=1e-6)
    tj = jprobe._time_pair("devA", "devB", m, trials=3, clock=cj,
                           pingpong=make_pingpong(cj))
    tt = tprobe._time_pair(0, 1, m, trials=3, clock=ct,
                           pingpong=make_pingpong(ct, tensor=True))
    assert tt == tj == pytest.approx((1e-6 + m * 1e-9) / 2)
    ms = [1 << 10, 1 << 14, 1 << 18, 1 << 20]
    cj, ct = jtrace.FakeClock(step=1e-6), ttrace.FakeClock(step=1e-6)
    pj = jprobe.probe_live_profile(ms, devices=("a", "b"), clock=cj,
                                   pingpong=make_pingpong(cj))
    pt = tprobe.probe_live_profile(ms, ranks=(0, 1), clock=ct,
                                   pingpong=make_pingpong(ct, tensor=True))
    assert vars(pt) == vars(pj)
    assert pt.byte_time == pytest.approx(0.5e-9, rel=0.05)
    # no process group: nothing to probe
    assert tprobe.probe_live_profile(ms) is None


def _meshes():
    return [(("dcn", "pod", "data"), (2, 2, 2)),
            (("pod", "data", "model"), (2, 4, 2)),
            (("pod", "dcn", "data"), (2, 2, 2)),
            (("data",), (4,)), (("model",), (2,)),
            (("pod", "data"), (1, 4))]


@pytest.mark.parametrize("axes,shape", _meshes())
def test_level_probe_pairs_and_topology_equal_reference(axes, shape):
    devs = np.arange(int(np.prod(shape))).reshape(shape)
    jmesh = SimpleNamespace(axis_names=axes, shape=dict(zip(axes, shape)),
                            devices=devs)
    tmesh = SimpleNamespace(axis_names=axes, shape=dict(zip(axes, shape)),
                            ranks=devs, device="cpu")
    jp, tp = jprobe.level_probe_pairs(jmesh), tprobe.level_probe_pairs(tmesh)
    assert [(n, a, s, (int(x), int(y))) for n, a, s, (x, y) in jp] == tp

    def timer(a, b, m):
        return 1e-6 * (1 + abs(int(b) - int(a))) + 1e-10 * m * (int(b) + 1)
    jt = jprobe.probe_mesh_topology(jmesh, timer=timer)
    tt = tprobe.probe_mesh_topology(tmesh, timer=timer)
    assert (tt is None) == (jt is None)
    if tt is not None:
        assert tt.to_json() == jt.to_json()
        text = tprobe.describe_topology(tt)
        assert text.count("host-staged") == len(tt.levels)
    assert tprobe.level_probe_pairs(None) == []


def test_probe_mesh_topology_with_injected_clock_equals_reference():
    axes, shape = ("dcn", "pod", "data"), (2, 2, 2)
    devs = np.arange(8).reshape(shape)
    cj, ct = jtrace.FakeClock(step=1e-6), ttrace.FakeClock(step=1e-6)
    ms = [1 << 10, 1 << 16, 1 << 20]
    jt = jprobe.probe_mesh_topology(
        SimpleNamespace(axis_names=axes, shape=dict(zip(axes, shape)),
                        devices=devs),
        ms=ms, clock=cj, pingpong=make_pingpong(cj))
    tt = tprobe.probe_mesh_topology(
        SimpleNamespace(axis_names=axes, shape=dict(zip(axes, shape)),
                        ranks=devs, device="cpu"),
        ms=ms, clock=ct, pingpong=make_pingpong(ct, tensor=True))
    assert tt.to_json() == jt.to_json()


def test_communicator_create_probe_synthesizes_topology(monkeypatch):
    """``Communicator.create(mesh, probe=True)`` runs the per-level probe
    (``_time_pair`` replaced wholesale, positional signature, as in the
    reference's test), keeps the synthesized Topology as its level map
    and matches against the innermost profile."""
    from repro_torch.comms import Communicator
    from test_torch_gradsync import FakeRankMesh
    mesh = FakeRankMesh(dcn=2, pod=2, data=2)
    fabric = {1: (0.5e-6, 1e-10), 2: (2e-6, 1e-9), 4: (10e-6, 2e-8)}

    def fake(a, b, m, trials=3):
        launch, byte_time = fabric[int(b) - int(a)]
        return launch + byte_time * m
    monkeypatch.setattr(tprobe, "_time_pair", fake)
    comm = Communicator.create(mesh, probe=True)
    topo = comm.probed_topology
    assert topo.names() == ("intra_host", "intra_pod", "cross_pod")
    assert [lv.axis for lv in topo.levels] == ["data", "pod", "dcn"]
    assert comm.probed is topo.inner.profile and comm.topology is topo
    assert comm.probed.byte_time == pytest.approx(1e-10, rel=0.05)
