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
* Residuals, exports and replay (``tests/test_observability.py``
  mirrored): ``modeled_gradient_report`` over the same levels, buckets
  and compute gives the reference's document, drift (zero for a matching
  fabric, scale-invariant, tripping ``retune_if_drifted`` for a slowed
  tier) and text; ``chrome_trace`` and ``summary`` of the same spans
  give the reference's documents. ``measure_gradient_schedule`` with an
  injected runner walks the reference's schedule over the port's
  per-layer tree (the reference's over its stacked one): the same
  spans, tags and order, one a plan entry; ``gradient_residual_report``
  of those spans on the live Communicator equals the reference's.
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


# ---------------------------------------------------------------------------
# residuals, exports and replay
# ---------------------------------------------------------------------------
def _levels(costs_mod):
    hockney = costs_mod.Hockney
    return [(8, hockney(1e-6, 1e-9)), (4, hockney(5e-6, 1e-8)),
            (2, hockney(2e-5, 4e-8))]


BUCKETS = [1 << 20, 1 << 18, 1 << 20, 1 << 16, 1 << 19]
COMPUTE = [3e-4, 2e-4, 4e-4, 1e-4, 3e-4]


def _packages():
    """(costs, hierarchy, residuals, export) of the reference, then the
    port's."""
    from repro.core.analytical import costs as jc
    from repro.core.analytical import hierarchy as jh
    from repro.obs import export as je
    from repro.obs import residuals as jr
    from repro_torch.core.analytical import costs as tc
    from repro_torch.core.analytical import hierarchy as th
    from repro_torch.obs import export as te
    from repro_torch.obs import residuals as tr
    return (jc, jh, jr, je), (tc, th, tr, te)


def _timed_spans(pkg, level_scale=None):
    costs, hier, resid, _ = pkg
    levels = _levels(costs)
    pc = hier.modeled_phase_cost(levels)
    ready, acc = [], 0.0
    for c in COMPUTE:
        acc += c
        ready.append(acc)
    _, timed = hier.backward_overlapped_schedule(
        [p for p, _ in levels], BUCKETS, pc,
        releases=list(range(len(BUCKETS))), ready_times=ready, n_streams=2)
    return resid.spans_from_timed(timed, level_scale=level_scale)


def _report(pkg, **kw):
    costs, _, resid, _ = pkg
    return resid.modeled_gradient_report(_levels(costs), BUCKETS, COMPUTE,
                                         **kw)


@pytest.mark.parametrize("scale", [None, {0: 2.0, 1: 2.0, 2: 2.0},
                                   {2: 3.0}])
def test_residual_report_drift_render_and_json_equal_reference(scale):
    from repro.core.tuning.session import TuningSession as JSession
    from repro_torch.core.tuning.session import TuningSession as TSession
    j, t = _packages()
    jrep = _report(j, spans=_timed_spans(j, scale),
                   level_names=["host", "pod", "dcn"])
    trep = _report(t, spans=_timed_spans(t, scale),
                   level_names=["host", "pod", "dcn"])
    assert trep.to_json() == jrep.to_json()
    assert trep.render() == jrep.render()
    assert trep.drift() == jrep.drift()
    assert trep.modeled_makespan == t[1].backward_overlapped_time(
        _levels(t[0]), BUCKETS, COMPUTE)
    assert trep.measured_tasks() == len(trep.tasks) > 0
    if scale is None or len(scale) == 3:     # matching or uniformly off
        assert trep.drift() == pytest.approx(0.0, abs=1e-9)
    else:                                    # one tier slowed: re-tune
        assert trep.drift() > 0.2
    for session_cls in (JSession, TSession):
        assert session_cls().retune_if_drifted(0.2, drift=trep.drift()) \
            == (trep.drift() > 0.2)
    # the modeled side alone: no span joined
    assert _report(t).to_json() == _report(j).to_json()


def test_chrome_trace_and_summary_equal_reference(tmp_path):
    j, t = _packages()
    names = ["host", "pod", "dcn"]
    jspans, tspans = _timed_spans(j), _timed_spans(t)
    # a compute span and an untagged (residual) one, as a real trace has
    for mod, spans in ((jtrace, jspans), (ttrace, tspans)):
        spans.append(mod.Span(kind="compute", op="layers", release=1,
                              concrete=True, t_start=0.5, t_end=0.75))
        spans.append(mod.Span(op="all_reduce", nbytes=64, level=0, phase=0,
                              concrete=True, t_start=1.0, t_end=1.5))
    jdoc = j[3].chrome_trace(jspans, level_names=names)
    tdoc = t[3].chrome_trace(tspans, level_names=names)
    assert tdoc == jdoc
    tracks = {e["args"]["name"] for e in tdoc["traceEvents"]
              if e["ph"] == "M"}
    assert {"compute", "host s0", "host s1", "host"} <= tracks
    path = tmp_path / "t.json"
    t[3].write_chrome_trace(str(path), tspans, level_names=names)
    import json
    assert json.loads(path.read_text()) == json.loads(json.dumps(jdoc))

    jreg, treg = JReg(), TReg()
    for reg in (jreg, treg):
        reg.inc("collective_bytes", 1024, label="data")
    jsum = j[3].summary(counters=jreg, residuals=_report(
        j, spans=_timed_spans(j)), extra={"wall_ms": 12.5})
    tsum = t[3].summary(counters=treg, residuals=_report(
        t, spans=_timed_spans(t)), extra={"wall_ms": 12.5})
    assert tsum == jsum
    assert "tasks" not in tsum["residuals"] and tsum["wall_ms"] == 12.5
    t[3].write_summary(str(path), counters=treg, extra={"step": 3})
    assert json.loads(path.read_text()) == {
        "counters": {"collective_bytes{data}": 1024.0}, "step": 3}


def _replay_trees(n_layers=3):
    rng = np.random.default_rng(0)
    w = rng.normal(size=(n_layers, 16, 4)).astype(np.float32)
    b = rng.normal(size=(n_layers, 4)).astype(np.float32)
    e = rng.normal(size=(8, 4)).astype(np.float32)
    stacked = {"layers": {"w": w, "b": b}, "embed": e}
    per_layer = {"layers": [{"w": torch.from_numpy(w[i]),
                             "b": torch.from_numpy(b[i])}
                            for i in range(n_layers)],
                 "embed": torch.from_numpy(e)}
    return stacked, per_layer


@pytest.mark.parametrize("overlap,bb", [(True, 256), (False, 256),
                                        (True, 0)])
def test_replay_spans_equal_reference_and_the_plan(overlap, bb, tmp_path):
    from repro.comms import Communicator as JComm
    from repro.obs.replay import measure_gradient_schedule as jmeasure
    from repro.obs.residuals import gradient_residual_report as jresid
    from repro_torch.comms import Communicator as TComm
    from repro_torch.core.topology import Topology as TTopo
    from repro_torch.obs.replay import measure_gradient_schedule as tmeasure
    from repro_torch.obs.residuals import gradient_residual_report as tresid
    from repro.core.topology import Topology as JTopo
    from test_gradsync_pipeline import fake_mesh, hier3
    from test_torch_gradsync import FakeRankMesh
    path = str(tmp_path / "hier3.json")
    hier3().save(path)
    sizes = dict(dcn=2, pod=2, data=2)
    jc = JComm.create(fake_mesh(**sizes), artifact=path, bucket_bytes=bb)
    tc = TComm.create(FakeRankMesh(**sizes), artifact=path, bucket_bytes=bb)
    stacked, per_layer = _replay_trees()

    def runner(op, elems, dtype, axis, axis_size, spec):
        return 1e-8 * elems * (1 + ("pod", "dcn", "data").index(axis))

    jspans = jmeasure(jc, stacked, overlap_backward=overlap, runner=runner)
    tspans = tmeasure(tc, per_layer, overlap_backward=overlap,
                      runner=runner)
    plan = tc.explain_gradients(per_layer, overlap_backward=overlap)
    assert len(tspans) == len(plan.entries)
    for s, e in zip(tspans, plan.entries):
        assert (s.op, s.nbytes, s.axis, s.algorithm, s.segments) == \
            (e.request.op, e.request.nbytes, e.request.axis,
             e.spec.algorithm, e.spec.segments)
        assert (s.bucket, s.step, s.release, s.stream) == \
            (e.bucket, e.step, e.release, e.stream)
    for prev, nxt in zip(tspans, tspans[1:]):
        assert nxt.t_start == pytest.approx(prev.t_end)
    assert all(e.measured_us is not None
               for e in plan.with_measured(tspans).entries)
    if not overlap:
        # the whole tree's buckets differ by design (the reference stacks
        # the layers); the streamed walk syncs one layer a release
        return
    released = [s.to_json() for s in tspans if s.release is not None]
    assert released and released == \
        [s.to_json() for s in jspans if s.release is not None]
    if bb:       # per leaf, the reference fuses the residual (see replay)
        assert [s.to_json() for s in tspans] == \
            [s.to_json() for s in jspans]
    topo = TTopo.from_spec("2x2x2")
    trep = tresid(tc, per_layer, spans=tspans, topology=topo,
                  overlap_backward=overlap)
    jrep = jresid(jc, stacked, spans=jspans, topology=JTopo.from_spec(
        "2x2x2"), overlap_backward=overlap)
    assert trep.to_json() == jrep.to_json()
    assert trep.measured_tasks() == len(trep.tasks) > 0
