"""The port's backward-overlapped gradient sync against the JAX package's.

* Release points (``tests/test_overlap_backward.py`` mirrored): the
  gradient through ``layers.grad_release`` with an identity sink is the
  plain one bit for bit, and the reference's within 1e-6; the events
  arrive deepest layer first; no sink leaves the tree untouched;
  ``release_scope`` restores the sink it replaced. In the reduced
  smollm-135m the forward releases every layer once, in backward order,
  with and without ``remat`` (the release wraps the layer's params
  outside the checkpoint), and the hooked gradients equal the plain
  ones bit for bit.
* The streamed plan: ``explain_gradients(overlap_backward=True)`` over
  the port's per-layer tree equals the reference's over its stacked
  tree entry for entry (op, bytes, axis, dtype, algorithm, segments,
  level, source, bucket, step, release, stream) and in text, for the
  hierarchical and flat artifacts and a static algorithm, per leaf and
  bucketed; a tree without layers falls back to the plain plan. The
  spans a recorder takes of the streamed sync over fake collectives
  (both sinks: synchronous and on the sync thread) equal the plan. The
  same for the reduced mamba2-130m and zamba2-2.7b, whose mamba layers
  release under their global indices (zamba2's ``shared`` block syncs
  with the residual).
* Numerics on 4 spawned ``gloo`` ranks, 2x2 ``("pod", "data")``
  (``tests/helpers/validate_communicator.py`` section 6 mirrored): a
  real backward through release points, synced by the hierarchical
  artifact, the flat artifact and ``"xla"``, equals the per-leaf sync
  and the float64 mean at 3e-5, and the sync thread's result equals the
  synchronous sink's bit for bit. ``build_train_step`` with
  ``overlap_backward`` on the reduced smollm (fp32): the gradients
  before the sync bit-equal to the plain step's, the synced gradients
  within 3e-5 of the per-leaf sync and the float64 mean, the loss and
  the release order (layer L-1 first) in every rank. On 2 ranks, the
  reduced mamba2 and zamba2: the overlapped step gives the plain tuned
  step's bits, releasing L-1 ... 0 in every rank.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.comms import Communicator as JComm  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch import bridge, pytree  # noqa: E402
from repro_torch.comms import Communicator as TComm  # noqa: E402
from repro_torch.configs import ARCHITECTURES, ParallelConfig, ShapeConfig  # noqa: E402,E501
from repro_torch.configs.base import CollectiveConfig  # noqa: E402
from repro_torch.core.collectives import group as grp  # noqa: E402
from repro_torch.data import batch_to_tensors  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.registry import build_model, make_train_batch  # noqa: E402,E501
from repro_torch.obs import FakeClock, TraceRecorder, assign_stream_tags  # noqa: E402,E501

from test_gradsync_pipeline import fake_mesh as jfake_mesh  # noqa: E402
from test_gradsync_pipeline import hier3  # noqa: E402
from test_torch_gradsync import FakeRankMesh  # noqa: E402
from test_torch_gradsync import restore_synth_registries  # noqa: E402,F401
from test_torch_gradsync import tfake_collectives  # noqa: E402,F401

ARTIFACTS = os.path.join(os.path.dirname(__file__), "..", "examples",
                         "artifacts")
HIER = os.path.join(ARTIFACTS, "hierarchical_decision.json")
FLAT = os.path.join(ARTIFACTS, "tuned_decision.json")
FP32 = ParallelConfig(compute_dtype="float32")
TOL = 3e-5                   # the reference's streamed-sync tolerance


def _cfg():
    return ARCHITECTURES["smollm-135m"].reduced().replace(vocab_size=256)


# ---------------------------------------------------------------------------
# release points
# ---------------------------------------------------------------------------
class _IdentitySink:
    def __init__(self):
        self.events = []

    def release(self, tag, ct):
        self.events.append(tag)
        return ct


def _layered_loss(xs, n_layers, width):
    acc = torch.zeros((width,), dtype=torch.float32)
    for i in range(n_layers):
        sl = L.grad_release(("layers", i), {k: v[i] for k, v in xs.items()})
        acc = torch.tanh(acc * sl["w"] + sl["b"])
    return acc.sum()


def _jlayered_loss(xs, n_layers, width):
    acc = jnp.zeros((width,), jnp.float32)
    for i in range(n_layers):
        sl = JL.grad_release(("layers", i), jax.tree.map(lambda a: a[i], xs))
        acc = jnp.tanh(acc * sl["w"] + sl["b"])
    return acc.sum()


def test_grad_release_bit_identical_and_backward_ordered():
    n_layers, width = 4, 8
    rng = np.random.default_rng(0)
    xs_np = {"w": rng.normal(size=(n_layers, width)).astype(np.float32),
             "b": rng.normal(size=(n_layers,)).astype(np.float32)}

    def grads(sink):
        xs = {k: torch.from_numpy(v).requires_grad_()
              for k, v in xs_np.items()}
        if sink is None:
            loss = _layered_loss(xs, n_layers, width)
        else:
            with L.release_scope(sink):
                loss = _layered_loss(xs, n_layers, width)
        return torch.autograd.grad(loss, [xs["b"], xs["w"]])

    plain, sink = grads(None), _IdentitySink()
    hooked = grads(sink)
    for a, b in zip(plain, hooked):
        assert torch.equal(a, b)
    jsink = _IdentitySink()
    with JL.release_scope(jsink):
        want = jax.grad(_jlayered_loss)(jax.tree.map(jnp.asarray, xs_np),
                                        n_layers, width)
    for g, w in zip(hooked, jax.tree.leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=1e-6)
    # deepest layer's gradients materialize first, as in the reference
    assert sink.events == jsink.events == [("layers", i) for i in
                                           reversed(range(n_layers))]


def test_grad_release_inert_without_sink():
    tree = {"w": torch.ones((3,))}
    assert L.grad_release(("layers", 0), tree) is tree
    assert L._RELEASE_SINK is None


def test_release_scope_restores_previous_sink():
    a, b = _IdentitySink(), _IdentitySink()
    with L.release_scope(a):
        assert L._RELEASE_SINK is a
        with L.release_scope(b):
            assert L._RELEASE_SINK is b
        assert L._RELEASE_SINK is a
    assert L._RELEASE_SINK is None
    with pytest.raises(RuntimeError):
        with L.release_scope(a):
            raise RuntimeError("boom")
    assert L._RELEASE_SINK is None


def _model_grads(remat, sink=None, cast=False):
    """The reduced smollm's loss gradients (fp32 compute), optionally
    under a release sink and with the params cast to bf16 first (the
    step's ``gather_in_compute_dtype``)."""
    cfg = _cfg()
    api = build_model(cfg, compute_dtype=torch.float32, remat=remat,
                      device="cpu")
    params = api.init(torch.Generator().manual_seed(0))
    shape = ShapeConfig(name="t", seq_len=32, global_batch=4, kind="train")
    batch = batch_to_tensors(make_train_batch(cfg, shape, seed=1), "cpu")
    leaves, treedef = pytree.flatten(params)
    leaves = [t.detach().requires_grad_() for t in leaves]
    p = treedef.unflatten(leaves)
    if cast:
        p = pytree.tree_map(lambda t: t.to(torch.bfloat16), p)
    if sink is None:
        loss, _ = api.loss(p, batch)
    else:
        with L.release_scope(sink):
            loss, _ = api.loss(p, batch)
    return loss, treedef.unflatten(list(torch.autograd.grad(loss, leaves)))


@pytest.mark.parametrize("remat", [False, True])
def test_model_releases_every_layer_once_and_bit_identical(remat):
    loss0, plain = _model_grads(remat)
    sink = _IdentitySink()
    loss1, hooked = _model_grads(remat, sink)
    assert loss0.item() == loss1.item()
    for a, b in zip(pytree.leaves(plain), pytree.leaves(hooked)):
        assert torch.equal(a, b)
    n = _cfg().num_layers
    assert sink.events == [("layers", i) for i in reversed(range(n))]


# ---------------------------------------------------------------------------
# the streamed plan, both packages
# ---------------------------------------------------------------------------
def _param_trees():
    """The reduced smollm's params: the port's per-layer tree and the
    reference's stacked one (shape structs)."""
    api = build_model(_cfg(), compute_dtype=torch.float32, device="cpu")
    params = api.init(torch.Generator().manual_seed(0))
    stacked = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                           bridge.to_reference(params))
    return params, stacked


def _entry_key(e):
    return (e.request.op, e.request.nbytes, e.request.axis,
            e.request.axis_size, e.request.dtype, e.spec.algorithm,
            e.spec.segments, e.level, e.source, e.bucket, e.step,
            e.release, e.stream)


def _comms(case, tmp_path):
    name, sizes, bb = case
    if name == "hier3":
        path = str(tmp_path / "hier3.json")
        hier3().save(path)
        kw = dict(artifact=path)
    elif name == "ring":
        kw = dict(algorithm="ring")
    else:
        kw = dict(artifact=name)
    return (JComm.create(jfake_mesh(**sizes), bucket_bytes=bb, **kw),
            TComm.create(FakeRankMesh(**sizes), bucket_bytes=bb, **kw))


PLAN_CASES = [(HIER, dict(pod=2, data=2), None),
              (HIER, dict(pod=2, data=2), 1 << 16),
              (FLAT, dict(pod=2, data=2), None),
              ("ring", dict(pod=2, data=2), 4096),
              ("hier3", dict(dcn=2, pod=2, data=2), 256)]


@pytest.mark.parametrize("case", PLAN_CASES,
                         ids=["hier", "hier-64K", "flat", "ring-4K", "hier3"])
def test_streamed_plan_equals_reference_and_the_executed_spans(
        case, tmp_path, tfake_collectives, monkeypatch):
    # the flat path's psum tops go through group.psum, not the dispatch
    monkeypatch.setattr(grp, "psum", lambda x, group=None: x * group.size)
    jc, tc = _comms(case, tmp_path)
    params, stacked = _param_trees()
    jplan = jc.explain_gradients(stacked, overlap_backward=True)
    tplan = tc.explain_gradients(params, overlap_backward=True)
    assert [_entry_key(e) for e in tplan.entries] == \
        [_entry_key(e) for e in jplan.entries]
    assert tplan.render() == jplan.render()
    n = _cfg().num_layers
    assert {e.release for e in tplan.entries} == set(range(n)) | {None}
    # the executed lookups: a real backward through the release points,
    # synced over fake collectives, recorded; both sinks record alike
    for overlap in (False, True):
        tc.trace = TraceRecorder(clock=FakeClock(step=1e-6))
        sink = tc.release_sink(overlap=overlap, device="cpu")
        _, grads = _model_grads(False, sink)
        tc.sync_gradients_streamed(grads, sink, mean=True)
        assert [t[1] for t in sink.events] == list(reversed(range(n)))
        spans = [s for s in assign_stream_tags(tc.trace)
                 if s.kind == "collective"]
        entries = [e for e in tplan.entries if e.source != "psum"]
        assert [(s.op, s.nbytes, s.axis, s.algorithm, s.segments, s.bucket,
                 s.step, s.release, s.stream) for s in spans] == \
            [(e.request.op, e.request.nbytes, e.request.axis,
              e.spec.algorithm, e.spec.segments, e.bucket, e.step,
              e.release, e.stream) for e in entries]


def _ssm_cfg(arch):
    return ARCHITECTURES[arch].reduced().replace(vocab_size=256)


SSM_ARCHS = ["mamba2-130m", "zamba2-2.7b"]


@pytest.mark.parametrize("case", PLAN_CASES[:2], ids=["hier", "hier-64K"])
@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_and_hybrid_streamed_plan_equals_reference_and_the_executed_spans(
        arch, case, tmp_path, tfake_collectives, monkeypatch):
    """The reduced mamba2's and zamba2's streamed plan equals the
    reference's over its stacked tree entry for entry (the reference
    counts the layers from the stacked leaf; zamba2's ``shared`` block
    syncs with the residual), and a real backward through the port's
    release points, synced over fake collectives, records exactly the
    plan: every mamba layer released once under its global index, L-1
    first (for zamba2 this pins the global tags: a tag repeated per
    group would leave a layer unsynced)."""
    monkeypatch.setattr(grp, "psum", lambda x, group=None: x * group.size)
    cfg = _ssm_cfg(arch)
    jc, tc = _comms(case, tmp_path)
    api = build_model(cfg, compute_dtype=torch.float32, device="cpu")
    params = api.init(torch.Generator().manual_seed(0))
    stacked = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                           bridge.to_reference(params))
    jplan = jc.explain_gradients(stacked, overlap_backward=True)
    tplan = tc.explain_gradients(params, overlap_backward=True)
    assert [_entry_key(e) for e in tplan.entries] == \
        [_entry_key(e) for e in jplan.entries]
    assert tplan.render() == jplan.render()
    n = cfg.num_layers
    assert {e.release for e in tplan.entries} == set(range(n)) | {None}

    shape = ShapeConfig(name="t", seq_len=32, global_batch=2, kind="train")
    batch = batch_to_tensors(make_train_batch(cfg, shape, seed=1), "cpu")
    leaves, treedef = pytree.flatten(params)
    leaves = [t.detach().requires_grad_() for t in leaves]
    tc.trace = TraceRecorder(clock=FakeClock(step=1e-6))
    sink = tc.release_sink(overlap=True, device="cpu")
    with L.release_scope(sink):
        loss, _ = api.loss(treedef.unflatten(leaves), batch)
    grads = treedef.unflatten(list(torch.autograd.grad(loss, leaves)))
    tc.sync_gradients_streamed(grads, sink, mean=True)
    assert sink.events == [("layers", i) for i in reversed(range(n))]
    spans = [sp for sp in assign_stream_tags(tc.trace)
             if sp.kind == "collective"]
    entries = [e for e in tplan.entries if e.source != "psum"]
    assert [(sp.op, sp.nbytes, sp.axis, sp.algorithm, sp.segments,
             sp.bucket, sp.step, sp.release, sp.stream) for sp in spans] == \
        [(e.request.op, e.request.nbytes, e.request.axis, e.spec.algorithm,
          e.spec.segments, e.bucket, e.step, e.release, e.stream)
         for e in entries]


def test_streamed_plan_matches_layerless_fallback(tmp_path):
    jc, tc = _comms(("ring", dict(pod=1, data=4), None), tmp_path)
    tree = {"embed": pytree.LeafStruct((32, 4), torch.float32)}
    jtree = {"embed": jax.ShapeDtypeStruct((32, 4), jnp.float32)}
    a = tc.explain_gradients(tree, bucket_bytes=256, overlap_backward=True)
    b = tc.explain_gradients(tree, bucket_bytes=256)
    j = jc.explain_gradients(jtree, bucket_bytes=256, overlap_backward=True)
    assert [(e.request.op, e.request.nbytes, e.bucket, e.step)
            for e in a.entries] \
        == [(e.request.op, e.request.nbytes, e.bucket, e.step)
            for e in b.entries] \
        == [(e.request.op, e.request.nbytes, e.bucket, e.step)
            for e in j.entries]
    # an empty layer list is layerless too
    tree["layers"] = []
    assert [_entry_key(e) for e in tc.explain_gradients(
        tree, bucket_bytes=256, overlap_backward=True).entries] == \
        [_entry_key(e) for e in a.entries]


def test_overlapped_sink_equals_synchronous_sink_under_the_bf16_cast(
        tfake_collectives):
    """With the params cast to bf16 before the forward (the step's
    ``gather_in_compute_dtype``), the released cotangents are bf16: the
    sync thread's result, cast to the fp32 leaves, equals what autograd
    carries through the cast from the synchronous sink, bit for bit."""
    outs = []
    for overlap in (False, True):
        tc = TComm.create(FakeRankMesh(pod=2, data=2), artifact=HIER)
        sink = tc.release_sink(overlap=overlap, device="cpu")
        _, grads = _model_grads(False, sink, cast=True)
        outs.append(tc.sync_gradients_streamed(grads, sink, mean=True))
        assert all(pytree.dtype_name(s.dtype) == "bfloat16" for s in
                   pytree.leaves(sink.synced[("layers", 0)]))
    for a, b in zip(*(pytree.leaves(o) for o in outs)):
        assert a.dtype == torch.float32 and torch.equal(a, b)


def test_sync_thread_raises_a_job_error_at_join():
    thread = grp.SyncThread("cpu")
    thread.submit(lambda: 1)
    thread.submit(lambda: 1 / 0)
    thread.submit(lambda: 3)              # skipped after the error
    with pytest.raises(ZeroDivisionError):
        thread.join()
    ok = grp.SyncThread("cpu")
    for i in range(3):
        ok.submit(lambda i=i: i * i)
    assert ok.join() == [0, 1, 4] and ok.busy_s >= 0.0


def test_sync_thread_keeps_submission_order_under_a_short_switch_interval():
    """Two submitting threads' worth of jobs against the sync thread with
    the interpreter switching threads every microsecond: every job runs
    once, in submission order, and ``join`` returns in time."""
    import sys
    import threading
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        thread, seen, out = grp.SyncThread("cpu"), [], {}
        for i in range(2000):
            thread.submit(seen.append, i)
        joiner = threading.Thread(
            target=lambda: out.setdefault("r", thread.join()))
        joiner.start()
        joiner.join(timeout=60)
        assert not joiner.is_alive()
    finally:
        sys.setswitchinterval(saved)
    assert seen == list(range(2000)) and len(out["r"]) == 2000


# ---------------------------------------------------------------------------
# four ranks, 2x2: the streamed sync's numerics
# ---------------------------------------------------------------------------
N_LAYERS, SBB = 3, 512


def _rank_tree(r, world):
    """Rank ``r``'s gradient tree (grad == params under ``_released_loss``)
    and the float64 mean over the ranks, from one seed."""
    rng = np.random.default_rng(5)
    w = rng.normal(size=(world, N_LAYERS, 9, 3)).astype(np.float32)
    b = rng.normal(size=(world, N_LAYERS, 5)).astype(np.float32)
    e = rng.normal(size=(world, 17)).astype(np.float32)

    def tree(wl, bl, el):
        return {"layers": [{"w": wl[i], "b": bl[i]} for i in range(N_LAYERS)],
                "embed": el}
    mean = tree(w.astype(np.float64).mean(0), b.astype(np.float64).mean(0),
                e.astype(np.float64).mean(0))
    return pytree.tree_map(torch.from_numpy, tree(w[r], b[r], e[r])), mean


def _released_grads(local, sink):
    """grad == params, each layer's slice through a release point as the
    model's forward passes it."""
    leaves, treedef = pytree.flatten(local)
    leaves = [t.clone().requires_grad_() for t in leaves]
    p = treedef.unflatten(leaves)
    with L.release_scope(sink):
        loss = 0.5 * (p["embed"] ** 2).sum()
        for i in range(N_LAYERS):
            sl = L.grad_release(("layers", i), p["layers"][i])
            loss = loss + sum(0.5 * (x ** 2).sum()
                              for x in pytree.leaves(sl))
    return treedef.unflatten(list(torch.autograd.grad(loss, leaves)))


def _four_ranks():
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import build_train_step
    mesh = make_local_mesh(pods=2)
    r = grp.rank()
    local, mean = _rank_tree(r, grp.size())
    out = {"mean": mean, "comms": {}}
    for name, kw in (("hier", dict(artifact=HIER)),
                     ("flat", dict(artifact=FLAT)), ("xla", {})):
        comm = TComm.create(mesh, **kw)
        per_leaf = comm.sync_gradients(local, mean=True)
        got = {}
        for overlap in (False, True):
            sink = comm.release_sink(SBB, overlap=overlap, device="cpu")
            grads = _released_grads(local, sink)
            got[overlap] = comm.sync_gradients_streamed(
                grads, sink, mean=True, bucket_bytes=SBB)
        out["comms"][name] = {"per_leaf": per_leaf, "sync": got[False],
                              "thread": got[True]}

    # the training step, plain and overlapped, on the reduced smollm
    cfg = _cfg()
    shape = ShapeConfig(name="t", seq_len=32, global_batch=8, kind="train")
    comm = TComm.create(mesh, artifact=HIER)
    res = {}
    for overlap in (False, True):
        coll = CollectiveConfig(decision=HIER, overlap_backward=overlap)
        step = build_train_step(cfg, shape, FP32, coll, mesh,
                                communicator=comm, device="cpu")
        params = step.api.init(torch.Generator().manual_seed(0))
        batch = batch_to_tensors(make_train_batch(cfg, shape, seed=3),
                                 "cpu", rows=step.rows)
        if not overlap:
            _, local_grads = step.grad(params, batch)
            parts = [None] * grp.size()
            torch.distributed.all_gather_object(
                parts, [g.double().numpy()
                        for g in pytree.leaves(local_grads)])
            out["step_mean"] = [np.mean(ls, axis=0) for ls in zip(*parts)]
        _, _, m = step.fn(params, step.opt.init(params), batch,
                          keep_grads=True)
        parts = [None] * grp.size()
        torch.distributed.all_gather_object(parts,
                                            m.get("release_events"))
        res[overlap] = {"loss": m["loss"].item(), "grads": m["grads"],
                        "fingerprint": m["local_grads_fingerprint"],
                        "events": parts}
    out["step"] = res
    return out if r == 0 else None


@pytest.fixture(scope="module")
def four_ranks():
    return grp.spawn(_four_ranks, 4)


def _two_ranks_ssm():
    """In each of 2 ranks, for the reduced mamba2 and zamba2 (fp32): the
    training step through the hierarchical artifact's tuned sync, plain
    and with ``overlap_backward``, on one batch; rank 0 returns each
    run's loss, synced gradients, pre-sync fingerprint and every rank's
    release order."""
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import build_train_step
    mesh = make_local_mesh()
    comm = TComm.create(mesh, artifact=HIER)
    out = {}
    for arch in SSM_ARCHS:
        cfg = _ssm_cfg(arch)
        shape = ShapeConfig(name="t", seq_len=32, global_batch=4,
                            kind="train")
        res = {}
        for overlap in (False, True):
            coll = CollectiveConfig(decision=HIER, overlap_backward=overlap)
            step = build_train_step(cfg, shape, FP32, coll, mesh,
                                    communicator=comm, device="cpu")
            params = step.api.init(torch.Generator().manual_seed(0))
            batch = batch_to_tensors(make_train_batch(cfg, shape, seed=3),
                                     "cpu", rows=step.rows)
            _, _, m = step.fn(params, step.opt.init(params), batch,
                              keep_grads=True)
            parts = [None] * grp.size()
            torch.distributed.all_gather_object(parts,
                                                m.get("release_events"))
            res[overlap] = {"loss": m["loss"].item(), "grads": m["grads"],
                            "fingerprint": m["local_grads_fingerprint"],
                            "events": parts}
        out[arch] = res
    return out if grp.rank() == 0 else None


@pytest.fixture(scope="module")
def two_ranks_ssm():
    return grp.spawn(_two_ranks_ssm, 2)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_overlapped_ssm_and_hybrid_steps_equal_the_plain_steps(two_ranks_ssm,
                                                               arch):
    """On 2 ranks, ``overlap_backward`` gives the plain tuned step's bits:
    the gradients before the sync, the loss and the synced gradients; the
    layers release under their global indices, deepest first, in every
    rank (zamba2: L-1 ... 0 across its groups)."""
    plain, ovl = two_ranks_ssm[arch][False], two_ranks_ssm[arch][True]
    assert ovl["fingerprint"] == plain["fingerprint"]
    assert ovl["loss"] == plain["loss"]
    for a, b in zip(pytree.leaves(ovl["grads"]), pytree.leaves(plain["grads"])):
        assert torch.equal(a, b)
    n = _ssm_cfg(arch).num_layers
    assert plain["events"] == [None] * 2
    assert ovl["events"] == [list(reversed(range(n)))] * 2


def _close(got, want, tol=TOL):
    for g, w in zip(pytree.leaves(got), pytree.leaves(want)):
        np.testing.assert_allclose(
            g.double().numpy() if isinstance(g, torch.Tensor) else g,
            w.double().numpy() if isinstance(w, torch.Tensor) else w,
            atol=tol, rtol=tol)


@pytest.mark.parametrize("name", ["hier", "flat", "xla"])
def test_streamed_sync_equals_per_leaf_and_the_mean(four_ranks, name):
    run = four_ranks["comms"][name]
    _close(run["thread"], run["per_leaf"])
    _close(run["thread"], four_ranks["mean"])
    # the sync thread sums as the synchronous sink does
    for a, b in zip(pytree.leaves(run["thread"]), pytree.leaves(run["sync"])):
        assert torch.equal(a, b)


def test_overlapped_train_step_equals_the_plain_step(four_ranks):
    plain, ovl = four_ranks["step"][False], four_ranks["step"][True]
    assert ovl["fingerprint"] == plain["fingerprint"]
    assert ovl["loss"] == pytest.approx(plain["loss"], rel=1e-6, abs=1e-6)
    _close(ovl["grads"], plain["grads"])
    _close(ovl["grads"], four_ranks["step_mean"])
    n = _cfg().num_layers
    assert plain["events"] == [None] * 4
    assert ovl["events"] == [list(reversed(range(n)))] * 4
