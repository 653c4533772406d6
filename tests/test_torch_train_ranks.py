"""The port's training launcher on several ranks against the JAX
package's single-device steps and against itself (the multi-rank half of
the training tests; ``tests/test_torch_train.py`` holds the one-process
half).

``repro_torch.launch.train`` on 4 spawned ``gloo`` ranks (2x2,
``examples/artifacts/hierarchical_decision.json``, 2 steps, fp32
compute): the tuned sync's losses, params and step 0's synced gradients
equal the ``"xla"`` run's to fp32 reduction order (1e-6), the replicas
stay bit-identical, and the loss and params equal the reference's
single-device steps on the global batch (1e-5: per-rank means of 2 rows
against one mean of 8, summed in another order; 1 param in 10^4 may be
off by up to two steps, see the test). The CLI prints the reference's
lines. ``--overlap-backward --trace-dir`` on 2 ranks equals the plain
tuned run. The reduced mamba2 on 2 ranks: tuned equals ``"xla"``
(1e-6). FSDP and the model axis train. The 2x2x2 (8-rank, bucketed)
case runs under ``slow``.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHITECTURES as JARCH  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.data import SyntheticPipeline as JPipe  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.optim import cosine_with_warmup as jcos  # noqa: E402
from repro_torch import bridge, pytree  # noqa: E402
from repro_torch.configs import ARCHITECTURES, ParallelConfig  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402

HERE = os.path.dirname(__file__)
ARTIFACTS = os.path.join(HERE, "..", "examples", "artifacts")
FP32 = ParallelConfig(compute_dtype="float32")


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _close_trees(got, want, tol):
    """Leaf by leaf over the reference's layout (numpy dicts)."""
    gl, wl = pytree.leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        np.testing.assert_allclose(_np(g), np.asarray(w, np.float32),
                                   atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# data-parallel ranks through the launcher
# ---------------------------------------------------------------------------
def _train(argv, capfd=None):
    res = train.main(["--arch", "smollm-135m", "--reduced", "--device",
                      "cpu", "--seq", "32", "--batch", "8", "--lr", "0.1",
                      *argv], keep_params=True, parallel=FP32)
    out = capfd.readouterr().out if capfd is not None else ""
    return res, out


def _reference_steps(cfg_t, steps, lr):
    """The reference's single-device steps on the global batches, from
    the port's initial params (drawn as every rank draws them)."""
    cfg_j = JARCH["smollm-135m"].reduced()
    shape = JShape(name="cli", seq_len=32, global_batch=8, kind="train")
    api = build_model(cfg_t, compute_dtype=torch.float32, device="cpu")
    p0 = api.init(torch.Generator().manual_seed(0))
    pj = jax.tree.map(jnp.asarray, bridge.to_reference(p0))
    japi = jbuild(cfg_j, compute_dtype=jnp.float32, attn_impl="ref")
    opt = JAdamW(lr=lr)
    state = opt.init(pj)
    pipe = JPipe(cfg_j, shape, seed=0)
    losses = []

    @jax.jit
    def step(p, s, batch):
        (loss, _), g = jax.value_and_grad(japi.loss, has_aux=True)(p, batch)
        scale = jcos(s.step, warmup_steps=100, total_steps=steps)
        p, s = opt.update(g, s, p, lr_scale=scale)
        return p, s, loss

    for i in range(steps):
        # the port's ranks number the streams as the launching process
        pipe_batch = {k: jnp.asarray(v) for k, v in pipe.batch_at(i).items()}
        pj, state, loss = step(pj, state, pipe_batch)
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, pj)


def test_four_ranks_tuned_equals_xla_and_the_reference(capfd):
    hier = os.path.join(ARTIFACTS, "hierarchical_decision.json")
    tuned, out = _train(["--topology", "2x2", "--tuning-table", hier,
                         "--steps", "2"], capfd)
    # the reference's printed lines (tests/test_launchers.py)
    assert "topology: cross_pod(2) > intra_pod(2)" in out
    assert "hierarchical, levels=['intra_pod', 'cross_pod']" in out
    assert "'pod': 2" in out and "step    1" in out and "done: 2 steps" in out
    xla, out = _train(["--topology", "2x2", "--collective", "xla",
                       "--steps", "2"], capfd)
    assert "collective=xla" in out
    assert tuned["tuned"] and not xla["tuned"]
    assert tuned["mesh"] == {"pod": 2, "data": 2, "model": 1}
    # every rank's params bit-identical at init and after every step
    for r in (tuned, xla):
        assert r["replicas_equal_at_init"] and all(r["replicas_equal"])
    # the tuned sync ran its plan; "xla" launched no combine (CPU: the
    # plain versions, which count nothing)
    assert tuned["plan_entries"] == 3 * tuned["leaves"]
    np.testing.assert_allclose(tuned["losses"], xla["losses"], atol=1e-6,
                               rtol=1e-6)
    _close_trees(tuned["params"], pytree.leaves(xla["params"]), 1e-6)
    # step 0's synced gradients: the same gradients before the sync (bit
    # checksums), summed in another order
    assert tuned["local_grads0_fingerprint"] == \
        xla["local_grads0_fingerprint"]
    _close_trees(tuned["grads0"], pytree.leaves(xla["grads0"]), 1e-6)
    assert pytree.fingerprint(tuned["init_params"]) == \
        pytree.fingerprint(xla["init_params"])

    cfg_t = ARCHITECTURES["smollm-135m"].reduced()
    losses, pj = _reference_steps(cfg_t, steps=2, lr=0.1)
    np.testing.assert_allclose(tuned["losses"], losses, atol=1e-5, rtol=1e-5)
    # Adam's early steps divide each gradient by its own size
    # (g / (|g| + eps)), so where |g| is near eps the two batch
    # decompositions' rounding can move, even flip, the update; its size
    # is at most one step (lr x lr_scale(1) = 1e-3; |m/sqrt(v)| <= 1 at
    # t = 2), so: all but 1 in 10^4 params within 1e-5, every one within
    # two steps
    diffs = np.concatenate([
        np.abs(_np(g) - np.asarray(w)).ravel() for g, w in zip(
            pytree.leaves(bridge.to_reference(tuned["params"])),
            jax.tree.leaves(pj))])
    assert (diffs > 1e-5).mean() <= 1e-4 and diffs.max() <= 2e-3, \
        (diffs.max(), (diffs > 1e-5).sum())


def test_overlap_backward_and_trace_dir_over_two_ranks(tmp_path, capfd):
    """``--overlap-backward --trace-dir`` on 2 CPU ranks for 2 steps: the
    run equals the non-overlapped one (the gradients before the sync bit
    for bit, synced within 1e-6), every rank releases the layers deepest
    first, and each step's trace and summary are written, one span a
    plan entry."""
    import json
    argv = ["--ranks", "2", "--topology", "2", "--tuning-table",
            os.path.join(ARTIFACTS, "hierarchical_decision.json"),
            "--steps", "2"]
    trace = tmp_path / "trace"
    ovl, out = _train([*argv, "--overlap-backward", "--trace-dir",
                       str(trace)], capfd)
    plain, _ = _train(argv, capfd)
    assert "gradient sync: backward-overlapped release streams" in out
    assert "exposed" in out and "trace: step    1 drift" in out
    assert ovl["local_grads0_fingerprint"] == \
        plain["local_grads0_fingerprint"]
    np.testing.assert_allclose(ovl["losses"], plain["losses"], atol=1e-6,
                               rtol=1e-6)
    _close_trees(ovl["grads0"], pytree.leaves(plain["grads0"]), 1e-6)
    layers = ARCHITECTURES["smollm-135m"].reduced().num_layers
    assert ovl["release_events"] == [[list(reversed(range(layers)))] * 2] * 2
    for i in range(2):
        doc = json.loads((trace / f"step{i:03d}.trace.json").read_text())
        spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
        assert len(spans) == ovl["plan_entries"]
        summary = json.loads((trace / f"step{i:03d}.summary.json")
                             .read_text())
        assert summary["step"] == i and summary["n_tasks"] == len(spans)
        assert "drift" in summary
    # the overlap needs a tuned sync and one microbatch, as the reference
    with pytest.raises(SystemExit, match="needs the tuned gradient-sync"):
        train.main(["--reduced", "--device", "cpu", "--overlap-backward"])


def test_two_ranks_reduced_mamba2_tuned_equals_xla(capfd):
    """The reduced mamba2-130m on 2 CPU ranks for 2 steps (fp32 compute,
    the SSD scan through ``ssd_scan.SSDChunk``), through the tuned sync
    of the hierarchical artifact and through ``"xla"``: rank 0's
    gradients before the sync bit-equal, the losses, step 0's synced
    gradients and the final params within 1e-6 (fp32 reduction order),
    the replicas bit-identical after every step."""
    argv = ["--arch", "mamba2-130m", "--ranks", "2", "--topology", "2",
            "--steps", "2"]
    tuned, out = _train([*argv, "--tuning-table",
                         os.path.join(ARTIFACTS,
                                      "hierarchical_decision.json")], capfd)
    xla, _ = _train([*argv, "--collective", "xla"], capfd)
    assert "arch=mamba2-130m devices=2" in out and "done: 2 steps" in out
    assert tuned["tuned"] and not xla["tuned"]
    for r in (tuned, xla):
        assert r["replicas_equal_at_init"] and all(r["replicas_equal"])
    assert tuned["local_grads0_fingerprint"] == \
        xla["local_grads0_fingerprint"]
    np.testing.assert_allclose(tuned["losses"], xla["losses"], atol=1e-6,
                               rtol=1e-6)
    _close_trees(tuned["grads0"], pytree.leaves(xla["grads0"]), 1e-6)
    _close_trees(tuned["params"], pytree.leaves(xla["params"]), 1e-6)


def test_unported_options_raise_naming_their_step():
    """Every option this test once found unported now trains (the name
    is kept from then): FSDP (one step on 4 ranks, each holding its
    shards, the replicated leaves equal); FSDP with a model axis (one
    step on 2 x 2, each rank holding its tensor-parallel slices cut to
    its FSDP shards, every leaf equal on the ranks that hold the same
    part of it); and a model axis for a family without experts
    (``--model-parallel 2`` for smollm, the VLM and the enc-dec family)
    tensor-parallel, as the reference does: one step on 2 x 2 ranks, the
    replicas equal."""
    fsdp = ParallelConfig(shard_params_over_data=True)
    res = train.main(["--reduced", "--device", "cpu", "--ranks", "4",
                      "--steps", "1", "--seq", "32", "--batch", "8"],
                     parallel=fsdp)
    assert res["mesh"] == {"data": 4, "model": 1}
    assert res["fsdp"]["sharded_leaves"] == 16
    assert res["replicas_equal_at_init"] and all(res["replicas_equal"])
    assert len(res["losses"]) == 1 and 0 < res["losses"][0] < 20
    res = train.main(["--reduced", "--device", "cpu", "--ranks", "4",
                      "--model-parallel", "2", "--steps", "1", "--seq",
                      "32", "--batch", "8"], parallel=fsdp)
    assert res["mesh"] == {"data": 2, "model": 2}
    assert res["fsdp"]["leaves"] == {"data": 4, "model": 0, "both": 12,
                                     "neither": 5}
    assert res["replicas_equal_at_init"] and all(res["replicas_equal"])
    assert len(res["losses"]) == 1 and 0 < res["losses"][0] < 20
    for arch in ("smollm-135m", "llava-next-mistral-7b", "whisper-large-v3"):
        res = train.main(["--arch", arch, "--reduced", "--device", "cpu",
                          "--ranks", "4", "--model-parallel", "2",
                          "--steps", "1", "--seq", "32", "--batch", "8"])
        assert res["mesh"] == {"data": 2, "model": 2}, arch
        assert res["tp_split"]["heads"] and res["tp_split"]["vocab"], arch
        assert res["replicas_equal_at_init"] and all(res["replicas_equal"])
        assert len(res["losses"]) == 1 and 0 < res["losses"][0] < 20


@pytest.mark.slow
def test_eight_ranks_bucketed_2x2x2_equals_xla():
    hier3 = os.path.join(ARTIFACTS, "hierarchical_decision_3level.json")
    tuned, _ = _train(["--topology", "2x2x2", "--tuning-table", hier3,
                       "--steps", "2"])
    xla, _ = _train(["--topology", "2x2x2", "--steps", "2"])
    assert "bucket_bytes" in tuned["describe"]
    assert all(tuned["replicas_equal"]) and all(xla["replicas_equal"])
    np.testing.assert_allclose(tuned["losses"], xla["losses"], atol=1e-6,
                               rtol=1e-6)
    _close_trees(tuned["params"], pytree.leaves(xla["params"]), 1e-6)
