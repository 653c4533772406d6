"""The port's training path against the JAX package's, in one process
(``tests/test_torch_train_ranks.py`` holds the multi-rank half).

Single process, the same numpy inputs through both packages (the port on
the CPU): the synthetic batches bit for bit, ``cosine_with_warmup``,
AdamW over three steps with clipping active (1e-6), ``lm_head_loss`` and
``cross_entropy`` with their gradients at fp32 (1e-5: padded vocab,
labels -1, S not a multiple of the chunk), and the reduced smollm-135m
at fp32 compute with the reference's params carried over by
``repro_torch.bridge``: loss within 1e-5, every gradient within 1e-3,
one AdamW step's params within 1e-5. Then the port alone, as
``tests/test_system.py`` holds the reference: the loss falls over 30
steps and a checkpoint round trip resumes bit-equal, on batches whose
stream ids are fixed (``RESUME_STREAMS``), so every process trains on the
same tokens whatever its hash salt (checked under two
``PYTHONHASHSEED`` values). The reduced mamba2-130m and zamba2-2.7b (the
SSD scan through ``ssd_scan.SSDChunk``) likewise: loss within 1e-5 and
every gradient within 1e-3 of the reference's, the same with ``remat``
bit for bit. In one spawned rank, ``overlap_microbatches=2`` accumulates
the whole batch's loss and gradients (1e-6), ``remat`` leaves loss and
gradients bit-equal, and ``gather_in_compute_dtype`` matches the
reference's cast.

The tests of this module run with one intra-op thread
(`one_intra_op_thread`): the suite runs beside other workers and their
spawned ranks, and a pool of one thread a core in each of them starves
the others (the 30-step loss test took 118 s instead of 1.3 s beside
five busy processes on 8 cores).
"""
import dataclasses
import hashlib
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHITECTURES as JARCH  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.data import SyntheticPipeline as JPipe  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro.models.registry import make_train_batch as jmake  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.optim import cosine_with_warmup as jcos  # noqa: E402
from repro_torch import bridge, pytree  # noqa: E402
from repro_torch.checkpoint import restore, save  # noqa: E402
from repro_torch.configs import ARCHITECTURES, ParallelConfig, ShapeConfig  # noqa: E402,E501
from repro_torch.data import SyntheticPipeline, batch_to_tensors  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.registry import build_model, make_train_batch  # noqa: E402,E501
from repro_torch.optim import AdamW, cosine_with_warmup  # noqa: E402
from repro_torch.optim.adamw import AdamWState, global_norm  # noqa: E402

HERE = os.path.dirname(__file__)
ARTIFACTS = os.path.join(HERE, "..", "examples", "artifacts")
FP32 = ParallelConfig(compute_dtype="float32")


#: the loss test's stream ids, fixed across processes (the pipeline's
#: default numbers its streams by ``hash(name)``, which Python salts per
#: process)
RESUME_STREAMS = {"tokens": 1, "labels": 2}
RESUME_VOCAB, RESUME_SEQ, RESUME_BATCH = 256, 32, 4
RESUME_STEPS = 30


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """Every test of this module with one intra-op thread, restored after."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _cfgs(**kw):
    return JARCH["smollm-135m"].reduced().replace(**kw), \
        ARCHITECTURES["smollm-135m"].reduced().replace(**kw)


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
# data, schedule, optimizer
# ---------------------------------------------------------------------------
def test_pipeline_batches_bit_for_bit():
    cfg_j, cfg_t = _cfgs()
    shape_j = JShape(name="t", seq_len=64, global_batch=4, kind="train")
    shape_t = ShapeConfig(name="t", seq_len=64, global_batch=4, kind="train")
    pj, pt = JPipe(cfg_j, shape_j, seed=3), SyntheticPipeline(cfg_t, shape_t,
                                                             seed=3)
    for i in (0, 1, 7, 123):
        bj, bt = pj.batch_at(i), pt.batch_at(i)
        assert sorted(bj) == sorted(bt)
        for k in bj:
            assert bt[k].dtype == bj[k].dtype
            np.testing.assert_array_equal(bt[k], bj[k])
    for k, a in jmake(cfg_j, shape_j, seed=5).items():
        np.testing.assert_array_equal(make_train_batch(cfg_t, shape_t,
                                                       seed=5)[k], a)
    # ranks take the launcher's stream ids: equal ids, equal batches
    other = SyntheticPipeline(cfg_t, shape_t, seed=3, streams=pt.streams)
    np.testing.assert_array_equal(other.batch_at(9)["tokens"],
                                  pt.batch_at(9)["tokens"])


def test_cosine_with_warmup_matches():
    steps = np.arange(0, 320, 7)
    want = np.asarray(jcos(jnp.asarray(steps), warmup_steps=100,
                           total_steps=300))
    got = cosine_with_warmup(torch.from_numpy(steps), warmup_steps=100,
                             total_steps=300)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-7, rtol=1e-6)
    assert float(cosine_with_warmup(0, warmup_steps=100,
                                    total_steps=300)) == 0.0


def test_adamw_three_steps_with_clipping():
    rng = np.random.default_rng(0)
    make = lambda: {"w": rng.normal(size=(8, 16)).astype(np.float32),  # noqa: E731,E501
                    "b": rng.normal(size=(16,)).astype(np.float32)}
    p_np = make()
    jopt, topt = JAdamW(lr=1e-2), AdamW(lr=1e-2)
    pj = jax.tree.map(jnp.asarray, p_np)
    pt = pytree.tree_map(torch.tensor, p_np)    # updated in place
    sj, st = jopt.init(pj), topt.init(pt)
    for i in range(3):
        g_np = pytree.tree_map(lambda a: a * 10.0, make())   # norm >> 1
        scale = float(jcos(i, warmup_steps=2, total_steps=3))
        pj, sj = jopt.update(jax.tree.map(jnp.asarray, g_np), sj, pj,
                             lr_scale=scale)
        pt, st = topt.update(pytree.tree_map(torch.from_numpy, g_np), st,
                             pt, lr_scale=cosine_with_warmup(
                                 i, warmup_steps=2, total_steps=3))
    assert int(st.step) == int(sj.step) == 3
    for k in ("w", "b"):
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]),
                                   atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(st.mu[k].numpy(), np.asarray(sj.mu[k]),
                                   atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(st.nu[k].numpy(), np.asarray(sj.nu[k]),
                                   atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# the loss and the model
# ---------------------------------------------------------------------------
def test_adamw_donated_update_is_bit_equal():
    """The update writes into the params and moments leaf by leaf (as
    the reference donates its buffers): the same bits as a functional
    update of the same operations in the same order, over three steps
    with the clip active, and the same tensors back."""
    rng = np.random.default_rng(3)

    def leaf(shape, scale):
        return torch.from_numpy(
            (scale * rng.normal(size=shape)).astype(np.float32))

    def tree(scale):
        return {"a": leaf((5, 7), scale),
                "b": {"c": leaf((11,), scale), "d": leaf((2, 3, 4), scale)}}

    def functional(opt, grads, state, params, lr_scale):
        step = state.step + 1
        gnorm = global_norm(grads)
        scale = torch.clamp(opt.grad_clip / (gnorm + 1e-9), max=1.0)
        grads = pytree.tree_map(lambda g: g * scale, grads)
        b1, b2 = opt.beta1, opt.beta2
        mu = pytree.tree_map(lambda m, g: b1 * m + (1 - b1) * g,
                             state.mu, grads)
        nu = pytree.tree_map(lambda v, g: b2 * v + (1 - b2) * g * g,
                             state.nu, grads)
        t = step.to(torch.float32)
        bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
        lr = opt.lr * torch.as_tensor(lr_scale, dtype=torch.float32)

        def upd(p, m, v):
            return (p - lr * ((m / bc1) / (torch.sqrt(v / bc2) + opt.eps)
                              + opt.weight_decay * p)).to(p.dtype)
        return pytree.tree_map(upd, params, mu, nu), \
            AdamWState(step=step, mu=mu, nu=nu)

    opt = AdamW(lr=0.1)
    p = tree(1.0)
    s = opt.init(p)
    pd = pytree.tree_map(torch.clone, p)
    sd = opt.init(pd)
    for i in range(3):
        g = tree(10.0)                       # the clip rescales it
        p, s = functional(opt, g, s, p, 0.5)
        before = pytree.leaves(pd)
        pd, sd = opt.update(g, sd, pd, lr_scale=0.5)
        assert all(a is b for a, b in zip(pytree.leaves(pd), before))
        for a, b in zip(pytree.leaves((pd, sd.mu, sd.nu)),
                        pytree.leaves((p, s.mu, s.nu))):
            assert torch.equal(a, b)
        assert int(sd.step) == int(s.step) == i + 1


def test_lm_head_loss_and_cross_entropy_with_gradients():
    cfg_j, cfg_t = _cfgs(vocab_size=250)          # padded to 256 columns
    rng = np.random.default_rng(1)
    B, S, d = 2, 40, cfg_t.d_model
    h = rng.normal(size=(B, S, d)).astype(np.float32)
    p = {"final_norm": (1 + 0.1 * rng.normal(size=(d,))).astype(np.float32),
         "out": (rng.normal(size=(d, 256)) / 16).astype(np.float32)}
    labels = rng.integers(0, 250, size=(B, S)).astype(np.int32)
    labels[0, :7] = -1
    labels[1, 3] = 252                            # a padded column: masked

    def jloss(h, p):
        return JL.lm_head_loss(h, p, jnp.asarray(labels), cfg_j,
                               compute_dtype=jnp.float32, chunk=16)
    want, (wh, wp) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        jnp.asarray(h), jax.tree.map(jnp.asarray, p))
    ht = torch.from_numpy(h).requires_grad_()
    pt = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    got = L.lm_head_loss(ht, pt, torch.from_numpy(labels), cfg_t,
                         compute_dtype=torch.float32, chunk=16)
    gh, gn, go = torch.autograd.grad(got, (ht, pt["final_norm"], pt["out"]))
    np.testing.assert_allclose(got.item(), float(want), atol=1e-5, rtol=1e-5)
    for g, w in ((gh, wh), (gn, wp["final_norm"]), (go, wp["out"])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)

    logits = rng.normal(size=(B, S, 250)).astype(np.float32)
    want, wl = jax.jit(jax.value_and_grad(lambda x: JL.cross_entropy(
        x, jnp.asarray(labels))))(jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_()
    got = L.cross_entropy(lt, torch.from_numpy(labels))
    (gl,) = torch.autograd.grad(got, (lt,))
    np.testing.assert_allclose(got.item(), float(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), atol=1e-5,
                               rtol=1e-5)


def _grads(api, params, batch):
    leaves, treedef = pytree.flatten(params)
    leaves = [x.detach().requires_grad_() for x in leaves]
    loss, _ = api.loss(treedef.unflatten(leaves), batch)
    return loss, treedef.unflatten(list(torch.autograd.grad(loss, leaves)))


def test_reduced_model_loss_gradients_and_step_match():
    cfg_j, cfg_t = _cfgs(vocab_size=256)
    shape = JShape(name="t", seq_len=48, global_batch=2, kind="train")
    japi = jbuild(cfg_j, compute_dtype=jnp.float32, attn_impl="ref")
    pj = japi.init(jax.random.PRNGKey(0))
    batch = jmake(cfg_j, shape, seed=2)
    (want, _), gj = jax.jit(jax.value_and_grad(japi.loss, has_aux=True))(
        pj, batch)

    api = build_model(cfg_t, compute_dtype=torch.float32, device="cpu")
    pt = bridge.from_jax(jax.tree.map(np.asarray, pj))
    bt = bridge.batch_from_jax(jax.tree.map(np.asarray, batch))
    got, gt = _grads(api, pt, bt)
    np.testing.assert_allclose(got.item(), float(want), atol=1e-5, rtol=1e-5)
    ref_layout = bridge.to_reference(gt)
    assert len(pytree.leaves(gt)) == 9 * cfg_t.num_layers + 3
    _close_trees(ref_layout, jax.tree.map(np.asarray, gj), 1e-3)

    # the step on the reference's gradients: Adam's first step is
    # g / (|g| + eps), which turns the 1e-3 gradient tolerance into an
    # lr-sized one wherever |g| is near eps
    jopt, topt = JAdamW(lr=1e-3), AdamW(lr=1e-3)
    sj = jopt.init(pj)
    pj2, _ = jopt.update(gj, sj, pj)
    st = bridge.opt_state_from_jax(jax.tree.map(np.asarray, sj))
    pt2, _ = topt.update(bridge.from_jax(jax.tree.map(np.asarray, gj)), st,
                         pt)
    _close_trees(bridge.to_reference(pt2), jax.tree.map(np.asarray, pj2),
                 1e-5)


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-2.7b"])
def test_reduced_ssm_and_hybrid_loss_and_gradients_match(arch):
    """The reduced mamba2-130m and zamba2-2.7b (2 SSM layers; zamba2's
    shared attention after each, ``attn_every=1``) at fp32 compute, the
    reference's params carried over by ``repro_torch.bridge``: the loss
    within 1e-5 and every leaf's gradient within 1e-3 of
    ``jax.value_and_grad`` of the reference's loss (its SSD through
    ``ref.ssd_chunked``, the port's through ``ssd_scan.SSDChunk``), as the
    dense family's; with ``remat`` the same loss and gradients bit for
    bit."""
    cfg_j = JARCH[arch].reduced().replace(vocab_size=256)
    cfg_t = ARCHITECTURES[arch].reduced().replace(vocab_size=256)
    shape = JShape(name="t", seq_len=64, global_batch=2, kind="train")
    japi = jbuild(cfg_j, compute_dtype=jnp.float32, attn_impl="ref",
                  ssd_impl="xla")
    pj = japi.init(jax.random.PRNGKey(0))
    batch = jmake(cfg_j, shape, seed=2)
    (want, _), gj = jax.jit(jax.value_and_grad(japi.loss, has_aux=True))(
        pj, batch)
    pt = bridge.from_jax(jax.tree.map(np.asarray, pj))
    bt = bridge.batch_from_jax(jax.tree.map(np.asarray, batch))
    runs = []
    for remat in (False, True):
        api = build_model(cfg_t, compute_dtype=torch.float32, device="cpu",
                          remat=remat)
        runs.append(_grads(api, pt, bt))
    (got, gt), (got_r, gt_r) = runs
    np.testing.assert_allclose(got.item(), float(want), atol=1e-5, rtol=1e-5)
    _close_trees(bridge.to_reference(gt), jax.tree.map(np.asarray, gj), 1e-3)
    assert got_r.item() == got.item()
    for a, b in zip(pytree.leaves(gt_r), pytree.leaves(gt)):
        assert torch.equal(a, b)


def _resume_pipeline():
    """The loss test's config and batches."""
    cfg = ARCHITECTURES["smollm-135m"].reduced().replace(
        vocab_size=RESUME_VOCAB)
    shape = ShapeConfig(name="tiny", seq_len=RESUME_SEQ,
                        global_batch=RESUME_BATCH, kind="train")
    return cfg, SyntheticPipeline(cfg, shape, seed=0, streams=RESUME_STREAMS)


def _digest(pipe, steps: int) -> str:
    h = hashlib.sha256()
    for i in range(steps):
        for k, v in sorted(pipe.batch_at(i).items()):
            h.update(k.encode())
            h.update(v.tobytes())
    return h.hexdigest()


def test_port_training_reduces_loss_and_resumes(tmp_path):
    """``tests/test_system.py``'s check, on the port alone."""
    cfg, pipe = _resume_pipeline()
    api = build_model(cfg, compute_dtype=torch.float32, device="cpu")
    opt = AdamW(lr=3e-3)
    params = api.init(torch.Generator().manual_seed(0))
    opt_state = opt.init(params)

    def step(params, opt_state, batch):
        loss, grads = _grads(api, params, batch)
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, loss.item()

    losses = []
    for i in range(RESUME_STEPS):
        params, opt_state, loss = step(
            params, opt_state, batch_to_tensors(pipe.batch_at(i), "cpu"))
        losses.append(loss)
    # hash-random tokens: learnable down to the unigram entropy; early >> late
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1, losses

    path = str(tmp_path / "ck")
    save(path, {"params": params, "opt": opt_state}, step=RESUME_STEPS)
    restored, step_no, _ = restore(path, {"params": params,
                                          "opt": opt_state})
    assert step_no == RESUME_STEPS
    b = batch_to_tensors(pipe.batch_at(RESUME_STEPS), "cpu")
    _, _, l_orig = step(params, opt_state, b)
    _, _, l_rest = step(restored["params"], restored["opt"], b)
    assert l_orig == l_rest


#: builds the loss test's batches in a fresh process (torch and the port
#: only) and prints their digest
HASH_SEED_SCRIPT = r"""
import hashlib, json, sys
from repro_torch.configs import ARCHITECTURES, ShapeConfig
from repro_torch.data import SyntheticPipeline
c = json.loads(sys.argv[1])
cfg = ARCHITECTURES["smollm-135m"].reduced().replace(vocab_size=c["vocab"])
shape = ShapeConfig(name="tiny", seq_len=c["seq"], global_batch=c["batch"],
                    kind="train")
pipe = SyntheticPipeline(cfg, shape, seed=0, streams=c["streams"])
h = hashlib.sha256()
for i in range(c["steps"]):
    for k, v in sorted(pipe.batch_at(i).items()):
        h.update(k.encode())
        h.update(v.tobytes())
print(h.hexdigest())
"""


def test_resume_batches_do_not_depend_on_the_hash_seed():
    """The loss test's 31 batches, built in a fresh process under two
    ``PYTHONHASHSEED`` values, are this process's bits."""
    import json
    import subprocess
    import sys
    arg = json.dumps({"vocab": RESUME_VOCAB, "seq": RESUME_SEQ,
                      "batch": RESUME_BATCH, "streams": RESUME_STREAMS,
                      "steps": RESUME_STEPS + 1})
    want = _digest(_resume_pipeline()[1], RESUME_STEPS + 1)
    procs = {seed: subprocess.Popen(
        [sys.executable, "-c", HASH_SEED_SCRIPT, arg],
        env=dict(os.environ, PYTHONHASHSEED=seed,
                 PYTHONPATH=os.path.join(HERE, "..", "src")),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for seed in ("1", "2")}
    try:
        for seed, proc in procs.items():
            out, err = proc.communicate(timeout=300)
            assert proc.returncode == 0, err[-2000:]
            assert out.split()[-1] == want, seed
    finally:
        for proc in procs.values():
            proc.kill()


def _step_grads(variants):
    """In one spawned rank: the step's loss and gradients of one batch
    (``step.grad``, before the sync) for each (ParallelConfig,
    CollectiveConfig) of ``variants``, with the params and batch, all on
    the host."""
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import build_train_step
    _, cfg = _cfgs(vocab_size=256)
    shape = ShapeConfig(name="t", seq_len=32, global_batch=4, kind="train")
    mesh = make_local_mesh()
    out = []
    for parallel, coll in variants:
        step = build_train_step(cfg, shape, parallel, coll, mesh,
                                device="cpu")
        params = step.api.init(torch.Generator().manual_seed(0))
        batch = batch_to_tensors(make_train_batch(cfg, shape, seed=1),
                                 "cpu", rows=step.rows)
        (loss, _), grads = step.grad(params, batch)
        out.append((loss.item(), pytree.leaves(grads)))
    return out, params, batch


def test_overlap_microbatches_accumulates_the_whole_batch_gradient():
    from repro_torch.configs.base import CollectiveConfig
    from repro_torch.core.collectives import group as grp
    [(l1, g1), (l2, g2)], _, _ = grp.spawn(_step_grads, 1, ([
        (FP32, CollectiveConfig(overlap_microbatches=k)) for k in (1, 2)],))
    np.testing.assert_allclose(l2, l1, atol=1e-6, rtol=1e-6)
    for a, b in zip(g2, g1):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6,
                                   rtol=1e-5)


def test_remat_and_gather_in_compute_dtype():
    """``ParallelConfig.remat`` recomputes every layer in the backward
    (``torch.utils.checkpoint``): the same loss and gradients, bit for
    bit. ``gather_in_compute_dtype`` casts the fp32 master params to
    bf16 before the forward, as the reference's ``loss_with_cast``
    (``src/repro/launch/steps.py:132``): at fp32 compute the loss equals
    the reference's at the bf16-rounded params (1e-5), every gradient
    comes back fp32 holding a bf16 value (the cast's cotangent), and
    equals the reference's per leaf within one bf16 step (2^-7, relative
    2-norm: the two packages' fp32 cotangents round apart where they
    straddle a bf16 boundary)."""
    from repro_torch.configs.base import CollectiveConfig
    from repro_torch.core.collectives import group as grp
    coll = CollectiveConfig()
    outs, params, batch = grp.spawn(_step_grads, 1, ([
        (FP32, coll), (dataclasses.replace(FP32, remat="full"), coll),
        (dataclasses.replace(FP32, gather_in_compute_dtype=True), coll)],))
    (l0, g0), (lr, gr), (lc, gc) = outs
    assert lr == l0
    for a, b in zip(gr, g0):
        np.testing.assert_array_equal(a.numpy(), b.numpy())

    cfg_j, _ = _cfgs(vocab_size=256)
    japi = jbuild(cfg_j, compute_dtype=jnp.float32, attn_impl="ref")

    def loss_with_cast(p, b):
        return japi.loss(jax.tree.map(lambda x: x.astype(jnp.bfloat16)
                                      if x.dtype == jnp.float32 else x, p),
                         b)

    pj = jax.tree.map(jnp.asarray, bridge.to_reference(params))
    bj = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    (want, _), gj = jax.value_and_grad(loss_with_cast, has_aux=True)(pj, bj)
    assert lc != l0                      # the cast changed the forward
    np.testing.assert_allclose(lc, float(want), atol=1e-5, rtol=1e-5)
    assert all(g.dtype == torch.float32 for g in gc)
    tree = pytree.flatten(params)[1].unflatten(gc)
    for g, w in zip(pytree.leaves(bridge.to_reference(tree)),
                    jax.tree.leaves(gj)):
        g, w = _np(g), np.asarray(w, np.float32)
        assert np.array_equal(g, torch.from_numpy(g).bfloat16().float()
                              .numpy())
        assert np.linalg.norm(g - w) <= 2 ** -7 * np.linalg.norm(w)


def _repeated_step_grads():
    """In one spawned rank (all the host's intra-op threads): three
    ``step.grad`` calls on one batch of 512 tokens over a 256-token
    vocabulary, so the embedding's rows repeat."""
    from repro_torch.configs.base import CollectiveConfig
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import build_train_step
    _, cfg = _cfgs(vocab_size=256)
    shape = ShapeConfig(name="t", seq_len=64, global_batch=8, kind="train")
    step = build_train_step(cfg, shape, FP32, CollectiveConfig(),
                            make_local_mesh(), device="cpu")
    params = step.api.init(torch.Generator().manual_seed(0))
    batch = batch_to_tensors(make_train_batch(cfg, shape, seed=1), "cpu",
                             rows=step.rows)
    return torch.get_num_threads(), [
        pytree.leaves(step.grad(params, batch)[1]) for _ in range(3)]


def test_step_gradients_are_bit_equal_across_calls_with_threads():
    """The embedding's gradient sums repeated tokens' rows in one order
    (``F.embedding``'s CPU backward), whatever the intra-op threads do:
    every call of ``step.grad`` gives the same bits."""
    from repro_torch.core.collectives import group as grp
    threads, runs = grp.spawn(_repeated_step_grads, 1)
    assert threads == max(1, os.cpu_count() or 1)
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
