"""The port's VLM family (llava-next-mistral-7b, reduced: 2 layers, d 256,
GQA 4:1, 16 patches) against the JAX package's.

The reference's params cross through ``repro_torch.bridge``; the same
numpy patches and tokens go through both. Held: ``vlm.prefill`` over
``[patches | tokens]`` (logits and cache) and greedy text decode past
the prefix at fp32 (2e-5) and bf16 (2e-2 of the largest value); the
masked loss (1e-5, the patch positions not counted) and every leaf's
gradient (1e-3) against ``jax.value_and_grad``; the synthetic batches
(patches and the labels' -1 mask) bit for bit; the serving CLI in both
modes; two ``gloo`` ranks, tuned equal to ``"xla"``.
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
from repro.models import vlm as jvlm  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro.models.registry import make_train_batch as jmake  # noqa: E402
from repro_torch import bridge, pytree  # noqa: E402
from repro_torch.configs import ARCHITECTURES, ParallelConfig, ShapeConfig  # noqa: E402,E501
from repro_torch.data import SyntheticPipeline  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import vlm  # noqa: E402
from repro_torch.models.registry import build_model, make_train_batch  # noqa: E402,E501

ARCH = "llava-next-mistral-7b"
ARTIFACTS = os.path.join(os.path.dirname(__file__), "..", "examples",
                         "artifacts")
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _cfgs(**kw):
    return JARCH[ARCH].reduced().replace(**kw), \
        ARCHITECTURES[ARCH].reduced().replace(**kw)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, dtype="float32"):
    """fp32: elementwise 2e-5; bf16: 2e-2 of the largest value."""
    g, w = _np(got), _np(want)
    assert g.shape == w.shape
    if dtype == "float32":
        np.testing.assert_allclose(g, w, atol=TOL[dtype], rtol=TOL[dtype])
    else:
        err = np.abs(g - w).max()
        assert err <= TOL[dtype] * max(np.abs(w).max(), 1.0), err


def test_reduced_config_keeps_gqa_and_patches():
    _, cfg = _cfgs()
    assert cfg.family == "vlm" and cfg.num_patches == 16
    assert cfg.num_heads // cfg.num_kv_heads == 4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_over_patches_and_text_decode(dtype):
    """``vlm.prefill`` over 16 patches and 8 tokens: logits, k, v and the
    length; then 6 greedy text decode steps from that cache (the port on
    the reference's tokens at bf16)."""
    cfg_j, cfg = _cfgs()
    japi = jbuild(cfg_j, compute_dtype=JDT[dtype], attn_impl="xla")
    api = build_model(cfg, compute_dtype=TDT[dtype], device="cpu")
    pn = jax.tree.map(np.asarray, japi.init(jax.random.PRNGKey(0)))
    jp, tp = jax.tree.map(jnp.asarray, pn), bridge.from_jax(pn)
    rng = np.random.default_rng(3)
    patches = rng.normal(size=(2, cfg.num_patches, cfg.d_model)).astype(
        np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (2, 8))
    jl, jc = jvlm.prefill(jp, {"patches": jnp.asarray(patches, jnp.bfloat16),
                               "tokens": jnp.asarray(tokens, jnp.int32)},
                          cfg_j, 32, compute_dtype=JDT[dtype],
                          attn_impl="xla")
    tl, tc = vlm.prefill(tp, {"patches": torch.from_numpy(patches).to(
        torch.bfloat16), "tokens": torch.from_numpy(tokens)}, cfg, 32,
        compute_dtype=TDT[dtype])
    _close(tl, jl, dtype)
    for k in ("k", "v"):
        _close(tc[k], jc[k], dtype)
    assert int(tc["length"]) == int(jc["length"]) == 24
    jstep = jax.jit(japi.decode_step)
    jtok = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)[:, None]
    ttok = torch.argmax(tl[:, -1], -1)[:, None]
    for _ in range(6):
        if dtype == "bfloat16":
            ttok = torch.from_numpy(np.asarray(jtok, np.int64))
        assert ttok.numpy().tolist() == np.asarray(jtok).tolist()
        jl, jc = jstep(jp, jc, jtok)
        tl, tc = api.decode_step(tp, tc, ttok)
        _close(tl, jl, dtype)
        jtok = jnp.argmax(jl, -1).astype(jnp.int32)[:, None]
        ttok = torch.argmax(tl, -1)[:, None]


def test_masked_loss_and_gradients_match():
    """fp32: the loss over the text positions within 1e-5 and every leaf's
    gradient within 1e-3 of ``jax.value_and_grad``; labels over the
    patches count for nothing (changing them leaves the loss)."""
    cfg_j, cfg = _cfgs(vocab_size=256)
    shape = JShape(name="t", seq_len=40, global_batch=2, kind="train")
    japi = jbuild(cfg_j, compute_dtype=jnp.float32, attn_impl="ref")
    pj = japi.init(jax.random.PRNGKey(0))
    batch = jmake(cfg_j, shape, seed=2)
    assert (np.asarray(batch["labels"])[:, :cfg.num_patches] == -1).all()
    (want, _), gj = jax.jit(jax.value_and_grad(japi.loss, has_aux=True))(
        pj, batch)
    api = build_model(cfg, compute_dtype=torch.float32, device="cpu")
    pt = bridge.from_jax(jax.tree.map(np.asarray, pj))
    bt = bridge.batch_from_jax(jax.tree.map(np.asarray, batch))
    leaves, treedef = pytree.flatten(pt)
    leaves = [x.detach().requires_grad_() for x in leaves]
    loss, _ = api.loss(treedef.unflatten(leaves), bt)
    grads = treedef.unflatten(list(torch.autograd.grad(loss, leaves)))
    np.testing.assert_allclose(loss.item(), float(want), atol=1e-5,
                               rtol=1e-5)
    gl, wl = pytree.leaves(bridge.to_reference(grads)), jax.tree.leaves(gj)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-3, rtol=1e-3)
    other = dict(bt, labels=bt["labels"].clone())
    other["labels"][:, :cfg.num_patches] = 7
    with torch.no_grad():
        moved, _ = api.loss(pt, other)
    assert moved.item() != loss.item()      # label 7 counts there
    other["labels"][:, :cfg.num_patches] = -5
    with torch.no_grad():
        masked, _ = api.loss(pt, other)
    assert masked.item() == loss.item()     # any label < 0 is masked


def test_batches_bit_for_bit():
    cfg_j, cfg = _cfgs()
    sj = JShape(name="t", seq_len=32, global_batch=4, kind="train")
    st = ShapeConfig(name="t", seq_len=32, global_batch=4, kind="train")
    pj, pt = JPipe(cfg_j, sj, seed=3), SyntheticPipeline(cfg, st, seed=3)
    for i in (0, 5):
        bj, bt = pj.batch_at(i), pt.batch_at(i)
        assert sorted(bt) == sorted(bj) == ["labels", "patches", "tokens"]
        assert bt["patches"].shape == (4, cfg.num_patches, cfg.d_model)
        assert bt["tokens"].shape == (4, 32 - cfg.num_patches)
        assert (bt["labels"][:, :cfg.num_patches] == -1).all()
        assert (bt["labels"][:, cfg.num_patches:] >= 0).all()
        for k in bj:
            assert bt[k].dtype == bj[k].dtype
            np.testing.assert_array_equal(bt[k], bj[k])
    for k, a in jmake(cfg_j, sj, seed=5).items():
        got = make_train_batch(cfg, st, seed=5)[k]
        if k == "patches":
            got = torch.from_numpy(got).to(torch.bfloat16).float().numpy()
        np.testing.assert_array_equal(got, np.asarray(a, got.dtype))
    with pytest.raises(ValueError, match="no text"):
        SyntheticPipeline(cfg, ShapeConfig(name="t", seq_len=16,
                                           global_batch=4, kind="train"))


def test_cli_serves_in_both_modes(capsys):
    res = launch_serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                             "--batch", "2", "--prompt-len", "6", "--gen",
                             "3"])
    assert res["tokens"].shape == (2, 3)
    res = launch_serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                             "--continuous", "--num-requests", "3",
                             "--poisson-rate", "200", "--prompt-len", "8",
                             "--gen", "3", "--max-active", "2",
                             "--block-size", "4"])
    out = capsys.readouterr().out
    assert f"arch={ARCH} batch=2 prompt=6 gen=3 device=cpu" in out
    assert "served 3 requests" in out
    assert all(len(t) == 3 for t in res["generated"].values())


def test_two_ranks_tuned_equals_xla():
    """2 CPU ranks, 2 steps, fp32 compute, 16 patches + 16 tokens a row:
    the tuned sync's losses, step 0's synced gradients and final params
    equal the ``"xla"`` run's (1e-6), rank 0's gradients before the sync
    bit-equal, the replicas bit-identical after every step."""
    def run(argv):
        return train.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                           "--ranks", "2", "--topology", "2", "--seq", "32",
                           "--batch", "4", "--steps", "2", "--lr", "0.1",
                           *argv], keep_params=True,
                          parallel=ParallelConfig(compute_dtype="float32"))
    tuned = run(["--tuning-table",
                 os.path.join(ARTIFACTS, "hierarchical_decision.json")])
    xla = run(["--collective", "xla"])
    for r in (tuned, xla):
        assert r["replicas_equal_at_init"] and all(r["replicas_equal"])
    assert tuned["local_grads0_fingerprint"] == \
        xla["local_grads0_fingerprint"]
    np.testing.assert_allclose(tuned["losses"], xla["losses"], atol=1e-6,
                               rtol=1e-6)
    for g, w in zip(pytree.leaves(tuned["grads0"]) +
                    pytree.leaves(tuned["params"]),
                    pytree.leaves(xla["grads0"]) +
                    pytree.leaves(xla["params"])):
        np.testing.assert_allclose(_np(g), _np(w), atol=1e-6, rtol=1e-6)
