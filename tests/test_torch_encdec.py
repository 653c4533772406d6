"""The port's enc-dec family (whisper-large-v3, reduced: 2 + 2 layers,
d 256, 64 frames) against the JAX package's.

The reference's params (numpy, LayerNorm scales and biases moved off
their init) go into the port through ``repro_torch.bridge``; the same
numpy frames and tokens go through both. Held: ``encode``,
``decode_train``, ``prime_cross``, ``prefill`` (logits and every cache
leaf) and eight greedy ``decode_step``s at fp32 (2e-5) and bf16 (2e-2 of
the largest value; the port teacher-forced on the reference's tokens);
the loss (1e-5) and every leaf's gradient (1e-3) against
``jax.value_and_grad``; the port's own decode against its
teacher-forced logits, per-row lengths against scalar calls; the
synthetic batches bit for bit; the bridge and checkpoint round trips of
the two stacks; the serving CLI in both modes, its engine's tokens
against the reference engine's; two ``gloo`` ranks, tuned equal to
``"xla"``, and the backward-overlapped sync, whose release points key
each stack by its own name, equal to the plain one.
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
from repro.models import encdec as jencdec  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro.models.registry import make_train_batch as jmake  # noqa: E402
from repro_torch import bridge, pytree  # noqa: E402
from repro_torch.checkpoint import restore, save  # noqa: E402
from repro_torch.configs import ARCHITECTURES, ParallelConfig, ShapeConfig  # noqa: E402,E501
from repro_torch.data import SyntheticPipeline  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import encdec  # noqa: E402
from repro_torch.models.registry import build_model, make_train_batch  # noqa: E402,E501
from repro_torch.optim import AdamW  # noqa: E402

ARCH = "whisper-large-v3"
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


def _jax_params(cfg_j, seed=0):
    """The reference's init as numpy, every LayerNorm's scale and bias
    moved off 1 and 0 so that they count."""
    api = jbuild(cfg_j, compute_dtype=jnp.float32, attn_impl="ref")
    pn = jax.tree.map(np.asarray, api.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for stack, names in (("encoder", ("ln1", "ln2")),
                         ("decoder", ("ln1", "ln2", "ln3"))):
        for n in names:
            for k, a in pn[stack][n].items():
                pn[stack][n][k] = ((k == "scale") + 0.1 * rng.normal(
                    size=a.shape)).astype(np.float32)
    return pn


@pytest.fixture(scope="module")
def model():
    cfg_j, cfg = _cfgs()
    pn = _jax_params(cfg_j)
    rng = np.random.default_rng(1)
    audio = rng.normal(size=(2, cfg.encoder_seq, cfg.d_model)).astype(
        np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (2, 10))
    return cfg_j, cfg, pn, audio, tokens


def _apis(cfg_j, cfg, dtype, attn_impl="auto"):
    return (jbuild(cfg_j, compute_dtype=JDT[dtype], attn_impl="xla"),
            build_model(cfg, compute_dtype=TDT[dtype], device="cpu",
                        attn_impl=attn_impl))


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_decode_train_and_prime_cross(model, dtype):
    cfg_j, cfg, pn, audio, tokens = model
    jp, tp = jax.tree.map(jnp.asarray, pn), bridge.from_jax(pn)
    ja, ta = jnp.asarray(audio), torch.from_numpy(audio)
    jdt, tdt = JDT[dtype], TDT[dtype]
    want = jencdec.encode(jp, ja, cfg_j, compute_dtype=jdt, attn_impl="xla")
    got = encdec.encode(tp, ta, cfg, compute_dtype=tdt)
    _close(got, want, dtype)
    hj = jencdec.decode_train(jp, jnp.asarray(tokens, jnp.int32), want,
                              cfg_j, compute_dtype=jdt, attn_impl="xla")
    ht = encdec.decode_train(tp, torch.from_numpy(tokens), got, cfg,
                             compute_dtype=tdt)
    _close(ht, hj, dtype)
    cj = jencdec.prime_cross(jp, ja, cfg_j, jencdec.init_cache(cfg_j, 2, 16),
                             compute_dtype=jdt, attn_impl="xla")
    ct = encdec.prime_cross(tp, ta, cfg, encdec.init_cache(cfg, 2, 16),
                            compute_dtype=tdt)
    for k in ("xk", "xv"):
        assert ct[k].dtype == torch.bfloat16
        assert ct[k].shape == (cfg.num_layers, 2, cfg.encoder_seq,
                               cfg.num_heads, cfg.resolved_head_dim)
        _close(ct[k], cj[k], "bfloat16")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_cache_and_greedy_decode(model, dtype):
    """Prefill (logits, k, v, xk, xv, length) and 8 greedy decode steps;
    at bf16 the port decodes the reference's tokens."""
    cfg_j, cfg, pn, audio, tokens = model
    japi, api = _apis(cfg_j, cfg, dtype)
    jp, tp = jax.tree.map(jnp.asarray, pn), bridge.from_jax(pn)
    jl, jc = japi.prefill(jp, jnp.asarray(tokens, jnp.int32), 24,
                          audio=jnp.asarray(audio, jnp.bfloat16))
    tl, tc = api.prefill(tp, torch.from_numpy(tokens), 24,
                         audio=torch.from_numpy(audio).to(torch.bfloat16))
    _close(tl, jl, dtype)
    assert sorted(tc) == sorted(jc)
    for k in ("k", "v", "xk", "xv"):
        assert tc[k].shape == jc[k].shape and tc[k].dtype == (
            TDT[dtype] if k in ("k", "v") else torch.bfloat16)
        # the cross KV is bf16 in both: a bf16 ulp apart at most
        _close(tc[k], jc[k], dtype if k in ("k", "v") else "bfloat16")
    assert int(tc["length"]) == int(jc["length"]) == 10
    # the decode starts from the reference's cache: a bf16 cross KV entry
    # a rounding apart moves the fp32 logits by ~2e-4, so each side's
    # own cache would hold the steps to their inputs, not their algebra
    tc = {k: torch.from_numpy(np.asarray(v, np.float32)).to(tc[k].dtype)
          for k, v in jc.items()}
    jstep = jax.jit(japi.decode_step)
    jtok = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)[:, None]
    ttok = torch.argmax(tl[:, -1], -1)[:, None]
    for _ in range(8):
        if dtype == "bfloat16":
            ttok = torch.from_numpy(np.asarray(jtok, np.int64))
        assert ttok.numpy().tolist() == np.asarray(jtok).tolist()
        jl, jc = jstep(jp, jc, jtok)
        tl, tc = api.decode_step(tp, tc, ttok)
        _close(tl, jl, dtype)
        jtok = jnp.argmax(jl, -1).astype(jnp.int32)[:, None]
        ttok = torch.argmax(tl, -1)[:, None]
    assert int(tc["length"]) == 18


def test_decode_matches_teacher_forcing():
    """The port alone (``tests/test_decode_consistency.py``'s check): the
    decode from a primed cache gives, token by token, the logits of the
    teacher-forced decoder over the whole sequence."""
    _, cfg = _cfgs()
    api = build_model(cfg, compute_dtype=torch.float32, device="cpu",
                      attn_impl="ref")
    with torch.no_grad():
        params = api.init(torch.Generator().manual_seed(0))
        g = torch.Generator().manual_seed(1)
        audio = torch.randn((1, cfg.encoder_seq, cfg.d_model), generator=g)
        tokens = torch.randint(0, cfg.vocab_size, (1, 8), generator=g)
        enc = encdec.encode(params, audio, cfg, compute_dtype=torch.float32,
                            attn_impl="ref")
        h = encdec.decode_train(params, tokens, enc, cfg,
                                compute_dtype=torch.float32, attn_impl="ref")
        full = encdec.T.logits_fn(params, h, cfg, torch.float32)
        cache = encdec.init_cache(cfg, 1, 8, dtype=torch.float32)
        cache = encdec.prime_cross(params, audio, cfg, cache,
                                   compute_dtype=torch.float32,
                                   attn_impl="ref")
        for i in range(8):
            logits, cache = api.decode_step(params, cache, tokens[:, i:i + 1])
            np.testing.assert_allclose(logits.numpy(), full[:, i].numpy(),
                                       atol=5e-3, rtol=5e-3,
                                       err_msg=f"pos {i}")


def test_per_row_lengths_index_their_own_positions():
    """A batched decode over rows at lengths 5, 9 and 3 (each its own
    learned position and cache slot) equals each row's scalar-length
    decode."""
    _, cfg = _cfgs()
    api = build_model(cfg, compute_dtype=torch.float32, device="cpu")
    with torch.inference_mode():
        params = api.init(torch.Generator().manual_seed(0))
        rng = np.random.default_rng(8)
        caches, toks = [], []
        for n in (5, 9, 3):
            prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, n)))
            audio = torch.from_numpy(rng.normal(
                size=(1, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
            logits, cache = api.prefill(params, prompt, 16, audio=audio)
            caches.append(cache)
            toks.append(int(torch.argmax(logits[0, -1])))
        batched = {k: torch.cat([c[k] for c in caches], dim=1)
                   for k in ("k", "v", "xk", "xv")}
        batched["length"] = torch.tensor([5, 9, 3])
        tok = torch.tensor(toks)[:, None]
        for _ in range(3):
            bl, batched = api.decode_step(params, batched, tok)
            for b, c in enumerate(caches):
                sl, caches[b] = api.decode_step(params, c, tok[b:b + 1])
                np.testing.assert_allclose(bl[b].numpy(), sl[0].numpy(),
                                           atol=1e-5, rtol=1e-5)
            tok = torch.argmax(bl, -1)[:, None]


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
def _grads(api, params, batch):
    leaves, treedef = pytree.flatten(params)
    leaves = [x.detach().requires_grad_() for x in leaves]
    loss, _ = api.loss(treedef.unflatten(leaves), batch)
    return loss, treedef.unflatten(list(torch.autograd.grad(loss, leaves)))


def test_loss_and_gradients_match():
    """fp32: the loss within 1e-5 and every leaf's gradient within 1e-3 of
    ``jax.value_and_grad`` of the reference's loss; ``remat`` bit-equal."""
    cfg_j, cfg = _cfgs(vocab_size=256)
    shape = JShape(name="t", seq_len=16, global_batch=2, kind="train")
    japi = jbuild(cfg_j, compute_dtype=jnp.float32, attn_impl="ref")
    pj = jax.tree.map(jnp.asarray, _jax_params(cfg_j))
    batch = jmake(cfg_j, shape, seed=2)
    (want, _), gj = jax.jit(jax.value_and_grad(japi.loss, has_aux=True))(
        pj, batch)
    pt = bridge.from_jax(jax.tree.map(np.asarray, pj))
    bt = bridge.batch_from_jax(jax.tree.map(np.asarray, batch))
    runs = [_grads(build_model(cfg, compute_dtype=torch.float32,
                               device="cpu", remat=remat), pt, bt)
            for remat in (False, True)]
    (got, gt), (got_r, gt_r) = runs
    np.testing.assert_allclose(got.item(), float(want), atol=1e-5, rtol=1e-5)
    gl, wl = pytree.leaves(bridge.to_reference(gt)), jax.tree.leaves(gj)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-3, rtol=1e-3)
    assert got_r.item() == got.item()
    assert all(torch.equal(a, b) for a, b in zip(pytree.leaves(gt_r),
                                                 pytree.leaves(gt)))


def test_batches_bit_for_bit():
    cfg_j, cfg = _cfgs()
    sj = JShape(name="t", seq_len=32, global_batch=4, kind="train")
    st = ShapeConfig(name="t", seq_len=32, global_batch=4, kind="train")
    pj, pt = JPipe(cfg_j, sj, seed=3), SyntheticPipeline(cfg, st, seed=3)
    for i in (0, 5):
        bj, bt = pj.batch_at(i), pt.batch_at(i)
        assert sorted(bt) == sorted(bj) == ["audio", "labels", "tokens"]
        assert bt["audio"].shape == (4, cfg.encoder_seq, cfg.d_model)
        for k in bj:
            assert bt[k].dtype == bj[k].dtype
            np.testing.assert_array_equal(bt[k], bj[k])
    # make_train_batch: the reference's draws (its frames bf16, the
    # port's float32 until they cross to the device)
    for k, a in jmake(cfg_j, sj, seed=5).items():
        got = make_train_batch(cfg, st, seed=5)[k]
        if k == "audio":
            got = torch.from_numpy(got).to(torch.bfloat16).float().numpy()
        np.testing.assert_array_equal(got, np.asarray(a, got.dtype))


def test_bridge_and_checkpoint_round_trip(model, tmp_path):
    """The two stacks (and ``enc_pos``, ``enc_final``, ``embed.pos``) cross
    both ways bit for bit, the optimizer state too, and a checkpoint of
    the port's tree restores bit-equal."""
    cfg_j, cfg, pn, _, _ = model
    tp = bridge.from_jax(pn)
    assert len(tp["encoder"]) == cfg.encoder_layers
    assert len(tp["decoder"]) == cfg.num_layers
    assert tp["embed"]["pos"].shape == (cfg.max_positions, cfg.d_model)
    back = bridge.to_reference(tp)
    wl = jax.tree.leaves(pn)
    assert len(pytree.leaves(back)) == len(wl)
    for g, w in zip(pytree.leaves(back), wl):
        np.testing.assert_array_equal(g, w)
    from repro.optim import AdamW as JAdamW
    sj = jax.tree.map(np.asarray, JAdamW().init(jax.tree.map(jnp.asarray,
                                                             pn)))
    st = bridge.opt_state_from_jax(sj)
    assert len(st.mu["decoder"]) == cfg.num_layers
    save(str(tmp_path / "ck"), {"params": tp, "opt": st}, step=3)
    restored, step, _ = restore(str(tmp_path / "ck"),
                                {"params": tp, "opt": AdamW().init(tp)})
    assert step == 3
    for a, b in zip(pytree.leaves(restored), pytree.leaves({"params": tp,
                                                           "opt": st})):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
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
    assert sorted(res["generated"]) == [0, 1, 2]
    assert all(len(t) == 3 for t in res["generated"].values())


def test_fixed_cli_tokens_match_the_reference_prefill_and_decode():
    """The fixed path's frames come from the prompt's generator, after the
    prompt, as the reference's do: the port's fp32 tokens equal a
    reference decode of the same prompt, frames and params."""
    cfg_j, cfg = _cfgs()
    api = build_model(cfg, compute_dtype=torch.float32, device="cpu")
    params = api.init(torch.Generator(device="cpu").manual_seed(0))
    res = launch_serve._serve_fixed(
        launch_serve.parse_args(["--arch", ARCH, "--reduced", "--device",
                                 "cpu", "--batch", "2", "--prompt-len", "6",
                                 "--gen", "4"]), cfg, api, params)
    japi = jbuild(cfg_j, compute_dtype=jnp.float32, attn_impl="xla")
    jp = jax.tree.map(jnp.asarray, bridge.to_reference(params))
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size, (2, 6))
    audio = rng.normal(size=(2, cfg.encoder_seq, cfg.d_model))
    jl, jc = japi.prefill(jp, jnp.asarray(prompt, jnp.int32), 10,
                          audio=jnp.asarray(audio, jnp.bfloat16))
    tok = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)[:, None]
    want = []
    for _ in range(4):
        want.append(np.asarray(tok)[:, 0])
        jl, jc = japi.decode_step(jp, jc, tok)
        tok = jnp.argmax(jl, -1).astype(jnp.int32)[:, None]
    np.testing.assert_array_equal(res["tokens"], np.stack(want, 1))


# ---------------------------------------------------------------------------
# data-parallel ranks through the launcher
# ---------------------------------------------------------------------------
def _train(argv):
    return train.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--ranks", "2", "--topology", "2", "--seq", "16",
                       "--batch", "4", "--steps", "2", "--lr", "0.1", *argv],
                      keep_params=True,
                      parallel=ParallelConfig(compute_dtype="float32"))


def _close_trees(got, want, tol):
    for g, w in zip(pytree.leaves(got), pytree.leaves(want)):
        np.testing.assert_allclose(_np(g), _np(w), atol=tol, rtol=tol)


def test_two_ranks_tuned_equals_xla_and_overlap_equals_plain():
    """2 CPU ranks, 2 steps, fp32 compute: the tuned sync equals
    ``"xla"`` (losses, step 0's synced gradients, final params at 1e-6;
    rank 0's gradients before the sync bit-equal); the
    backward-overlapped tuned sync (releases ``("decoder", 1)`` ...
    ``("encoder", 0)`` on the sync thread) equals the plain tuned one at
    1e-6 and syncs every layer once: its gradients are averaged, not
    summed, over the ranks."""
    table = ["--tuning-table", os.path.join(ARTIFACTS,
                                            "hierarchical_decision.json")]
    tuned = _train(table)
    xla = _train(["--collective", "xla"])
    over = _train([*table, "--overlap-backward"])
    for r in (tuned, xla, over):
        assert r["replicas_equal_at_init"] and all(r["replicas_equal"])
    assert tuned["tuned"] and not xla["tuned"]
    assert tuned["local_grads0_fingerprint"] == \
        xla["local_grads0_fingerprint"] == over["local_grads0_fingerprint"]
    for r in (xla, over):
        np.testing.assert_allclose(r["losses"], tuned["losses"], atol=1e-6,
                                   rtol=1e-6)
        _close_trees(r["grads0"], tuned["grads0"], 1e-6)
        _close_trees(r["params"], tuned["params"], 1e-6)
    # backward order: the decoder's layers, then the encoder's (releases
    # are indices; every rank and step the same)
    assert over["release_events"] == [[[1, 0, 1, 0]] * 2] * 2
