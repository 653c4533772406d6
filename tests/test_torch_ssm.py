"""The port's SSM and hybrid families (mamba2, zamba2) against the JAX package.

The same numpy inputs go through the JAX package and the port: the SSD
within-chunk pass (JAX's Pallas kernel in interpret mode, as
``tests/test_kernels.py`` runs it on the CPU, against the port's
``ssd_chunked_plain`` path) over the reference's sweep and tolerances;
``ssm_block`` in its three modes; whole-model prefill and decode through
the parameter bridge at fp32; the serving engine's tokens; and the CLI.
The CUDA kernel itself runs only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHITECTURES as JARCH  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro.serve import Scheduler as JScheduler  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro.serve import synthetic_trace as jsynthetic_trace  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import ARCHITECTURES  # noqa: E402
from repro_torch.kernels import ops, ref, ssd_scan  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.serve import Scheduler, ServeEngine, synthetic_trace  # noqa: E402

# the reference's SSD tolerances (tests/test_kernels.py), bf16 compared in fp32
SSD_TOL = {"float32": 5e-5, "bfloat16": 5e-2}
MODEL_TOL = 1e-4
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ARCHS = ["mamba2-130m", "zamba2-2.7b"]
BLOCK = 4

SWEEP = [                         # B, S, H, P, N, chunk
    (1, 64, 2, 64, 32, 32),       # tests/test_kernels.py's sweep
    (2, 128, 3, 64, 64, 32),
    (1, 128, 1, 32, 128, 64),
    (1, 6, 2, 64, 16, 6),         # Q = S = 6: one chunk, not a power of two
]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol=MODEL_TOL):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _tree_close(got, want, tol=MODEL_TOL):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _tree_close(got[k], want[k], tol)
    else:
        assert tuple(got.shape) == tuple(want.shape)
        _close(got, want, tol)


def _ssd_inputs(B, S, H, P, N, dtype, seed=0):
    """x, dt, A, B, C, D for both packages from one numpy draw; x, B and C
    are rounded to bf16 the same way (round-to-nearest-even) by each."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, H, P)).astype(np.float32)
    dt = rng.uniform(0.001, 0.1, (B, S, H)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, (H,)).astype(np.float32)
    Bm = rng.normal(size=(B, S, N)).astype(np.float32)
    Cm = rng.normal(size=(B, S, N)).astype(np.float32)
    D = rng.normal(size=(H,)).astype(np.float32)
    cast = (True, False, False, True, True, False)
    arrs = (x, dt, A, Bm, Cm, D)
    j = [jnp.asarray(a, JDT[dtype] if c else jnp.float32)
         for a, c in zip(arrs, cast)]
    t = [torch.from_numpy(a).to(TDT[dtype] if c else torch.float32)
         for a, c in zip(arrs, cast)]
    return j, t


# ---------------------------------------------------------------------------
# the SSD kernel module
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,P,N,chunk", SWEEP)
def test_ssd_plain_matches_pallas(dtype, B, S, H, P, N, chunk):
    j, t = _ssd_inputs(B, S, H, P, N, dtype)
    want_kernel = jops.ssd(*j, chunk=chunk, impl="interpret")
    want_ref = jref.ssd(*j)
    got = ops.ssd(*t, chunk=chunk, impl="auto")
    assert got.dtype == TDT[dtype] and got.shape == (B, S, H, P)
    _close(got, want_kernel, SSD_TOL[dtype])
    _close(got, want_ref, SSD_TOL[dtype])


@pytest.mark.parametrize("impl,jfn", [
    ("ref", jref.ssd),
    ("xla", lambda *a: jref.ssd_chunked(*a, chunk=32)),
])
def test_ssd_ops_plain_paths_match_jax(impl, jfn):
    j, t = _ssd_inputs(2, 128, 3, 64, 64, "float32", seed=1)
    _close(ops.ssd(*t, chunk=32, impl=impl), jfn(*j), SSD_TOL["float32"])


def test_ssd_chunked_plain_outputs_compose_to_the_decode_state():
    """The kernel's three outputs, checked on their own: ``cum`` is the
    within-chunk cumsum of dt*A, and the chunk states carried through the
    inter-chunk recurrence give the closed-form state after the whole
    sequence (the state ``ssm_block``'s prefill hands to decode)."""
    _, (x, dt, A, Bm, Cm, _) = _ssd_inputs(2, 96, 3, 32, 16, "float32", 2)
    y, states, cum = ssd_scan.ssd_chunked_plain(x, dt, A, Bm, Cm, chunk=32)
    assert y.shape == (2, 3, 3, 32, 32) and states.shape == (2, 3, 3, 16, 32)
    want_cum = torch.cumsum((dt * A).reshape(2, 3, 32, 3), dim=2)
    _close(cum, want_cum.permute(0, 3, 1, 2), 1e-6)
    state = torch.zeros((2, 3, 16, 32))
    for c in range(3):
        state = state * torch.exp(cum[:, :, c, -1])[..., None, None] \
            + states[:, :, c]
    run = torch.cumsum(dt, dim=1)
    decay = torch.exp((run[:, -1:] - run) * A)
    want = torch.einsum("bsh,bsn,bshp->bhnp", dt * decay, Bm, x)
    _close(state, want, 1e-5)


def test_ssd_rejects_a_ragged_chunk():
    _, t = _ssd_inputs(1, 100, 2, 64, 16, "float32")
    for fn in (ssd_scan.ssd_chunked, ref.ssd_chunked):
        with pytest.raises(ValueError, match="not divisible"):
            fn(*t, chunk=32)


def test_cpu_tensors_never_count_a_launch_and_other_devices_raise():
    _, t = _ssd_inputs(1, 32, 2, 64, 16, "bfloat16")
    before = ssd_scan.launches
    ops.ssd(*t, chunk=32, impl="auto")
    assert ssd_scan.launches == before == 0
    # meta tensors take the accounting's meta path: the kernel's outputs,
    # no launch; tensors on two devices raise
    meta = [a.to("meta") for a in t[:5]]
    y, states, cum = ssd_scan.ssd_chunk(*meta, chunk=32)
    assert y.device.type == "meta" and ssd_scan.launches == 0
    assert y.shape == ssd_scan.ssd_chunked_plain(*t[:5], chunk=32)[0].shape
    with pytest.raises(ValueError, match="one device"):
        ssd_scan.ssd_chunk(*meta[:4], t[4], chunk=32)
    with pytest.raises(ValueError, match="unknown ssd impl"):
        ops.ssd(*t, chunk=32, impl="pallas")


# ---------------------------------------------------------------------------
# the mamba2 block and the two models, through the bridge
# ---------------------------------------------------------------------------
def _cfgs(arch):
    return JARCH[arch].reduced(), ARCHITECTURES[arch].reduced()


def _jax_params(cfg_j, seed=0):
    """The JAX package's init, as numpy, with the conv, biases, skip and
    norm scales moved off their constant init so those paths count."""
    api = jbuild(cfg_j, compute_dtype=jnp.float32, attn_impl="xla",
                 ssd_impl="xla")
    pn = jax.tree.map(np.asarray, api.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def jitter(tree, name, scale, base):
        a = tree[name]
        tree[name] = (base + scale * rng.normal(size=a.shape)).astype(
            np.float32)

    sp = pn["layers"]["ssm"]
    jitter(sp, "conv_w", 0.2, sp["conv_w"])
    for name, scale, base in (("conv_b", 0.1, 0.0), ("dt_bias", 0.5, 0.0),
                              ("D", 0.1, 1.0), ("norm", 0.1, 1.0)):
        jitter(sp, name, scale, base)
    jitter(pn["layers"], "ln", 0.1, 1.0)
    jitter(pn["embed"], "final_norm", 0.1, 1.0)
    if "shared" in pn:
        for name in ("ln1", "ln2"):
            jitter(pn["shared"], name, 0.1, 1.0)
    return pn


def _layer0(pn):
    return {k: v[0] for k, v in pn["layers"]["ssm"].items()}


@pytest.mark.parametrize("mode", ["sequence", "prefill", "decode"])
def test_ssm_block_matches_jax(mode):
    cfg_j, cfg = _cfgs("mamba2-130m")
    p0 = _layer0(_jax_params(cfg_j))
    rng = np.random.default_rng(3)
    S = 1 if mode == "decode" else 64        # 64 = two chunks of 32
    x = rng.normal(size=(2, S, cfg.d_model)).astype(np.float32)
    kw_j = dict(compute_dtype=jnp.float32, ssd_impl="xla")
    kw_t = dict(compute_dtype=torch.float32, ssd_impl="auto")
    if mode == "prefill":
        kw_j["return_state"] = kw_t["return_state"] = True
    if mode == "decode":
        conv = rng.normal(size=(2, cfg.d_conv - 1, ssm.conv_dim(cfg)))
        st = rng.normal(size=(2, cfg.ssm_heads, cfg.ssm_state,
                              cfg.ssm_head_dim)).astype(np.float32)
        kw_j["state"] = {"conv": jnp.asarray(conv, jnp.bfloat16),
                         "ssd": jnp.asarray(st)}
        kw_t["state"] = {"conv": torch.from_numpy(conv).to(torch.bfloat16),
                         "ssd": torch.from_numpy(st)}
    want, wstate = jssm.ssm_block(jnp.asarray(x), jax.tree.map(
        jnp.asarray, p0), cfg_j, **kw_j)
    got, gstate = ssm.ssm_block(torch.from_numpy(x), {
        k: torch.from_numpy(np.array(v)) for k, v in p0.items()}, cfg, **kw_t)
    _close(got, want)
    assert (gstate is None) == (wstate is None)
    if wstate is not None:
        _tree_close(gstate, wstate)
        assert gstate["conv"].dtype == TDT[str(wstate["conv"].dtype)]


def _run_both(arch, *, steps=6, S=64, B=2):
    """Prefill (two chunks) and greedy decode through both packages at
    fp32, with the JAX params through the bridge."""
    cfg_j, cfg = _cfgs(arch)
    pn = _jax_params(cfg_j)
    japi = jbuild(cfg_j, compute_dtype=jnp.float32, attn_impl="xla",
                  ssd_impl="xla")
    api = build_model(cfg, compute_dtype=torch.float32, device="cpu")
    jparams = jax.tree.map(jnp.asarray, pn)
    params = bridge.from_jax(pn)
    prompt = np.random.default_rng(7).integers(0, cfg.vocab_size, (B, S))
    jl, jc = japi.prefill(jparams, jnp.asarray(prompt, jnp.int32), S + steps)
    tl, tc = api.prefill(params, torch.from_numpy(prompt), S + steps)
    _tree_close(tc, jax.tree.map(np.asarray, jc))
    out = [(tl, jl)]
    jstep = jax.jit(japi.decode_step)
    jtok = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)[:, None]
    ttok = torch.argmax(tl[:, -1], -1)[:, None]
    for _ in range(steps):
        assert ttok.numpy().tolist() == np.asarray(jtok).tolist()
        jl, jc = jstep(jparams, jc, jtok)
        tl, tc = api.decode_step(params, tc, ttok)
        out.append((tl, jl))
        jtok = jnp.argmax(jl, -1).astype(jnp.int32)[:, None]
        ttok = torch.argmax(tl, -1)[:, None]
    _tree_close({k: v for k, v in tc.items() if k != "length"},
                {k: np.asarray(v) if not isinstance(v, dict) else
                 jax.tree.map(np.asarray, v)
                 for k, v in jc.items() if k != "length"})
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax_fp32(arch):
    for tl, jl in _run_both(arch):
        _close(tl, jl)


def test_hybrid_batched_decode_per_row_lengths_equals_single_rows():
    """The port's design change: one batched decode with per-row lengths
    in place of the reference's vmap over batch-1 requests."""
    _, cfg = _cfgs("zamba2-2.7b")
    api = build_model(cfg, compute_dtype=torch.float32, device="cpu")
    with torch.inference_mode():
        params = api.init(torch.Generator().manual_seed(0))
        rng = np.random.default_rng(8)
        caches, toks = [], []
        for n in (5, 9, 3):
            prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, n)))
            logits, cache = api.prefill(params, prompt, 16)
            caches.append(cache)
            toks.append(int(torch.argmax(logits[0, -1])))
        batched = {
            "ssm": {n: torch.cat([c["ssm"][n] for c in caches], dim=1)
                    for n in ("conv", "ssd")},
            "k": torch.cat([c["k"] for c in caches], dim=1),
            "v": torch.cat([c["v"] for c in caches], dim=1),
            "length": torch.tensor([5, 9, 3])}
        tok = torch.tensor(toks)[:, None]
        for _ in range(3):
            bl, batched = api.decode_step(params, batched, tok)
            for b, c in enumerate(caches):
                sl, caches[b] = api.decode_step(params, c, tok[b:b + 1])
                _close(bl[b], sl[0])
                _close(batched["ssm"]["ssd"][:, b],
                       caches[b]["ssm"]["ssd"][:, 0])
                _close(batched["k"][:, b], caches[b]["k"][:, 0])
            tok = torch.argmax(bl, -1)[:, None]


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_round_trip(arch):
    cfg_j, cfg = _cfgs(arch)
    pn = _jax_params(cfg_j)
    params = bridge.from_jax(pn)
    assert len(params["layers"]) == cfg.num_layers
    assert set(params) == set(pn)
    back = jax.tree.map(lambda *a: np.stack([_np(t) for t in a]),
                        *params["layers"])
    for name, tree in (("layers", back), ("embed", params["embed"]),
                       ("shared", params.get("shared"))):
        if tree is None:
            assert "shared" not in pn
            continue
        flat_got = jax.tree_util.tree_leaves_with_path(
            jax.tree.map(_np, tree))
        flat_want = jax.tree_util.tree_leaves_with_path(pn[name])
        assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
        for (_, g), (_, w) in zip(flat_got, flat_want):
            np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# the serving engine and the CLI
# ---------------------------------------------------------------------------
def _engine_tokens(api, params, trace, *, max_active, view_len):
    engine = ServeEngine(api, params, max_active=max_active,
                         view_len=view_len, block_size=BLOCK)
    sched = Scheduler(trace, max_active=max_active,
                      token_budget=max_active * view_len)
    engine.run(sched, cost_model=lambda kind, n: 1e-3)
    assert len(sched.finished) == len(trace)
    return engine, {r.rid: list(r.generated) for r in sched.finished}


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_match_jax_engine_fp32(arch):
    """Same params (through the bridge), same trace, same simulated clock:
    the port's engine and the JAX package's engine emit the same tokens.
    The SSM state is per-request opaque state in both; the hybrid's
    attention k/v are paged."""
    cfg_j, cfg = _cfgs(arch)
    pn = _jax_params(cfg_j)
    japi = jbuild(cfg_j, compute_dtype=jnp.float32, attn_impl="xla",
                  ssd_impl="xla")
    trace_kw = dict(rate_rps=500.0, vocab=cfg_j.vocab_size,
                    prompt_lens=(4, 6), max_new=6, seed=0)
    view_len = 12

    jengine = JServeEngine(japi, jax.tree.map(jnp.asarray, pn), max_active=2,
                           view_len=view_len, block_size=BLOCK)
    jsched = JScheduler(jsynthetic_trace(5, **trace_kw), max_active=2,
                        token_budget=2 * view_len)
    with warnings.catch_warnings():
        # the reference scatters f32 k/v into its bf16 pool implicitly
        warnings.filterwarnings("ignore", category=FutureWarning,
                                message=".*scatter.*")
        jengine.run(jsched, cost_model=lambda kind, n: 1e-3)
    want = {r.rid: list(r.generated) for r in jsched.finished}

    api = build_model(cfg, compute_dtype=torch.float32, device="cpu")
    engine, got = _engine_tokens(api, bridge.from_jax(pn),
                                 synthetic_trace(5, **trace_kw),
                                 max_active=2, view_len=view_len)
    assert len(want) == 5 and got == want
    assert (engine.paged is None) == (cfg.family == "ssm")
    conv = (engine.opaque["conv"] if cfg.family == "ssm"
            else engine.opaque["ssm"]["conv"])
    assert conv.shape[:2] == (cfg.num_layers, 2)


@pytest.mark.parametrize("mode", ["fixed", "continuous"])
def test_cli_mamba2(mode, capsys):
    argv = ["--arch", "mamba2-130m", "--device", "cpu", "--reduced",
            "--prompt-len", "8", "--gen", "3"]
    if mode == "fixed":
        res = launch_serve.main(argv + ["--batch", "2"])
        assert res["tokens"].shape == (2, 3)
        assert "arch=mamba2-130m batch=2 prompt=8 gen=3 device=cpu" in \
            capsys.readouterr().out
    else:
        res = launch_serve.main(argv + [
            "--continuous", "--num-requests", "3", "--poisson-rate", "200",
            "--max-active", "2", "--block-size", "4", "--slo-ms", "5000"])
        out = capsys.readouterr().out
        assert "served 3 requests, 9 tokens" in out
        assert "SLO p99 <= 5000 ms: met" in out
        assert all(len(t) == 3 for t in res["generated"].values())


def test_cli_zamba2_fixed(capsys):
    res = launch_serve.main(["--arch", "zamba2-2.7b", "--device", "cpu",
                             "--reduced", "--batch", "2", "--prompt-len", "64",
                             "--gen", "2"])
    assert res["tokens"].shape == (2, 2)
    assert "arch=zamba2-2.7b" in capsys.readouterr().out


@pytest.mark.parametrize("mode", ["fixed", "continuous"])
def test_cli_prompt_longer_than_chunk_must_be_a_multiple(mode):
    # reduced chunk is 32: 40 is longer and not a multiple
    argv = ["--arch", "mamba2-130m", "--device", "cpu", "--reduced",
            "--prompt-len", "40", "--gen", "2"]
    if mode == "continuous":
        argv += ["--continuous", "--num-requests", "2"]
    with pytest.raises(ValueError, match="multiple of it"):
        launch_serve.main(argv)
