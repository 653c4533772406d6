"""The port's layers and dense model against the JAX package.

Layer-level parity at fp32 on the same numpy inputs, then whole-model
parity through the parameter bridge: the JAX package's params (numpy)
go into the port, and prefill + greedy decode logits are compared at
fp32 (1e-4, tokens equal) and at bf16 (2e-2 of the largest logit).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHITECTURES as JARCH  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import ARCHITECTURES  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402

TOL = 1e-5


def _cfgs(arch, **kw):
    return JARCH[arch].reduced().replace(**kw), \
        ARCHITECTURES[arch].reduced().replace(**kw)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _both(a):
    """One numpy array as a JAX array and a torch tensor."""
    return jnp.asarray(a), torch.from_numpy(np.array(a))


def _jp(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _tp(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def _jax_params(cfg_j, seed=0):
    """The JAX package's init, as numpy, with the biases and norm scales
    moved off their zero/one init so that those paths are exercised."""
    api = jbuild(cfg_j, compute_dtype=jnp.float32, attn_impl="xla")
    pn = jax.tree.map(np.asarray, api.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for name in ("bq", "bk", "bv"):
        if name in pn["layers"]["attn"]:
            a = pn["layers"]["attn"][name]
            pn["layers"]["attn"][name] = (0.1 * rng.normal(size=a.shape)
                                          ).astype(np.float32)
    for tree, name in ((pn["layers"], "ln1"), (pn["layers"], "ln2"),
                       (pn["embed"], "final_norm")):
        a = tree[name]
        tree[name] = (1 + 0.1 * rng.normal(size=a.shape)).astype(np.float32)
    return pn


def _layer0(pn, name):
    """Layer 0's slice of a stacked JAX leaf group, as numpy."""
    return {k: v[0] for k, v in pn["layers"][name].items()}


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("norm", ["rms_norm", "layer_norm"])
def test_norms(norm):
    rng = np.random.default_rng(0)
    jx, x = _both((3 + rng.normal(size=(2, 5, 256))).astype(np.float32))
    args = [_both(rng.normal(size=(256,)).astype(np.float32))
            for _ in range(1 if norm == "rms_norm" else 2)]
    got = getattr(L, norm)(x, *[a[1] for a in args], 1e-5)
    want = getattr(JL, norm)(jx, *[a[0] for a in args], 1e-5)
    _close(got, want)


@pytest.mark.parametrize("rotary_pct", [1.0, 0.5])
@pytest.mark.parametrize("per_row", [False, True])
def test_apply_rope(rotary_pct, per_row):
    rng = np.random.default_rng(1)
    jx, x = _both(rng.normal(size=(2, 7, 4, 64)).astype(np.float32))
    pos = np.arange(7) + 3
    if per_row:
        pos = np.stack([pos, pos + 40])
    jp, p = _both(pos)
    got = L.apply_rope(x, p, rotary_pct=rotary_pct, theta=10000.0)
    want = JL.apply_rope(jx, jp, rotary_pct=rotary_pct, theta=10000.0)
    _close(got, want)
    if rotary_pct < 1:                      # the unrotated half is untouched
        assert torch.equal(got[..., 32:], x[..., 32:])


def test_ring_slot_positions():
    for length in range(0, 20):
        _close(L.ring_slot_positions(torch.tensor(length), 8),
               JL.ring_slot_positions(jnp.int32(length), 8), 0)
    lens = np.array([0, 3, 8, 13])
    got = L.ring_slot_positions(torch.from_numpy(lens), 8)
    for b, n in enumerate(lens):
        _close(got[b], JL.ring_slot_positions(jnp.int32(n), 8), 0)


@pytest.mark.parametrize("arch", ["smollm-135m", "chatglm3-6b"])
@pytest.mark.parametrize("window", [0, 5])
def test_attention_block_prefill(arch, window):
    cfg_j, cfg = _cfgs(arch)
    p_np = _layer0(_jax_params(cfg_j), "attn")
    rng = np.random.default_rng(2)
    jx, x = _both(rng.normal(size=(2, 12, cfg.d_model)).astype(np.float32))
    jpos, pos = _both(np.arange(12))
    want, wkv = JL.attention_block(
        jx, _jp(p_np), cfg_j, jpos,
        window=window, return_kv=True, compute_dtype=jnp.float32,
        attn_impl="ref")
    got, gkv = L.attention_block(
        x, _tp(p_np), cfg, pos,
        window=window, return_kv=True, compute_dtype=torch.float32,
        attn_impl="auto")
    _close(got, want)
    _close(gkv["k"], wkv["k"])
    _close(gkv["v"], wkv["v"])


@pytest.mark.parametrize("window", [0, 5])
def test_attention_block_decode_ring_wrap(window):
    """Decode into a T=8 ring that has wrapped (11 tokens written): the
    new token lands in slot 11 % 8 and attends the live window."""
    cfg_j, cfg = _cfgs("chatglm3-6b")
    p_np = _layer0(_jax_params(cfg_j), "attn")
    rng = np.random.default_rng(3)
    B, T, KV, Dh = 2, 8, cfg.num_kv_heads, cfg.resolved_head_dim
    jx, x = _both(rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32))
    jk, ck = _both(rng.normal(size=(B, T, KV, Dh)).astype(np.float32))
    jv, cv = _both(rng.normal(size=(B, T, KV, Dh)).astype(np.float32))
    jpos, pos = _both(np.array([11]))
    want, wkv = JL.attention_block(
        jx, _jp(p_np), cfg_j, jpos,
        window=window, kv_cache={"k": jk, "v": jv, "length": jnp.int32(11)},
        compute_dtype=jnp.float32)
    got, gkv = L.attention_block(
        x, _tp(p_np), cfg, pos,
        window=window, kv_cache={"k": ck, "v": cv, "length": 11},
        compute_dtype=torch.float32)
    _close(got, want)
    _close(gkv["k"], wkv["k"])
    _close(gkv["v"], wkv["v"])
    assert int(gkv["length"]) == int(wkv["length"]) == 12


@pytest.mark.parametrize("cache_dtype,tol", [("float32", TOL),
                                             ("bfloat16", 2e-2)])
def test_cache_attention(cache_dtype, tol):
    rng = np.random.default_rng(4)
    jq, q = _both(rng.normal(size=(2, 1, 4, 64)).astype(np.float32))
    kn = rng.normal(size=(2, 8, 2, 64)).astype(np.float32)
    vn = rng.normal(size=(2, 8, 2, 64)).astype(np.float32)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[cache_dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[cache_dtype]
    slot_j = JL.ring_slot_positions(jnp.int32(13), 8)
    slot_t = L.ring_slot_positions(torch.tensor(13), 8)
    for window in (0, 3):
        want = JL.cache_attention(jq, jnp.asarray(kn, jdt),
                                  jnp.asarray(vn, jdt), jnp.array([12]),
                                  slot_j, window=window)
        got = L.cache_attention(q, torch.from_numpy(kn).to(tdt),
                                torch.from_numpy(vn).to(tdt),
                                torch.tensor([12]), slot_t, window=window)
        _close(got, want, tol)


@pytest.mark.parametrize("gated", [True, False])
def test_mlp_block(gated):
    rng = np.random.default_rng(5)
    p_np = {name: (rng.normal(size=shape) / np.sqrt(shape[0])).astype(
        np.float32) for name, shape in (("w_up", (64, 96)), ("w_gate", (64, 96)),
                                        ("w_down", (96, 64)))}
    if not gated:
        del p_np["w_gate"]
    jx, x = _both(rng.normal(size=(2, 6, 64)).astype(np.float32))
    want = JL.mlp_block(jx, _jp(p_np), gated=gated, compute_dtype=jnp.float32)
    got = L.mlp_block(x, _tp(p_np), gated=gated, compute_dtype=torch.float32)
    _close(got, want)


def test_unembed_masks_padded_vocab():
    cfg_j, cfg = _cfgs("smollm-135m", vocab_size=1000)   # padded to 1024
    pn = _jax_params(cfg_j)
    rng = np.random.default_rng(6)
    jx, x = _both(rng.normal(size=(2, 3, cfg.d_model)).astype(np.float32))
    want = JL.unembed(jx, _jp(pn["embed"]),
                      cfg_j, jnp.float32)
    got = L.unembed(x, _tp(pn["embed"]),
                    cfg, torch.float32)
    assert got.shape[-1] == 1024 and (got[..., 1000:] == -1e30).all()
    _close(got, want)


# ---------------------------------------------------------------------------
# whole model through the bridge
# ---------------------------------------------------------------------------
def _run_both(arch, compute):
    cfg_j, cfg = _cfgs(arch)
    pn = _jax_params(cfg_j)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[compute]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[compute]
    japi = jbuild(cfg_j, compute_dtype=jdt, attn_impl="xla")
    api = build_model(cfg, compute_dtype=tdt, device="cpu")
    jparams = jax.tree.map(jnp.asarray, pn)
    params = bridge.from_jax(pn)
    assert len(params["layers"]) == cfg.num_layers
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, cfg.vocab_size, (2, 12))
    jl, jc = japi.prefill(jparams, jnp.asarray(prompt, jnp.int32), 24)
    tl, tc = api.prefill(params, torch.from_numpy(prompt), 24)
    jstep = jax.jit(japi.decode_step)
    steps = [(tl, jl)]
    jtok = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)[:, None]
    ttok = torch.argmax(tl[:, -1], -1)[:, None]
    for _ in range(8):
        if compute == "bfloat16":        # teacher-force the reference's tokens
            ttok = torch.from_numpy(np.asarray(jtok, np.int64))
        assert ttok.numpy().tolist() == np.asarray(jtok).tolist()
        jl, jc = jstep(jparams, jc, jtok)
        tl, tc = api.decode_step(params, tc, ttok)
        steps.append((tl, jl))
        jtok = jnp.argmax(jl, -1).astype(jnp.int32)[:, None]
        ttok = torch.argmax(tl, -1)[:, None]
    return steps


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen2.5-3b", "chatglm3-6b"])
def test_model_parity_fp32(arch):
    for tl, jl in _run_both(arch, "float32"):
        _close(tl, jl, 1e-4)


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen2.5-3b", "chatglm3-6b"])
def test_model_parity_bf16(arch):
    for tl, jl in _run_both(arch, "bfloat16"):
        want = _np(jl)
        err = np.abs(_np(tl) - want).max()
        assert err <= 2e-2 * np.abs(want).max(), err


def test_forward_matches_jax():
    from repro.models import transformer as jtransformer
    from repro_torch.models import transformer
    cfg_j, cfg = _cfgs("chatglm3-6b")
    pn = _jax_params(cfg_j)
    rng = np.random.default_rng(9)
    jx, x = _both(rng.normal(size=(2, 10, cfg.d_model)).astype(np.float32))
    want = jtransformer.forward(jax.tree.map(jnp.asarray, pn), jx, cfg_j,
                                window=4, compute_dtype=jnp.float32,
                                attn_impl="ref")
    got = transformer.forward(bridge.from_jax(pn), x, cfg, window=4,
                              compute_dtype=torch.float32)
    _close(got, want, 1e-4)


def test_batched_decode_per_row_lengths_equals_scalar_calls():
    _, cfg = _cfgs("smollm-135m")
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
        batched = {"k": torch.cat([c["k"] for c in caches], dim=1),
                   "v": torch.cat([c["v"] for c in caches], dim=1),
                   "length": torch.tensor([5, 9, 3])}
        tok = torch.tensor(toks)[:, None]
        for _ in range(3):
            bl, batched = api.decode_step(params, batched, tok)
            for b, c in enumerate(caches):
                sl, caches[b] = api.decode_step(params, c, tok[b:b + 1])
                _close(bl[b], sl[0])
                _close(batched["k"][:, b], caches[b]["k"][:, 0])
                assert int(batched["length"][b]) == int(caches[b]["length"])
            tok = torch.argmax(bl, -1)[:, None]


@pytest.mark.parametrize("arch", ["smollm-135m", "llava-next-mistral-7b",
                                  "olmoe-1b-7b", "mamba2-130m",
                                  "zamba2-2.7b", "whisper-large-v3"])
def test_non_dense_family_names_its_slice(arch):
    """Every one of the six families builds on the CPU: params drawn,
    a two-token prefill and one decode step give finite logits."""
    cfg = ARCHITECTURES[arch].reduced()
    api = build_model(cfg, compute_dtype=torch.float32, device="cpu")
    with torch.inference_mode():
        params = api.init(torch.Generator().manual_seed(0))
        extra = {"audio": torch.zeros((1, cfg.encoder_seq, cfg.d_model))} \
            if cfg.family == "encdec" else {}
        logits, cache = api.prefill(params, torch.tensor([[1, 2]]), 4,
                                    **extra)
        step, _ = api.decode_step(params, cache, torch.tensor([[3]]))
    assert logits.shape[:2] == (1, 2) and step.shape[0] == 1
    assert torch.isfinite(step[:, :cfg.vocab_size]).all()


def test_cuda_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(ARCHITECTURES["smollm-135m"].reduced())
