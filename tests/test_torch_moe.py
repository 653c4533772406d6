"""The port's MoE family against the JAX package.

Routing, dispatch and the MoE block on the same numpy inputs at fp32
(olmoe reduced, with capacity drops forced by a small capacity factor,
and arctic reduced for its dense residual MLP); the whole model through
the parameter bridge (prefill and decode logits); the serving engine
token for token against the JAX package's engine. The engine routes
each request as its own group (the reference vmaps batch-1 decodes);
the fixed-batch decode keeps the reference's batched capacity.
"""
import json
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHITECTURES as JARCH  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro.serve import Scheduler as JScheduler  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro.serve import synthetic_trace as jsynthetic_trace  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import ARCHITECTURES, ModelConfig  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.serve import Request, Scheduler, ServeEngine  # noqa: E402
from repro_torch.serve import synthetic_trace  # noqa: E402

TOL = 1e-5
MODEL_TOL = 1e-4
BLOCK = 4
# (arch, capacity factor): olmoe at its own factor and at one that drops
# tokens, arctic (dense residual MLP beside the experts)
CASES = [("olmoe-1b-7b", 1.25), ("olmoe-1b-7b", 0.5), ("arctic-480b", 1.25)]


def _cfgs(arch, cf=1.25):
    return (JARCH[arch].reduced().replace(capacity_factor=cf),
            ARCHITECTURES[arch].reduced().replace(capacity_factor=cf))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _block_params(cfg_j, seed=0):
    """One layer's MoE params from the JAX package's init, as numpy."""
    p = jmoe.moe_params(jax.random.PRNGKey(seed), cfg_j)
    return jax.tree.map(np.asarray, p)


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _x(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# ---------------------------------------------------------------------------
# routing, dispatch, the block
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,cf", CASES)
def test_route_and_dispatch_match_jax(arch, cf):
    cfg_j, cfg = _cfgs(arch, cf)
    p = _block_params(cfg_j)
    x = _x((12, cfg.d_model))
    E, k = cfg.num_experts, cfg.experts_per_token
    C = max(1, int(12 * k * cf) // E)
    jg, je, jaux = jmoe._route(jnp.asarray(x), jnp.asarray(p["router"]), k,
                               jnp.float32)
    tg, te, taux = moe._route(torch.from_numpy(x),
                              _to_torch(p["router"]), k)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    _close(tg, jg)
    for name in ("lb_loss", "z_loss"):
        _close(taux[name], jaux[name])
    want = jmoe._dispatch_indices(je, jg, E, C)
    got = moe._dispatch_indices(te[None], tg[None], E, C)
    for w, g in zip(want, got):
        assert g.shape == (1, E * C)
    np.testing.assert_array_equal(got[0][0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[2][0].numpy(), np.asarray(want[2]))
    _close(got[1][0], want[1])
    if cf < 1:                     # the case forces drops: some slot is kept
        kept = int((got[2] < 12).sum())          # fewer than the T*k routings
        assert 0 < kept < 12 * k


@pytest.mark.parametrize("arch,cf", CASES)
def test_moe_block_matches_jax(arch, cf):
    cfg_j, cfg = _cfgs(arch, cf)
    p = _block_params(cfg_j, seed=2)
    x = _x((2, 6, cfg.d_model), seed=3)
    jy, jaux = jmoe.moe_block(jnp.asarray(x), _to_jax(p), cfg_j,
                              compute_dtype=jnp.float32)
    ty, taux = moe.moe_block(torch.from_numpy(x), _to_torch(p), cfg,
                             compute_dtype=torch.float32)
    _close(ty, jy)
    for name in ("lb_loss", "z_loss"):
        _close(taux[name], jaux[name])


@pytest.mark.parametrize("arch,cf", CASES)
def test_per_row_routing_is_the_vmap_of_one_row_blocks(arch, cf):
    """``per_row=True`` routes each row as its own group: the JAX block
    vmapped over batch-1 rows (the reference engine's decode), and the
    port's block called on each row alone."""
    cfg_j, cfg = _cfgs(arch, cf)
    p = _block_params(cfg_j, seed=4)
    x = _x((4, 3, cfg.d_model), seed=5)
    jp = _to_jax(p)
    want = jax.vmap(lambda xr: jmoe.moe_block(
        xr[None], jp, cfg_j, compute_dtype=jnp.float32)[0][0])(jnp.asarray(x))
    tp, tx = _to_torch(p), torch.from_numpy(x)
    got, _ = moe.moe_block(tx, tp, cfg, compute_dtype=torch.float32,
                           per_row=True)
    _close(got, want)
    for b in range(4):
        alone, _ = moe.moe_block(tx[b:b + 1], tp, cfg,
                                 compute_dtype=torch.float32)
        _close(got[b:b + 1], alone)


def test_expert_parallel_axis_names_the_collectives_slice():
    _, cfg = _cfgs("olmoe-1b-7b")
    p = _to_torch(_block_params(_cfgs("olmoe-1b-7b")[0]))
    with pytest.raises(NotImplementedError, match="collectives slice"):
        moe.moe_block(torch.zeros((1, 2, cfg.d_model)), p, cfg,
                      ep_axis="model")


# ---------------------------------------------------------------------------
# the model through the bridge
# ---------------------------------------------------------------------------
def _jax_params(cfg_j, seed=0):
    """The JAX package's init, as numpy, with the norm scales moved off
    their one init."""
    api = jbuild(cfg_j, compute_dtype=jnp.float32, attn_impl="xla")
    pn = jax.tree.map(np.asarray, api.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for tree, name in ((pn["layers"], "ln1"), (pn["layers"], "ln2"),
                       (pn["embed"], "final_norm")):
        a = tree[name]
        tree[name] = (1 + 0.1 * rng.normal(size=a.shape)).astype(np.float32)
    return pn


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "arctic-480b"])
def test_bridge_carries_the_moe_layers(arch):
    cfg_j, cfg = _cfgs(arch)
    pn = _jax_params(cfg_j)
    params = bridge.from_jax(pn)
    assert len(params["layers"]) == cfg.num_layers
    want = {"router", "w_gate", "w_up", "w_down"} | (
        {"dense"} if cfg.dense_residual else set())
    for i, lp in enumerate(params["layers"]):
        assert set(lp) == {"attn", "moe", "ln1", "ln2"}
        assert set(lp["moe"]) == want
        for name in ("router", "w_gate", "w_up", "w_down"):
            np.testing.assert_array_equal(lp["moe"][name].numpy(),
                                          pn["layers"]["moe"][name][i])
        if cfg.dense_residual:
            np.testing.assert_array_equal(
                lp["moe"]["dense"]["w_gate"].numpy(),
                pn["layers"]["moe"]["dense"]["w_gate"][i])


@pytest.mark.parametrize("arch,cf", CASES)
def test_model_prefill_and_decode_match_jax_fp32(arch, cf):
    """Prefill logits, then 6 greedy batched decode steps over the dense
    cache (batched capacity in both): logits within 1e-4, tokens equal."""
    cfg_j, cfg = _cfgs(arch, cf)
    pn = _jax_params(cfg_j)
    japi = jbuild(cfg_j, compute_dtype=jnp.float32, attn_impl="xla")
    api = build_model(cfg, compute_dtype=torch.float32, device="cpu")
    jparams, params = _to_jax(pn), bridge.from_jax(pn)
    prompt = np.random.default_rng(7).integers(0, cfg.vocab_size, (3, 10))
    jl, jc = japi.prefill(jparams, jnp.asarray(prompt, jnp.int32), 20)
    with torch.inference_mode():
        tl, tc = api.prefill(params, torch.from_numpy(prompt), 20)
    _close(tl, jl, MODEL_TOL)
    jstep = jax.jit(japi.decode_step)
    jtok = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)[:, None]
    ttok = torch.argmax(tl[:, -1], -1)[:, None]
    for _ in range(6):
        assert ttok.numpy().tolist() == np.asarray(jtok).tolist()
        jl, jc = jstep(jparams, jc, jtok)
        with torch.inference_mode():
            tl, tc = api.decode_step(params, tc, ttok)
        _close(tl, jl, MODEL_TOL)
        jtok = jnp.argmax(jl, -1).astype(jnp.int32)[:, None]
        ttok = torch.argmax(tl, -1)[:, None]


def _paged(cache, bs):
    """A dense ``(L, B, T, KV, Dh)`` cache as pools + tables: row b owns
    blocks 1 + b*nb .. (block 0 is the null block)."""
    L_, B, T = cache["k"].shape[:3]
    nb = T // bs
    tables = (1 + torch.arange(B * nb, dtype=torch.int32)).reshape(B, nb)
    out = {"block_tables": tables,
           "length": torch.full((B,), int(cache["length"]))}
    for n in ("k", "v"):
        pool = cache[n].new_zeros((L_, 1 + B * nb, bs) + cache[n].shape[3:])
        pool[:, 1:] = cache[n].reshape((L_, B * nb, bs) + cache[n].shape[3:])
        out[f"{n}_pool"] = pool
    return out


def test_fixed_decode_keeps_batched_capacity_paged_decode_routes_per_row():
    """At a capacity factor that drops tokens, the dense (fixed-batch)
    decode is the JAX batched ``decode_step``, and the paged (engine)
    decode is the JAX ``decode_step`` on each request alone; the two
    differ, so routing is what the cache form chooses."""
    cfg_j, cfg = _cfgs("olmoe-1b-7b", 0.5)
    pn = _jax_params(cfg_j, seed=1)
    japi = jbuild(cfg_j, compute_dtype=jnp.float32, attn_impl="xla")
    api = build_model(cfg, compute_dtype=torch.float32, device="cpu")
    jparams, params = _to_jax(pn), bridge.from_jax(pn)
    prompt = np.random.default_rng(8).integers(0, cfg.vocab_size, (4, 6))
    tok = np.random.default_rng(9).integers(0, cfg.vocab_size, (4, 1))
    _, jc = japi.prefill(jparams, jnp.asarray(prompt, jnp.int32), 8)
    batched, _ = japi.decode_step(jparams, jc, jnp.asarray(tok, jnp.int32))
    alone = []                      # each row of the same cache, alone
    for b in range(4):
        jcb = {"k": jc["k"][:, b:b + 1], "v": jc["v"][:, b:b + 1],
               "length": jc["length"]}
        lb, _ = japi.decode_step(jparams, jcb,
                                 jnp.asarray(tok[b:b + 1], jnp.int32))
        alone.append(np.asarray(lb)[0])
    with torch.inference_mode():
        _, tc = api.prefill(params, torch.from_numpy(prompt), 8)
        paged = _paged(tc, BLOCK)
        dense_l, _ = api.decode_step(params, tc, torch.from_numpy(tok))
        paged_l, _ = api.decode_step(params, paged, torch.from_numpy(tok),
                                     attn_impl="auto")
    _close(dense_l, batched, MODEL_TOL)
    _close(paged_l, np.stack(alone), MODEL_TOL)
    assert not np.allclose(np.asarray(batched), np.stack(alone), atol=1e-3)
    assert pa.launches == 0                     # CPU: the gather path


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
def _engine_tokens(api, params, trace, *, max_active, view_len):
    engine = ServeEngine(api, params, max_active=max_active,
                         view_len=view_len, block_size=BLOCK)
    sched = Scheduler(trace, max_active=max_active,
                      token_budget=max_active * view_len)
    engine.run(sched, cost_model=lambda kind, n: 1e-3)
    assert len(sched.finished) == len(trace)
    return {r.rid: list(r.generated) for r in sched.finished}


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "arctic-480b"])
def test_engine_tokens_match_jax_engine_fp32(arch):
    """Same params (through the bridge), same trace, same simulated clock:
    the port's engine (one batched decode, each row routed alone) and the
    JAX package's engine (a vmap of batch-1 decodes) emit the same
    tokens. Both keep bf16 KV pools."""
    cfg_j, cfg = _cfgs(arch)
    pn = _jax_params(cfg_j)
    japi = jbuild(cfg_j, compute_dtype=jnp.float32, attn_impl="xla")
    trace_kw = dict(rate_rps=500.0, vocab=cfg_j.vocab_size,
                    prompt_lens=(4, 6), max_new=6, seed=0)
    view_len = 12
    jengine = JServeEngine(japi, _to_jax(pn), max_active=3,
                           view_len=view_len, block_size=BLOCK)
    jsched = JScheduler(jsynthetic_trace(6, **trace_kw), max_active=3,
                        token_budget=3 * view_len)
    with warnings.catch_warnings():
        # the reference scatters f32 k/v into its bf16 pool implicitly
        warnings.filterwarnings("ignore", category=FutureWarning,
                                message=".*scatter.*")
        jengine.run(jsched, cost_model=lambda kind, n: 1e-3)
    want = {r.rid: list(r.generated) for r in jsched.finished}

    api = build_model(cfg, compute_dtype=torch.float32, device="cpu")
    got = _engine_tokens(api, bridge.from_jax(pn),
                         synthetic_trace(6, **trace_kw), max_active=3,
                         view_len=view_len)
    assert len(want) == 6 and got == want


def test_request_served_alone_equals_request_served_beside_others():
    """At a capacity factor that drops tokens in a batched routing, a
    request's tokens do not depend on its neighbours or on the inactive
    slots' garbage rows."""
    _, cfg = _cfgs("olmoe-1b-7b", 0.5)
    api = build_model(cfg, compute_dtype=torch.float32, device="cpu")
    with torch.inference_mode():
        params = api.init(torch.Generator().manual_seed(3))
    rng = np.random.default_rng(11)
    reqs = [Request(rid=i, arrival_s=0.0,
                    prompt=tuple(int(t) for t in
                                 rng.integers(0, cfg.vocab_size, 5)),
                    max_new=7) for i in range(4)]

    def clone(rs):
        return [Request(rid=r.rid, arrival_s=r.arrival_s, prompt=r.prompt,
                        max_new=r.max_new) for r in rs]
    alone = _engine_tokens(api, params, clone(reqs[:1]), max_active=4,
                           view_len=12)
    together = _engine_tokens(api, params, clone(reqs), max_active=4,
                              view_len=12)
    assert together[0] == alone[0]


def test_registry_builds_olmoe_and_the_other_families_still_raise():
    api = build_model(ARCHITECTURES["olmoe-1b-7b"], device="cpu")
    assert api.cfg.num_experts == 64 and api.cfg.experts_per_token == 8
    for family in ("vlm", "encdec"):
        cfg = ModelConfig(name="m", family=family, num_layers=1, d_model=8,
                          num_heads=2, num_kv_heads=2, d_ff=8, vocab_size=8)
        with pytest.raises(NotImplementedError, match="slice"):
            build_model(cfg, device="cpu")


def test_cli_serves_olmoe_in_both_modes(capsys, tmp_path):
    res = launch_serve.main(["--arch", "olmoe-1b-7b", "--reduced",
                             "--device", "cpu", "--batch", "2",
                             "--prompt-len", "6", "--gen", "3"])
    assert res["tokens"].shape == (2, 3) and res["decode_steps"] == 3
    res = launch_serve.main([
        "--arch", "olmoe-1b-7b", "--reduced", "--device", "cpu",
        "--continuous", "--num-requests", "3", "--poisson-rate", "200",
        "--prompt-len", "8", "--gen", "3", "--max-active", "2",
        "--block-size", "4", "--trace-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "arch=olmoe-1b-7b batch=2" in out
    assert "served 3 requests, 9 tokens" in out
    assert all(len(t) == 3 for t in res["generated"].values())
    assert res["decode_steps"] >= 2
    summary = json.loads((tmp_path / "decode_summary.json").read_text())
    assert summary["arch"] == "olmoe-1b-7b"
