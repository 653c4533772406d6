"""The port's serving tier: paged KV, scheduler, engine and CLI.

The unit cases of ``tests/test_serving.py`` run against the port. The
bit-identity contract is the reference's under the port's batching: the
paged engine generates EXACTLY the tokens of the same batched
``decode_step`` run over dense caches of the same requests, so paging
(block tables, gather/scatter, null block, ring wrap, preemption) is the
only difference. The port's engine is also held token for token against
the JAX package's engine at fp32 compute, with params through the bridge.
"""
import json
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHITECTURES as JARCH  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro.serve import Scheduler as JScheduler  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro.serve import synthetic_trace as jsynthetic_trace  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import ARCHITECTURES  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    BlockPool,
    PagedKV,
    Request,
    Scheduler,
    ServeEngine,
    synthetic_trace,
)

BLOCK = 4


# ---------------------------------------------------------------------------
# block pool + paged KV storage
# ---------------------------------------------------------------------------
def test_block_pool_alloc_free():
    pool = BlockPool(8)                 # block 0 reserved -> 7 allocatable
    assert pool.available == 7
    a = pool.alloc(3)
    assert len(a) == 3 and 0 not in a and pool.available == 4
    assert pool.alloc(5) is None        # short -> nothing handed out
    assert pool.available == 4
    pool.free(a)
    assert pool.available == 7
    with pytest.raises(ValueError):
        pool.free([0])                  # null block is never owned
    b = pool.alloc(2)
    pool.free(b)
    with pytest.raises(ValueError):
        pool.free(b)                    # double free


def test_block_pool_lifo_reuse():
    pool = BlockPool(6)
    a = pool.alloc(2)
    pool.free(a)
    again = pool.alloc(2)
    assert set(again) == set(a)         # freed blocks are recycled first


def test_paged_kv_write_gather_roundtrip():
    rng = np.random.default_rng(0)
    lead, T, KV, Dh, bs = 2, 8, 2, 4, 4
    tmpl = {n: torch.zeros((lead, 1, T, KV, Dh)) for n in ("k", "v")}
    kv = PagedKV(tmpl, block_size=bs, max_requests=2)
    assert kv.blocks_per_request == 2

    assert kv.admit(0) and kv.admit(1)
    with pytest.raises(ValueError):
        kv.admit(0)                     # slot already owns a table
    views = {n: torch.from_numpy(rng.normal(size=(lead, 1, T, KV, Dh)))
             .float() for n in ("k", "v")}
    kv.write_view(0, views)
    got = kv.gather()                   # (lead, R, T, KV, Dh)
    for n in ("k", "v"):
        assert torch.equal(got[n][:, 0], views[n][:, 0])
    # single-token scatter into slot 0's ring position 5 (block 1, off 1)
    tok = {n: torch.from_numpy(rng.normal(size=(lead, 2, T, KV, Dh))).float()
           for n in ("k", "v")}
    kv.scatter_token(tok, torch.tensor([5, 0]))
    got = kv.gather()
    for n in ("k", "v"):
        assert torch.equal(got[n][:, 0, 5], tok[n][:, 0, 5])
        # the other slots of request 0 are untouched
        assert torch.equal(got[n][:, 0, :5], views[n][:, 0, :5])

    kv.release(0)
    assert kv.available_blocks == 2
    assert kv.admit(0)                  # table comes back from the free list


def test_paged_kv_write_view_casts_to_pool_dtype():
    tmpl = {"k": torch.zeros((1, 1, 8, 1, 2), dtype=torch.bfloat16)}
    kv = PagedKV(tmpl, block_size=4, max_requests=1)
    assert kv.admit(0)
    view = torch.linspace(-1, 1, 16).reshape(1, 1, 8, 1, 2)
    kv.write_view(0, {"k": view})
    assert kv.pools["k"].dtype == torch.bfloat16
    assert torch.equal(kv.gather()["k"][:, 0], view[:, 0].to(torch.bfloat16))


def test_paged_kv_exhaustion():
    tmpl = {"k": torch.zeros((1, 1, 8, 1, 2))}
    kv = PagedKV(tmpl, block_size=4, max_requests=4, num_blocks=5)
    assert kv.admit(0) and kv.admit(1)
    assert not kv.admit(2)              # pool exhausted -> admission refused
    kv.release(0)
    assert kv.admit(2)


# ---------------------------------------------------------------------------
# scheduler policy (pure host-side, injected clock)
# ---------------------------------------------------------------------------
def _req(rid, t, plen=4, new=4):
    return Request(rid=rid, arrival_s=t, prompt=tuple(range(plen)),
                   max_new=new)


def test_scheduler_continuous_joins_midflight():
    sched = Scheduler([_req(0, 0.0), _req(1, 0.1)], max_active=2,
                      token_budget=100)
    (r0,) = sched.admissible(0.0)
    assert r0.rid == 0
    sched.start(r0, 0.0, 0)
    # request 1 joins while 0 is in flight
    assert [r.rid for r in sched.admissible(0.2)] == [1]


def test_scheduler_drain_blocks_until_batch_retires():
    r0, r1 = _req(0, 0.0, new=2), _req(1, 0.0, new=2)
    sched = Scheduler([r0, r1], max_active=1, token_budget=100, drain=True)
    (got,) = sched.admissible(0.0)
    sched.start(got, 0.0, 0)
    assert sched.admissible(1.0) == []              # drain: no join
    sched.record_token(r0, 1, 1.0)
    sched.record_token(r0, 2, 1.1)
    assert [r.rid for r in sched.retire_done(1.2)] == [0]
    assert [r.rid for r in sched.admissible(1.3)] == [1]


def test_scheduler_token_budget_defers_admission():
    sched = Scheduler([_req(0, 0.0, plen=4, new=4),
                       _req(1, 0.0, plen=4, new=4)],
                      max_active=4, token_budget=10)
    assert len(sched.admissible(0.0)) == 1          # 8 + 8 > 10


def test_scheduler_slo_guard_defers_prefill():
    sched = Scheduler([_req(0, 0.0), _req(1, 1.0)], max_active=2,
                      token_budget=100, slo_ms=10.0)
    (r0,) = sched.admissible(0.0)
    sched.start(r0, 0.0, 0)
    sched.note_prefill(8.0)
    sched.note_decode(1.0)
    # 5 ms since last decode + 8 ms predicted prefill > 10 ms SLO: defer
    assert sched.admissible(1.005) == []
    # right after a decode the gap is gone -> admit
    sched.note_decode(1.010)
    assert [r.rid for r in sched.admissible(1.0101)] == [1]


def test_scheduler_preempt_recompute():
    r0 = _req(0, 0.0, plen=4, new=6)
    sched = Scheduler([r0], max_active=1, token_budget=100)
    (got,) = sched.admissible(0.0)
    sched.start(got, 0.0, 0)
    for t, tok in enumerate((7, 8, 9)):
        sched.record_token(r0, tok, 0.1 * (t + 1))
    back = sched.preempt(0)
    assert back.prompt == (0, 1, 2, 3, 7, 8, 9)     # generated folded in
    assert back.max_new == 3 and back.generated == []
    assert sched.next_arrival() == 0.0              # head of the queue


@pytest.mark.parametrize("seed,kw", [
    (0, dict(rate_rps=500.0, prompt_lens=(4, 6), max_new=6)),
    (3, dict(rate_rps=20.0, prompt_lens=(128, 256, 512), max_new=64)),
])
def test_synthetic_trace_matches_reference(seed, kw):
    mine = synthetic_trace(12, vocab=49152, seed=seed, **kw)
    ref = jsynthetic_trace(12, vocab=49152, seed=seed, **kw)
    assert [(r.rid, r.arrival_s, r.prompt, r.max_new) for r in mine] == \
        [(r.rid, r.arrival_s, r.prompt, r.max_new) for r in ref]


# ---------------------------------------------------------------------------
# engine bit-identity vs the port's dense oracle
# ---------------------------------------------------------------------------
def _model(window=0, compute=torch.bfloat16):
    cfg = ARCHITECTURES["smollm-135m"].reduced()
    api = build_model(cfg, window=window, compute_dtype=compute, device="cpu")
    with torch.inference_mode():
        params = api.init(torch.Generator().manual_seed(0))
    return cfg, api, params


def _trace(vocab, n=4):
    return synthetic_trace(n, rate_rps=500.0, vocab=vocab,
                           prompt_lens=(4, 6), max_new=6, seed=0)


def _clone(trace):
    return [Request(rid=r.rid, arrival_s=r.arrival_s, prompt=r.prompt,
                    max_new=r.max_new) for r in trace]


def _engine_tokens(api, params, trace, *, max_active, view_len):
    engine = ServeEngine(api, params, max_active=max_active,
                         view_len=view_len, block_size=BLOCK)
    sched = Scheduler(trace, max_active=max_active,
                      token_budget=max_active * view_len)
    engine.run(sched, cost_model=lambda kind, n: 1e-3)
    assert len(sched.finished) == len(trace)
    return {r.rid: list(r.generated) for r in sched.finished}


@torch.inference_mode()
def _dense_batched_tokens(api, params, reqs, view_len, width):
    """The paging oracle: each request's dense batch-1 prefill cache, cast
    to the pool dtype, stacked into one dense ``(L, width, view_len, KV,
    Dh)`` cache with per-row lengths, and decoded by the same batched
    ``decode_step`` the engine runs over its ``width`` slots (spare rows
    hold an empty cache)."""
    tmpl = api.init_cache(1, view_len)
    ks, vs, lens, toks = [], [], [], []
    for req in reqs:
        prompt = torch.tensor(req.prompt)[None]
        logits, cache = api.prefill(params, prompt, view_len)
        ks.append(cache["k"].to(tmpl["k"].dtype))
        vs.append(cache["v"].to(tmpl["v"].dtype))
        lens.append(req.prompt_len)
        toks.append(int(torch.argmax(logits[0, -1])))
    for _ in range(width - len(reqs)):
        ks.append(torch.zeros_like(tmpl["k"]))
        vs.append(torch.zeros_like(tmpl["v"]))
        lens.append(0)
        toks.append(0)
    cache = {"k": torch.cat(ks, dim=1), "v": torch.cat(vs, dim=1),
             "length": torch.tensor(lens)}
    outs = [[t] for t in toks]
    tok = torch.tensor(toks)[:, None]
    for _ in range(max(r.max_new for r in reqs) - 1):
        logits, cache = api.decode_step(params, cache, tok)
        tok = torch.argmax(logits, -1)[:, None]
        for i in range(len(reqs)):
            outs[i].append(int(tok[i]))
    return {r.rid: outs[i][:r.max_new] for i, r in enumerate(reqs)}


def _oracle(api, params, trace, view_len, width):
    want = {}
    for i in range(0, len(trace), width):
        want.update(_dense_batched_tokens(api, params, trace[i:i + width],
                                          view_len, width))
    return want


def test_engine_bit_identical_to_dense_oracle():
    cfg, api, params = _model()
    trace = _trace(cfg.vocab_size)
    view_len = -(-max(r.prompt_len + r.max_new for r in trace)
                 // BLOCK) * BLOCK
    got = _engine_tokens(api, params, _clone(trace), max_active=2,
                         view_len=view_len)
    assert got == _oracle(api, params, _clone(trace), view_len, 2)


def test_engine_eviction_refill_windowed_wrap():
    """Sequences longer than the KV view: the ring wraps, every block is
    evicted and refilled mid-sequence, and (with a sliding window) the
    paged run still matches the dense oracle token for token."""
    cfg, api, params = _model(window=8)
    view_len = 12                      # < prompt + generated -> wraps
    rng = np.random.default_rng(7)
    trace = [Request(rid=i, arrival_s=0.0,
                     prompt=tuple(int(x) for x in
                                  rng.integers(0, cfg.vocab_size, 6)),
                     max_new=14) for i in range(3)]
    got = _engine_tokens(api, params, _clone(trace), max_active=2,
                         view_len=view_len)
    assert got == _oracle(api, params, _clone(trace), view_len, 2)


def test_engine_preempt_release_readmit_matches_uninterrupted():
    """Recompute preemption: release the slot mid-generation (blocks go
    back to the pool), fold the generated tokens into the prompt,
    re-admit, finish — the full sequence equals the uninterrupted run."""
    cfg, api, params = _model()
    view_len, max_new = 24, 10
    req = Request(rid=0, arrival_s=0.0, prompt=tuple(range(3, 11)),
                  max_new=max_new)
    full = _dense_batched_tokens(api, params, _clone([req]), view_len, 2)[0]

    engine = ServeEngine(api, params, max_active=2, view_len=view_len,
                         block_size=BLOCK)
    sched = Scheduler([req], max_active=2, token_budget=100)
    (r0,) = sched.admissible(0.0)
    slot = engine.admit(r0)
    sched.start(r0, 0.0, slot)
    sched.record_token(r0, int(engine.cur_tokens[slot]), 0.0)
    for i in range(4):                 # 5 tokens generated, then preempt
        toks = engine.step()
        sched.record_token(r0, toks[slot], 0.1 * i)
    engine.release(slot)
    assert engine.paged.available_blocks == engine.paged.pool_mgr.num_blocks - 1
    back = sched.preempt(0)
    assert len(back.prompt) == 8 + 5   # generated folded into the prompt
    assert list(back.prompt[8:]) == full[:5]
    assert back.max_new == max_new - 5

    (r1,) = sched.admissible(1.0)      # re-admit from the queue head
    slot = engine.admit(r1)
    sched.start(r1, 1.0, slot)
    resumed = [int(engine.cur_tokens[slot])]
    for _ in range(back.max_new - 1):
        resumed.append(engine.step()[slot])
    assert list(req.prompt[8:]) + resumed == full


def test_engine_tokens_match_jax_engine_fp32():
    """Same params (through the bridge), same trace, same simulated clock:
    the port's engine and the JAX package's engine emit the same tokens.
    Both keep bf16 KV pools (``init_cache``'s default)."""
    cfg_j = JARCH["smollm-135m"].reduced()
    japi = jbuild(cfg_j, compute_dtype=jnp.float32, attn_impl="xla")
    pn = jax.tree.map(np.asarray, japi.init(jax.random.PRNGKey(0)))
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

    cfg = ARCHITECTURES["smollm-135m"].reduced()
    api = build_model(cfg, compute_dtype=torch.float32, device="cpu")
    got = _engine_tokens(api, bridge.from_jax(pn),
                         synthetic_trace(5, **trace_kw), max_active=2,
                         view_len=view_len)
    assert len(want) == 5 and got == want


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
def test_cli_fixed_batch(capsys):
    res = launch_serve.main(["--device", "cpu", "--reduced", "--batch", "2",
                             "--prompt-len", "6", "--gen", "3"])
    out = capsys.readouterr().out
    assert "arch=smollm-135m batch=2 prompt=6 gen=3 device=cpu" in out
    assert "per-token decode latency: p50" in out
    assert res["tokens"].shape == (2, 3)


def test_cli_continuous(capsys, tmp_path):
    res = launch_serve.main([
        "--device", "cpu", "--reduced", "--continuous", "--num-requests", "3",
        "--poisson-rate", "200", "--prompt-len", "8", "--gen", "3",
        "--max-active", "2", "--block-size", "4", "--slo-ms", "5000",
        "--trace-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "served 3 requests, 9 tokens" in out
    assert "per-token decode latency: p50" in out
    assert "SLO p99 <= 5000 ms: met" in out
    assert all(len(t) == 3 for t in res["generated"].values())
    summary = json.loads((tmp_path / "decode_summary.json").read_text())
    assert summary["mode"] == "continuous" and len(summary["requests"]) == 3


def test_cli_request_trace(capsys, tmp_path):
    path = tmp_path / "trace.jsonl"
    path.write_text('{"arrival_s": 0.0, "prompt_len": 5, "max_new": 2}\n'
                    '{"arrival_s": 0.01, "prompt": [1, 2, 3], "max_new": 4}\n')
    res = launch_serve.main([
        "--device", "cpu", "--reduced", "--continuous", "--request-trace",
        str(path), "--max-active", "2", "--block-size", "4"])
    assert "served 2 requests, 6 tokens" in capsys.readouterr().out
    assert {r: len(t) for r, t in res["generated"].items()} == {0: 2, 1: 4}


@pytest.mark.parametrize("flag", [["--tensor-parallel", "2"],
                                  ["--tuning-table", "t.json"],
                                  ["--device", "tpu"]])
def test_cli_rejects_flags_of_later_slices(flag, capsys):
    with pytest.raises(SystemExit):
        launch_serve.parse_args(["--reduced", *flag])
    assert "unrecognized arguments" in capsys.readouterr().err or \
        flag[0] == "--device"
