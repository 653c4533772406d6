"""The port's tensor-parallel decode against the one-process decode and the
JAX package's plan.

Multi-rank (2 and 4 spawned ``gloo`` ranks on the CPU, a ``("model",)``
mesh, the reduced smollm-135m at the serving default of bf16 compute):
each rank decodes a fixed batch, and serves a request trace through the
continuous engine, once alone (no collective) and once through the
tuned logits collective, for ``all_gather`` (ring, recursive_doubling,
bruck) and ``all_reduce`` (ring, rabenseifner), each forced by a
`Communicator` with that static algorithm. The assembled logits equal
the rank's own logits bit for bit at every step (the fixed loop's, and
every call the engine makes), the tokens equal the one-process run's,
and every rank's equal rank 0's, as ``tests/helpers/validate_tp_decode.py``
claims for the reference. Under an SLO that defers prefills on the wall
clock, rank 0 decides each step's admissions and every rank applies the
same decisions and emits the same tokens.

Single process: ``tp_decode_plan(...).render()`` and ``executed_spec``
equal the reference's for the committed artifacts, and the serve CLI's
errors are the reference's.
"""
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.comms import Communicator as JComm  # noqa: E402
from repro.launch import tp_decode as jtp  # noqa: E402
from repro_torch.comms import Communicator as TComm  # noqa: E402
from repro_torch.core.collectives import group as grp  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import tp_decode as ttp  # noqa: E402

HERE = os.path.dirname(__file__)
ARTIFACTS = os.path.join(HERE, "..", "examples", "artifacts")
FLAT = os.path.join(ARTIFACTS, "tuned_decision.json")
HIER = os.path.join(ARTIFACTS, "hierarchical_decision.json")
CASES = [("all_gather", "ring"), ("all_gather", "recursive_doubling"),
         ("all_gather", "bruck"), ("all_reduce", "ring"),
         ("all_reduce", "rabenseifner")]
WORLDS = (2, 4)
B, PROMPT, GEN = 2, 8, 4


def _fixed(api, params, step):
    """Greedy decode of a seeded batch through ``step``: (tokens, the
    logits of every step)."""
    cfg = api.cfg
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, PROMPT)))
    logits, cache = api.prefill(params, prompt, PROMPT + GEN)
    tok = torch.argmax(logits[:, -1], -1)[:, None]
    toks, all_logits = [], []
    for _ in range(GEN):
        toks.append(tok)
        logits, cache = step(params, cache, tok)
        all_logits.append(logits.clone())
        tok = torch.argmax(logits, -1)[:, None]
    return torch.cat(toks, 1), all_logits


def _trace(cfg, n=5):
    from repro_torch.serve import synthetic_trace
    return synthetic_trace(n, rate_rps=1000.0, vocab=cfg.vocab_size,
                           prompt_lens=(4, 6, 8), max_new=4, seed=0)


def _continuous(api, params, mesh=None, comm=None, collective="all_gather",
                slo_ms=None, sim=True):
    from repro_torch.serve import Scheduler, ServeEngine
    trace = _trace(api.cfg)
    engine = ServeEngine(api, params, max_active=2, view_len=16,
                         block_size=4, mesh=mesh, comm=comm,
                         collective=collective)
    sched = Scheduler(trace, max_active=2, token_budget=32, slo_ms=slo_ms)
    engine.run(sched, cost_model=(lambda kind, n: 1e-3) if sim else None)
    return ({r.rid: list(r.generated) for r in sched.finished},
            engine.decisions)


def _rank_work(p, out_dir):
    from repro_torch.configs import ARCHITECTURES
    from repro_torch.models.registry import build_model
    mesh = grp.RankMesh((p,), ("model",), device="cpu")
    api = build_model(ARCHITECTURES["smollm-135m"].reduced(), device="cpu")
    out = {}
    with torch.inference_mode():
        params = api.init(torch.Generator().manual_seed(0))
        alone_tokens, alone_logits = _fixed(api, params, api.decode_step)
        alone_gen, _ = _continuous(api, params)
        calls = []
        real = ttp.assemble_logits

        def spy(logits, *a, **kw):
            got = real(logits, *a, **kw)
            calls.append(torch.equal(got, logits))
            return got

        for collective, algo in CASES:
            comm = TComm.create(mesh, algorithm=algo)
            assert comm.spec(ttp.logits_request(
                collective, B, api.cfg.vocab_size, p)).algorithm == algo
            step = ttp.build_tp_decode_step(api, mesh, comm,
                                            collective=collective)
            tokens, logits = _fixed(api, params, step)
            key = f"{collective}|{algo}"
            out[f"fixed|{key}"] = {
                "tokens_equal": torch.equal(tokens, alone_tokens),
                "logits_equal": all(torch.equal(a, b) for a, b in
                                    zip(logits, alone_logits)),
                "tokens": tokens.tolist()}
            calls.clear()
            ttp.assemble_logits = spy
            try:
                gen, _ = _continuous(api, params, mesh, comm, collective)
            finally:
                ttp.assemble_logits = real
            out[f"continuous|{key}"] = {
                "tokens_equal": gen == alone_gen,
                "logits_equal": bool(calls) and all(calls),
                "tokens": {str(k): v for k, v in gen.items()}}
        # rank 0 decides under a wall-clock SLO that defers prefills
        comm = TComm.create(mesh, algorithm="ring")
        gen, decisions = _continuous(api, params, mesh, comm, slo_ms=1e-3,
                                     sim=False)
        out["slo"] = {"tokens": {str(k): v for k, v in gen.items()},
                      "tokens_equal": gen == alone_gen,
                      "rids": [rids for _, rids in decisions],
                      "clock": [t for t, _ in decisions]}
    with open(os.path.join(out_dir, f"r{grp.rank()}.json"), "w") as f:
        json.dump(out, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    for p in WORLDS:
        d = tmp_path_factory.mktemp(f"tp{p}")
        grp.spawn(_rank_work, p, (p, str(d)), timeout_s=300)
        out[p] = [json.loads((d / f"r{r}.json").read_text())
                  for r in range(p)]
    return out


@pytest.mark.parametrize("mode", ["fixed", "continuous"])
@pytest.mark.parametrize("collective,algo", CASES)
@pytest.mark.parametrize("p", WORLDS)
def test_tp_decode_is_bit_identical_to_one_process(runs, p, collective,
                                                   algo, mode):
    ranks = runs[p]
    key = f"{mode}|{collective}|{algo}"
    for r in ranks:
        assert r[key]["tokens_equal"] and r[key]["logits_equal"], key
        assert r[key]["tokens"] == ranks[0][key]["tokens"]


@pytest.mark.parametrize("p", WORLDS)
def test_rank_zero_decides_the_continuous_schedule(runs, p):
    ranks = runs[p]
    first = ranks[0]["slo"]
    for r in ranks:
        assert r["slo"]["rids"] == first["rids"]
        assert r["slo"]["clock"] == first["clock"]
        assert r["slo"]["tokens"] == first["tokens"]
        assert r["slo"]["tokens_equal"]
    # every request admitted once, over several steps: with an SLO of
    # 1 us no prefill joins an active request, so the trace comes in
    # batches that wait for the slots to drain
    admitted = [rid for rids in first["rids"] for rid in rids]
    assert sorted(admitted) == list(range(5))
    assert sum(1 for rids in first["rids"] if rids) >= 3


@pytest.mark.parametrize("artifact", [FLAT, HIER])
@pytest.mark.parametrize("batch,p", [(4, 2), (8, 4)])
def test_plan_text_equals_reference(artifact, batch, p):
    from repro_torch.configs import ARCHITECTURES
    cfg = ARCHITECTURES["smollm-135m"]
    want = jtp.tp_decode_plan(JComm.create(artifact=artifact), batch,
                              cfg.d_model, cfg.vocab_size, p)
    got = ttp.tp_decode_plan(TComm.create(artifact=artifact), batch,
                             cfg.d_model, cfg.vocab_size, p)
    assert got.render(indent="    ") == want.render(indent="    ")
    for collective in ttp.TP_COLLECTIVES:
        nj, sj = jtp.executed_spec(JComm.create(artifact=artifact),
                                   collective, batch, cfg.vocab_size, p)
        nt, st = ttp.executed_spec(TComm.create(artifact=artifact),
                                   collective, batch, cfg.vocab_size, p)
        assert (nt, st.algorithm, st.segments) == \
            (nj, sj.algorithm, sj.segments)


def test_serve_cli_errors_as_the_reference(monkeypatch, capsys):
    from repro.launch import serve as jserve
    argv = ["--arch", "smollm-135m", "--reduced", "--batch", "1",
            "--prompt-len", "2", "--gen", "1", "--tensor-parallel", "2"]
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    with pytest.raises(SystemExit) as want:
        jserve.main()
    with pytest.raises(SystemExit) as got:
        launch_serve.main([*argv, "--device", "cpu"])
    assert str(got.value) == str(want.value) == \
        "--tensor-parallel needs --tuning-table"
    bad = ["--tp-collective", "broadcast"]
    monkeypatch.setattr(sys, "argv", ["serve", *bad])
    with pytest.raises(SystemExit) as want:
        jserve.main()
    with pytest.raises(SystemExit) as got:
        launch_serve.main(bad)
    assert got.value.code == want.value.code == 2
    err = capsys.readouterr().err
    assert err.count("invalid choice: 'broadcast'") == 2


def test_serve_cli_tp_fixed_prints_the_plan_and_the_executed_spec(capfd,
                                                                 tmp_path):
    res = launch_serve.main([
        "--arch", "smollm-135m", "--reduced", "--device", "cpu",
        "--batch", "2", "--prompt-len", "8", "--gen", "3",
        "--tensor-parallel", "2", "--tuning-table", FLAT,
        "--tp-collective", "all_reduce", "--trace-dir", str(tmp_path)])
    out = capfd.readouterr().out
    alone = launch_serve.main(["--arch", "smollm-135m", "--reduced",
                               "--device", "cpu", "--batch", "2",
                               "--prompt-len", "8", "--gen", "3"])
    nbytes, spec = ttp.executed_spec(TComm.create(artifact=FLAT),
                                     "all_reduce", 2, 1024, 2)
    assert f"tensor-parallel decode: p=2 via tuned all_reduce ({nbytes} B " \
        f"-> {spec.algorithm} segments={spec.segments})" in out
    assert "  decode plan p=2" in out and "arch=smollm-135m batch=2" in out
    assert res["executed_spec"] == [nbytes, spec.algorithm, spec.segments]
    assert np.array_equal(res["tokens"], alone["tokens"])
    summary = json.loads((tmp_path / "decode_summary.json").read_text())
    assert summary["tensor_parallel"] == 2
    assert summary["counters"]["decision_cache_miss{plan}"] >= 1


def test_engine_decode_requests_are_the_reference_builders():
    """``ServeEngine.decode_requests()`` (the plan ``explain`` renders for
    the engine) are the reference's requests for the slot count."""
    from repro_torch.configs import ARCHITECTURES
    from repro_torch.models.registry import build_model
    from repro_torch.serve import ServeEngine
    cfg = ARCHITECTURES["smollm-135m"].reduced()
    api = build_model(cfg, device="cpu")
    with torch.inference_mode():
        params = api.init(torch.Generator().manual_seed(0))
        engine = ServeEngine(api, params, max_active=3, view_len=16,
                             block_size=4)
    fields = ("op", "nbytes", "axis", "axis_size", "dtype")
    want = jtp.decode_requests(3, cfg.d_model, cfg.vocab_size, 2)
    got = engine.decode_requests()
    assert [[getattr(r, f) for f in fields] for r in got] == \
        [[getattr(r, f) for f in fields] for r in want]
