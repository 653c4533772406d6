"""Serving launcher of the port: fixed-batch oracle + continuous batching.

  * default (oracle) — one fixed batch prefilled in a single batched pass
    (``api.prefill``: attention through the hand-written flash-attention
    kernel and the SSM families' chunk scan through the hand-written
    SSD kernel on the card) and greedily decoded to completion over
    dense KV caches.
  * ``--continuous`` — the ``repro_torch.serve`` subsystem: a request
    trace (``--request-trace`` JSONL or synthetic Poisson arrivals),
    paged KV blocks read in every decode step by the hand-written
    paged-attention kernel on the card, per-request SSM state,
    token-budget + SLO admission, per-step join/retire.

With ``--tensor-parallel N --tuning-table ART`` either mode runs in N
spawned ranks (`group.spawn`, a ``("model",)`` mesh of ``gloo`` ranks,
each on ``cuda:0`` or the host) with the model compute replicated, and
each decode step's logits are reassembled through the `Communicator`'s
{algorithm, segments} choice for ``--tp-collective`` (all_gather or
all_reduce, `launch.tp_decode`): bit-identical to the one-process loop,
executing the tuned wire schedule. Decode messages are KB-scale, so
they resolve through the small-message end of the tuning grid; the
printed decode plan is `Communicator.explain` over the same requests
the step executes. Under ``--continuous`` rank 0 decides each step's
admissions and the others apply them (`serve.engine`). Rank 0 prints.
``--probe-fabric`` probes the live fabric first so a multi-backend
artifact resolves to the matching profile's table.

Runs on the GPU (``--device cuda``, the default; no GPU is an error) or,
when asked, on the CPU, where the kernels take their plain PyTorch
versions. Weights are random, drawn by a ``torch.Generator`` with seed 0
on the serving device (the same in every rank). The enc-dec family
(whisper-large-v3) takes each request's audio frames as the reference
draws them (precomputed frame embeddings: its conv front end is a
stub); the VLM family (llava-next-mistral-7b) serves text prompts
through the dense family's prefill, as the reference's serving does.
For the SSM and hybrid families (mamba2-130m, zamba2-2.7b) a prompt
longer than the scan's chunk (``ssm_chunk``, 128; 32 with
``--reduced``) must be a multiple of it.

Examples:
    python -m repro_torch.launch.serve --arch smollm-135m \\
        --batch 8 --prompt-len 512 --gen 64
    python -m repro_torch.launch.serve --arch smollm-135m --continuous \\
        --num-requests 32 --poisson-rate 20 --prompt-len 512 --gen 64 \\
        --max-active 8 --block-size 16 --slo-ms 200
    python -m repro_torch.launch.serve --arch mamba2-130m \\
        --batch 8 --prompt-len 512 --gen 64
    python -m repro_torch.launch.serve --arch zamba2-2.7b --continuous \\
        --num-requests 8 --poisson-rate 20 --prompt-len 512 --gen 16
    python -m repro_torch.launch.serve --arch olmoe-1b-7b --continuous \\
        --num-requests 8 --poisson-rate 20 --prompt-len 512 --gen 16
    python -m repro_torch.launch.serve --arch whisper-large-v3 \\
        --batch 4 --prompt-len 64 --gen 32
    python -m repro_torch.launch.serve --arch llava-next-mistral-7b \\
        --continuous --num-requests 8 --poisson-rate 20 --prompt-len 512 \\
        --gen 16
    python -m repro_torch.launch.serve --arch smollm-135m \\
        --batch 8 --prompt-len 512 --gen 64 --tensor-parallel 4 \\
        --tuning-table examples/artifacts/tuned_decision.json \\
        --tp-collective all_reduce
    python -m repro_torch.launch.serve --arch smollm-135m --reduced \\
        --device cpu --batch 2 --prompt-len 8 --gen 4
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import pytree
from repro_torch.configs import ARCHITECTURES
from repro_torch.core.collectives import group as grp
from repro_torch.models import ssm
from repro_torch.models.registry import build_model


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _say(msg: str) -> None:
    """Print from rank 0 (of a tensor-parallel group), or the process."""
    if not dist.is_initialized() or grp.rank() == 0:
        print(msg, flush=True)


def _prefill_extra_fn(cfg, device):
    """Per-request inputs beyond the token prompt (encdec: audio frames,
    bf16, drawn from numpy's generator seeded with ``1000 + rid``, as the
    reference draws them)."""
    if cfg.family != "encdec":
        return None

    def mk(req):
        rng = np.random.default_rng(1000 + req.rid)
        audio = rng.normal(size=(1, cfg.encoder_seq, cfg.d_model))
        return {"audio": torch.from_numpy(audio).to(device, torch.bfloat16)}
    return mk


def _serve_continuous(args, cfg, api, params, comm=None, mesh=None):
    from repro_torch.serve import ServeEngine, Scheduler, load_trace, \
        synthetic_trace

    if args.request_trace:
        trace = load_trace(args.request_trace, vocab=cfg.vocab_size)
    else:
        trace = synthetic_trace(
            args.num_requests, rate_rps=args.poisson_rate,
            vocab=cfg.vocab_size,
            prompt_lens=(max(args.prompt_len // 4, 1),
                         max(args.prompt_len // 2, 1), args.prompt_len),
            max_new=args.gen, seed=0)

    _check_prompt_lens(cfg, [r.prompt_len for r in trace])
    bs = args.block_size
    longest = max(r.prompt_len + r.max_new for r in trace)
    view_len = -(-longest // bs) * bs
    engine = ServeEngine(api, params, max_active=args.max_active,
                         view_len=view_len, block_size=bs, mesh=mesh,
                         comm=comm, collective=args.tp_collective,
                         prefill_extra=_prefill_extra_fn(cfg, api.device))
    sched = Scheduler(trace, max_active=args.max_active,
                      token_budget=args.max_active * view_len,
                      slo_ms=args.slo_ms)
    _say(f"continuous serving: arch={cfg.name} requests={len(trace)} "
         f"max_active={args.max_active} block={bs} view={view_len} "
         f"slo_ms={args.slo_ms} device={api.device}")
    res = engine.run(sched)
    s = res.summary
    _say(f"served {s['requests']} requests, {s['new_tokens']} tokens "
         f"in {res.wall_s:.2f}s ({s['tok_per_s']:.1f} tok/s)")
    _say(f"per-token decode latency: p50 {s['token_ms_p50']:.2f} ms  "
         f"p90 {s['token_ms_p90']:.2f} ms  p99 {s['token_ms_p99']:.2f} ms")
    if args.slo_ms:
        ok = s["token_ms_p99"] <= args.slo_ms
        _say(f"SLO p99 <= {args.slo_ms:.0f} ms: "
             f"{'met' if ok else 'MISSED'}")

    out = {"arch": cfg.name, "mode": "continuous",
           "tensor_parallel": args.tensor_parallel,
           "max_active": args.max_active, "block_size": bs,
           "view_len": view_len, "slo_ms": args.slo_ms,
           "wall_s": res.wall_s, "decode_steps": engine.decode_steps, **s,
           "requests": res.records}
    _write_summary(args, comm, out)
    out["generated"] = {r.rid: list(r.generated) for r in sched.finished}
    out["max_new"] = {r.rid: r.max_new for r in trace}
    out["decisions"] = engine.decisions
    out["executed"] = sorted(engine.executed)
    return out


def _write_summary(args, comm, extra) -> None:
    """``decode_summary.json`` (rank 0's), with the Communicator's
    counters when there is one."""
    if not args.trace_dir or (dist.is_initialized() and grp.rank() != 0):
        return
    from repro_torch.obs import export as obs_export
    os.makedirs(args.trace_dir, exist_ok=True)
    obs_export.write_summary(
        os.path.join(args.trace_dir, "decode_summary.json"),
        counters=comm.metrics if comm is not None else None, extra=extra)
    print(f"decode summary -> {args.trace_dir}/decode_summary.json")


def _check_prompt_lens(cfg, lens) -> None:
    """The SSM families' chunked scan: a prompt longer than the chunk must
    be a multiple of it. Raises before any prompt is served."""
    if cfg.family in ("ssm", "hybrid"):
        for n in sorted(set(lens)):
            ssm.check_prompt_len(cfg, n)


def _serve_fixed(args, cfg, api, params, comm=None, mesh=None):
    """The fixed-batch validation oracle: one batched prefill, then greedy
    decode with every token synced before the next issues; with a
    ``mesh``, each step's logits assembled through the tuned
    collective."""
    step = api.decode_step
    if mesh is not None:
        from repro_torch.launch.tp_decode import build_tp_decode_step
        step = build_tp_decode_step(api, mesh, comm,
                                    collective=args.tp_collective)
    B = args.batch
    cache_len = args.prompt_len + args.gen
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (B, args.prompt_len))).to(api.device)

    extra = {}
    if cfg.family == "encdec":      # the frames, after the prompt
        audio = rng.normal(size=(B, cfg.encoder_seq, cfg.d_model))
        extra["audio"] = torch.from_numpy(audio).to(api.device,
                                                    torch.bfloat16)

    t0 = time.perf_counter()
    logits, cache = api.prefill(params, prompt, cache_len, **extra)
    logits = logits[:, -1]
    _sync(api.device)
    t_prefill = time.perf_counter() - t0

    out = []
    tok = torch.argmax(logits, -1)[:, None]
    # per-token latency: each token is synced before the next issues, so
    # the percentiles are honest tail latencies, not launch times
    tok_ms = []
    t0 = time.perf_counter()
    for _ in range(args.gen):
        out.append(tok)
        tt0 = time.perf_counter()
        logits, cache = step(params, cache, tok)
        tok = torch.argmax(logits, -1)[:, None]
        _sync(api.device)
        tok_ms.append((time.perf_counter() - tt0) * 1e3)
    t_gen = time.perf_counter() - t0

    gen = torch.cat(out, dim=1).cpu().numpy()
    p50, p90, p99 = np.percentile(tok_ms, [50, 90, 99])
    _say(f"arch={cfg.name} batch={B} prompt={args.prompt_len} "
         f"gen={args.gen} device={api.device}")
    _say(f"prefill: {t_prefill:.2f}s  decode: {t_gen:.2f}s "
         f"({B * args.gen / t_gen:.1f} tok/s)")
    _say(f"per-token decode latency: p50 {p50:.2f} ms  "
         f"p90 {p90:.2f} ms  p99 {p99:.2f} ms")
    _say(f"sample tokens: {gen[0, :16].tolist()}")

    res = {"arch": cfg.name, "batch": B, "prompt_len": args.prompt_len,
           "gen": args.gen, "tensor_parallel": args.tensor_parallel,
           "decode_steps": args.gen,
           "prefill_s": t_prefill, "decode_s": t_gen,
           "tok_per_s": B * args.gen / t_gen,
           "token_ms_p50": float(p50), "token_ms_p90": float(p90),
           "token_ms_p99": float(p99)}
    _write_summary(args, comm, res)
    res["tokens"] = gen
    res["last_logits"] = logits.cpu()
    res["executed"] = sorted(getattr(step, "executed", ()))
    return res


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="smollm-135m",
                    choices=sorted(ARCHITECTURES))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default; no GPU is an error) or cpu")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--window", type=int, default=0)
    ap.add_argument("--continuous", action="store_true",
                    help="serve a request trace with continuous batching "
                         "over paged KV (the repro_torch.serve subsystem) "
                         "instead of one fixed batch")
    ap.add_argument("--request-trace", default=None,
                    help="JSONL request trace ({arrival_s, prompt_len|"
                         "prompt, max_new} per line); default: synthetic "
                         "Poisson arrivals")
    ap.add_argument("--num-requests", type=int, default=16,
                    help="synthetic trace length (--continuous)")
    ap.add_argument("--poisson-rate", type=float, default=50.0,
                    help="synthetic arrival rate, requests/s (--continuous)")
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="per-token latency SLO; admission defers prefills "
                         "that would bust it (--continuous)")
    ap.add_argument("--max-active", type=int, default=4,
                    help="request slots decoded per step (--continuous)")
    ap.add_argument("--block-size", type=int, default=16,
                    help="KV block size in tokens (--continuous)")
    ap.add_argument("--tuning-table", default=None,
                    help="tuned decision artifact (schema 2 or 3); prints "
                         "the tuned collective plan and, with "
                         "--tensor-parallel, drives the decode loop's "
                         "logits collective through it")
    ap.add_argument("--tensor-parallel", type=int, default=0,
                    help=">=2: run the tuned TP decode path over a 'model' "
                         "mesh axis of this size (requires --tuning-table; "
                         "spawns that many ranks)")
    ap.add_argument("--tp-collective", default="all_gather",
                    choices=("all_gather", "all_reduce"),
                    help="which tuned collective assembles the TP logits")
    ap.add_argument("--probe-fabric", action="store_true",
                    help="probe the live fabric before selecting a table "
                         "from a multi-backend artifact (instead of "
                         "first-table-wins)")
    ap.add_argument("--trace-dir", default=None,
                    help="write decode_summary.json here (per-token "
                         "latency percentiles + throughput + config; "
                         "with --continuous also per-request spans)")
    return ap.parse_args(argv)


def _serve(args, cfg, comm=None, mesh=None):
    api = build_model(cfg, window=args.window, attn_impl="auto",
                      device=args.device if mesh is None else mesh.device)
    with torch.inference_mode():
        params = api.init(torch.Generator(device=api.device).manual_seed(0))
        run = _serve_continuous if args.continuous else _serve_fixed
        res = run(args, cfg, api, params, comm, mesh)
    # what was served: the layers held (whisper's decoder stack) and the
    # params drawn
    res["num_layers"] = len(params["decoder" if "decoder" in params
                                   else "layers"])
    res["param_elems"] = sum(t.numel() for t in pytree.leaves(params))
    return res


def _tp_rank_main(args, cfg):
    """One rank of the tensor-parallel group: the ``("model",)`` mesh,
    the launch's Communicator over it, and the serving run; rank 0's
    result is the launch's."""
    from repro_torch.comms import Communicator
    p = args.tensor_parallel
    mesh = grp.RankMesh((p,), ("model",), device=grp.device_of(args.device))
    comm = Communicator.create(mesh, artifact=args.tuning_table,
                               probe=args.probe_fabric)
    from repro_torch.kernels.ops import SERVE_COUNTERS as counters
    for mod in counters.values():       # counts: the serving run alone
        mod.launches = 0
    res = _serve(args, cfg, comm, mesh)
    # every rank's tokens (and the fixed loop's last logits, bit for
    # bit) against rank 0's, and the launches summed over the ranks
    from repro_torch import pytree
    mine = [res.get("tokens", np.zeros(0)).tolist(),
            sorted(res.get("generated", {}).items()),
            pytree.fingerprint([res["last_logits"]])
            if "last_logits" in res else None]
    parts = [None] * grp.size()
    dist.all_gather_object(parts, (mine, {k: m.launches
                                          for k, m in counters.items()}))
    res["ranks_equal"] = all(p[0] == parts[0][0] for p in parts)
    res["launches"] = {k: sum(p[1][k] for p in parts) for k in counters}
    return res


def main(argv=None, *, config: dict = None):
    """Serve once; returns the run's summary (what ``--trace-dir`` writes,
    plus the generated tokens; rank 0's under ``--tensor-parallel``).
    ``config`` replaces fields of the model's config (``{"num_layers":
    1}``: a full-width model cut in depth to fit one card), as
    `train.main`'s does."""
    args = parse_args(argv)
    cfg = ARCHITECTURES[args.arch]
    if args.reduced:
        cfg = cfg.reduced()
    if config:
        cfg = cfg.replace(**config)

    comm = None
    if args.tuning_table:
        from repro_torch.comms import Communicator
        from repro_torch.launch.tp_decode import tp_decode_plan
        # the launch's Communicator: probe -> select -> decide (the
        # ranks of --tensor-parallel build theirs over the mesh)
        comm = Communicator.create(artifact=args.tuning_table,
                                   probe=args.probe_fabric)
        print(f"tuning table: {args.tuning_table} ({comm.describe()})")
        # decode-time collectives: per-token TP all-reduce of the residual
        # (B, d) and all-gather of vocab-parallel logits (B, V/p)
        p = args.tensor_parallel or 2
        batch = args.max_active if args.continuous else args.batch
        print(f"  decode plan p={p}")
        print(tp_decode_plan(comm, batch, cfg.d_model,
                             cfg.vocab_size, p).render(indent="    "))
    if args.tensor_parallel < 2:
        return _serve(args, cfg)
    if comm is None:
        raise SystemExit("--tensor-parallel needs --tuning-table")
    from repro_torch.launch.tp_decode import executed_spec
    tp = args.tensor_parallel
    batch = args.max_active if args.continuous else args.batch
    nbytes, spec = executed_spec(comm, args.tp_collective, batch,
                                 cfg.vocab_size, tp)
    print(f"tensor-parallel decode: p={tp} via tuned "
          f"{args.tp_collective} ({nbytes} B -> {spec.algorithm} "
          f"segments={spec.segments})", flush=True)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass --device cpu to serve "
                               "on the host")
        from repro_torch.kernels import _build
        _build.build_all()      # once, before the ranks load it
    res = grp.spawn(_tp_rank_main, tp, (args, cfg))
    res["executed_spec"] = [nbytes, spec.algorithm, spec.segments]
    return res


if __name__ == "__main__":
    main()
