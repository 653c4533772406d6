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

Runs on the GPU (``--device cuda``, the default; no GPU is an error) or,
when asked, on the CPU, where the kernels take their plain PyTorch
versions. Weights are random, drawn by a ``torch.Generator`` with seed 0
on the serving device. For the SSM and hybrid families (mamba2-130m,
zamba2-2.7b) a prompt longer than the scan's chunk (``ssm_chunk``, 128;
32 with ``--reduced``) must be a multiple of it. The reference's
``--tuning-table``/``--tensor-parallel``/``--tp-collective``
/``--probe-fabric`` arrive with the collectives slice.

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
    python -m repro_torch.launch.serve --arch smollm-135m --reduced \\
        --device cpu --batch 2 --prompt-len 8 --gen 4
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from repro_torch.configs import ARCHITECTURES
from repro_torch.models import ssm
from repro_torch.models.registry import build_model


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _serve_continuous(args, cfg, api, params):
    from repro_torch.obs import export as obs_export
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
                         view_len=view_len, block_size=bs)
    sched = Scheduler(trace, max_active=args.max_active,
                      token_budget=args.max_active * view_len,
                      slo_ms=args.slo_ms)
    print(f"continuous serving: arch={cfg.name} requests={len(trace)} "
          f"max_active={args.max_active} block={bs} view={view_len} "
          f"slo_ms={args.slo_ms} device={api.device}")
    res = engine.run(sched)
    s = res.summary
    print(f"served {s['requests']} requests, {s['new_tokens']} tokens "
          f"in {res.wall_s:.2f}s ({s['tok_per_s']:.1f} tok/s)")
    print(f"per-token decode latency: p50 {s['token_ms_p50']:.2f} ms  "
          f"p90 {s['token_ms_p90']:.2f} ms  p99 {s['token_ms_p99']:.2f} ms")
    if args.slo_ms:
        ok = s["token_ms_p99"] <= args.slo_ms
        print(f"SLO p99 <= {args.slo_ms:.0f} ms: "
              f"{'met' if ok else 'MISSED'}")

    out = {"arch": cfg.name, "mode": "continuous",
           "max_active": args.max_active, "block_size": bs,
           "view_len": view_len, "slo_ms": args.slo_ms,
           "wall_s": res.wall_s, "decode_steps": engine.decode_steps, **s,
           "requests": res.records}
    if args.trace_dir:
        os.makedirs(args.trace_dir, exist_ok=True)
        obs_export.write_summary(
            os.path.join(args.trace_dir, "decode_summary.json"), extra=out)
        print(f"decode summary -> {args.trace_dir}/decode_summary.json")
    out["generated"] = {r.rid: list(r.generated) for r in sched.finished}
    out["max_new"] = {r.rid: r.max_new for r in trace}
    return out


def _check_prompt_lens(cfg, lens) -> None:
    """The SSM families' chunked scan: a prompt longer than the chunk must
    be a multiple of it. Raises before any prompt is served."""
    if cfg.family in ("ssm", "hybrid"):
        for n in sorted(set(lens)):
            ssm.check_prompt_len(cfg, n)


def _serve_fixed(args, cfg, api, params):
    """The fixed-batch validation oracle: one batched prefill, then greedy
    decode with every token synced before the next issues."""
    B = args.batch
    cache_len = args.prompt_len + args.gen
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (B, args.prompt_len))).to(api.device)

    t0 = time.perf_counter()
    logits, cache = api.prefill(params, prompt, cache_len)
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
        logits, cache = api.decode_step(params, cache, tok)
        tok = torch.argmax(logits, -1)[:, None]
        _sync(api.device)
        tok_ms.append((time.perf_counter() - tt0) * 1e3)
    t_gen = time.perf_counter() - t0

    gen = torch.cat(out, dim=1).cpu().numpy()
    p50, p90, p99 = np.percentile(tok_ms, [50, 90, 99])
    print(f"arch={cfg.name} batch={B} prompt={args.prompt_len} "
          f"gen={args.gen} device={api.device}")
    print(f"prefill: {t_prefill:.2f}s  decode: {t_gen:.2f}s "
          f"({B * args.gen / t_gen:.1f} tok/s)")
    print(f"per-token decode latency: p50 {p50:.2f} ms  "
          f"p90 {p90:.2f} ms  p99 {p99:.2f} ms")
    print("sample tokens:", gen[0, :16].tolist())

    res = {"arch": cfg.name, "batch": B, "prompt_len": args.prompt_len,
           "gen": args.gen, "decode_steps": args.gen,
           "prefill_s": t_prefill, "decode_s": t_gen,
           "tok_per_s": B * args.gen / t_gen,
           "token_ms_p50": float(p50), "token_ms_p90": float(p90),
           "token_ms_p99": float(p99)}
    if args.trace_dir:
        from repro_torch.obs import export as obs_export
        os.makedirs(args.trace_dir, exist_ok=True)
        obs_export.write_summary(
            os.path.join(args.trace_dir, "decode_summary.json"), extra=res)
        print(f"decode summary -> {args.trace_dir}/decode_summary.json")
    res["tokens"] = gen
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
    ap.add_argument("--trace-dir", default=None,
                    help="write decode_summary.json here (per-token "
                         "latency percentiles + throughput + config; "
                         "with --continuous also per-request spans)")
    return ap.parse_args(argv)


def main(argv=None):
    """Serve once; returns the run's summary (what ``--trace-dir`` writes,
    plus the generated tokens)."""
    args = parse_args(argv)
    cfg = ARCHITECTURES[args.arch]
    if args.reduced:
        cfg = cfg.reduced()
    api = build_model(cfg, window=args.window, attn_impl="auto",
                      device=args.device)
    with torch.inference_mode():
        params = api.init(torch.Generator(device=api.device).manual_seed(0))
        if args.continuous:
            return _serve_continuous(args, cfg, api, params)
        return _serve_fixed(args, cfg, api, params)


if __name__ == "__main__":
    main()
