"""Chip smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Imports only the port (``src/repro_torch``), torch and numpy. Phases:

1. device: the card's name and power limit; build every CUDA kernel from
   ``src/repro_torch/csrc`` (nvcc, sm_90a) into ``build/repro_torch/``;
2. kernel vs plain version on the card: flash attention against
   ``flash_attention_plain`` over the reference's test sweep (f32 at
   2e-5, bf16 at 2e-2), the windows, the decode offset and the serving
   shape; times the kernel, the plain version and
   ``F.scaled_dot_product_attention`` (a yardstick only: the port never
   calls it) at the serving shape, beside the bound;
3. the kernel inside the model: full-width smollm-135m prefill logits at
   fp32 with ``attn_impl="auto"`` (kernel) vs ``"ref"`` (plain oracle);
4. fixed-batch serving through ``repro_torch.launch.serve`` at full
   width, bf16: 30 kernel launches (one per layer) for its one prefill;
5. continuous serving (paged KV, 32 Poisson requests): every request gets
   its ``max_new`` tokens and 30 launches per admitted request;
6. where the time goes: torch.profiler over one full-width prefill and
   over decode steps (device busy share, top kernels);
7. the kernels line, then ``{"ok": true, "device": ...}`` as the last line.

Exits nonzero, with no result line, when there is no CUDA device, when
the port is not beside this file, or when any phase fails.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
BF16_FLOP_PER_S = 989e12         # H100 SXM dense bf16 tensor-core peak
FP32_FLOP_PER_S = 67e12          # H100 SXM fp32 outside the tensor cores
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
MODEL_TOL = 1e-3                 # phase 3: 30 layers of the 2e-5 kernel tolerance
SERVE_SHAPE = dict(B=8, S=512, H=9, KV=3, D=64)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_calls(fn, reps: int = 30, warmup: int = 3) -> list:
    """Device time (ms) of each of ``reps`` calls, from CUDA events around
    each call, after ``warmup`` calls. The inputs stay in the 50 MB L2."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def attention_bound_ms(B, S, T, H, KV, D, itemsize, causal=True):
    """Least time for the call: each input read once and the output
    written once over the memory rate, or the QK and PV products of the
    visible (query, key) pairs over the peak rate of the input type."""
    nbytes = itemsize * (2 * B * S * H * D + 2 * B * T * KV * D)
    pairs = B * H * (S * (S + 1) // 2 if causal and S == T else S * T)
    flops = 4 * D * pairs
    peak = BF16_FLOP_PER_S if itemsize == 2 else FP32_FLOP_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations"), nbytes, flops


def rand_qkv(B, S, T, H, KV, D, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda *s: torch.randn(s, generator=g, device="cuda").to(dtype)  # noqa: E731
    return mk(B, S, H, D), mk(B, T, KV, D), mk(B, T, KV, D)


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    log(f"[1] card: {smi}")
    log(f"    torch {torch.__version__} cuda {torch.version.cuda}; "
        f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"    built {sorted(libs)} in {time.perf_counter() - t0:.1f}s "
        f"-> {_build.build_dir()}")
    for name in libs:
        logf = _build.build_dir() / f"{name}.log"
        if logf.exists():
            for line in logf.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"    ptxas {name}: {line.strip()}")
    return smi


def phase_kernel():
    from repro_torch.kernels import attention as fa
    sweep = [((1, 128, 128, 4, 4, 64), {}), ((2, 256, 256, 4, 2, 64), {}),
             ((1, 128, 128, 4, 1, 128), {}), ((1, 96, 96, 2, 2, 80), {})]
    cases = [(shape, dt, kw) for shape, kw in sweep
             for dt in (torch.float32, torch.bfloat16)]
    cases += [((1, 256, 256, 2, 2, 64), torch.float32, {"window": w})
              for w in (1, 17, 64, 256)]
    cases += [((2, 1, 200, 4, 2, 64), torch.float32, {"q_offset": 199})]
    s = SERVE_SHAPE
    serve_case = ((s["B"], s["S"], s["S"], s["H"], s["KV"], s["D"]),
                  torch.bfloat16, {})
    cases.append(serve_case)
    max_err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for i, ((B, S, T, H, KV, D), dt, kw) in enumerate(cases):
        q, k, v = rand_qkv(B, S, T, H, KV, D, dt, seed=i)
        before = fa.launches
        got = fa.flash_attention(q, k, v, causal=True, **kw)
        torch.cuda.synchronize()
        if fa.launches != before + 1:
            raise AssertionError("the wrapper did not count its launch")
        want = fa.flash_attention_plain(q, k, v, causal=True, **kw)
        err = (got.float() - want.float()).abs().max().item()
        bad = (got.float() - want.float()).abs() > \
            TOL[dt] * (1 + want.float().abs())
        if not torch.isfinite(got).all() or bad.any():
            raise AssertionError(f"flash_attention disagrees with plain at "
                                 f"{(B, S, T, H, KV, D)} {dt} {kw}: "
                                 f"max err {err}")
        max_err[dt] = max(max_err[dt], err)
        log(f"[2] {(B, S, T, H, KV, D)} {str(dt)[6:]} {kw}: max|err| {err:.3g}")
    serve_err = err      # the serving shape is the last case
    log(f"    max|err| f32 {max_err[torch.float32]:.3g} (tol 2e-5), "
        f"bf16 {max_err[torch.bfloat16]:.3g} (tol 2e-2)")

    B, S, H, KV, D = s["B"], s["S"], s["H"], s["KV"], s["D"]
    q, k, v = rand_qkv(B, S, S, H, KV, D, torch.bfloat16, seed=99)
    import torch.nn.functional as F
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    # in turns (kernel, plain, library, kernel, plain): one card, one call
    kern = lambda: fa.flash_attention(q, k, v, causal=True)  # noqa: E731
    plain = lambda: fa.flash_attention_plain(q, k, v, causal=True)  # noqa: E731
    k1, p1 = time_calls(kern), time_calls(plain)
    library_ms = statistics.median(time_calls(
        lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)))
    k2, p2 = time_calls(kern), time_calls(plain)
    ms, plain_ms = statistics.median(k1 + k2), statistics.median(p1 + p2)
    ms_turns = (statistics.median(k1), statistics.median(k2))
    bound_ms, bound_by, nbytes, flops = attention_bound_ms(
        B, S, S, H, KV, D, 2)
    log(f"    serving shape B={B} S={S} H={H} KV={KV} D={D} bf16 causal: "
        f"kernel {ms:.4f} ms (turns {ms_turns[0]:.4f}, {ms_turns[1]:.4f}), "
        f"plain {plain_ms:.4f} ms, "
        f"sdpa {library_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}: "
        f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP)")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/attention.py:132",
            "max_abs_err": serve_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
            "max_err_f32": max_err[torch.float32],
            "max_err_bf16": max_err[torch.bfloat16],
            "shape": f"B={B} S={S} H={H} KV={KV} D={D} bf16 causal"}


def phase_model():
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    cfg = get_config("smollm-135m")
    kern = build_model(cfg, compute_dtype=torch.float32, attn_impl="auto")
    plain = build_model(cfg, compute_dtype=torch.float32, attn_impl="ref")
    with torch.inference_mode():
        params = kern.init(torch.Generator().manual_seed(0))
        g = torch.Generator().manual_seed(1)
        tokens = torch.randint(0, cfg.vocab_size, (2, 256), generator=g)
        tokens = tokens.cuda()
        lk, _ = kern.prefill(params, tokens, 256)
        lp, _ = plain.prefill(params, tokens, 256)
        torch.cuda.synchronize()
        valid = slice(0, cfg.vocab_size)
        diff = (lk[..., valid] - lp[..., valid]).abs().max().item()
        scale = lp[..., valid].abs().max().item()
    log(f"[3] smollm-135m full width fp32 prefill (2x256): logits "
        f"kernel vs plain max|diff| {diff:.3g} (max|logit| {scale:.3g}, "
        f"tol {MODEL_TOL})")
    if not (torch.isfinite(lk).all() and diff <= MODEL_TOL):
        raise AssertionError(f"model logits through the kernel differ by "
                             f"{diff} > {MODEL_TOL}")
    del params
    torch.cuda.empty_cache()
    return diff


def phase_fixed(cfg_layers: int):
    from repro_torch.kernels import attention as fa
    from repro_torch.launch import serve
    argv = ["--arch", "smollm-135m", "--batch", "8", "--prompt-len", "512",
            "--gen", "64"]
    log(f"[4] serve {' '.join(argv)}")
    fa.launches = 0
    res = serve.main(argv)
    n = fa.launches
    toks = res["tokens"]
    log(f"    prefill {res['prefill_s']:.4f}s, {res['tok_per_s']:.1f} tok/s, "
        f"per-token p50 {res['token_ms_p50']:.3f} p90 "
        f"{res['token_ms_p90']:.3f} p99 {res['token_ms_p99']:.3f} ms; "
        f"kernel launches {n}")
    if n != cfg_layers:
        raise AssertionError(f"fixed-batch prefill launched the kernel {n} "
                             f"times, expected {cfg_layers}")
    if toks.shape != (8, 64) or toks.min() < 0 or toks.max() >= 49152:
        raise AssertionError(f"bad generated tokens {toks.shape}")
    return n, res


def phase_continuous(cfg_layers: int):
    from repro_torch.kernels import attention as fa
    from repro_torch.launch import serve
    argv = ["--arch", "smollm-135m", "--continuous", "--num-requests", "32",
            "--poisson-rate", "20", "--prompt-len", "512", "--gen", "64",
            "--max-active", "8", "--block-size", "16"]
    log(f"[5] serve {' '.join(argv)}")
    fa.launches = 0
    res = serve.main(argv)
    n = fa.launches
    gen, max_new = res["generated"], res["max_new"]
    log(f"    served {len(gen)} requests, {res['new_tokens']} tokens, "
        f"{res['tok_per_s']:.1f} tok/s, per-token p50 "
        f"{res['token_ms_p50']:.3f} p90 {res['token_ms_p90']:.3f} p99 "
        f"{res['token_ms_p99']:.3f} ms, wall {res['wall_s']:.2f}s; "
        f"kernel launches {n}")
    if len(gen) != 32 or any(len(gen[r]) != max_new[r] for r in max_new):
        raise AssertionError("not every request got its max_new tokens")
    if n != 32 * cfg_layers:
        raise AssertionError(f"continuous serving launched the kernel {n} "
                             f"times, expected {32 * cfg_layers}")
    return n, res


def phase_breakdown():
    """Where the fixed-batch path's time goes: torch.profiler over one
    full-width bf16 prefill (8 x 512) and over 8 decode steps; the
    device's busy share of the wall time and the kernels that fill it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    cfg = get_config("smollm-135m")
    api = build_model(cfg)
    out = {}
    with torch.inference_mode():
        params = api.init(torch.Generator().manual_seed(0))
        g = torch.Generator().manual_seed(2)
        prompt = torch.randint(0, cfg.vocab_size, (8, 512), generator=g).cuda()
        logits, cache = api.prefill(params, prompt, 576)
        tok = torch.argmax(logits[:, -1], -1)[:, None]
        api.decode_step(params, cache, tok)
        torch.cuda.synchronize()
        for name, reps, fn in (
                ("prefill", 1, lambda: api.prefill(params, prompt, 576)),
                ("decode", 8, lambda: api.decode_step(params, cache, tok))):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                wall_ms = 1e3 * (time.perf_counter() - t0) / reps
            by_kernel = {}
            for e in prof.events():
                if e.device_type == DeviceType.CUDA:
                    by_kernel[e.name] = by_kernel.get(e.name, 0.0) + \
                        e.time_range.elapsed_us() / 1e3 / reps
            busy = sum(by_kernel.values())
            top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
            n_kernels = sum(1 for e in prof.events()
                            if e.device_type == DeviceType.CUDA) // reps
            out[name] = {"wall_ms": wall_ms, "device_busy_ms": busy,
                         "kernels_per_call": n_kernels,
                         "top": [(k[:60], v) for k, v in top]}
            share = f"{busy / wall_ms:.3f}" if busy else "not measured"
            log(f"[6] {name}: wall {wall_ms:.3f} ms/call, device busy "
                f"{busy:.3f} ms/call (share {share}), {n_kernels} kernels")
            for k, v in top:
                log(f"      {v:9.4f} ms  {k[:90]}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    smi = phase_device()
    kern = phase_kernel()
    diff = phase_model()
    n_fixed, fixed = phase_fixed(30)
    n_cont, cont = phase_continuous(30)
    breakdown = phase_breakdown()
    kern["launches"] = n_fixed + n_cont
    kern["launches_by_path"] = {"fixed_batch": n_fixed,
                                "continuous": n_cont}
    log(f"    total {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"card": smi, "model_logit_diff_fp32": diff,
                      "breakdown": breakdown,
                      "fixed": {k: fixed[k] for k in (
                          "prefill_s", "tok_per_s", "token_ms_p50",
                          "token_ms_p90", "token_ms_p99")},
                      "continuous": {"requests": len(cont["generated"]),
                                     **{k: cont[k] for k in (
                                         "new_tokens", "tok_per_s", "wall_s",
                                         "token_ms_p50", "token_ms_p90",
                                         "token_ms_p99")}}}))
    print(json.dumps({"kernels": [kern]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
