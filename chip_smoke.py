"""Chip smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Imports only the port (``src/repro_torch``), torch and numpy. Phases:

1. device: the card's name and power limit; build every CUDA kernel from
   ``src/repro_torch/csrc`` (nvcc, sm_90a, one process per source, all
   started together) into ``build/repro_torch/``;
2. kernels vs plain versions on the card:
   a. flash attention against ``flash_attention_plain`` over the
      reference's test sweep (f32 at 2e-5, bf16 at 2e-2), the windows,
      the decode offset, zamba2's shared-attention shapes (D=80,
      H=KV=32) and smollm's serving shape; times the kernel, the
      plain version and ``F.scaled_dot_product_attention`` (a yardstick
      only: the port never calls it) at the serving shape, beside the
      bound;
   b. the SSD chunk kernel against ``ssd_chunked_plain`` (all three
      outputs) over the reference's sweep in f32 (5e-5) and bf16 (5e-2),
      Q=100, Q=7 and both models' serving shapes; times kernel and plain
      at mamba2's serving shape beside the bound (no single PyTorch call
      computes this function, so there is no library time);
   c. the segment-combine kernel against ``segment_combine_plain`` over
      the reference's sweep (n in 7, 128, 1000, 65536), 16M elements and
      misaligned row slices, f32 and bf16, add/max/min, at the
      reference's 1e-6 (it is expected bit-equal; the count of bit-equal
      cases is printed); times kernel, plain and ``torch.add`` (the
      yardstick) at 16M elements f32 and bf16 beside the bound;
   d. the paged decode attention kernel against ``ref.paged_attention_ref``
      (the gather path) over the reference's sweep (partial, full,
      wrapped and several-wraps-deep views, windows 0 and 6, shuffled
      tables) at head dims 64, 80 and 128 and the three serving shapes
      (smollm, zamba2, olmoe), f32 at 2e-5 and bf16 at 2e-2; times the
      kernel and the plain version at each serving shape beside the
      bound (no single PyTorch call computes this function);
3. the kernels inside the models, fp32: full-width smollm-135m prefill
   logits with ``attn_impl="auto"`` (kernel) vs ``"ref"``;
   full-width, full-depth mamba2-130m and zamba2-2.7b prefill logits
   with ``ssd_impl``/``attn_impl="auto"`` (kernels) vs ``"xla"``/``"ref"``
   (the plain chunked SSD oracle, plain attention), with both launch
   counts read from the kernel prefill; olmoe-1b-7b at full width and
   depth: prefill logits through the flash kernel vs plain attention,
   then the continuous engine decoding through the paged kernel vs the
   engine decoding through the gather path, the same requests on a
   simulated clock: tokens equal and logits within 1e-3 over fp32
   pools, the launches one per layer per decode step (and, printed
   only, the same comparison over the serving dtype's bf16 pools, where
   the two round q and the probabilities differently);
4. serving through ``repro_torch.launch.serve`` at full width, bf16, each
   path with every launch count zeroed just before it and read just
   after: smollm-135m, mamba2-130m, zamba2-2.7b (full depth: 54 SSM
   layers, 9 shared-attention applications) and olmoe-1b-7b (full
   depth: 16 layers of 64 experts), each in the fixed-batch and the
   continuous mode; the counts must be one flash or SSD launch per layer
   for every prefill, one paged-attention launch per attention layer for
   every decode step of a continuous path (none on a fixed path), and
   zero for a kernel off the path;
5. where the time goes: torch.profiler over one full-width prefill and
   over decode steps of each model (device busy share, top kernels);
6. tuned collectives through ``repro_torch.launch.measure_collectives``
   at 4 ranks on the card (processes under a gloo group, payloads staged
   through the host, every reduce step in the segment-combine kernel):
   every algorithm and synthesized program held against the oracle at
   4 MB and an odd size; every (algorithm, segments) candidate of
   all_reduce and broadcast timed at 4 KB, 256 KB, 4 MB and 64 MB over 3
   trials, the exhaustive tuner's table printed, saved and loaded back,
   with the launch counts gathered from the ranks (zeroed just before the
   tuning run, read just after: every reducing algorithm launches the
   kernel exactly as its schedule says); then smollm-135m's whole fp32
   gradient, counted from the port's model, all-reduced through the
   tuned choice and through ``"xla"`` (gloo's all-reduce), each held
   against the oracle sum and timed;
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
SSD_TOL = {torch.float32: 5e-5, torch.bfloat16: 5e-2}   # tests/test_kernels.py
MODEL_TOL = 1e-3                 # phase 3: 24-54 layers of the kernel tolerance
COMBINE_TOL = 1e-6               # tests/test_kernels.py (expected bit-equal)
COMBINE_N = 1 << 24              # 16M elements: 64 MB of fp32 per operand
RANKS = 4                        # processes on the card for the collectives
SERVE_SHAPE = dict(B=8, S=512, H=9, KV=3, D=64)
# mamba2-130m's SSD call at the fixed-batch serving shape (8 x 512 prompts)
SSD_SERVE_SHAPE = dict(B=8, S=512, H=24, P=64, N=128, Q=128)
# the paged decode attention at each continuous path's shape: requests
# (slots), query heads, KV heads, head dim, block size, view length
PAGED_SERVE_SHAPES = {
    "smollm-135m": dict(R=8, H=9, KV=3, D=64, bs=16, T=576),
    "zamba2-2.7b": dict(R=4, H=32, KV=32, D=80, bs=16, T=528),
    "olmoe-1b-7b": dict(R=4, H=16, KV=16, D=128, bs=16, T=528),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_calls(fn, reps: int = 20, runs: int = 5, warmup: int = 3) -> list:
    """Device time (ms per call) of each of ``runs`` runs of ``reps``
    back-to-back calls, one pair of CUDA events around each run, after
    ``warmup`` calls: the host's launch work overlaps the device's as it
    does on the serving path. The inputs are warm in the 50 MB L2."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
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
    # zamba2's shared attention: fixed batch (4 x 512) and the continuous
    # mode's one-request prefills (128 and 512)
    cases += [((4, 512, 512, 32, 32, 80), torch.bfloat16, {}),
              ((1, 128, 128, 32, 32, 80), torch.bfloat16, {}),
              ((1, 512, 512, 32, 32, 80), torch.bfloat16, {})]
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


def ssd_bound_ms(B, S, H, P, N, Q, itemsize):
    """Least time for the call: x, dt, A, B and C read once and y_intra,
    states and cum written once over the memory rate, or the operations
    the data needs over the peak rate of the input type: C B^T on the
    lower triangle once per (batch, chunk) (B and C are shared by the
    heads), scores times x on the lower triangle and the chunk state's
    N x Q x P product per (batch, head, chunk)."""
    nc = S // Q
    nbytes = (itemsize * (B * S * H * P + 2 * B * S * N) + 4 * B * S * H
              + 4 * H + 4 * B * H * nc * (Q * P + N * P + Q))
    pairs = Q * (Q + 1) // 2
    flops = (2 * N * pairs * B * nc
             + B * H * nc * (2 * P * pairs + 2 * N * Q * P))
    peak = BF16_FLOP_PER_S if itemsize == 2 else FP32_FLOP_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations"), nbytes, flops


def rand_ssd(B, S, H, P, N, dtype, seed):
    """x, B and C as column slices of one (B, S, H*P + 2N) tensor, as the
    model's conv output hands them to the kernel (read through strides)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    xbc = torch.randn((B, S, H * P + 2 * N), generator=g,
                      device="cuda").to(dtype)
    x = xbc[..., :H * P].reshape(B, S, H, P)
    dt = 0.001 + 0.099 * torch.rand((B, S, H), generator=g, device="cuda")
    A = -(0.5 + 1.5 * torch.rand((H,), generator=g, device="cuda"))
    return x, dt, A, xbc[..., H * P:H * P + N], xbc[..., H * P + N:]


def phase_ssd_kernel():
    from repro_torch.kernels import ssd_scan
    sweep = [(1, 64, 2, 64, 32, 32), (2, 128, 3, 64, 64, 32),
             (1, 128, 1, 32, 128, 64)]                # tests/test_kernels.py
    cases = [(shape, dt) for shape in sweep
             for dt in (torch.float32, torch.bfloat16)]
    cases += [((1, 200, 2, 64, 128, 100), dt)          # Q = 100
              for dt in (torch.float32, torch.bfloat16)]
    cases += [((2, 14, 3, 64, 128, 7), dt)             # Q = 7, two chunks
              for dt in (torch.float32, torch.bfloat16)]
    cases.append(((4, 512, 80, 64, 64, 128), torch.bfloat16))  # zamba2 serving
    s = SSD_SERVE_SHAPE
    cases.append(((s["B"], s["S"], s["H"], s["P"], s["N"], s["Q"]),
                  torch.bfloat16))                     # mamba2 serving, last
    max_err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for i, ((B, S, H, P, N, Q), dt) in enumerate(cases):
        x, dts, A, Bm, Cm = rand_ssd(B, S, H, P, N, dt, seed=100 + i)
        before = ssd_scan.launches
        got = ssd_scan.ssd_chunk(x, dts, A, Bm, Cm, chunk=Q)
        torch.cuda.synchronize()
        if ssd_scan.launches != before + 1:
            raise AssertionError("the wrapper did not count its launch")
        want = ssd_scan.ssd_chunked_plain(x, dts, A, Bm, Cm, chunk=Q)
        err = 0.0
        for name, g_, w_ in zip(("y_intra", "states", "cum"), got, want):
            diff = (g_ - w_).abs()
            bad = diff > SSD_TOL[dt] * (1 + w_.abs())
            if g_.shape != w_.shape or not torch.isfinite(g_).all() \
                    or bad.any():
                raise AssertionError(
                    f"ssd_chunk {name} disagrees with plain at "
                    f"{(B, S, H, P, N, Q)} {dt}: max err "
                    f"{diff.max().item()}")
            err = max(err, diff.max().item())
        max_err[dt] = max(max_err[dt], err)
        log(f"[2b] ssd {(B, S, H, P, N, Q)} {str(dt)[6:]}: max|err| {err:.3g}")
    serve_err = err      # the mamba2 serving shape is the last case
    log(f"    max|err| f32 {max_err[torch.float32]:.3g} (tol 5e-5), "
        f"bf16 {max_err[torch.bfloat16]:.3g} (tol 5e-2)")

    B, S, H, P, N, Q = (s[k] for k in ("B", "S", "H", "P", "N", "Q"))
    x, dts, A, Bm, Cm = rand_ssd(B, S, H, P, N, torch.bfloat16, seed=99)
    kern = lambda: ssd_scan.ssd_chunk(x, dts, A, Bm, Cm, chunk=Q)  # noqa: E731
    plain = lambda: ssd_scan.ssd_chunked_plain(  # noqa: E731
        x, dts, A, Bm, Cm, chunk=Q)
    # in turns (kernel, plain, kernel, plain): one card, one call
    k1, p1 = time_calls(kern), time_calls(plain)
    k2, p2 = time_calls(kern), time_calls(plain)
    ms, plain_ms = statistics.median(k1 + k2), statistics.median(p1 + p2)
    bound_ms, bound_by, nbytes, flops = ssd_bound_ms(B, S, H, P, N, Q, 2)
    log(f"    serving shape B={B} S={S} H={H} P={P} N={N} Q={Q} bf16: "
        f"kernel {ms:.4f} ms (turns {statistics.median(k1):.4f}, "
        f"{statistics.median(k2):.4f}), plain {plain_ms:.4f} ms, "
        f"bound {bound_ms:.5f} ms ({bound_by}: {nbytes / 1e6:.2f} MB, "
        f"{flops / 1e9:.3f} GFLOP); no single library call")
    return {"name": "ssd_chunk", "route": "cuda",
            "source": "src/repro_torch/csrc/ssd_chunk.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:81",
            "max_abs_err": serve_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "max_err_f32": max_err[torch.float32],
            "max_err_bf16": max_err[torch.bfloat16],
            "shape": f"B={B} S={S} H={H} P={P} N={N} Q={Q} bf16"}


def combine_bound_ms(n, itemsize):
    """Least time for the call: acc and part read once and out written
    once over the memory rate, or the n fp32 operations over the fp32
    rate outside the tensor cores."""
    nbytes = 3 * n * itemsize
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, n / FP32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations"), nbytes


def phase_combine_kernel():
    from repro_torch.kernels import segment_reduce as sr
    # (n, element offset of acc): the reference's sweep, 16M elements,
    # and row slices that start off a 16-byte boundary, as a ring's
    # segments do
    shapes = [(7, 0), (128, 0), (1000, 0), (65536, 0), (4099, 0),
              (COMBINE_N, 0), (1000, 1), (65536, 3), (4099, 5),
              ((1 << 20) + 1, 2)]
    cases = [(n, off, dt, op) for n, off in shapes
             for dt in (torch.float32, torch.bfloat16)
             for op in ("add", "max", "min")]
    g = torch.Generator(device="cuda").manual_seed(7)
    max_err, equal = 0.0, 0
    for n, off, dt, op in cases:
        acc = torch.randn((n + off,), generator=g, device="cuda").to(dt)[off:]
        part = torch.randn((n,), generator=g, device="cuda").to(dt)
        before = sr.launches
        got = sr.segment_combine(acc, part, op)
        torch.cuda.synchronize()
        if sr.launches != before + 1:
            raise AssertionError("the wrapper did not count its launch")
        want = sr.segment_combine_plain(acc, part, op)
        err = (got.float() - want.float()).abs().max().item()
        if got.dtype != dt or not torch.isfinite(got).all() \
                or not err <= COMBINE_TOL:
            raise AssertionError(f"segment_combine disagrees with plain at "
                                 f"n={n} offset={off} {dt} {op}: {err}")
        max_err = max(max_err, err)
        equal += bool(torch.equal(got, want))
    log(f"[2c] segment_combine: {len(cases)} cases (n 7..{COMBINE_N}, "
        f"offsets 0-5, f32/bf16, add/max/min), max|err| {max_err:.3g} "
        f"(tol {COMBINE_TOL}), bit-equal {equal}/{len(cases)}")

    out = {"name": "segment_combine", "route": "cuda",
           "source": "src/repro_torch/csrc/segment_combine.cu",
           "replaces": "src/repro/kernels/segment_reduce.py:63",
           "max_abs_err": max_err, "bit_equal_cases": equal,
           "cases": len(cases)}
    for dt in (torch.float32, torch.bfloat16):
        a = torch.randn((COMBINE_N,), generator=g, device="cuda").to(dt)
        b = torch.randn((COMBINE_N,), generator=g, device="cuda").to(dt)
        kern = lambda: sr.segment_combine(a, b, "add")  # noqa: E731
        plain = lambda: sr.segment_combine_plain(a, b, "add")  # noqa: E731
        lib = lambda: torch.add(a, b)  # noqa: E731
        # in turns (kernel, plain, library, kernel, plain): one card
        k1, p1, l1 = time_calls(kern), time_calls(plain), time_calls(lib)
        k2, p2 = time_calls(kern), time_calls(plain)
        ms, plain_ms = statistics.median(k1 + k2), statistics.median(p1 + p2)
        library_ms = statistics.median(l1)
        bound_ms, bound_by, nbytes = combine_bound_ms(COMBINE_N,
                                                      a.element_size())
        name = str(dt)[6:]
        log(f"    n={COMBINE_N} {name} add: kernel {ms:.4f} ms (turns "
            f"{statistics.median(k1):.4f}, {statistics.median(k2):.4f}), "
            f"plain {plain_ms:.4f} ms, torch.add {library_ms:.4f} ms, "
            f"bound {bound_ms:.5f} ms ({bound_by}: {nbytes / 1e6:.1f} MB)")
        if dt == torch.float32:
            out.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by, library_ms=library_ms,
                       shape=f"n={COMBINE_N} f32 add")
        else:
            out.update(ms_bf16=ms, plain_ms_bf16=plain_ms,
                       bound_ms_bf16=bound_ms, library_ms_bf16=library_ms)
    del a, b
    torch.cuda.empty_cache()
    return out


def rand_paged(R, H, KV, D, bs, nb, dtype, seed):
    """q, pools with a null block 0, and shuffled int32 tables on the
    card, as the engine lays them out."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    NB = 1 + R * nb
    kp = torch.randn((NB, bs, KV, D), generator=g, device="cuda").to(dtype)
    vp = torch.randn((NB, bs, KV, D), generator=g, device="cuda").to(dtype)
    perm = torch.randperm(R * nb, generator=g, device="cuda")
    tables = (1 + perm).reshape(R, nb).to(torch.int32)
    q = torch.randn((R, 1, H, D), generator=g, device="cuda").to(dtype)
    return q, kp, vp, tables


def paged_bound_ms(R, H, KV, D, T, itemsize):
    """Least time for a call over full views (every slot valid): each
    request's K and V view read once, q, the tables and lengths read
    and the output written once over the memory rate, or the QK and PV
    products of every (query head, slot) over the peak rate of the
    input type."""
    nbytes = (itemsize * (2 * R * T * KV * D + 2 * R * H * D)
              + 4 * (R * T // 16 + R))
    flops = 4 * D * H * T * R
    peak = BF16_FLOP_PER_S if itemsize == 2 else FP32_FLOP_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations"), nbytes, flops


def phase_paged_kernel():
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    # tests/test_paged_attention.py's setup (3 requests of 3 blocks of 4
    # slots, 2 KV heads, 4 query heads) at each built head dim, windows 0
    # and 6, partial/full/wrapped and several-wraps-deep views
    cases = []
    for D in (64, 80, 128):
        for window in (0, 6):
            for lens in ((5, 12, 17), (27, 36, 13)):
                for dt in (torch.float32, torch.bfloat16):
                    cases.append((dict(R=3, H=4, KV=2, D=D, bs=4, T=12),
                                  lens, window, dt))
    for arch, s in PAGED_SERVE_SHAPES.items():
        T = s["T"]
        lens = tuple(([T - 64, T, T + 100, 3 * T + 5, 1, 200] * 2)[:s["R"]])
        for dt in (torch.float32, torch.bfloat16):
            cases.append((s, lens, 0, dt))
    max_err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for i, (s, lens, window, dt) in enumerate(cases):
        q, kp, vp, tables = rand_paged(s["R"], s["H"], s["KV"], s["D"],
                                       s["bs"], s["T"] // s["bs"], dt,
                                       seed=300 + i)
        lengths = torch.tensor(lens, device="cuda")
        before = pa.launches
        got = pa.paged_attention(q, kp, vp, tables, lengths, window=window)
        torch.cuda.synchronize()
        if pa.launches != before + 1:
            raise AssertionError("the wrapper did not count its launch")
        want = ref.paged_attention_ref(q, kp, vp, tables, lengths,
                                       window=window)
        diff = (got.float() - want.float()).abs()
        err = diff.max().item()
        if got.dtype != dt or not torch.isfinite(got).all() or \
                (diff > TOL[dt] * (1 + want.float().abs())).any():
            raise AssertionError(f"paged_attention disagrees with plain at "
                                 f"{s} lengths {lens} window {window} {dt}: "
                                 f"max err {err}")
        max_err[dt] = max(max_err[dt], err)
    log(f"[2d] paged_attention: {len(cases)} cases (head dims 64/80/128, "
        f"windows 0/6, partial/full/wrapped views, the 3 serving shapes), "
        f"max|err| f32 {max_err[torch.float32]:.3g} (tol 2e-5), bf16 "
        f"{max_err[torch.bfloat16]:.3g} (tol 2e-2)")

    out = {"name": "paged_attention", "route": "cuda",
           "source": "src/repro_torch/csrc/paged_attention.cu",
           "replaces": "src/repro/kernels/paged_attention.py:179",
           "max_abs_err": max_err[torch.bfloat16],
           "max_err_f32": max_err[torch.float32],
           "max_err_bf16": max_err[torch.bfloat16], "library_ms": None,
           "by_shape": {}}
    for arch, s in PAGED_SERVE_SHAPES.items():
        R, H, KV, D, bs, T = (s[k] for k in ("R", "H", "KV", "D", "bs", "T"))
        q, kp, vp, tables = rand_paged(R, H, KV, D, bs, T // bs,
                                       torch.bfloat16, seed=99)
        lengths = torch.full((R,), T, device="cuda")     # full views
        kern = lambda: pa.paged_attention(  # noqa: E731
            q, kp, vp, tables, lengths)
        plain = lambda: ref.paged_attention_ref(  # noqa: E731
            q, kp, vp, tables, lengths)
        # in turns (kernel, plain, kernel, plain): one card, one call
        k1, p1 = time_calls(kern), time_calls(plain)
        k2, p2 = time_calls(kern), time_calls(plain)
        ms, plain_ms = statistics.median(k1 + k2), statistics.median(p1 + p2)
        bound_ms, bound_by, nbytes, flops = paged_bound_ms(R, H, KV, D, T, 2)
        log(f"    {arch} R={R} H={H} KV={KV} D={D} block {bs} view {T} "
            f"bf16: kernel {ms:.4f} ms (turns {statistics.median(k1):.4f}, "
            f"{statistics.median(k2):.4f}), plain {plain_ms:.4f} ms, bound "
            f"{bound_ms:.5f} ms ({bound_by}: {nbytes / 1e6:.3f} MB, "
            f"{flops / 1e9:.4f} GFLOP); no single library call")
        out["by_shape"][arch] = {"ms": ms, "plain_ms": plain_ms,
                                 "bound_ms": bound_ms}
        if arch == "smollm-135m":
            out.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by,
                       shape=f"R={R} H={H} KV={KV} D={D} bs={bs} view={T} "
                             f"bf16")
    return out


def moe_engine_run(api, params, attn_impl, pool_dtype):
    """The continuous engine on a simulated clock (so admission is the
    same in every run) over 6 requests; returns the tokens, the logits
    of the active rows of every decode step, the decode steps and the
    paged-attention launches."""
    import dataclasses
    import functools

    from repro_torch.kernels import paged_attention as pa
    from repro_torch.serve import Scheduler, ServeEngine, synthetic_trace
    logits, step = [], api.decode_step

    def record(params_, cache, tokens, **kw):
        out = step(params_, cache, tokens, **kw)
        active = cache["block_tables"][:, 0] != 0       # live slots own blocks
        logits.append(out[0][active].float())
        return out
    api = dataclasses.replace(
        api, decode_step=record,
        init_cache=functools.partial(api.init_cache, dtype=pool_dtype))
    trace = synthetic_trace(6, rate_rps=20.0, vocab=api.cfg.vocab_size,
                            prompt_lens=(128, 256, 512), max_new=8, seed=0)
    engine = ServeEngine(api, params, max_active=4, view_len=528,
                         block_size=16, attn_impl=attn_impl)
    sched = Scheduler(trace, max_active=4, token_budget=4 * 528)
    pa.launches = 0
    engine.run(sched, cost_model=lambda kind, n: 1e-3)
    tokens = {r.rid: list(r.generated) for r in sched.finished}
    return tokens, logits, engine.decode_steps, pa.launches


def phase_moe_model():
    """olmoe-1b-7b at full width and depth, fp32: prefill logits through
    the flash kernel vs plain attention (one flash launch per layer),
    then the continuous engine through the paged kernel vs through the
    gather path."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import attention
    from repro_torch.models.registry import build_model
    cfg = get_config("olmoe-1b-7b")
    kern = build_model(cfg, compute_dtype=torch.float32, attn_impl="auto")
    plain = build_model(cfg, compute_dtype=torch.float32, attn_impl="ref")
    out = {}
    with torch.inference_mode():
        params = kern.init(torch.Generator(device="cuda").manual_seed(0))
        g = torch.Generator().manual_seed(1)
        tokens = torch.randint(0, cfg.vocab_size, (2, 256), generator=g)
        tokens = tokens.cuda()
        attention.launches = 0
        lk, _ = kern.prefill(params, tokens, 256)
        fa = attention.launches
        lp, _ = plain.prefill(params, tokens, 256)
        torch.cuda.synchronize()
        valid = slice(0, cfg.vocab_size)
        diff = (lk[..., valid] - lp[..., valid]).abs().max().item()
        scale = lp[..., valid].abs().max().item()
        log(f"[3c] olmoe-1b-7b full width/depth fp32 prefill (2x256): logits "
            f"kernel vs plain max|diff| {diff:.3g} (max|logit| {scale:.3g}, "
            f"tol {MODEL_TOL}); flash_attention launches {fa}")
        if not (torch.isfinite(lk).all() and diff <= MODEL_TOL):
            raise AssertionError(f"olmoe logits through the kernel differ by "
                                 f"{diff} > {MODEL_TOL}")
        if fa != cfg.num_layers:
            raise AssertionError(f"olmoe prefill launched flash_attention "
                                 f"{fa} times, expected {cfg.num_layers}")
        out["prefill_logit_diff"] = diff
        del lk, lp
        for pool_dtype in (torch.float32, torch.bfloat16):
            t0 = time.perf_counter()
            kt, kl, steps, launches = moe_engine_run(kern, params, "auto",
                                                     pool_dtype)
            xt, xl, xsteps, xlaunches = moe_engine_run(kern, params, "xla",
                                                       pool_dtype)
            same = kt == xt
            n = min(len(kl), len(xl))
            ldiff = max(((a - b)[:, valid].abs().max().item()
                         for a, b in zip(kl[:n], xl[:n])
                         if a.shape == b.shape), default=float("inf"))
            name = str(pool_dtype)[6:]
            log(f"    engine over {name} pools, 6 requests, 8 new tokens: "
                f"paged kernel vs gather path tokens "
                f"{'equal' if same else 'DIFFER'}, active-row logits "
                f"max|diff| {ldiff:.3g} over {n} steps; decode steps "
                f"{steps}/{xsteps}, paged launches {launches}/{xlaunches} "
                f"({time.perf_counter() - t0:.1f}s)")
            out[f"engine_{name}"] = {"tokens_equal": same, "logit_diff": ldiff,
                                     "decode_steps": steps,
                                     "launches": launches}
            if launches != steps * cfg.num_layers or xlaunches != 0:
                raise AssertionError(f"paged launches {launches}/{xlaunches} "
                                     f"over {steps} steps, expected "
                                     f"{steps * cfg.num_layers}/0")
            if pool_dtype == torch.float32 and not (
                    same and len(kl) == len(xl) and ldiff <= MODEL_TOL):
                raise AssertionError(f"olmoe engine through the paged kernel "
                                     f"differs from the gather path: tokens "
                                     f"equal {same}, logits {ldiff}")
    del params
    torch.cuda.empty_cache()
    return out


def phase_ssm_model(arch: str, batch: int):
    """Full-width, full-depth fp32 prefill logits of an SSM-family model
    through the kernels (``"auto"``) against the plain chunked SSD oracle
    (``ssd_impl="xla"``) and, for the hybrid, plain attention
    (``attn_impl="ref"``); both counts are zeroed just before the kernel
    prefill and read just after: one ssd launch per SSM layer and one
    flash-attention launch per shared-attention application."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import attention, ssd_scan
    from repro_torch.models.registry import build_model
    cfg = get_config(arch)
    hybrid = cfg.family == "hybrid"
    kern = build_model(cfg, compute_dtype=torch.float32, ssd_impl="auto",
                       attn_impl="auto")
    plain = build_model(cfg, compute_dtype=torch.float32, ssd_impl="xla",
                        attn_impl="ref")
    want = {"ssd_chunk": cfg.num_layers,
            "flash_attention": (cfg.num_layers // cfg.attn_every
                                if hybrid else 0)}
    with torch.inference_mode():
        params = kern.init(torch.Generator(device="cuda").manual_seed(0))
        g = torch.Generator().manual_seed(1)
        tokens = torch.randint(0, cfg.vocab_size, (batch, 512), generator=g)
        tokens = tokens.cuda()
        ssd_scan.launches = attention.launches = 0
        lk, ck = kern.prefill(params, tokens, 512)
        got = {"ssd_chunk": ssd_scan.launches,
               "flash_attention": attention.launches}
        lp, cp = plain.prefill(params, tokens, 512)
        torch.cuda.synchronize()
        valid = slice(0, cfg.vocab_size)
        diff = (lk[..., valid] - lp[..., valid]).abs().max().item()
        scale = lp[..., valid].abs().max().item()
        state = ck["ssm"] if hybrid else ck
        state_p = cp["ssm"] if hybrid else cp
        sdiff = (state["ssd"] - state_p["ssd"]).abs().max().item()
    log(f"[3b] {arch} full width/depth fp32 prefill ({batch}x512): logits "
        f"kernel vs plain max|diff| {diff:.3g} (max|logit| {scale:.3g}, "
        f"tol {MODEL_TOL}); decode state max|diff| {sdiff:.3g}; "
        f"launches {got}")
    if not (torch.isfinite(lk).all() and diff <= MODEL_TOL):
        raise AssertionError(f"{arch} logits through the kernels differ by "
                             f"{diff} > {MODEL_TOL}")
    if got != want:
        raise AssertionError(f"{arch} prefill launched {got}, expected "
                             f"{want}")
    del params, lk, lp, ck, cp
    torch.cuda.empty_cache()
    return diff


def _counters():
    from repro_torch.kernels import attention, paged_attention, \
        segment_reduce, ssd_scan
    return {"flash_attention": attention, "ssd_chunk": ssd_scan,
            "segment_combine": segment_reduce,
            "paged_attention": paged_attention}


def serve_path(label, argv, expect):
    """Serve once through the CLI with every launch count zeroed just
    before and read just after; ``expect`` is kernel -> launches (a
    number, or a function of the run's result: the paged kernel's count
    follows the decode steps), and a kernel it does not name must not
    launch."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    vocab = get_config(argv[argv.index("--arch") + 1]).vocab_size
    log(f"[4] {label}: serve {' '.join(argv)}")
    counters = _counters()
    for mod in counters.values():
        mod.launches = 0
    t0 = time.perf_counter()
    res = serve.main(argv)
    wall = time.perf_counter() - t0
    got = {name: mod.launches for name, mod in counters.items()}
    want = {name: expect.get(name, 0) for name in counters}
    want = {name: n(res) if callable(n) else n for name, n in want.items()}
    if "tokens" in res:
        toks = res["tokens"]
        log(f"    prefill {res['prefill_s']:.4f}s, {res['tok_per_s']:.1f} "
            f"tok/s, per-token p50 {res['token_ms_p50']:.3f} p90 "
            f"{res['token_ms_p90']:.3f} p99 {res['token_ms_p99']:.3f} ms; "
            f"launches {got}; {wall:.1f}s with set-up")
        B, gen = int(argv[argv.index("--batch") + 1]), \
            int(argv[argv.index("--gen") + 1])
        if toks.shape != (B, gen) or toks.min() < 0 or \
                toks.max() >= vocab:
            raise AssertionError(f"{label}: bad generated tokens "
                                 f"{toks.shape}")
    else:
        gen, max_new = res["generated"], res["max_new"]
        log(f"    served {len(gen)} requests, {res['new_tokens']} tokens, "
            f"{res['tok_per_s']:.1f} tok/s, per-token p50 "
            f"{res['token_ms_p50']:.3f} p90 {res['token_ms_p90']:.3f} p99 "
            f"{res['token_ms_p99']:.3f} ms, wall {res['wall_s']:.2f}s, "
            f"{res['decode_steps']} decode steps; launches {got}; "
            f"{wall:.1f}s with set-up")
        n_req = int(argv[argv.index("--num-requests") + 1])
        if len(gen) != n_req or any(len(gen[r]) != max_new[r]
                                    for r in max_new):
            raise AssertionError(f"{label}: not every request got its "
                                 f"max_new tokens")
    if got != want:
        raise AssertionError(f"{label}: kernel launches {got}, expected "
                             f"{want}")
    return got, res


def per_step(n_attention):
    """Expected paged-attention launches of a continuous path: one per
    attention application for every decode step of the engine."""
    return lambda res: res["decode_steps"] * n_attention


def serving_paths():
    """(label, argv, expected launches) of every serving path: one
    launch per attention layer (flash_attention) or SSM layer
    (ssd_chunk) for every prefill, and one paged_attention launch per
    attention layer for every decode step of the continuous engine."""
    fixed = ["--prompt-len", "512", "--gen", "64", "--batch", "8"]
    cont = ["--continuous", "--num-requests", "32", "--poisson-rate", "20",
            "--prompt-len", "512", "--gen", "64", "--max-active", "8",
            "--block-size", "16"]
    z_fixed = ["--prompt-len", "512", "--gen", "16", "--batch", "4"]
    z_cont = ["--continuous", "--num-requests", "8", "--poisson-rate", "20",
              "--prompt-len", "512", "--gen", "16", "--max-active", "4",
              "--block-size", "16"]
    return [
        ("smollm_fixed", ["--arch", "smollm-135m", *fixed],
         {"flash_attention": 30}),
        ("smollm_continuous", ["--arch", "smollm-135m", *cont],
         {"flash_attention": 32 * 30, "paged_attention": per_step(30)}),
        ("mamba2_fixed", ["--arch", "mamba2-130m", *fixed],
         {"ssd_chunk": 24}),
        ("mamba2_continuous", ["--arch", "mamba2-130m", *cont],
         {"ssd_chunk": 32 * 24}),
        ("zamba2_fixed", ["--arch", "zamba2-2.7b", *z_fixed],
         {"ssd_chunk": 54, "flash_attention": 9}),
        ("zamba2_continuous", ["--arch", "zamba2-2.7b", *z_cont],
         {"ssd_chunk": 8 * 54, "flash_attention": 8 * 9,
          "paged_attention": per_step(9)}),
        # olmoe: 6.92B fp32 parameters; cut like zamba2
        ("olmoe_fixed", ["--arch", "olmoe-1b-7b", *z_fixed],
         {"flash_attention": 16}),
        ("olmoe_continuous", ["--arch", "olmoe-1b-7b", *z_cont],
         {"flash_attention": 8 * 16, "paged_attention": per_step(16)}),
    ]


def phase_breakdown(arch, B, S):
    """Where a fixed-batch path's time goes: torch.profiler over one
    full-width bf16 prefill (B x S) and over 8 decode steps; the device's
    busy share of the wall time and the kernels that fill it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    cfg = get_config(arch)
    api = build_model(cfg)
    out = {}
    with torch.inference_mode():
        params = api.init(torch.Generator(device="cuda").manual_seed(0))
        g = torch.Generator().manual_seed(2)
        prompt = torch.randint(0, cfg.vocab_size, (B, S), generator=g).cuda()
        logits, cache = api.prefill(params, prompt, S + 64)
        tok = torch.argmax(logits[:, -1], -1)[:, None]
        api.decode_step(params, cache, tok)
        torch.cuda.synchronize()
        for name, reps, fn in (
                ("prefill", 1, lambda: api.prefill(params, prompt, S + 64)),
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
            log(f"[5] {arch} {name} (batch {B}, prompt {S}): wall "
                f"{wall_ms:.3f} ms/call, device busy {busy:.3f} ms/call "
                f"(share {share}), {n_kernels} kernels")
            for k, v in top:
                log(f"      {v:9.4f} ms  {k[:90]}")
    del params, cache
    torch.cuda.empty_cache()
    return out


def expected_combines(op, key, p):
    """segment_combine launches of one run of ``key`` summed over the p
    ranks, from its schedule: ring g(p-1) per rank and segment count g,
    recursive doubling and Rabenseifner log2(p) per rank, the binomial
    reduce of reduce_bcast p-1 (the receiving ranks only), a synthesized
    program its reduce steps per rank, allgather_reduce none (it sums
    with an add of its own)."""
    from repro_torch.core.collectives import synth
    algo, segs = key.rsplit("/", 1)
    k = p.bit_length() - 1
    if op != "all_reduce" or algo == "allgather_reduce":
        return 0
    if algo == "ring":
        return p * int(segs) * (p - 1)
    if algo in ("recursive_doubling", "rabenseifner"):
        return p * k
    if algo == "reduce_bcast":
        return p - 1
    if algo.startswith("synth:"):
        prog = synth.get_program(op, algo[len("synth:"):], p)
        return p * sum(1 for st in prog.steps if st.reduce)
    raise AssertionError(f"no launch count for {op} {algo}")


def gradient_elems():
    """smollm-135m's parameter count, from the port's model."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    api = build_model(get_config("smollm-135m"))
    with torch.inference_mode():
        params = api.init(torch.Generator(device="cuda").manual_seed(0))

    def count(t):
        if isinstance(t, dict):
            return sum(count(v) for v in t.values())
        if isinstance(t, (list, tuple)):
            return sum(count(v) for v in t)
        return t.numel()
    n = count(params)
    del params
    torch.cuda.empty_cache()
    return n


def phase_collectives(ranks=RANKS):
    """measure_collectives at ``ranks`` processes on the card, with the
    oracle check and the gradient all-reduce; returns the result and the
    launch counts by path."""
    from repro_torch.core.tuning import DecisionTable
    from repro_torch.launch import measure_collectives as mc
    n_grad = gradient_elems()
    out_path = os.path.join(ROOT, "device_measured_decision.json")
    argv = ["--ranks", str(ranks), "--check", "--grad-elems", str(n_grad),
            "--out", out_path]
    log(f"[6] measure_collectives {' '.join(argv)}")
    t0 = time.perf_counter()
    res = mc.main(argv)
    wall = time.perf_counter() - t0
    chk = res["check"]
    worst = max(chk["max_abs_err"].items(), key=lambda kv: kv[1])
    log(f"    check: {len(chk['max_abs_err'])} cases (every algorithm and "
        f"synthesized program, n {mc.CHECK_ELEMS}), max|err| vs oracle "
        f"{worst[1]:.3g} ({worst[0]}; tol {mc.TOL}); launches "
        f"{chk['launches']}")
    if res["device"] != "cuda:0" or res["ranks"] != ranks:
        raise AssertionError(f"ran on {res['device']} x {res['ranks']}")

    # launches of the tuning run, zeroed just before it and read after
    got, runs = res["launches_by_method"], res["runs_by_method"]
    for key, n_runs in sorted(runs.items()):
        op, k = key.split("/", 1)
        want = n_runs // ranks * expected_combines(op, k, ranks)
        if got.get(key, 0) != want:
            raise AssertionError(f"{key}: {got.get(key)} segment_combine "
                                 f"launches over {n_runs} rank-runs, "
                                 f"expected {want}")
    reducing = [k for k in runs if expected_combines(
        k.split("/", 1)[0], k.split("/", 1)[1], ranks)]
    if not reducing or any(got[k] <= 0 for k in reducing):
        raise AssertionError("a reducing algorithm never launched the "
                             "kernel")
    if res["launches"]["segment_combine"] != sum(got.values()) or \
            res["launches"]["flash_attention"] or res["launches"]["ssd_chunk"]:
        raise AssertionError(f"tuning run launches {res['launches']}")
    by_point = {}
    for key, t in res["means"].items():
        op, _, m, algo, segs = key.split("/")
        by_point.setdefault((op, int(m)), []).append((t, f"{algo}/s{segs}"))
    for (op, m), row in sorted(by_point.items()):
        log(f"    {op} {m} B, ms (mean of the trials, each the slowest "
            f"rank's): "
            + ", ".join(f"{a} {1e3 * t:.3f}" for t, a in sorted(row)))
    log(f"    tuning: {res['samples']} samples in "
        f"{res['tune_seconds']:.1f}s; segment_combine launches "
        f"{res['launches']['segment_combine']} over {len(reducing)} "
        f"reducing candidates, each as its schedule says")

    # the artifact, loaded back: the measured argmin at every point
    table = DecisionTable.load(out_path)
    if table.meta.backend != "DeviceBackend" or len(table.table) != \
            len(res["best"]):
        raise AssertionError(f"artifact {out_path}: {table.meta}")
    for op, m, algo, segs, _ in res["best"]:
        meth = table.decide(op, ranks, m)
        if (meth.algorithm, meth.segments) != (algo, segs):
            raise AssertionError(f"artifact row {op} {m}: {meth}")
    log(f"    {out_path} loaded back: {len(table.table)} rows, backend "
        f"{table.meta.backend}, {len(table.meta.programs or ())} programs")

    gs = res["grad_sync"]
    for label in ("tuned", "xla"):
        g = gs[label]
        log(f"    gradient all-reduce {label} ({g['algorithm']}/s"
            f"{g['segments']}), {gs['elems']} fp32 elements "
            f"({gs['bytes'] / 1e6:.1f} MB): "
            f"{' '.join(f'{t:.4f}' for t in g['seconds'])} s, max|err| "
            f"vs oracle {g['max_abs_err']:.3g}; launches {g['launches']}")
    if gs["tuned"]["launches"]["segment_combine"] != gs["tuned"]["runs"] \
            * expected_combines("all_reduce", f"{gs['tuned']['algorithm']}/"
                                f"{gs['tuned']['segments']}", ranks):
        raise AssertionError(f"gradient launches {gs['tuned']['launches']}")
    log(f"    {wall:.1f}s with set-up")
    res["wall_s"] = wall
    paths = {"measure_collectives_tune": res["launches"],
             "measure_collectives_check": chk["launches"],
             "grad_sync_tuned": gs["tuned"]["launches"],
             "grad_sync_xla": gs["xla"]["launches"]}
    return res, paths


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
    kernels = {"flash_attention": phase_kernel(),
               "ssd_chunk": phase_ssd_kernel(),
               "segment_combine": phase_combine_kernel(),
               "paged_attention": phase_paged_kernel()}
    diffs = {"smollm-135m": phase_model(),
             "mamba2-130m": phase_ssm_model("mamba2-130m", 2),
             "zamba2-2.7b": phase_ssm_model("zamba2-2.7b", 2)}
    moe = phase_moe_model()
    diffs["olmoe-1b-7b"] = moe["prefill_logit_diff"]
    serving = {}
    for k in kernels.values():
        k["launches"], k["launches_by_path"] = 0, {}
    for label, argv, expect in serving_paths():
        got, res = serve_path(label, argv, expect)
        for name, n in got.items():
            if n:
                kernels[name]["launches"] += n
                kernels[name]["launches_by_path"][label] = n
        serving[label] = {k: res[k] for k in (
            "prefill_s", "decode_s", "new_tokens", "tok_per_s", "wall_s",
            "token_ms_p50", "token_ms_p90", "token_ms_p99", "decode_steps")
            if k in res}
        if "generated" in res:
            serving[label]["requests"] = len(res["generated"])
    breakdown = {"smollm-135m": phase_breakdown("smollm-135m", 8, 512),
                 "mamba2-130m": phase_breakdown("mamba2-130m", 8, 512),
                 "zamba2-2.7b": phase_breakdown("zamba2-2.7b", 4, 512),
                 "olmoe-1b-7b": phase_breakdown("olmoe-1b-7b", 4, 512)}
    coll, coll_paths = phase_collectives()
    for path, counts in coll_paths.items():
        for name, n in counts.items():
            if n:
                kernels[name]["launches_by_path"][path] = n
    # the collectives path's launches: its tuning run
    kernels["segment_combine"]["launches"] = \
        coll_paths["measure_collectives_tune"]["segment_combine"]
    log(f"    total {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"card": smi, "model_logit_diff_fp32": diffs,
                      "olmoe_engine": {k: v for k, v in moe.items()
                                       if k.startswith("engine")},
                      "breakdown": breakdown, "serving": serving,
                      "collectives": {k: coll[k] for k in (
                          "best", "grad_sync", "tune_seconds", "wall_s",
                          "samples", "penalty", "fronts")}}))
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
