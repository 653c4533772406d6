"""Chip smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Imports only the port (``src/repro_torch``), torch and numpy. Phases:

1. device: the card's name and power limit; build every CUDA kernel from
   ``src/repro_torch/csrc`` (nvcc, sm_90a, one process per source, all
   started together) into ``build/repro_torch/``; each kernel's
   registers, static shared memory and spills from ``-Xptxas -v``;
2. kernels vs plain versions on the card:
   a. flash attention against ``flash_attention_plain`` over the
      reference's test sweep (f32 at 2e-5 on the SIMT kernel, bf16 at
      2e-2 on the tensor-core kernel; the instantiation each call ran is
      checked and printed), the windows, the decode offset, fully masked
      rows (before position 0 and past the window), T > S with
      q_offset, S not a multiple of 64, MQA and GQA, q/k/v as views of
      one fused projection, zamba2's shared-attention shapes (D=80,
      H=KV=32) and smollm's serving shape; times the kernel, the plain
      version and ``F.scaled_dot_product_attention`` (a yardstick only:
      the port never calls it) in turns at four prefill shapes (smollm's
      serving batch and one request, olmoe's and zamba2's), on the device
      alone (torch.profiler) and back to back between CUDA events,
      beside the bound and the host's time to issue one call;
   b. the SSD chunk kernels against ``ssd_chunked_plain`` (all three
      outputs) over the reference's sweep in f32 (5e-5, the SIMT
      ``ssd_chunk``) and bf16 (5e-2, the tensor-core ``ssd_chunk_mma``;
      the instantiation each call ran is checked), Q=100, Q=7, P=32,
      mamba2's one-request shapes (B=1, S=128/256/512) and both models'
      serving shapes; times kernel and plain at mamba2's serving shape
      and the one-request shapes, warm (back to back, and on the device
      from the profiler) and cold (L2 flushed by a 1 GiB write before
      each call), beside the bound (no single PyTorch call computes this
      function, so there is no library time);
   c. the segment-combine kernel against ``segment_combine_plain`` over
      the reference's sweep (n in 7, 128, 1000, 65536), 16M elements and
      misaligned row slices, f32 and bf16, add/max/min, at the
      reference's 1e-6 (it is expected bit-equal; the count of bit-equal
      cases is printed), each case again in place (``out=acc``), which
      must give the out-of-place bits; times kernel, plain and
      ``torch.add`` (the yardstick), the in-place call, ``Tensor.add_``
      and the out-of-place call plus a copy back, at 16M elements f32 and
      bf16 beside the bound, and the kernel's design alternatives
      (vectors per thread, grid cap);
   d. the paged decode attention kernel (split over the table, two
      launches) against ``ref.paged_attention_ref`` (the gather path)
      over the reference's sweep (partial, full, wrapped and
      several-wraps-deep views, windows 0 and 6, shuffled tables) at head
      dims 64, 80 and 128, the three serving shapes (smollm, zamba2,
      olmoe) and the splits' edges (an empty row, splits with no valid
      slot, a wrapped window across a split boundary), f32 at 2e-5 and
      bf16 within one bf16 ulp (2**-7); sharp scores on which fp32 q and
      P would miss that by 4x; two calls bit-equal; times the kernel
      (warm back to back and on the device, and cold) and the plain
      version at each serving shape beside the bound (no single PyTorch
      call computes this function);
   e. the flash-attention backward (bf16 ``fa_bwd_dq_mma`` then
      ``fa_bwd_dkdv_mma`` on the tensor cores, fp32 the SIMT ``fa_bwd_dq``
      then ``fa_bwd_dkdv``; the instantiation each call ran is checked)
      against ``flash_attention_bwd_plain`` on the forward's own output
      and row log-sum-exp, over the forward's sweep (windows, the decode
      offset, fully masked rows, T != S, S and T off the tile heights,
      MQA and GQA, D 64/80/128 with query groups of 1, 2 and 3) and
      smollm-135m's training shape, f32 at 1e-4 and bf16 at 2e-2, bf16
      also against ``flash_attention_bwd_mma_plain`` (the kernels'
      rounding) at 1e-2, each case called twice and held bit-equal, the
      forward's lse held to the plain one and the serving forward's bits
      to the lse-writing forward's; times the backward, the SIMT kernels
      on the same bf16 inputs (the first design, as the yardstick), its
      plain version, the forward and backward through autograd, and
      SDPA's forward alone and forward and backward through autograd (a
      yardstick only; its backward alone is the difference of the two
      device times) at the training shape (2, 256, 9, 3, 64) and the
      serving shape, beside the backward's bound; the tensor-core
      kernels must not spill at D = 64 (ptxas, [1]);
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
   pools, tokens equal over the serving dtype's bf16 pools (their logit
   difference printed beside PR 14's 0.271 and beside the gather path
   run twice; above 0.05 the first decode layer whose MoE input or
   output departs is traced and printed), the launches one per layer per
   decode step;
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
   over decode steps of each model, dense and, where the model has a KV
   cache, through the paged kernel (device busy share, top kernels, and
   the port's own kernels wherever they rank);
6. tuned collectives through ``repro_torch.launch.measure_collectives``
   at 4 ranks on the card (processes under a gloo group, payloads staged
   through the host, every reduce step in the segment-combine kernel):
   every algorithm and synthesized program held against the oracle at
   4 MB and an odd size; every (algorithm, segments) candidate of
   all_reduce and broadcast timed at 4 KB, 256 KB, 4 MB and 64 MB over 3
   trials, the exhaustive tuner's table printed, saved and loaded back,
   with the launch counts gathered from the ranks (zeroed just before the
   tuning run, read just after: every reducing algorithm launches the
   kernel exactly as its schedule says); then a gradient of
   smollm-135m's parameter count (one fp32 leaf) synced through the
   Communicator built from the table just tuned, on a ``("data",)``
   mesh, and through ``"xla"`` (gloo's all-reduce), each held against
   the float64 oracle mean and timed, with its launches held to its
   plan's;
   b. every tuner family of ``core.tuning.TUNERS``
   (``measure_collectives --tuners all``, 4 ranks, [6]'s ops and sizes)
   fitted over one measured session: per family its new experiments,
   cache hits, empirical penalty, seconds and ``segment_combine``
   launches (zeroed just before its fit, read just after, summed over
   the ranks): a family that only refits the cache launches nothing,
   and every family's launches (STAR's and feedback's fresh samples)
   equal what its runs' schedules imply; every rank ends with the same
   table for every family;
7. the tuned Communicator over smollm-135m's whole fp32 gradient tree
   (the port's per-layer layout, leaves drawn from a seed), through
   ``measure_collectives --grad-arch smollm-135m``: (a) a 2x2
   ``("pod", "data")`` mesh of 4 ranks with
   ``examples/artifacts/hierarchical_decision.json``, per leaf, the
   sync tiers probed first; (b) a 2x2x2 ``("dcn", "pod", "data")`` mesh
   of 8 ranks with ``hierarchical_decision_3level.json``, per leaf and
   bucketed and pipelined at the artifact's own 8 MB schedule; (c)
   ``"xla"`` on both meshes. Each variant is held against the float64
   oracle mean at 2e-4, its ``explain_gradients`` against the spans a
   `TraceRecorder` recorded, and its ``segment_combine`` launches
   (zeroed just before it, read just after, summed over the ranks)
   against what its plan's reduce phases imply; the bucketed result is
   held to each bucket's own sequential composition bit for bit and to
   the per-leaf result at 2e-4; every variant is timed; (d) [7b]'s tree
   and artifact with a tuned mesh mapping stamped into every level's
   meta (the first non-identity candidate of ``enumerate_mappings`` on
   2x2x2, written to a temporary file): the Communicator rebuilds the
   mesh in the mapping's rank order, every rank is checked at its
   ``device_order`` slot and ``describe()`` names the mapping; each
   variant checked as in (b), the bucketed one timed beside (b)'s; then
   ``tune_topology(2x2x2, tune_mapping=True)`` on the simulator and its
   winner's summary;
8. training: ``repro_torch.launch.train --arch smollm-135m --ranks 4
   --topology 2x2 --tuning-table examples/artifacts/
   hierarchical_decision.json --steps 4 --seq 256 --batch 8`` (full
   width and depth, fp32 master weights, bf16 compute, 4 host-staged
   ranks on the card), then the same with ``--collective xla`` as the
   oracle: each step's loss and its split into forward+backward,
   gradient sync and optimizer seconds, each rank's peak memory; the
   replicas' params bit-equal after every step; the launches (zeroed in
   every rank just before the steps, summed over the ranks just after)
   held to 30 flash forwards and 30 x ``attention_bwd.LAUNCHES_PER_CALL``
   backward launches a rank-step
   and, tuned, the plan's 2,184 combines a step (none through xla); the
   tuned run held to the xla run: step 0's synced gradients leaf by
   leaf (relative 2-norm; rank 0's gradients before the sync bit-equal
   in both runs, so only the order of the sum differs), the params'
   change over the run (relative 2-norm over the tree) and the losses;
   each reading also taken of faults planted in the tuned run's trees
   (gradients zeroed, negated, summed and not averaged, shifted between
   same-shaped leaves, half a leaf dropped; the update lost, reversed),
   each of which must exceed its tolerance;
9. the kernels line, then ``{"ok": true, "device": ...}`` as the last line.

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
# the paged kernel rounds where the gather path does: fp32 summation order
# only, so within one bf16 ulp at bf16 (tests/test_torch_cuda.py)
PAGED_TOL = {torch.float32: 2e-5, torch.bfloat16: 2 ** -7}
BF16_LOGIT_DIFF_PR14 = 0.271     # olmoe's engine over bf16 pools, PR 14
L2_FLUSH_BYTES = 1 << 30         # written before each cold call (L2: 50 MB)
SSD_TOL = {torch.float32: 5e-5, torch.bfloat16: 5e-2}   # tests/test_kernels.py
MODEL_TOL = 1e-3                 # phase 3: 24-54 layers of the kernel tolerance
COMBINE_TOL = 1e-6               # tests/test_kernels.py (expected bit-equal)
# the flash backward against its plain version (tests/test_torch_cuda.py):
# f32 sums up to S x H/KV terms per dK/dV entry in another order; bf16
# computes in fp32 from the same bf16 inputs and rounds once, as the
# forward (the forward's bf16 tolerance)
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# bf16 against flash_attention_bwd_mma_plain, which rounds P and dS where
# the kernels do: fp32 summation order, which now and then moves a
# rounded P or dS by one ulp, and one bf16 ulp of the output (2**-7)
BWD_MMA_TOL = 1e-2
# smollm-135m's training attention: 2 rows a rank of the 8 x 256 batch
TRAIN_ATTN_SHAPE = (2, 256, 9, 3, 64)
COMBINE_N = 1 << 24              # 16M elements: 64 MB of fp32 per operand
RANKS = 4                        # processes on the card for the collectives
SERVE_SHAPE = dict(B=8, S=512, H=9, KV=3, D=64)
# the prefill attention calls of the serving paths, (B, S, H, KV, D), bf16
ATTN_TIMED_SHAPES = {
    "smollm serving": (8, 512, 9, 3, 64),
    "olmoe prefill": (4, 512, 16, 16, 128),
    "zamba2 prefill": (4, 512, 32, 32, 80),
    "smollm one request": (1, 512, 9, 3, 64),
}
# mamba2-130m's SSD call at the fixed-batch serving shape (8 x 512 prompts)
SSD_SERVE_SHAPE = dict(B=8, S=512, H=24, P=64, N=128, Q=128)
# and at the continuous path's one-request prefills
SSD_ONE_REQUEST_S = (128, 256, 512)
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


def device_ms(fn, reps: int = 20) -> float:
    """Device time (ms per call) of the kernels ``fn`` launches, from
    torch.profiler's CUDA events over ``reps`` calls after a warm-up:
    the kernels alone, without the host's launch work between them,
    which the back-to-back timing of ``time_calls`` (every kernel's
    ``ms``) counts where the host is slower than the device. Every
    kernel's ``device_ms`` comes from here."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    # a trace now and then comes back without its device events: take
    # the next one, and fail rather than report a time of 0
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
        if len(kernels) >= reps:
            return sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / reps
    raise AssertionError(f"the profiler saw {len(kernels)} device events "
                         f"over {reps} calls")


def host_ms(fn, reps: int = 20) -> float:
    """Host time (ms per call) to issue ``fn`` back to back, without
    waiting for the device: where it exceeds the device time, the
    back-to-back timing measures the host."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * t / reps


def cold_ms(fn, reps: int = 20) -> float:
    """Device time (ms per call, median of ``reps``) of ``fn`` with the L2
    cold: before each call a 1 GiB write evicts the 50 MB L2, then CUDA
    events around the call alone. The write takes longer on the device
    than the host takes to queue the call behind it, so the events time
    the device, not the host."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        flush.fill_(1)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    del flush
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


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
            for fn, props in ptxas_report(logf.read_text()):
                log(f"    ptxas {name}: {fn}: {props}")
                # the tensor-core backward at D = 64 (the training path's)
                if "fa_bwd_" in fn and ("_mma<64>" in fn or
                                        "_mmaILi64E" in fn) \
                        and "0 bytes spill stores" not in props:
                    raise AssertionError(f"{fn} spills: {props}")
    return smi


def ptxas_report(text):
    """(kernel, 'N registers, S bytes smem, spills') for every entry
    function in nvcc's ``-Xptxas -v`` output, names demangled where
    ``c++filt`` is on the path (dynamic shared memory is not in it: the
    wrappers size that at launch)."""
    out, fn, spill = [], None, ""
    for line in text.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif "spill" in line and fn:
            spill = line.split(",", 1)[1].strip()
        elif "Used" in line and "registers" in line and fn:
            used = line.split("Used", 1)[1].strip()
            out.append((fn, f"{used}; {spill}"))
            fn, spill = None, ""
    names = [fn for fn, _ in out]
    try:
        names = subprocess.run(["c++filt"], input="\n".join(names),
                               capture_output=True, text=True, timeout=30,
                               check=True).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        pass
    if len(names) != len(out):
        names = [fn for fn, _ in out]
    return [(n, props) for n, (_, props) in zip(names, out)]


def kernel_for(dtype, D):
    """The instantiation the wrapper must launch for ``dtype``: bf16 on
    the tensor cores, fp32 on the SIMT kernel."""
    return (f"fa_fwd_mma<bf16,{D}>" if dtype == torch.bfloat16
            else f"fa_fwd<f32,{D}>")


def phase_kernel():
    from repro_torch.kernels import attention as fa
    sweep = [((1, 128, 128, 4, 4, 64), {}), ((2, 256, 256, 4, 2, 64), {}),
             ((1, 128, 128, 4, 1, 128), {}), ((1, 96, 96, 2, 2, 80), {})]
    both = (torch.float32, torch.bfloat16)
    cases = [(shape, dt, kw) for shape, kw in sweep for dt in both]
    cases += [((1, 256, 256, 2, 2, 64), dt, {"window": w})
              for w in (1, 17, 64, 256) for dt in both]
    cases += [((2, 1, 200, 4, 2, 64), dt, {"q_offset": 199}) for dt in both]
    # bf16 edges of the tensor-core kernel: fully masked rows before
    # position 0; rows fully masked by the window (q_offset past T: whole
    # warps of them); S not a multiple of 64 with T > S and q_offset; MQA
    # at S = 200; no causal mask over a ragged T; head dims 80 and 128
    # with windows
    cases += [((1, 40, 40, 2, 1, 64), dt, {"q_offset": -5}) for dt in both]
    cases += [((1, 64, 64, 2, 1, 64), torch.bfloat16,
               {"window": 16, "q_offset": 50}),
              ((1, 96, 300, 4, 2, 64), torch.bfloat16, {"q_offset": 204}),
              ((2, 200, 200, 4, 1, 64), torch.bfloat16, {}),
              ((2, 70, 300, 3, 1, 64), torch.bfloat16, {"causal": False}),
              ((1, 200, 200, 4, 2, 80), torch.bfloat16, {"window": 17}),
              ((1, 200, 264, 2, 1, 128), torch.bfloat16,
               {"window": 64, "q_offset": 64})]
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
        kw = {"causal": True, **kw}
        err = check_attention(fa, q, k, v, dt, kw)
        max_err[dt] = max(max_err[dt], err)
        log(f"[2] {(B, S, T, H, KV, D)} {str(dt)[6:]} {kw}: "
            f"{fa.last_kernel()}, max|err| {err:.3g}")
    serve_err = err      # the serving shape is the last case
    # q, k and v as strided views of one fused projection, both dtypes
    for dt in both:
        g = torch.Generator(device="cuda").manual_seed(5)
        qkv = torch.randn((2, 96, 4 + 2 + 2, 64), generator=g,
                          device="cuda").to(dt)
        q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
        err = check_attention(fa, q, k, v, dt, {"causal": True})
        max_err[dt] = max(max_err[dt], err)
        log(f"[2] fused qkv views (2, 96, 96, 4, 2, 64) {str(dt)[6:]}: "
            f"{fa.last_kernel()}, max|err| {err:.3g}")
    log(f"    max|err| f32 {max_err[torch.float32]:.3g} (tol 2e-5), "
        f"bf16 {max_err[torch.bfloat16]:.3g} (tol 2e-2)")

    by_shape = {name: time_attention(fa, name, shape)
                for name, shape in ATTN_TIMED_SHAPES.items()}
    top = by_shape["smollm serving"]
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/attention.py:132",
            "max_abs_err": serve_err, "ms": top["ms"],
            "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"], "library_ms": top["library_ms"],
            "device_ms": top["device_ms"],
            "library_device_ms": top["library_device_ms"],
            "max_err_f32": max_err[torch.float32],
            "max_err_bf16": max_err[torch.bfloat16],
            "shape": f"B={s['B']} S={s['S']} H={s['H']} KV={s['KV']} "
                     f"D={s['D']} bf16 causal",
            "by_shape": by_shape}


def check_attention(fa, q, k, v, dt, kw):
    """One launch against ``flash_attention_plain``: counted once, the
    dtype's kernel, finite and within the dtype's tolerance; returns the
    max error."""
    before = fa.launches
    got = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    if fa.launches != before + 1:
        raise AssertionError("the wrapper did not count its launch")
    D = q.shape[-1]
    if fa.last_kernel() != kernel_for(dt, D):
        raise AssertionError(f"{dt} D={D} ran {fa.last_kernel()}, expected "
                             f"{kernel_for(dt, D)}")
    want = fa.flash_attention_plain(q, k, v, **kw)
    err = (got.float() - want.float()).abs().max().item()
    bad = (got.float() - want.float()).abs() > \
        TOL[dt] * (1 + want.float().abs())
    if not torch.isfinite(got).all() or bad.any():
        raise AssertionError(f"flash_attention disagrees with plain at "
                             f"{tuple(q.shape)} k {tuple(k.shape)} {dt} "
                             f"{kw}: max err {err}")
    return err


def time_attention(fa, name, shape):
    """Kernel, plain version and SDPA (a yardstick only: the port never
    calls it) in turns at one bf16 causal shape, beside the bound: back
    to back between CUDA events (``ms``, ``plain_ms``, ``library_ms``,
    which count the host's launch work where it is slower than the
    device), on the device alone from the profiler (``device_ms``,
    ``library_device_ms``), and the host's time to issue one call."""
    import torch.nn.functional as F
    B, S, H, KV, D = shape
    q, k, v = rand_qkv(B, S, S, H, KV, D, torch.bfloat16, seed=99)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    kern = lambda: fa.flash_attention(q, k, v, causal=True)  # noqa: E731
    plain = lambda: fa.flash_attention_plain(q, k, v, causal=True)  # noqa: E731
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=True, enable_gqa=KV != H)
    # in turns (kernel, plain, library, kernel, plain, library): one card
    k1, p1, l1 = time_calls(kern), time_calls(plain), time_calls(lib)
    dk1, dl1 = device_ms(kern), device_ms(lib)
    k2, p2, l2 = time_calls(kern), time_calls(plain), time_calls(lib)
    dk2, dl2 = device_ms(kern), device_ms(lib)
    ms, plain_ms = statistics.median(k1 + k2), statistics.median(p1 + p2)
    library_ms = statistics.median(l1 + l2)
    dev, library_dev = (dk1 + dk2) / 2, (dl1 + dl2) / 2
    host, library_host = host_ms(kern), host_ms(lib)
    bound_ms, bound_by, nbytes, flops = attention_bound_ms(
        B, S, S, H, KV, D, 2)
    log(f"    {name} B={B} S={S} H={H} KV={KV} D={D} bf16 causal: "
        f"{fa.last_kernel()} back to back: kernel {ms:.4f} ms (turns "
        f"{statistics.median(k1):.4f}, {statistics.median(k2):.4f}), plain "
        f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms; device: kernel "
        f"{dev:.4f} ms (turns {dk1:.4f}, {dk2:.4f}), sdpa "
        f"{library_dev:.4f} ms (turns {dl1:.4f}, {dl2:.4f}); host per "
        f"call: kernel {host:.4f} ms, sdpa {library_host:.4f} ms; bound "
        f"{bound_ms:.5f} ms ({bound_by}: {nbytes / 1e6:.2f} MB, "
        f"{flops / 1e9:.3f} GFLOP); device {dev / bound_ms:.1f}x the "
        f"bound, {dev / library_dev:.2f}x sdpa")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "device_ms": dev,
            "library_device_ms": library_dev, "host_ms": host,
            "library_host_ms": library_host,
            "shape": f"B={B} S={S} H={H} KV={KV} D={D}"}


# ---------------------------------------------------------------------------
# [2e] the flash-attention backward
# ---------------------------------------------------------------------------
def flash_bwd_bound_ms(B, S, T, H, KV, D, itemsize, causal=True):
    """Least time for the backward: q, k, v, o, dO and the fp32 lse read
    once, dq, dk, dv written once, over the memory rate; or its five
    products (QK^T, dO V^T, P^T dO, dS K, dS^T Q) over the visible
    pairs, 10 D flops a pair, over the peak rate of the input type."""
    nbytes = itemsize * (4 * B * S * H * D + 4 * B * T * KV * D) \
        + 4 * B * H * S
    pairs = B * H * (S * (S + 1) // 2 if causal and S == T else S * T)
    flops = 10 * D * pairs
    peak = BF16_FLOP_PER_S if itemsize == 2 else FP32_FLOP_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations"), nbytes, flops


def bwd_kernel_for(dtype, D):
    """The backward instantiation the wrapper must launch for ``dtype``:
    bf16 on the tensor cores, fp32 on the SIMT kernels."""
    return (f"fa_bwd_mma<bf16,{D}>" if dtype == torch.bfloat16
            else f"fa_bwd<f32,{D}>")


def check_flash_bwd(fa, fb, q, k, v, dt, kw, seed):
    """One backward call against ``flash_attention_bwd_plain`` on the
    forward's own output and lse: counted, the dtype's kernels, finite,
    within the dtype's tolerance (bf16 also against
    ``flash_attention_bwd_mma_plain``), and a second call bit-equal; the
    lse against the plain forward's. Returns (max error, max error
    against the kernels' rounding (bf16), lse max error)."""
    out, lse = fa.flash_attention_fwd(q, k, v, with_lse=True, **kw)
    g = torch.Generator(device="cuda").manual_seed(seed)
    dout = torch.randn(q.shape, generator=g, device="cuda").to(dt)
    before = fb.launches
    got = fb.flash_attention_bwd(q, k, v, out, dout, lse, **kw)
    torch.cuda.synchronize()
    if fb.launches != before + fb.LAUNCHES_PER_CALL:
        raise AssertionError("the backward did not count its launches")
    name = bwd_kernel_for(dt, q.shape[-1])
    if fb.last_kernel() != name:
        raise AssertionError(f"ran {fb.last_kernel()}, expected {name}")
    want = fb.flash_attention_bwd_plain(q, k, v, out, dout, lse, **kw)
    err = 0.0
    for a, b in zip(got, want):
        d = (a.float() - b.float()).abs()
        if not torch.isfinite(a).all() or \
                (d > BWD_TOL[dt] * (1 + b.float().abs())).any():
            raise AssertionError(f"backward disagrees at {tuple(q.shape)} "
                                 f"k {tuple(k.shape)} {dt} {kw}: max err "
                                 f"{d.max().item()}")
        err = max(err, d.max().item())
    mma_err = 0.0
    if dt == torch.bfloat16:
        rounded = fb.flash_attention_bwd_mma_plain(q, k, v, out, dout, lse,
                                                   **kw)
        for a, b in zip(got, rounded):
            d = (a.float() - b.float()).abs()
            if (d > BWD_MMA_TOL * (1 + b.float().abs())).any():
                raise AssertionError(
                    f"backward disagrees with its rounding at "
                    f"{tuple(q.shape)} k {tuple(k.shape)} {kw}: max err "
                    f"{d.max().item()}")
            mma_err = max(mma_err, d.max().item())
    again = fb.flash_attention_bwd(q, k, v, out, dout, lse, **kw)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"two backward calls differ at "
                             f"{tuple(q.shape)} {dt} {kw}")
    _, plse = fa.flash_attention_plain(q, k, v, return_lse=True, **kw)
    if not torch.equal(torch.isinf(lse), torch.isinf(plse)):
        raise AssertionError(f"lse -inf rows differ at {tuple(q.shape)}")
    fin = torch.isfinite(plse)
    lerr = 0.0
    if fin.any():
        lerr = (lse[fin] - plse[fin]).abs().max().item()
        if lerr > 1e-4 * (1 + plse[fin].abs().max().item()):
            raise AssertionError(f"lse off by {lerr} at {tuple(q.shape)}")
    if not torch.equal(fa.flash_attention(q, k, v, **kw), out):
        raise AssertionError("the serving forward's bits change with lse")
    return err, mma_err, lerr


def time_flash_bwd(fa, fb, name, shape):
    """At one bf16 causal shape, in turns: the backward kernels alone, the
    SIMT kernels on the same inputs (the first design: the yardstick of
    the redesign), the plain backward, the forward (with lse) and
    backward through autograd, SDPA's forward alone and SDPA's forward
    and backward through autograd (a yardstick only: the port never
    calls it; its backward alone is the difference of the two device
    times, derived); back to back between CUDA events and on the device
    from the profiler; beside the backward's bound."""
    import torch.nn.functional as F
    B, S, H, KV, D = shape
    q, k, v = rand_qkv(B, S, S, H, KV, D, torch.bfloat16, seed=98)
    out, lse = fa.flash_attention_fwd(q, k, v, with_lse=True)
    g = torch.Generator(device="cuda").manual_seed(97)
    dout = torch.randn(q.shape, generator=g, device="cuda").to(q.dtype)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    qt, kt, vt = (t.transpose(1, 2).clone().requires_grad_()
                  for t in (q, k, v))
    doutt = dout.transpose(1, 2)
    bwd = lambda: fb.flash_attention_bwd(q, k, v, out, dout, lse)  # noqa: E731
    simt = lambda: fb.flash_attention_bwd(  # noqa: E731
        q, k, v, out, dout, lse, simt=True)
    plain = lambda: fb.flash_attention_bwd_plain(  # noqa: E731
        q, k, v, out, dout, lse)
    lib_fwd = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=True, enable_gqa=KV != H)

    def ours():
        o = fa.flash_attention(qg, kg, vg)
        return torch.autograd.grad(o, (qg, kg, vg), dout)

    def lib():
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                           enable_gqa=KV != H)
        return torch.autograd.grad(o, (qt, kt, vt), doutt)
    # the yardstick computes the same gradients, on its own kernels
    ran = simt()
    if fb.last_kernel() != f"fa_bwd<bf16,{D}>" or not all(
            torch.allclose(a.float(), b.float(), atol=BWD_TOL[q.dtype],
                           rtol=BWD_TOL[q.dtype])
            for a, b in zip(ran, plain())):
        raise AssertionError(f"the SIMT yardstick ({fb.last_kernel()}) "
                             f"disagrees with the plain backward")
    fns = {"bwd": bwd, "simt": simt, "plain": plain, "ours": ours,
           "lib_fwd": lib_fwd, "lib": lib}
    on_device = ("bwd", "simt", "ours", "lib_fwd", "lib")
    turns = [({key: time_calls(fn) for key, fn in fns.items()},
              {key: device_ms(fns[key]) for key in on_device})
             for _ in range(2)]
    ms = {key: statistics.median(turns[0][0][key] + turns[1][0][key])
          for key in fns}
    dev = {key: (turns[0][1][key] + turns[1][1][key]) / 2
           for key in on_device}
    lib_bwd_dev = dev["lib"] - dev["lib_fwd"]
    bwd()                  # last_kernel() names the kernels timed
    bound_ms, bound_by, nbytes, flops = flash_bwd_bound_ms(B, S, S, H, KV,
                                                           D, 2)
    log(f"    {name} B={B} S={S} H={H} KV={KV} D={D} bf16 causal: "
        f"{fb.last_kernel()} back to back: backward {ms['bwd']:.4f} ms "
        f"(turns {statistics.median(turns[0][0]['bwd']):.4f}, "
        f"{statistics.median(turns[1][0]['bwd']):.4f}), SIMT "
        f"{ms['simt']:.4f} ms, plain {ms['plain']:.4f} ms; forward+backward"
        f" through autograd: ours {ms['ours']:.4f} ms, sdpa "
        f"{ms['lib']:.4f} ms; device: backward {dev['bwd']:.4f} ms (turns "
        f"{turns[0][1]['bwd']:.4f}, {turns[1][1]['bwd']:.4f}), SIMT "
        f"{dev['simt']:.4f} ms (turns {turns[0][1]['simt']:.4f}, "
        f"{turns[1][1]['simt']:.4f}), ours fwd+bwd {dev['ours']:.4f} ms, "
        f"sdpa fwd {dev['lib_fwd']:.4f} ms, fwd+bwd {dev['lib']:.4f} ms, "
        f"bwd alone {lib_bwd_dev:.4f} ms (derived: the difference); bound "
        f"{bound_ms:.5f} ms ({bound_by}: {nbytes / 1e6:.2f} MB, "
        f"{flops / 1e9:.3f} GFLOP); device {dev['bwd'] / bound_ms:.1f}x "
        f"the bound, {dev['simt'] / dev['bwd']:.2f}x faster than SIMT, "
        f"{dev['bwd'] / lib_bwd_dev:.2f}x sdpa's backward")
    return {"ms": ms["bwd"], "plain_ms": ms["plain"], "bound_ms": bound_ms,
            "bound_by": bound_by, "device_ms": dev["bwd"],
            "simt_ms": ms["simt"], "simt_device_ms": dev["simt"],
            "fwd_bwd_ms": ms["ours"], "fwd_bwd_device_ms": dev["ours"],
            "library_ms": ms["lib"], "library_device_ms": dev["lib"],
            "library_fwd_device_ms": dev["lib_fwd"],
            "library_bwd_device_ms": lib_bwd_dev,
            "shape": f"B={B} S={S} H={H} KV={KV} D={D}"}


def phase_flash_backward():
    """[2e] the backward kernels against ``flash_attention_bwd_plain``
    over the forward's sweep, both dtypes, then timed at smollm's
    training and serving shapes; returns the kernels-line entry."""
    from repro_torch.kernels import attention as fa
    from repro_torch.kernels import attention_bwd as fb
    both = (torch.float32, torch.bfloat16)
    sweep = [((1, 128, 128, 4, 4, 64), {}), ((2, 256, 256, 4, 2, 64), {}),
             ((1, 128, 128, 4, 1, 128), {}), ((1, 96, 96, 2, 2, 80), {})]
    sweep += [((1, 256, 256, 2, 2, 64), {"window": w})
              for w in (1, 17, 64, 256)]
    sweep += [((2, 1, 200, 4, 2, 64), {"q_offset": 199}),
              ((1, 40, 40, 2, 1, 64), {"q_offset": -5}),   # fully masked
              ((1, 96, 300, 4, 2, 64), {"q_offset": 204}),
              ((2, 200, 200, 4, 1, 64), {}),               # MQA, S = 200
              ((2, 200, 200, 6, 2, 80), {}),               # GQA
              ((2, 70, 300, 3, 1, 128), {"causal": False}),
              ((1, 200, 264, 2, 1, 128), {"window": 64, "q_offset": 64})]
    # S and T off the tile heights (32 and 64 rows); D 80 and 128 with
    # query groups of 1, 2 and 3
    sweep += [((2, 200, 264, 6, 3, 64), {"q_offset": 64}),
              ((1, 200, 264, 3, 3, 80), {"q_offset": 64}),
              ((2, 200, 264, 4, 2, 80), {"q_offset": 64}),
              ((2, 200, 264, 4, 2, 128), {}),
              ((1, 200, 264, 6, 2, 128), {"q_offset": 64, "window": 96})]
    B, S, H, KV, D = TRAIN_ATTN_SHAPE
    sweep.append(((B, S, S, H, KV, D), {}))
    max_err = {dt: 0.0 for dt in both}
    lse_err = mma_err = 0.0
    for i, ((B, S, T, H, KV, D), kw) in enumerate(sweep):
        for dt in both:
            q, k, v = rand_qkv(B, S, T, H, KV, D, dt, seed=200 + i)
            err, merr, lerr = check_flash_bwd(fa, fb, q, k, v, dt,
                                              {"causal": True, **kw}, seed=i)
            max_err[dt] = max(max_err[dt], err)
            mma_err, lse_err = max(mma_err, merr), max(lse_err, lerr)
            log(f"[2e] {(B, S, T, H, KV, D)} {str(dt)[6:]} {kw}: "
                f"{fb.last_kernel()}, max|err| {err:.3g}"
                + (f" (its rounding {merr:.3g})" if dt == torch.bfloat16
                   else "") + f", lse {lerr:.3g}; two calls bit-equal")
    train_err = err          # the training shape (bf16) is the last case
    log(f"    max|err| f32 {max_err[torch.float32]:.3g} (tol "
        f"{BWD_TOL[torch.float32]}), bf16 {max_err[torch.bfloat16]:.3g} "
        f"(tol {BWD_TOL[torch.bfloat16]}; against its rounding "
        f"{mma_err:.3g}, tol {BWD_MMA_TOL}), lse {lse_err:.3g}; every "
        f"serving forward bit-equal with and without lse")
    s = SERVE_SHAPE
    by_shape = {"smollm training": time_flash_bwd(fa, fb, "smollm training",
                                                  TRAIN_ATTN_SHAPE),
                "smollm serving": time_flash_bwd(
                    fa, fb, "smollm serving",
                    (s["B"], s["S"], s["H"], s["KV"], s["D"]))}
    top = by_shape["smollm training"]
    return {"name": "flash_attention_bwd", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
            "replaces": "src/repro/kernels/attention.py:132",
            "note": "the gradient of that kernel's function, as the "
                    "reference takes it under jax.value_and_grad",
            "max_abs_err": train_err, "ms": top["ms"],
            "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"], "library_ms": top["library_ms"],
            "library_is": "F.scaled_dot_product_attention forward and "
                          "backward through autograd",
            "device_ms": top["device_ms"],
            "library_device_ms": top["library_device_ms"],
            "library_bwd_device_ms": top["library_bwd_device_ms"],
            "library_bwd_is": "derived: SDPA fwd+bwd minus SDPA fwd, "
                              "device times",
            "simt_device_ms": top["simt_device_ms"],
            "fwd_bwd_ms": top["fwd_bwd_ms"],
            "fwd_bwd_device_ms": top["fwd_bwd_device_ms"],
            "launches_per_call": fb.LAUNCHES_PER_CALL,
            "max_err_f32": max_err[torch.float32],
            "max_err_bf16": max_err[torch.bfloat16],
            "max_err_bf16_vs_rounding": mma_err,
            "max_lse_err": lse_err,
            "shape": top["shape"] + " bf16 causal", "by_shape": by_shape}


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


def ssd_kernel_for(dtype, P):
    """The instantiation the wrapper must launch for ``dtype``: bf16 on
    the tensor cores, fp32 on the SIMT kernel."""
    return (f"ssd_chunk_mma<bf16,{P}>" if dtype == torch.bfloat16
            else f"ssd_chunk<f32,{P}>")


def phase_ssd_kernel():
    from repro_torch.kernels import ssd_scan
    s = SSD_SERVE_SHAPE
    sweep = [(1, 64, 2, 64, 32, 32), (2, 128, 3, 64, 64, 32),
             (1, 128, 1, 32, 128, 64)]                # tests/test_kernels.py
    cases = [(shape, dt) for shape in sweep
             for dt in (torch.float32, torch.bfloat16)]
    cases += [((1, 200, 2, 64, 128, 100), dt)          # Q = 100
              for dt in (torch.float32, torch.bfloat16)]
    cases += [((2, 14, 3, 64, 128, 7), dt)             # Q = 7, two chunks
              for dt in (torch.float32, torch.bfloat16)]
    # mamba2's continuous path: one request per call
    cases += [((1, S, s["H"], s["P"], s["N"], s["Q"]), torch.bfloat16)
              for S in SSD_ONE_REQUEST_S]
    cases.append(((4, 512, 80, 64, 64, 128), torch.bfloat16))  # zamba2 serving
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
        if ssd_scan.last_kernel() != ssd_kernel_for(dt, P):
            raise AssertionError(f"{dt} P={P} ran {ssd_scan.last_kernel()}, "
                                 f"expected {ssd_kernel_for(dt, P)}")
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
        log(f"[2b] ssd {(B, S, H, P, N, Q)} {str(dt)[6:]}: "
            f"{ssd_scan.last_kernel()}, max|err| {err:.3g}")
    serve_err = err      # the mamba2 serving shape is the last case
    log(f"    max|err| f32 {max_err[torch.float32]:.3g} (tol 5e-5), "
        f"bf16 {max_err[torch.bfloat16]:.3g} (tol 5e-2)")

    by_shape = {}
    shapes = [("mamba2 serving", s["B"], s["S"])] + [
        (f"mamba2 one request S={S}", 1, S) for S in SSD_ONE_REQUEST_S]
    for name, B, S in shapes:
        H, P, N, Q = (s[k] for k in ("H", "P", "N", "Q"))
        x, dts, A, Bm, Cm = rand_ssd(B, S, H, P, N, torch.bfloat16, seed=99)
        kern = lambda: ssd_scan.ssd_chunk(  # noqa: E731
            x, dts, A, Bm, Cm, chunk=Q)
        plain = lambda: ssd_scan.ssd_chunked_plain(  # noqa: E731
            x, dts, A, Bm, Cm, chunk=Q)
        # in turns (kernel, plain, kernel, plain): one card, one call
        k1, p1, dk1, c1 = (time_calls(kern), time_calls(plain),
                           device_ms(kern), cold_ms(kern))
        k2, p2, dk2, c2 = (time_calls(kern), time_calls(plain),
                           device_ms(kern), cold_ms(kern))
        ms, plain_ms = statistics.median(k1 + k2), statistics.median(p1 + p2)
        dev, cold = (dk1 + dk2) / 2, (c1 + c2) / 2
        bound_ms, bound_by, nbytes, flops = ssd_bound_ms(B, S, H, P, N, Q, 2)
        log(f"    {name} B={B} S={S} H={H} P={P} N={N} Q={Q} bf16 "
            f"({B * H * (S // Q)} blocks): kernel back to back {ms:.4f} ms "
            f"(turns {statistics.median(k1):.4f}, "
            f"{statistics.median(k2):.4f}), device warm {dev:.4f} ms (turns "
            f"{dk1:.4f}, {dk2:.4f}), cold {cold:.4f} ms (turns {c1:.4f}, "
            f"{c2:.4f}), plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms "
            f"({bound_by}: {nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP); "
            f"no single library call")
        by_shape[name] = {"ms": ms, "plain_ms": plain_ms, "device_ms": dev,
                          "cold_ms": cold, "bound_ms": bound_ms,
                          "bound_by": bound_by}
    top = by_shape["mamba2 serving"]
    return {"name": "ssd_chunk", "route": "cuda",
            "source": "src/repro_torch/csrc/ssd_chunk.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:81",
            "max_abs_err": serve_err, "ms": top["ms"],
            "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"], "library_ms": None,
            "device_ms": top["device_ms"], "cold_ms": top["cold_ms"],
            "max_err_f32": max_err[torch.float32],
            "max_err_bf16": max_err[torch.bfloat16],
            "shape": f"B={s['B']} S={s['S']} H={s['H']} P={s['P']} "
                     f"N={s['N']} Q={s['Q']} bf16",
            "by_shape": by_shape}


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
    max_err, equal, in_place_equal = 0.0, 0, 0
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
        # in place into acc: the out-of-place call's bits
        res = sr.segment_combine(acc, part, op, out=acc)
        torch.cuda.synchronize()
        if res.data_ptr() != acc.data_ptr() or \
                sr.launches != before + 2:
            raise AssertionError("the in-place call did not write acc")
        err = (acc.float() - want.float()).abs().max().item()
        if not err <= COMBINE_TOL:
            raise AssertionError(f"segment_combine in place disagrees at "
                                 f"n={n} offset={off} {dt} {op}: {err}")
        max_err = max(max_err, err)
        in_place_equal += bool(torch.equal(acc, got))
    if in_place_equal != len(cases):
        raise AssertionError(f"in place bit-equal to out of place in only "
                             f"{in_place_equal}/{len(cases)} cases")
    log(f"[2c] segment_combine: {len(cases)} cases (n 7..{COMBINE_N}, "
        f"offsets 0-5, f32/bf16, add/max/min), each out of place and in "
        f"place, max|err| {max_err:.3g} (tol {COMBINE_TOL}), bit-equal to "
        f"plain {equal}/{len(cases)}, in place bit-equal to out of place "
        f"{in_place_equal}/{len(cases)}")

    out = {"name": "segment_combine", "route": "cuda",
           "source": "src/repro_torch/csrc/segment_combine.cu",
           "replaces": "src/repro/kernels/segment_reduce.py:63",
           "max_abs_err": max_err, "bit_equal_cases": equal,
           "cases": len(cases)}
    for dt in (torch.float32, torch.bfloat16):
        a = torch.randn((COMBINE_N,), generator=g, device="cuda").to(dt)
        b = torch.randn((COMBINE_N,), generator=g, device="cuda").to(dt)
        c = torch.empty_like(a)
        kern = lambda: sr.segment_combine(a, b, "add")  # noqa: E731
        plain = lambda: sr.segment_combine_plain(a, b, "add")  # noqa: E731
        lib = lambda: torch.add(a, b)  # noqa: E731
        # in place, as the ring calls it, against Tensor.add_ and against
        # the earlier form: out of place, then copied back
        inplace = lambda: sr.segment_combine(c, b, "add", out=c)  # noqa: E731
        lib_inplace = lambda: c.add_(b)  # noqa: E731
        copy_back = lambda: c.copy_(sr.segment_combine(c, b, "add"))  # noqa: E731
        # in turns (kernel, plain, library, ..., then again): one card
        t = {}
        for rnd in range(2):
            for key, fn in (("kernel", kern), ("plain", plain),
                            ("library", lib), ("in_place", inplace),
                            ("add_", lib_inplace), ("copy_back", copy_back)):
                c.copy_(a)
                t.setdefault(key, []).append(time_calls(fn))
            t.setdefault("device", []).append(device_ms(kern))
        med = {key: statistics.median(r[0] + r[1]) for key, r in t.items()
               if key != "device"}
        dev = sum(t["device"]) / 2
        bound_ms, bound_by, nbytes = combine_bound_ms(COMBINE_N,
                                                      a.element_size())
        name = str(dt)[6:]
        log(f"    n={COMBINE_N} {name} add: kernel {med['kernel']:.4f} ms "
            f"(turns {statistics.median(t['kernel'][0]):.4f}, "
            f"{statistics.median(t['kernel'][1]):.4f}), device {dev:.4f} ms "
            f"(turns {t['device'][0]:.4f}, {t['device'][1]:.4f}), plain "
            f"{med['plain']:.4f} ms, torch.add {med['library']:.4f} ms; in "
            f"place {med['in_place']:.4f} ms, Tensor.add_ {med['add_']:.4f} "
            f"ms, out of place + copy back {med['copy_back']:.4f} ms; bound "
            f"{bound_ms:.5f} ms ({bound_by}: {nbytes / 1e6:.1f} MB)")
        suffix = "" if dt == torch.float32 else "_bf16"
        out.update({f"ms{suffix}": med["kernel"],
                    f"plain_ms{suffix}": med["plain"],
                    f"bound_ms{suffix}": bound_ms,
                    f"library_ms{suffix}": med["library"],
                    f"in_place_ms{suffix}": med["in_place"],
                    f"add__ms{suffix}": med["add_"],
                    f"copy_back_ms{suffix}": med["copy_back"],
                    f"device_ms{suffix}": dev})
        if dt == torch.float32:
            out.update(bound_by=bound_by, shape=f"n={COMBINE_N} f32 add")
    del a, b, c
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


def off_by(got, want, tol):
    """Max |got - want| and whether some element lies outside
    ``tol * (1 + |want|)``."""
    diff = (got.float() - want.float()).abs()
    return diff.max().item(), bool(
        (diff > tol * (1 + want.float().abs())).any())


def check_paged(pa, ref, q, kp, vp, tables, lengths, window, label):
    """One launch against the gather path at the dtype's tolerance (a row
    with no valid slot must be 0, where the gather path gives the mean of
    V); returns the max error over the other rows."""
    dt = q.dtype
    before = pa.launches
    got = pa.paged_attention(q, kp, vp, tables, lengths, window=window)
    torch.cuda.synchronize()
    if pa.launches != before + 1:
        raise AssertionError("the wrapper did not count its launch")
    want = ref.paged_attention_ref(q, kp, vp, tables, lengths, window=window)
    empty = lengths == 0
    err, bad = off_by(got[~empty], want[~empty], PAGED_TOL[dt])
    if got.dtype != dt or not torch.isfinite(got).all() or bad or \
            (got[empty] != 0).any():
        raise AssertionError(f"paged_attention disagrees with plain at "
                             f"{label} window {window} {dt}: max err {err}")
    return err


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
    # one split: a table of one pool block, and R * KV filling the card
    for s in (dict(R=4, H=4, KV=2, D=80, bs=16, T=16),
              dict(R=33, H=16, KV=16, D=128, bs=16, T=32)):
        for dt in (torch.float32, torch.bfloat16):
            cases.append((s, tuple(([5, 16, 40, 100] * 9)[:s["R"]]), 0, dt))
    for arch, s in PAGED_SERVE_SHAPES.items():
        T = s["T"]
        lens = tuple(([T - 64, T, T + 100, 3 * T + 5, 1, 200] * 2)[:s["R"]])
        for dt in (torch.float32, torch.bfloat16):
            cases.append((s, lens, 0, dt))
            # the splits' edges: an empty row, splits with no valid slot,
            # a wrapped window across a split and the ring's end
            edge = tuple(([0, 20, T + 50, T + 3, 1, T, 2 * T + 47, 300]
                          * 2)[:s["R"]])
            cases.append((s, edge, 6, dt))
    max_err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for i, (s, lens, window, dt) in enumerate(cases):
        q, kp, vp, tables = rand_paged(s["R"], s["H"], s["KV"], s["D"],
                                       s["bs"], s["T"] // s["bs"], dt,
                                       seed=300 + i)
        lengths = torch.tensor(lens, device="cuda")
        err = check_paged(pa, ref, q, kp, vp, tables, lengths, window,
                          f"{s} lengths {lens}")
        max_err[dt] = max(max_err[dt], err)
    log(f"[2d] paged_attention: {len(cases)} cases (head dims 64/80/128, "
        f"windows 0/6, partial/full/wrapped views, one split, the 3 serving "
        f"shapes, the splits' edges), max|err| f32 {max_err[torch.float32]:.3g} "
        f"(tol 2e-5), bf16 {max_err[torch.bfloat16]:.3g} (tol 2**-7)")
    # sharp scores (q and K x 8) at the serving shapes: fp32 q and P (the
    # TPU kernel's rounding) would miss the gather path by 4 tolerances
    for arch, s in PAGED_SERVE_SHAPES.items():
        R, T = s["R"], s["T"]
        q, kp, vp, tables = rand_paged(R, s["H"], s["KV"], s["D"], s["bs"],
                                       T // s["bs"], torch.float32, seed=7)
        q, kp, vp = (q * 8).bfloat16(), (kp * 8).bfloat16(), vp.bfloat16()
        lengths = torch.tensor(([T - 3, T, T + 5] * R)[:R], device="cuda")
        want = ref.paged_attention_ref(q, kp, vp, tables, lengths)
        fp32_err, fp32_bad = off_by(
            ref.paged_attention_ref(q.float(), kp.float(), vp.float(),
                                    tables, lengths), want,
            4 * PAGED_TOL[torch.bfloat16])
        err = check_paged(pa, ref, q, kp, vp, tables, lengths, 0,
                          f"{arch} sharp")
        log(f"    {arch} sharp scores bf16: kernel max|err| {err:.3g}; fp32 "
            f"q and P would be {fp32_err:.3g} off"
            f"{' (past 4 ulps: the case tells the roundings apart)' if fp32_bad else ''}")
        # two calls on the same inputs give the same bits
        again = [pa.paged_attention(q, kp, vp, tables, lengths)
                 for _ in range(2)]
        if not torch.equal(again[0], again[1]):
            raise AssertionError(f"paged_attention at {arch}: two calls "
                                 f"differ")

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
        lengths = torch.full((R,), T, dtype=torch.int32,
                             device="cuda")                 # full views
        kern = lambda: pa.paged_attention(  # noqa: E731
            q, kp, vp, tables, lengths)
        plain = lambda: ref.paged_attention_ref(  # noqa: E731
            q, kp, vp, tables, lengths)
        # in turns (kernel, plain, kernel, plain): one card, one call
        k1, p1, dk1, c1 = (time_calls(kern), time_calls(plain),
                           device_ms(kern), cold_ms(kern))
        k2, p2, dk2, c2 = (time_calls(kern), time_calls(plain),
                           device_ms(kern), cold_ms(kern))
        ms, plain_ms = statistics.median(k1 + k2), statistics.median(p1 + p2)
        dev, cold = (dk1 + dk2) / 2, (c1 + c2) / 2
        host = host_ms(kern)
        bps, splits = pa.split_plan(R, KV, T // bs, pa._sms(q.device))
        bound_ms, bound_by, nbytes, flops = paged_bound_ms(R, H, KV, D, T, 2)
        log(f"    {arch} R={R} H={H} KV={KV} D={D} block {bs} view {T} "
            f"bf16 ({splits} splits of {bps} blocks, {R * KV * splits} "
            f"blocks a launch): kernel back to back {ms:.4f} ms (turns "
            f"{statistics.median(k1):.4f}, {statistics.median(k2):.4f}), "
            f"device warm {dev:.4f} ms (turns {dk1:.4f}, {dk2:.4f}), cold "
            f"{cold:.4f} ms (turns {c1:.4f}, {c2:.4f}), host per call "
            f"{host:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.5f} "
            f"ms ({bound_by}: {nbytes / 1e6:.3f} MB, {flops / 1e9:.4f} "
            f"GFLOP); no single library call")
        out["by_shape"][arch] = {"ms": ms, "plain_ms": plain_ms,
                                 "bound_ms": bound_ms, "device_ms": dev,
                                 "cold_ms": cold, "host_ms": host,
                                 "blocks": R * KV * splits}
        if arch == "smollm-135m":
            out.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by, device_ms=dev, cold_ms=cold,
                       shape=f"R={R} H={H} KV={KV} D={D} bs={bs} view={T} "
                             f"bf16")
    return out


def moe_engine_run(api, params, attn_impl, pool_dtype, trace=None):
    """The continuous engine on a simulated clock (so admission is the
    same in every run) over 6 requests; returns the tokens, the logits
    of the active rows of every decode step, the decode steps and the
    paged-attention launches. With a list as ``trace``, every decode
    layer's MoE input and output (fp32 copies) are appended to it."""
    import dataclasses
    import functools

    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import moe_model
    from repro_torch.serve import Scheduler, ServeEngine, synthetic_trace
    logits, step = [], api.decode_step
    moe_block = moe_model.moe_block

    def traced_moe(h, *args, **kw):
        y, aux = moe_block(h, *args, **kw)
        if h.shape[1] == 1:                     # a decode step's rows
            trace.append((h.float().clone(), y.float().clone()))
        return y, aux

    def record(params_, cache, tokens, **kw):
        out = step(params_, cache, tokens, **kw)
        active = cache["block_tables"][:, 0] != 0       # live slots own blocks
        logits.append(out[0][active].float())
        return out
    api = dataclasses.replace(
        api, decode_step=record,
        init_cache=functools.partial(api.init_cache, dtype=pool_dtype))
    requests = synthetic_trace(6, rate_rps=20.0, vocab=api.cfg.vocab_size,
                               prompt_lens=(128, 256, 512), max_new=8,
                               seed=0)
    engine = ServeEngine(api, params, max_active=4, view_len=528,
                         block_size=16, attn_impl=attn_impl)
    sched = Scheduler(requests, max_active=4, token_budget=4 * 528)
    pa.launches = 0
    if trace is not None:
        moe_model.moe_block = traced_moe
    try:
        engine.run(sched, cost_model=lambda kind, n: 1e-3)
    finally:
        moe_model.moe_block = moe_block
    tokens = {r.rid: list(r.generated) for r in sched.finished}
    return tokens, logits, engine.decode_steps, pa.launches


def trace_moe_departure(api, params, num_layers):
    """Where the bf16-pool engine through the paged kernel departs from
    the one through the gather path: both runs' decode-layer MoE inputs
    and outputs, compared call by call; prints the first calls whose
    input or output differs by more than 1e-2 and the per-layer
    differences of that decode step."""
    runs = []
    for impl in ("auto", "xla"):
        trace = []
        moe_engine_run(api, params, impl, torch.bfloat16, trace=trace)
        runs.append(trace)
    rows = []
    for i, ((hk, yk), (hx, yx)) in enumerate(zip(*runs)):
        rows.append((i // num_layers, i % num_layers,
                     (hk - hx).abs().max().item(),
                     (yk - yx).abs().max().item()))
    first = next((r for r in rows if max(r[2], r[3]) > 1e-2), None)
    log(f"    trace: {len(rows)} decode-layer MoE calls compared; first "
        f"past 1e-2: "
        + ("none" if first is None else
           f"step {first[0]} layer {first[1]} (input {first[2]:.3g}, "
           f"output {first[3]:.3g})"))
    if first is not None:
        for st, layer, dh, dy in rows:
            if st == first[0]:
                log(f"      step {st} layer {layer:2d}: MoE input max|diff| "
                    f"{dh:.3g}, output {dy:.3g}")
    return first


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
            if pool_dtype == torch.bfloat16:
                # the kernel rounds q and P where the gather path does; the
                # gather path run again gives the run-to-run floor (the
                # MoE combine's index_add_ sums with atomics)
                _, xl2, _, _ = moe_engine_run(kern, params, "xla", pool_dtype)
                floor = max(((a - b)[:, valid].abs().max().item()
                             for a, b in zip(xl, xl2) if a.shape == b.shape),
                            default=float("inf"))
                out[f"engine_{name}"]["gather_vs_gather_logit_diff"] = floor
                log(f"    bf16 pools: logits max|diff| {ldiff:.3g} (PR 14, "
                    f"before the kernel rounded as the gather path: "
                    f"{BF16_LOGIT_DIFF_PR14}); the gather path against "
                    f"itself {floor:.3g}")
                if ldiff > 0.05:
                    out[f"engine_{name}"]["first_departure"] = \
                        trace_moe_departure(kern, params, cfg.num_layers)
                if not (same and len(kl) == len(xl)):
                    raise AssertionError(f"olmoe engine over bf16 pools "
                                         f"through the paged kernel gives "
                                         f"other tokens than the gather "
                                         f"path")
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
    from repro_torch.kernels import attention, attention_bwd, \
        paged_attention, segment_reduce, ssd_scan
    return {"flash_attention": attention,
            "flash_attention_bwd": attention_bwd, "ssd_chunk": ssd_scan,
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


# the device-side names of the port's kernels (csrc/*.cu)
PORT_KERNELS = ("fa_fwd", "ssd_chunk", "ssd_chunk_mma", "combine_kernel",
                "pa_scores", "pa_pv")


def paged_cache(cache, bs=16):
    """A dense decode cache in the engine's paged form: each layer's K and
    V cut into ``bs``-slot pool blocks behind a null block 0, one table
    row per batch row, per-row lengths; any other state as it is."""
    k = cache["k"]
    layers, B, T, KV, D = k.shape
    nb = T // bs

    def pool(x):
        blocks = x.reshape(layers, B * nb, bs, KV, D)
        return torch.cat([torch.zeros_like(blocks[:, :1]), blocks], dim=1)
    tables = 1 + torch.arange(B * nb, dtype=torch.int32,
                              device=k.device).reshape(B, nb)
    rest = {n: x for n, x in cache.items() if n not in ("k", "v", "length")}
    return {**rest, "k_pool": pool(k), "v_pool": pool(cache["v"]),
            "block_tables": tables,
            "length": torch.full((B,), int(cache["length"]),
                                 dtype=torch.long, device=k.device)}


def phase_breakdown(arch, B, S):
    """Where a fixed-batch path's time goes: torch.profiler over one
    full-width bf16 prefill (B x S) and over 8 decode steps, and, for a
    family with a KV cache, over 8 decode steps through the same cache
    in the continuous engine's paged form (the paged kernel's path); the
    device's busy share of the wall time, the kernels that fill it, and
    the port's own kernels wherever they rank."""
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
        runs = [("prefill", 1, lambda: api.prefill(params, prompt, S + 64)),
                ("decode", 8, lambda: api.decode_step(params, cache, tok))]
        if "k" in cache:
            pcache = paged_cache(cache)
            api.decode_step(params, pcache, tok)
            runs.append(("paged decode", 8,
                         lambda: api.decode_step(params, pcache, tok)))
        torch.cuda.synchronize()
        for name, reps, fn in runs:
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
            # the port's own kernels, wherever they rank
            ours = {k: v for k, v in by_kernel.items()
                    if any(n in k for n in PORT_KERNELS)}
            out[name]["port_kernels"] = {k[:60]: v for k, v in ours.items()}
            for k, v in sorted(ours.items(), key=lambda kv: -kv[1]):
                if (k[:60], v) not in out[name]["top"]:
                    log(f"      {v:9.4f} ms  {k[:90]} (a port kernel)")
    del params, cache, runs
    torch.cuda.empty_cache()
    return out


def expected_combines(op, key, p):
    """segment_combine launches of one run of ``key`` ("algorithm/
    segments") summed over the p ranks, from its schedule
    (``measure_collectives.combines_per_rank``: ring g(p-1) per rank and
    segment count g, recursive doubling and Rabenseifner log2(p) per
    rank, the binomial reduce of reduce_bcast p-1 in all, a synthesized
    program its reduce steps per rank, allgather_reduce none; broadcast
    and all-gather none)."""
    from repro_torch.launch import measure_collectives as mc
    algo, segs = key.rsplit("/", 1)
    return int(p * mc.combines_per_rank(op, algo, int(segs), p))


def check_grad_sync(gs, world, tag):
    """The launcher's gradient-sync variants, held again here: the
    oracle error within 2e-4, the recorded spans equal to the plan, the
    traced run's bits equal to the untraced one's, and the launches,
    summed over the ``world`` ranks, equal to the runs times what the
    plan's phases imply (recounted here entry by entry). Returns the
    launch counts by path."""
    from repro_torch.launch import measure_collectives as mc
    paths = {}
    for label, v in gs["variants"].items():
        per_run = 0
        for key, n in v["plan"].items():
            op, algo, segs, p = key.split("/")
            per_run += n * world // int(p) * expected_combines(
                op, f"{algo}/{segs}", int(p))
        got = v["launches"]["segment_combine"]
        log(f"    {tag} {label}: {v['plan_entries']} plan entries "
            f"({v['describe']}), s per run "
            f"{' '.join(f'{t:.4f}' for t in v['seconds'])}, max|err| vs "
            f"the float64 mean {v['max_abs_err']:.3g}; segment_combine "
            f"{got} over {v['runs']} runs, plan {per_run} a run"
            + (f"; {v['buckets_bit_equal']}/{v['buckets']} buckets "
               f"bit-equal to their sequential composition, "
               f"{v['vs_per_leaf_max_abs']:.3g} from per leaf"
               if "buckets" in v else ""))
        log(f"      rank 0's traced run {v['recorded_s']:.4f} s, in its "
            f"collectives: " + ", ".join(
                f"{k} {t:.4f}" for k, t in sorted(v["span_s"].items())))
        if not (v["max_abs_err"] <= mc.GRAD_TOL and v["plan_matches_spans"]
                and v["trace_bits_equal"] and per_run == v["plan_combines"]
                and got == v["runs"] * per_run
                and v["launches"]["flash_attention"] == 0
                and v["launches"]["ssd_chunk"] == 0
                and v.get("buckets_bit_equal") == v.get("buckets")
                and v.get("vs_per_leaf_max_abs", 0.0) <= mc.GRAD_TOL):
            raise AssertionError(f"{tag} {label}: {v}")
        paths[f"{tag}_{label}"] = v["launches"]
    return paths


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
    log(f"    gradient sync through the Communicator, mesh {gs['mesh']}, "
        f"{gs['elems']} fp32 elements ({gs['bytes'] / 1e6:.1f} MB)")
    if gs["mesh"] != {"data": ranks} or list(gs["variants"]) != \
            ["per_leaf", "xla"]:
        raise AssertionError(f"gradient sync ran {gs['mesh']} "
                             f"{list(gs['variants'])}")
    paths = check_grad_sync(gs, ranks, "grad_sync")
    log(f"    {wall:.1f}s with set-up")
    res["wall_s"] = wall
    paths.update({"measure_collectives_tune": res["launches"],
                  "measure_collectives_check": chk["launches"]})
    return res, paths


#: the Communicator phase: (path, topology, committed artifact, variants)
COMMUNICATOR_PATHS = (
    ("comm_2x2", "2x2", "hierarchical_decision.json",
     ["per_leaf", "xla"]),
    ("comm_2x2x2", "2x2x2", "hierarchical_decision_3level.json",
     ["per_leaf", "bucketed", "xla"]),
)


def communicator_run(tag, topo, artifact, variants, n_params, probe=False):
    """One ``measure_collectives --tuning-table`` run of smollm-135m's
    whole fp32 gradient tree (``n_params`` elements, as [6] counted
    them) on the ``topo`` mesh, each variant checked; returns the
    launcher's gradient-sync result, its summary and the launch counts
    by path."""
    from repro_torch.launch import measure_collectives as mc
    argv = ["--topology", topo, "--tuning-table", artifact,
            "--grad-arch", "smollm-135m"]
    if probe:
        argv.append("--probe-fabric")
    log(f"[7] measure_collectives {' '.join(argv)}")
    t0 = time.perf_counter()
    res = mc.main(argv)
    wall = time.perf_counter() - t0
    gs = res["grad_sync"]
    world = 1
    for n in gs["mesh"].values():
        world *= n
    if res["device"] != "cuda:0" or res["ranks"] != world or \
            list(gs["variants"]) != variants or gs["arch"] != \
            "smollm-135m" or gs["elems"] != n_params:
        raise AssertionError(f"{tag}: ran {res['device']} x "
                             f"{res['ranks']}, {gs['elems']} elements, "
                             f"variants {list(gs['variants'])}")
    if "probed" in res:
        for line in res["probed"].splitlines():
            log(f"    {line}")
    log(f"    {tag}: mesh {gs['mesh']}, {gs['leaves']} leaves, "
        f"{gs['elems']} fp32 elements ({gs['bytes'] / 1e6:.1f} MB); "
        f"{gs['describe']}; slot -> rank {gs['slots']}")
    paths = check_grad_sync(gs, world, tag)
    log(f"    {wall:.1f}s with set-up")
    summary = {"wall_s": wall, "mesh": gs["mesh"], "leaves": gs["leaves"],
               "probed": res.get("probed"), "slots": gs["slots"],
               "mapping": gs["mapping"],
               "variants": {k: {kk: v[kk] for kk in (
                   "seconds", "max_abs_err", "plan_entries",
                   "plan_combines", "runs", "launches", "buckets",
                   "vs_per_leaf_max_abs", "recorded_s", "span_s")
                   if kk in v}
                   for k, v in gs["variants"].items()}}
    return gs, summary, paths


def phase_communicator(n_params):
    """smollm-135m's whole fp32 gradient tree through the tuned
    Communicator on the 2x2 and 2x2x2 meshes (``measure_collectives
    --tuning-table``), each variant checked and timed; returns the
    results and the launch counts by path."""
    out, paths = {}, {}
    for tag, topo, artifact, variants in COMMUNICATOR_PATHS:
        gs, out[tag], got = communicator_run(
            tag, topo, os.path.join(ROOT, "examples", "artifacts", artifact),
            variants, n_params, probe=topo == "2x2")
        if gs["mapping"] is not None or gs["slots"] != list(range(len(
                gs["slots"]))):
            raise AssertionError(f"{tag}: a committed artifact remapped "
                                 f"the mesh: {gs['slots']}")
        paths.update(got)
    return out, paths


# ---------------------------------------------------------------------------
# [6b] every tuner family from the card's measurements
# ---------------------------------------------------------------------------
#: the families that measure afresh (``session.fresh_sample``)
ADAPTIVE_TUNERS = ("star", "feedback")


def phase_tuners(ranks=RANKS):
    """``measure_collectives --tuners all`` at ``ranks`` processes on the
    card, over [6]'s ops and sizes: every family fitted over the one
    measured session, each with its launch counts zeroed just before its
    fit and read just after. Returns the per-family results and the
    launch counts by path."""
    import tempfile
    from repro_torch.core.tuning import TUNERS, DecisionTable
    from repro_torch.launch import measure_collectives as mc
    with tempfile.TemporaryDirectory() as d:
        out_path = os.path.join(d, "tuners_measured_decision.json")
        argv = ["--ranks", str(ranks), "--tuners", "all", "--out", out_path]
        log(f"[6b] measure_collectives {' '.join(argv[:-2])}")
        t0 = time.perf_counter()
        res = mc.main(argv)
        wall = time.perf_counter() - t0
        table = DecisionTable.load(out_path)
    fams = res["families"]
    if res["device"] != "cuda:0" or res["ranks"] != ranks or \
            [f["name"] for f in fams] != list(TUNERS) or \
            table.meta.tuner != res["tuner"] or \
            table.meta.backend != "DeviceBackend":
        raise AssertionError(f"[6b] ran {res['device']} x {res['ranks']}, "
                             f"families {[f['name'] for f in fams]}, "
                             f"table {table.meta}")
    log(f"    {res['samples']} samples, {res['n_experiments']} experiments "
        f"in {res['tune_seconds']:.1f}s (host-staged ranks); sizes "
        f"{list(mc.SIZES)} B, ops {list(mc.OPS)}")
    log(f"    {'tuner':14s} {'new exps':>9s} {'cache hits':>11s} "
        f"{'penalty':>9s} {'seconds':>8s} {'segment_combine':>16s}")
    paths = {}
    for f in fams:
        got = f["launches"]["segment_combine"]
        want = 0
        for key, n_runs in f["runs_by_method"].items():
            op, k = key.split("/", 1)
            want += n_runs // ranks * expected_combines(op, k, ranks)
        log(f"    {f['name']:14s} {f['n_experiments']:9d} "
            f"{f['cache_hits']:11d} {f['penalty'] * 100:8.2f}% "
            f"{f['seconds']:8.2f} {got:16d}")
        ok = (f["same_table_on_every_rank"] and got == want
              and got == sum(f["launches_by_method"].values())
              and f["launches"]["flash_attention"] == 0
              and f["launches"]["ssd_chunk"] == 0)
        if f["n_experiments"] == 0:
            ok = ok and got == 0 and not f["runs_by_method"]
        if f["name"] in ADAPTIVE_TUNERS:
            ok = ok and f["n_experiments"] > 0 and got > 0
        if not ok:
            raise AssertionError(f"[6b] {f['name']}: launches {got}, the "
                                 f"runs' schedules imply {want}: {f}")
        paths[f"tuner_{f['name']}"] = f["launches"]
    log(f"    best: {res['tuner']} ({res['penalty'] * 100:.2f}%); every "
        f"rank ended with the same table for every family; {wall:.1f}s "
        f"with set-up")
    return {"wall_s": wall, "tune_seconds": res["tune_seconds"],
            "samples": res["samples"], "best": res["tuner"],
            "families": [{k: f[k] for k in (
                "name", "n_experiments", "cache_hits", "penalty", "seconds",
                "launches")} for f in fams]}, paths


# ---------------------------------------------------------------------------
# [7d] the gradient tree through a remapped mesh
# ---------------------------------------------------------------------------
def mapped_artifact(path):
    """``hierarchical_decision_3level.json`` with the first non-identity
    candidate of ``enumerate_mappings`` on 2x2x2 stamped into every
    level's meta, written to ``path``; returns the mapping."""
    from repro_torch.core.topology import (
        HierarchicalDecision, Topology, enumerate_mappings, load_decision)
    from repro_torch.core.tuning.decision import TableMeta
    axes, shape = ("dcn", "pod", "data"), (2, 2, 2)
    remap = next(c for c in enumerate_mappings(
        Topology.from_spec("2x2x2"), axes, shape) if not c.is_identity)
    hier = load_decision(os.path.join(
        ROOT, "examples", "artifacts", "hierarchical_decision_3level.json"))
    if not isinstance(hier, HierarchicalDecision):
        raise AssertionError(f"3-level artifact loads as "
                             f"{type(hier).__name__}")
    for _, table in hier.levels:
        if table.meta is None:
            table.meta = TableMeta()
        table.meta.mapping = remap.to_json()
    hier.save(path)
    return remap


def phase_remapped(n_params, identity_bucketed):
    """[7b]'s tree and artifact through a mesh rebuilt in a mapping's
    rank order, bucketed at the artifact's schedule, checked as [7]
    checks; the placement sweep of ``tune_topology`` on the simulator;
    returns the summary and the launch counts by path."""
    import tempfile
    from repro_torch.core.topology import MeshMapping, Topology, tune_topology
    from repro_torch.core.tuning.space import DECODE_MESSAGE_SIZES
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "mapped_3level.json")
        remap = mapped_artifact(path)
        log(f"[7d] 2x2x2 remapped: {remap.summary()}, slot -> rank "
            f"{list(remap.device_order)}")
        gs, summary, paths = communicator_run(
            "comm_2x2x2_mapped", "2x2x2", path,
            ["per_leaf", "bucketed", "xla"], n_params)
    if gs["slots"] != list(remap.device_order) or \
            MeshMapping.from_json(gs["mapping"]) != remap or \
            f"mapping={remap.summary()}" not in gs["describe"]:
        raise AssertionError(f"[7d] ran slots {gs['slots']}, mapping "
                             f"{gs['mapping']}: {gs['describe']}")
    b = gs["variants"]["bucketed"]
    log(f"    bucketed through the remapped mesh: s per run "
        f"{' '.join(f'{t:.4f}' for t in b['seconds'])} beside [7b]'s "
        f"identity mesh {' '.join(f'{t:.4f}' for t in identity_bucketed)} "
        f"(host-staged ranks, this call); every rank at its "
        f"device_order slot")
    # examples/autotune_collectives.py's grid and gradient-leaf mix
    ms = tuple(sorted(set(1024 * 4 ** i for i in range(7))
                      | set(DECODE_MESSAGE_SIZES)))
    leaf_mix = [4 << 20, 64 << 10, 64 << 10, 16 << 10] * 6
    t0 = time.perf_counter()
    hier, _ = tune_topology(Topology.from_spec("2x2x2"), ms=ms,
                            schedule_leaf_bytes=leaf_mix, tune_mapping=True)
    winner = MeshMapping.from_json(hier.levels[0][1].meta.mapping)
    log(f"    tune_topology(2x2x2, tune_mapping=True) on the simulator "
        f"({time.perf_counter() - t0:.1f}s): {winner.summary()}"
        + ("; the identity wins, as the reference's "
           "BENCH_mapping_smoke.json reads for 2x2x2 (vs-identity=1.00x)"
           if winner.is_identity else ""))
    summary["tune_topology_winner"] = winner.summary()
    return summary, paths


# ---------------------------------------------------------------------------
# [8] the data-parallel training step
# ---------------------------------------------------------------------------
TRAIN_STEPS = 4
TRAIN_ARGV = ["--arch", "smollm-135m", "--ranks", "4", "--topology", "2x2",
              "--steps", str(TRAIN_STEPS), "--seq", "256", "--batch", "8"]
# the tuned run against the "xla" run. Both start from the same params
# and batches, and rank 0's step-0 gradients before the sync are checked
# bit-equal in both, so step 0's synced trees differ only by the order
# of an fp32 sum of 4 terms: per leaf |g_t - g_x| / |g_x| (2-norms), a
# few 1e-8 where the terms do not cancel
TRAIN_GRAD_TOL = 1e-6
# the params' change over the run, |d_t - d_x| / |d_x| over the whole
# tree (d = final - initial): Adam's update g / (|g| + eps) is
# insensitive to the gradient's size and the global-norm clip rescales
# it anyway, so this holds the sync's signs and placement; where a
# gradient is near 0 the order of the sum can flip its update (two steps
# apart), which a flip in 1 of 10^5 params would read at ~1e-2
TRAIN_CHANGE_TOL = 1e-2
# lr_scale is 0, .01, .02, .03 over the 4 warmup steps (lr 3e-4), so a
# param moves at most a few times 1.8e-5 in all; a param that crosses a
# bf16 rounding boundary moves the bf16 forward's loss by ~1e-4
TRAIN_LOSS_TOL = 5e-3


def grad_reading(got, want) -> float:
    """max over the leaves of |got - want| / |want| (2-norms, float64 on
    the card)."""
    worst = 0.0
    for g, w in zip(got, want):
        g, w = g.to("cuda", torch.float64), w.to("cuda", torch.float64)
        num, den = (g - w).norm().item(), w.norm().item()
        worst = max(worst, num / den if den else
                    (0.0 if num == 0 else float("inf")))
    return worst


def change_reading(final, init, want) -> float:
    """|d - d_want| / |d_want| over the whole tree, d = final - init."""
    num = den = 0.0
    for f, i, w in zip(final, init, want):
        f, i, w = (t.to("cuda", torch.float64) for t in (f, i, w))
        num += (f - w).square().sum().item()
        den += (w - i).square().sum().item()
    return (num / den) ** 0.5


def sync_readings(tuned, xla):
    """[8]'s readings of the tuned run against the xla run, and the same
    readings of faults planted in the tuned run's trees."""
    from repro_torch import pytree
    gt, gx = pytree.leaves(tuned["grads0"]), pytree.leaves(xla["grads0"])
    init = pytree.leaves(tuned["init_params"])
    ft, fx = pytree.leaves(tuned["params"]), pytree.leaves(xla["params"])
    if not all(torch.equal(a, b) for a, b in
               zip(init, pytree.leaves(xla["init_params"]))) or \
            tuned["local_grads0_fingerprint"] != \
            xla["local_grads0_fingerprint"]:
        raise AssertionError("[8] the runs' initial params or rank 0's "
                             "step-0 gradients before the sync differ")
    shifted = list(gt)              # each leaf takes the next same-shaped
    by_shape = {}
    for j, t in enumerate(gt):
        by_shape.setdefault(tuple(t.shape), []).append(j)
    for idx in by_shape.values():
        for a, b in zip(idx, idx[1:] + idx[:1]):
            shifted[a] = gt[b]
    big = max(range(len(gt)), key=lambda j: gt[j].numel())
    halved = list(gt)
    halved[big] = gt[big].flatten().clone()
    halved[big][gt[big].numel() // 2:] = 0
    planted = {
        "gradients zeroed": grad_reading([torch.zeros_like(g) for g in gt],
                                         gx),
        "gradients negated": grad_reading([-g for g in gt], gx),
        "summed, not averaged": grad_reading([4 * g for g in gt], gx),
        "shifted between same-shaped leaves": grad_reading(shifted, gx),
        "half of the largest leaf dropped": grad_reading(
            halved, [g.flatten() if j == big else g
                     for j, g in enumerate(gx)]),
        "update lost": change_reading(init, init, fx),
        "update reversed": change_reading([2 * i - f for i, f in
                                           zip(init, ft)], init, fx)}
    return {"grad": grad_reading(gt, gx),
            "change": change_reading(ft, init, fx),
            "max_abs_param": max((a.double() - b.double()).abs().max().item()
                                 for a, b in zip(ft, fx)),
            "planted": planted}


def train_run(label, argv):
    """One ``repro_torch.launch.train`` run (its counts are zeroed in
    every rank just before the steps and summed over the ranks just
    after); returns rank 0's result with its final params."""
    from repro_torch.launch import train
    log(f"[8] {label}: train {' '.join(argv)}")
    t0 = time.perf_counter()
    res = train.main(argv, keep_params=True)
    res["wall_s"] = time.perf_counter() - t0
    mem = ", ".join(f"{b / 2**30:.2f}" for b in res["peak_mem_bytes"])
    log(f"    losses {' '.join(f'{x:.6f}' for x in res['losses'])}; s per "
        f"step {' '.join(f'{x:.3f}' for x in res['step_s'])}")
    for i in range(len(res["losses"])):
        log(f"    step {i}: forward+backward {res['compute_s'][i]:.4f} s, "
            f"gradient sync {res['sync_s'][i]:.4f} s, optimizer "
            f"{res['opt_s'][i]:.4f} s (slowest rank's)")
    log(f"    peak memory per rank (GiB): {mem}; launches {res['launches']};"
        f" {res['plan_entries']} sync collectives and "
        f"{res['plan_combines']} combines a step; replicas bit-equal after "
        f"every step: "
        f"{all(res['replicas_equal'])}; {res['wall_s']:.1f}s with set-up")
    return res


def phase_training():
    """[8] smollm-135m at full width and depth trained data-parallel on 4
    host-staged ranks on the card through the tuned 2x2 hierarchical
    sync, and again through ``--collective xla`` as the oracle; each
    run's launches held to its plan; returns the summary and the launch
    counts by path."""
    hier = os.path.join(ROOT, "examples", "artifacts",
                        "hierarchical_decision.json")
    tuned = train_run("tuned", [*TRAIN_ARGV, "--tuning-table", hier])
    xla = train_run("xla", [*TRAIN_ARGV, "--collective", "xla"])
    from repro_torch.kernels import attention_bwd
    ranks, layers = 4, 30
    for label, r in (("tuned", tuned), ("xla", xla)):
        want = {"flash_attention": layers * TRAIN_STEPS * ranks,
                "flash_attention_bwd": layers * TRAIN_STEPS * ranks
                * attention_bwd.LAUNCHES_PER_CALL,
                "segment_combine": TRAIN_STEPS * r["plan_combines"]}
        bad = (r["device"] != "cuda:0" or r["ranks"] != ranks
               or r["mesh"] != {"pod": 2, "data": 2, "model": 1}
               or r["param_elems"] != 162826560 or r["leaves"] != 273
               or not r["replicas_equal_at_init"]
               or not all(r["replicas_equal"])
               or len(r["losses"]) != TRAIN_STEPS
               or not all(x == x and 0 < x < 20 for x in r["losses"])
               or r["launches"] != want)
        if bad:
            raise AssertionError(f"[8] {label}: {r['launches']} vs {want}; "
                                 f"{ {k: r[k] for k in ('mesh', 'losses')} }")
    if not tuned["tuned"] or xla["tuned"] or xla["plan_combines"] != 0 or \
            tuned["plan_combines"] != 2184:
        raise AssertionError(f"[8] plans: tuned {tuned['plan_combines']} "
                             f"combines a step, xla {xla['plan_combines']}")
    loss_diff = max(abs(a - b) for a, b in zip(tuned["losses"],
                                               xla["losses"]))
    rd = sync_readings(tuned, xla)
    log(f"    tuned vs xla: step 0's synced gradients within {rd['grad']:.3g}"
        f" (tol {TRAIN_GRAD_TOL}), the params' change within "
        f"{rd['change']:.3g} (tol {TRAIN_CHANGE_TOL}), losses within "
        f"{loss_diff:.3g} (tol {TRAIN_LOSS_TOL}), final params within "
        f"{rd['max_abs_param']:.3g}; sync s a step tuned "
        f"{statistics.median(tuned['sync_s']):.3f}, xla "
        f"{statistics.median(xla['sync_s']):.3f} (medians)")
    log("    planted in the tuned run's trees: " + "; ".join(
        f"{k} {v:.3g}" for k, v in rd["planted"].items()))
    if rd["grad"] > TRAIN_GRAD_TOL or rd["change"] > TRAIN_CHANGE_TOL \
            or loss_diff > TRAIN_LOSS_TOL:
        raise AssertionError("[8] the tuned run departs from the xla run")
    for k, v in rd["planted"].items():
        if v <= (TRAIN_CHANGE_TOL if k.startswith("update")
                 else TRAIN_GRAD_TOL):
            raise AssertionError(f"[8] the planted fault '{k}' reads {v}, "
                                 f"inside the tolerance")
    keep = ("losses", "step_s", "compute_s", "sync_s", "opt_s",
            "peak_mem_bytes", "launches", "plan_entries", "plan_combines",
            "describe", "wall_s")
    summary = {"tuned": {k: tuned[k] for k in keep},
               "xla": {k: xla[k] for k in keep},
               "loss_diff": loss_diff, "readings": rd}
    paths = {"train_tuned": tuned["launches"], "train_xla": xla["launches"]}
    return summary, paths


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
               "flash_attention_bwd": phase_flash_backward(),
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
    tuners, tuner_paths = phase_tuners()
    coll_paths.update(tuner_paths)
    comm, comm_paths = phase_communicator(coll["grad_sync"]["elems"])
    comm["comm_2x2x2_mapped"], mapped_paths = phase_remapped(
        coll["grad_sync"]["elems"],
        comm["comm_2x2x2"]["variants"]["bucketed"]["seconds"])
    comm_paths.update(mapped_paths)
    training, train_paths = phase_training()
    for path, counts in train_paths.items():
        for name, n in counts.items():
            kernels[name]["launches_by_path"][path] = n
    # the training path's launches of the attention kernels
    kernels["flash_attention_bwd"]["launches"] = \
        train_paths["train_tuned"]["flash_attention_bwd"]
    for path, counts in {**coll_paths, **comm_paths}.items():
        for name, n in counts.items():
            # every gradient-sync path is listed for the combine, 0 too
            if n or (name == "segment_combine" and path in comm_paths):
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
                          "samples", "penalty", "fronts")},
                      "tuners": tuners,
                      "communicator": comm, "training": training}))
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
