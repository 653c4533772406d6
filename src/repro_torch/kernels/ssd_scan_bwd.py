"""Mamba2 SSD within-chunk pass, backward: the hand-written CUDA kernels and
their plain versions.

The reference trains through ``repro/kernels/ssd_scan.py::ssd_chunked_pallas``
(the Pallas TPU kernel ``_ssd_chunk_kernel``) by taking the gradient of
its function under ``jax.value_and_grad``; this is that gradient, from
the cotangents of all three outputs of the forward (``y_intra``, the
chunk ``states`` and ``cum``, which ``ssd_scan.ssd_chunked`` feeds into
the inter-chunk recurrence) to dx, ddt, dA, dB and dC. ``ssd_scan.SSDChunk``
calls it. The kernels are in ``csrc/ssd_chunk_bwd.cu``, built by
``_build`` and called through ctypes on PyTorch's current stream:

* bf16 x, B and C (every training call): ``ssd_chunk_bwd_mma``, one
  launch. One block of 8 warps per (batch, head, chunk); the blocks of
  one (batch, chunk) and `cluster_size` heads form a thread block
  cluster. The seven products run on the tensor cores (``mma.sync``
  bf16, fp32 accumulators): dy and dS are rounded to bf16 as they are
  staged (dy exactly on the training path, where it is a bf16 output
  widened), the scores and dG as they become operands; F's sums, dw and
  the scans of ddt and dA stay fp32 (the scans on one warp, in a fixed
  order). The cluster sums dB and dC over its heads through distributed
  shared memory; where H exceeds the cluster, the last cluster of a
  (batch, chunk) to arrive sums the clusters' fp32 partials, and the
  last block of a head sums dA's, by integer arrival counters that their
  last reader resets (one buffer of them a stream, so calls on two
  streams at once do not share them). dx, dB and dC leave the kernel in bf16, ddt and dA
  in fp32. cum and the cotangents are read through their strides (the
  training path's dy is a transposed view). It takes N a multiple of 8
  up to 128 and x, B and C rows on 16 bytes, as the forward does, and
  raises ValueError for anything else.
* fp32 (and bf16 with ``simt=True``, the first design, which
  ``chip_smoke.py`` times beside it): ``ssd_chunk_bwd`` (fp32 SIMT FMAs,
  per-head fp32 partials of dB, dC and dA) then ``ssd_chunk_bwd_reduce``
  (sums them in head order, dA over batch and chunks), two launches;
  the wrapper copies the cotangents contiguous and casts the outputs.

No float atomics on either path, so two calls give the same bits.

Bound on the card, at mamba2-130m's training shape per rank (B=2, S=256,
H=24, P=64, N=128, Q=128, bf16 x/B/C): the call must read x, dt, A, B,
C, cum and the three fp32 cotangents once and write the five gradients
once, dx, dB and dC in bf16 (10.16 MB, 3.03 us at 3.35 TB/s), and do
1.02 GFLOP (the lower-triangle products dy x^T, scores^T dy, dG B and
dG^T C, the N x P products x dS^T and B dS, and C B^T once per (batch,
chunk)): 1.03 us at the bf16 tensor-core rate, so bound by bytes;
``chip_smoke.ssd_bwd_bound_ms`` counts it from the shapes and
``PERF.md`` has the times.

``ssd_chunk_bwd`` takes CUDA tensors to the kernels and only CPU tensors
to ``ssd_chunk_bwd_plain``; ``meta`` tensors get the kernels' outputs
and scratch and run nothing (both note `bwd_work` to the open count,
``repro_torch.count``); any other device raises, and there is no
fallback from the kernels to the plain version.
``ssd_chunk_bwd_mma_plain`` is the tensor-core kernel's rounding in plain
PyTorch (tests and ``chip_smoke.py`` only).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import count
from repro_torch.kernels import _build

NEG_INF = -1e30
Q_MAX = 128                   # chunk rows one kernel block covers
HEAD_DIMS = (32, 64)          # P values the kernel is built for
MMA_MAX_STATE = 128           # state dims the bf16 (tensor-core) kernels take
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: kernel launches of one backward call, by the dtype of x: bf16 runs the
#: tensor-core kernel (one launch), fp32 the SIMT chunk pass and its
#: reduce (two; also bf16 with ``simt=True``)
LAUNCHES_PER_CALL = {torch.bfloat16: 1, torch.float32: 2}

# kernel launches since the last reset (chip_smoke.py zeroes and reads it)
launches = 0


def _bwd_terms(x, dt, A, Bm, Cm, cum, dy, dstates, dcum, chunk, acc, rnd):
    """The backward's algebra in ``acc``, with ``rnd`` applied where the
    tensor-core kernel rounds to bf16 (dy, dS, the scores and dG): dx
    (B,S,H,P), ddt (B,S,H), dA's terms (B,H,nc), and dB and dC of each
    head (B,H,nc,Q,N), not yet summed over the heads."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    nc = S // chunk
    xf = x.to(acc).reshape(Bsz, nc, chunk, H, P).permute(0, 3, 1, 2, 4)
    dtf = dt.to(acc).reshape(Bsz, nc, chunk, H).permute(0, 3, 1, 2)
    Bf = Bm.to(acc).reshape(Bsz, 1, nc, chunk, N)
    Cf = Cm.to(acc).reshape(Bsz, 1, nc, chunk, N)
    cum, dy, dS = cum.to(acc), rnd(dy.to(acc)), rnd(dstates.to(acc))
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    diff = cum[..., :, None] - cum[..., None, :]           # (B,H,nc,Q,Q) t,s
    L = torch.exp(diff.masked_fill(~tri, NEG_INF))
    e = torch.exp(cum[..., -1:] - cum)                     # (B,H,nc,Q)
    w = e * dtf
    GL = torch.einsum("bxctn,bxcsn->bxcts", Cf, Bf) * L
    dsc = torch.einsum("bhctp,bhcsp->bhcts", dy, xf)
    F = dsc * GL                                           # 0 where masked
    dG = rnd(dsc * L * dtf[..., None, :])
    dx = torch.einsum("bhcts,bhctp->bhcsp", rnd(GL * dtf[..., None, :]), dy) \
        + w[..., None] * torch.einsum("bxcsn,bhcnp->bhcsp", Bf, dS)
    xd = torch.einsum("bhcsp,bhcnp->bhcsn", xf, dS)        # x dS^T
    dC = torch.einsum("bhcts,bxcsn->bhctn", dG, Bf)
    dB = torch.einsum("bhcts,bxctn->bhcsn", dG, Cf) + w[..., None] * xd
    dw = (Bf * xd).sum(-1)                                 # (B,H,nc,Q)
    colF = F.sum(-2)
    dc = dcum.to(acc) + (F * dtf[..., None, :]).sum(-1) - dtf * colF \
        - dw * w
    dc[..., -1] += (dw * w).sum(-1)
    da = torch.flip(torch.cumsum(torch.flip(dc, [-1]), -1), [-1])
    ddt = colF + dw * e + A.to(acc)[None, :, None, None] * da
    return (dx.permute(0, 2, 3, 1, 4).reshape(Bsz, S, H, P),
            ddt.permute(0, 2, 3, 1).reshape(Bsz, S, H),
            (dtf * da).sum(-1), dB, dC)


def ssd_chunk_bwd_plain(x, dt, A, Bm, Cm, cum, dy, dstates, dcum, *,
                        chunk: int):
    """The backward's algebra in plain PyTorch, fp32. Inputs as
    ``ssd_scan.ssd_chunk`` takes them, ``cum`` its output, and the
    cotangents ``dy`` (B,H,nc,Q,P), ``dstates`` (B,H,nc,N,P) and ``dcum``
    (B,H,nc,Q). With ``L[t,s] = exp(cum_t - cum_s)`` (s <= t, else 0),
    ``G = C B^T``, ``scores = G L dt_s`` and ``w_s = exp(cum_Q - cum_s)
    dt_s``:

      dscores = dy x^T;  dG = dscores L dt_s;  F = dscores G L
      dx = scores^T dy + w (B dS);  dC = sum_h dG B
      dB = sum_h (dG^T C + w (x dS^T));  dw = rowsum(B (x dS^T))
      dcum' = dcum + rowsum(F dt_s) - dt colsum(F) - dw w
              (+ sum_s dw_s w_s on the last row)
      da = reverse cumsum of dcum';  ddt = colsum(F) + dw e^{cum_Q - cum}
              + A da;  dA = sum_{b,c,t} dt da

    Returns (dx, ddt, dA, dB, dC) in the inputs' dtypes (float64 inputs
    compute in float64, as ``ssd_scan.ssd_chunked_plain``)."""
    Bsz, S, _, _ = x.shape
    N = Bm.shape[-1]
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    dx, ddt, dA, dB, dC = _bwd_terms(x, dt, A, Bm, Cm, cum, dy, dstates,
                                     dcum, chunk, acc, lambda t: t)
    return (dx.to(x.dtype), ddt.to(dt.dtype), dA.sum((0, 2)).to(A.dtype),
            dB.sum(1).reshape(Bsz, S, N).to(Bm.dtype),
            dC.sum(1).reshape(Bsz, S, N).to(Cm.dtype))


def cluster_size(H: int) -> int:
    """Heads whose blocks form one thread block cluster in the tensor-core
    backward: the largest of 8, 4, 2 and 1 that divides ``H``."""
    return next(g for g in (8, 4, 2, 1) if H % g == 0)


def _bf16(t):
    return t.to(torch.bfloat16).float()


def ssd_chunk_bwd_mma_plain(x, dt, A, Bm, Cm, cum, dy, dstates, dcum, *,
                            chunk: int):
    """The tensor-core kernel's rounding in plain PyTorch (tests and
    ``chip_smoke.py`` only; the main path never calls it): the algebra of
    `ssd_chunk_bwd_plain` in fp32, but with bf16 where the kernel rounds.
    ``dy`` and ``dS`` are rounded to bf16 (``dy`` exactly on the main
    path, where it is a bf16 output widened), the scores and dG are
    rounded to bf16 before their products, dB and dC are summed over the
    heads in the clusters' order (each cluster's heads in order, then the
    clusters in order), dA over (batch, chunk) in order, and dx, dB and
    dC are rounded to the inputs' dtype once, at the end."""
    Bsz, S, H, _ = x.shape
    N = Bm.shape[-1]
    nc = S // chunk
    dx, ddt, dA_bhc, dB_h, dC_h = _bwd_terms(
        x, dt, A, Bm, Cm, cum, dy, dstates, dcum, chunk, torch.float32,
        _bf16)
    dA = dA_bhc[0, :, 0]
    for i in range(1, Bsz * nc):                           # b, then c
        dA = dA + dA_bhc[i // nc, :, i % nc]
    G = cluster_size(H)

    def head_sum(t):                                       # (B,H,nc,Q,N)
        total = None
        for c0 in range(0, H, G):
            part = t[:, c0]
            for j in range(1, G):
                part = part + t[:, c0 + j]
            total = part if total is None else total + part
        return total.reshape(Bsz, S, N)
    return (dx.to(x.dtype), ddt.to(dt.dtype), dA.to(A.dtype),
            head_sum(dB_h).to(Bm.dtype), head_sum(dC_h).to(Cm.dtype))


def check_mma_rows(x, Bm, Cm):
    """Raise ValueError unless the bf16 tensor-core kernels (the SSD
    forward's and its backward's) take x, B and C: a state dim that is a
    multiple of 8 up to ``MMA_MAX_STATE``, and rows that start on 16
    bytes (their cp.async copies move whole 16-byte pieces)."""
    N = Bm.shape[-1]
    if N > MMA_MAX_STATE or N % 8:
        raise ValueError(f"the bf16 kernel takes a state dim that is a "
                         f"multiple of 8 up to {MMA_MAX_STATE}, not {N}")
    for name, t in (("x", x), ("B", Bm), ("C", Cm)):
        if t.data_ptr() % 16 or any(
                st % 8 for st, n in zip(t.stride()[:-1], t.shape[:-1])
                if n > 1):
            raise ValueError(f"the bf16 kernel reads 16-byte-aligned "
                             f"rows; {name} has data_ptr {t.data_ptr()} "
                             f"and strides {t.stride()}")


def _check(x, dt, A, Bm, Cm, cum, dy, dstates, dcum, chunk):
    if x.dim() != 4 or dt.dim() != 3 or Bm.dim() != 3 or Cm.dim() != 3:
        raise ValueError("ssd wants x (B,S,H,P), dt (B,S,H), B/C (B,S,N)")
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    if not 1 <= chunk <= Q_MAX or S % chunk:
        raise ValueError(f"chunk {chunk} must divide seq {S} and lie in "
                         f"1..{Q_MAX}")
    nc = S // chunk
    want = {"dt": (dt, (Bsz, S, H)), "A": (A, (H,)), "B": (Bm, (Bsz, S, N)),
            "C": (Cm, (Bsz, S, N)), "cum": (cum, (Bsz, H, nc, chunk)),
            "dy": (dy, (Bsz, H, nc, chunk, P)),
            "dstates": (dstates, (Bsz, H, nc, N, P)),
            "dcum": (dcum, (Bsz, H, nc, chunk))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, wants "
                             f"{shape}")
        if t.device != x.device:
            raise ValueError("the backward's tensors must be on one device")
    if x.dtype not in _DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"ssd takes x, B and C in float32 or bfloat16, one "
                        f"dtype: {x.dtype} {Bm.dtype} {Cm.dtype}")
    for name in ("dt", "cum", "dy", "dstates", "dcum"):
        if want[name][0].dtype != torch.float32:
            raise TypeError(f"the backward takes {name} in float32, not "
                            f"{want[name][0].dtype}")
    if P not in HEAD_DIMS:
        raise ValueError(f"head dim {P} not built; kernel has {HEAD_DIMS}")
    for name, t in (("x", x), ("B", Bm), ("C", Cm)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s last dim must be contiguous")


def bwd_work(x, dt, Bm, chunk: int):
    """``(flops, bytes)`` of one backward call: FLOPs as
    ``torch.utils.flop_counter`` counts autograd's backward of
    ``ssd_scan.ssd_chunked_plain`` with every input requiring a gradient
    (each forward product transposed twice), bytes as the inputs, ``cum``
    and the three fp32 cotangents read once and the five gradients
    written once."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    nc = S // chunk
    isz, bsz = x.element_size(), Bm.element_size()
    flops = 4 * Bsz * nc * chunk * (chunk * N + H * chunk * P + H * N * P)
    cots = 4 * Bsz * H * nc * (chunk * P + N * P + chunk)
    nbytes = 2 * (x.numel() * isz + 4 * dt.numel() + 4 * H
                  + 2 * Bm.numel() * bsz) + 4 * Bsz * H * nc * chunk + cots
    return flops, nbytes


def ssd_chunk_bwd(x, dt, A, Bm, Cm, cum, dy, dstates, dcum, *, chunk: int,
                  simt: bool = False):
    """Gradients (dx, ddt, dA, dB, dC) of ``ssd_scan.ssd_chunk`` at its
    inputs, from its output ``cum`` and the cotangents of its three
    outputs. CUDA tensors run the hand-written kernels, counted in
    ``launches``: bf16 the tensor-core kernel (one launch; ValueError for
    a state dim or a row alignment it does not take, as the forward),
    fp32 the SIMT kernel and its reduce (two); ``simt=True`` runs the SIMT
    pair for bf16 too (the first design, which ``chip_smoke.py`` times
    beside the tensor-core kernel; the training path never passes it).
    CPU tensors run ``ssd_chunk_bwd_plain``."""
    if x.device.type == "cpu":
        launched = LAUNCHES_PER_CALL.get(
            torch.float32 if simt else x.dtype,
            LAUNCHES_PER_CALL[torch.float32])
        with count.kernel("ssd_chunk_bwd", *bwd_work(x, dt, Bm, chunk),
                          launched):
            return ssd_chunk_bwd_plain(x, dt, A, Bm, Cm, cum, dy, dstates,
                                       dcum, chunk=chunk)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"ssd_chunk_bwd runs on cuda or cpu (or meta), "
                         f"not {x.device}")
    _check(x, dt, A, Bm, Cm, cum, dy, dstates, dcum, chunk)
    if x.dtype == torch.bfloat16 and not simt:
        check_mma_rows(x, Bm, Cm)
        return _bwd_mma(x, dt, A, Bm, Cm, cum, dy, dstates, dcum, chunk)
    return _bwd_simt(x, dt, A, Bm, Cm, cum, dy, dstates, dcum, chunk)


# per (device, stream): the tensor-core kernel's arrival counters, zero
# between calls (their last reader resets them), grown on demand and
# zeroed on that stream. Calls on one stream run one after another, so
# two calls in flight at once (on two streams) never share a counter.
_arrivals: dict = {}


def _counters(n: int, stream: torch.cuda.Stream) -> torch.Tensor:
    key = (stream.device, stream.cuda_stream)
    buf = _arrivals.get(key)
    if buf is None or buf.numel() < n:
        with torch.cuda.stream(stream):
            buf = torch.zeros(max(n, 4096), dtype=torch.int32,
                              device=stream.device)
        _arrivals[key] = buf
    return buf


def _bwd_mma(x, dt, A, Bm, Cm, cum, dy, dstates, dcum, chunk,
             defines: tuple[str, ...] = ()):
    """The tensor-core kernel: one launch, the outputs in their final
    dtypes, cum and the cotangents read through their strides; scratch
    only for what crosses clusters (dB/dC partials when H exceeds the
    cluster, dA partials over batch and chunks). ``defines`` runs a
    build of the kernel with those macros (``tools/ssd_bwd_phases.py``'s
    stamped build); it computes the same bits."""
    global launches
    Bsz, S, H, P = x.shape
    G = cluster_size(H)
    N = Bm.shape[-1]
    nc = S // chunk
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty((Bsz, S, H, P), dtype=x.dtype, device=x.device)
    ddt = torch.empty((Bsz, S, H), **f32)
    dA = torch.empty((H,), **f32)
    dB = torch.empty((Bsz, S, N), dtype=Bm.dtype, device=x.device)
    dC = torch.empty((Bsz, S, N), dtype=Cm.dtype, device=x.device)
    if x.numel() == 0:
        return dx, ddt, dA.zero_().to(A.dtype), dB.zero_(), dC.zero_()
    n_part = 2 * Bsz * (H // G) * S * N if H > G else 0
    n_dA = H * Bsz * nc if Bsz * nc > 1 else 0
    scratch = torch.empty(n_part + n_dA, **f32) if n_part + n_dA else None
    if x.device.type == "meta":     # the outputs and the scratch, no launch
        count.note("ssd_chunk_bwd", *bwd_work(x, dt, Bm, chunk),
                   LAUNCHES_PER_CALL[torch.bfloat16])
        return dx, ddt, dA.to(A.dtype), dB, dC
    base = scratch.data_ptr() if scratch is not None else 0
    stream = torch.cuda.current_stream(x.device)
    cnt = _counters(Bsz * nc * G + H, stream)
    A32 = A.float().contiguous()
    strides = (ctypes.c_longlong * 28)(
        *x.stride()[:3], *dt.stride(), *Bm.stride()[:2], *Cm.stride()[:2],
        *cum.stride(), *dy.stride(), *dstates.stride(), *dcum.stride())
    fn = _kernel_mma(defines)
    rc = fn(x.data_ptr(), dt.data_ptr(), A32.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), cum.data_ptr(), dy.data_ptr(),
            dstates.data_ptr(), dcum.data_ptr(), dx.data_ptr(),
            ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(), dC.data_ptr(),
            base if n_part else None, base + 4 * n_part if n_dA else None,
            cnt.data_ptr(), strides, Bsz, S, H, P, N, chunk, G,
            stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssd_chunk backward launch failed: cudaError "
                           f"{rc}")
    launches += LAUNCHES_PER_CALL[torch.bfloat16]
    return dx, ddt, dA.to(A.dtype), dB, dC


def _bwd_simt(x, dt, A, Bm, Cm, cum, dy, dstates, dcum, chunk):
    """The SIMT kernel and its reduce: fp32 outputs, cast afterwards."""
    global launches
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    nc = S // chunk
    # the cotangents autograd hands over may be strided views
    cum, dy, dstates, dcum = (t.contiguous()
                              for t in (cum, dy, dstates, dcum))
    A32 = A.float().contiguous()
    kw = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty((Bsz, S, H, P), **kw)
    ddt = torch.empty((Bsz, S, H), **kw)
    dA = torch.empty((H,), **kw)
    dB = torch.empty((Bsz, S, N), **kw)
    dC = torch.empty((Bsz, S, N), **kw)
    if x.numel() == 0 or N == 0:
        return (dx.zero_().to(x.dtype), ddt.zero_(), dA.zero_().to(A.dtype),
                dB.zero_().to(Bm.dtype), dC.zero_().to(Cm.dtype))
    # fp32 scratch: the per-head dB and dC partials (B, H, S, N) each and
    # the per-(batch, head, chunk) dA partials
    scratch = torch.empty(2 * Bsz * H * S * N + Bsz * H * nc, **kw)
    if x.device.type == "meta":     # the outputs and the scratch, no launch
        count.note("ssd_chunk_bwd", *bwd_work(x, dt, Bm, chunk),
                   LAUNCHES_PER_CALL[torch.float32])
        return (dx.to(x.dtype), ddt, dA.to(A.dtype), dB.to(Bm.dtype),
                dC.to(Cm.dtype))
    fn = _kernel()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), dt.data_ptr(), A32.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), cum.data_ptr(), dy.data_ptr(),
            dstates.data_ptr(), dcum.data_ptr(), dx.data_ptr(),
            ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(), dC.data_ptr(),
            scratch.data_ptr(),
            x.stride(0), x.stride(1), x.stride(2),
            dt.stride(0), dt.stride(1), dt.stride(2),
            Bm.stride(0), Bm.stride(1), Cm.stride(0), Cm.stride(1),
            Bsz, S, H, P, N, chunk, _DTYPES[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"ssd_chunk backward launch failed: cudaError "
                           f"{rc}")
    launches += LAUNCHES_PER_CALL[torch.float32]
    return (dx.to(x.dtype), ddt, dA.to(A.dtype), dB.to(Bm.dtype),
            dC.to(Cm.dtype))


def mma_resources(P: int, N: int, H: int) -> dict:
    """What the tensor-core kernel takes on this card at head dim ``P``,
    state ``N`` and ``H`` heads: dynamic shared memory
    (bytes), resident blocks per SM, clusters resident at once, cluster
    size, registers a thread and local (spill) bytes a thread."""
    fn = _build.load("ssd_chunk_bwd").repro_ssd_chunk_bwd_mma_info
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 5)()
    G = cluster_size(H)
    rc = fn(P, N, G, out)
    if rc != 0:
        raise RuntimeError(f"ssd_chunk_bwd_mma resource query failed: "
                           f"cudaError {rc}")
    return {"smem_bytes": out[0], "blocks_per_sm": out[1],
            "max_active_clusters": out[2], "cluster": G,
            "registers": out[3], "local_bytes": out[4]}


def last_kernel() -> str:
    """The kernel the last call ran (``ssd_chunk_bwd_mma<bf16,64>``, or the
    SIMT chunk pass ``ssd_chunk_bwd<f32,32>``, ``ssd_chunk_bwd<bf16,64>``
    ...)."""
    fn = _build.load("ssd_chunk_bwd").repro_ssd_chunk_bwd_last_kernel
    fn.argtypes, fn.restype = [], ctypes.c_char_p
    return fn().decode()


def _kernel():
    lib = _build.load("ssd_chunk_bwd")
    fn = lib.repro_ssd_chunk_bwd
    if fn.argtypes is None:
        ll, i = ctypes.c_longlong, ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 15 + [ll] * 10 + [i] * 7
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _kernel_mma(defines: tuple[str, ...] = ()):
    lib = _build.load("ssd_chunk_bwd", defines)
    fn = lib.repro_ssd_chunk_bwd_mma
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 17
                       + [ctypes.POINTER(ctypes.c_longlong)]
                       + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn
