"""Mamba2 SSD within-chunk pass, backward: the hand-written CUDA kernels and
their plain version.

The reference trains through ``repro/kernels/ssd_scan.py::ssd_chunked_pallas``
(the Pallas TPU kernel ``_ssd_chunk_kernel``) by taking the gradient of
its function under ``jax.value_and_grad``; this is that gradient, from
the cotangents of all three outputs of the forward (``y_intra``, the
chunk ``states`` and ``cum``, which ``ssd_scan.ssd_chunked`` feeds into
the inter-chunk recurrence) to dx, ddt, dA, dB and dC. ``ssd_scan.SSDChunk``
calls it. The kernels are in ``csrc/ssd_chunk_bwd.cu``, built by
``_build`` and called through ctypes on PyTorch's current stream, two
launches a call:

* ``ssd_chunk_bwd`` (one block per (batch, head, chunk), fp32 SIMT FMAs
  for fp32 and bf16 inputs alike) recomputes ``C B^T`` and the decays
  from the forward's ``cum``, and writes dx and ddt, and per-head fp32
  partials of dB, dC and dA;
* ``ssd_chunk_bwd_reduce`` sums the partials in a fixed order: dB and dC
  over the heads in head order, dA over batch and chunks. There are no
  float atomics, so two calls give the same bits.

Bound on the card, at mamba2-130m's training shape per rank (B=2, S=256,
H=24, P=64, N=128, Q=128, bf16 x/B/C): the call must read x, dt, A, B,
C, cum and the three fp32 cotangents once and write the five gradients
once (10.16 MB, 3.03 us at 3.35 TB/s), and do 1.02 GFLOP (the
lower-triangle products dy x^T, scores^T dy, dG B and dG^T C, the
N x P products x dS^T and B dS, and C B^T once per (batch, chunk)):
1.03 us at the bf16 tensor-core rate, so bound by bytes (the fp32 SIMT
FMAs this kernel runs take 15.2 us at their peak rate);
``chip_smoke.ssd_bwd_bound_ms`` counts it from the shapes and
``PERF.md`` has the times. The design keeps
the Q x Q tile on the SM (it holds G*L, then the scores, then dG), stages
B, C and dS in slices of 32 state dims, and writes each output once;
the cost it pays is the per-head dB/dC partials (2 x B x H x S x N fp32,
read once more by the reduce).

``ssd_chunk_bwd`` takes CUDA tensors to the kernels and only CPU tensors
to ``ssd_chunk_bwd_plain``; any other device raises, and there is no
fallback from the kernels to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
Q_MAX = 128                   # chunk rows one kernel block covers
HEAD_DIMS = (32, 64)          # P values the kernel is built for
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: kernel launches of one backward call (the chunk pass, then the reduce)
LAUNCHES_PER_CALL = 2

# kernel launches since the last reset (chip_smoke.py zeroes and reads it)
launches = 0


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
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    nc = S // chunk
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    xf = x.to(acc).reshape(Bsz, nc, chunk, H, P).permute(0, 3, 1, 2, 4)
    dtf = dt.to(acc).reshape(Bsz, nc, chunk, H).permute(0, 3, 1, 2)
    Bf = Bm.to(acc).reshape(Bsz, 1, nc, chunk, N)
    Cf = Cm.to(acc).reshape(Bsz, 1, nc, chunk, N)
    cum, dy, dS = cum.to(acc), dy.to(acc), dstates.to(acc)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    diff = cum[..., :, None] - cum[..., None, :]           # (B,H,nc,Q,Q) t,s
    L = torch.exp(diff.masked_fill(~tri, NEG_INF))
    e = torch.exp(cum[..., -1:] - cum)                     # (B,H,nc,Q)
    w = e * dtf
    GL = torch.einsum("bxctn,bxcsn->bxcts", Cf, Bf) * L
    dsc = torch.einsum("bhctp,bhcsp->bhcts", dy, xf)
    F = dsc * GL                                           # 0 where masked
    dG = dsc * L * dtf[..., None, :]
    dx = torch.einsum("bhcts,bhctp->bhcsp", GL * dtf[..., None, :], dy) \
        + w[..., None] * torch.einsum("bxcsn,bhcnp->bhcsp", Bf, dS)
    xd = torch.einsum("bhcsp,bhcnp->bhcsn", xf, dS)        # x dS^T
    dC = torch.einsum("bhcts,bxcsn->bhctn", dG, Bf).sum(1)
    dB = (torch.einsum("bhcts,bxctn->bhcsn", dG, Cf)
          + w[..., None] * xd).sum(1)
    dw = (Bf * xd).sum(-1)                                 # (B,H,nc,Q)
    colF = F.sum(-2)
    dc = dcum.to(acc) + (F * dtf[..., None, :]).sum(-1) - dtf * colF \
        - dw * w
    dc[..., -1] += (dw * w).sum(-1)
    da = torch.flip(torch.cumsum(torch.flip(dc, [-1]), -1), [-1])
    ddt = colF + dw * e + A.to(acc)[None, :, None, None] * da
    dA = (dtf * da).sum((0, 2, 3))
    return (dx.permute(0, 2, 3, 1, 4).reshape(Bsz, S, H, P).to(x.dtype),
            ddt.permute(0, 2, 3, 1).reshape(Bsz, S, H).to(dt.dtype),
            dA.to(A.dtype), dB.reshape(Bsz, S, N).to(Bm.dtype),
            dC.reshape(Bsz, S, N).to(Cm.dtype))


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


def ssd_chunk_bwd(x, dt, A, Bm, Cm, cum, dy, dstates, dcum, *, chunk: int):
    """Gradients (dx, ddt, dA, dB, dC) of ``ssd_scan.ssd_chunk`` at its
    inputs, from its output ``cum`` and the cotangents of its three
    outputs. CUDA tensors run the hand-written kernels (two launches,
    counted in ``launches``); CPU tensors run ``ssd_chunk_bwd_plain``."""
    global launches
    if x.device.type == "cpu":
        return ssd_chunk_bwd_plain(x, dt, A, Bm, Cm, cum, dy, dstates, dcum,
                                   chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_chunk_bwd runs on cuda or cpu, not "
                         f"{x.device}")
    _check(x, dt, A, Bm, Cm, cum, dy, dstates, dcum, chunk)
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
    launches += LAUNCHES_PER_CALL
    return (dx.to(x.dtype), ddt, dA.to(A.dtype), dB.to(Bm.dtype),
            dC.to(Cm.dtype))


def last_kernel() -> str:
    """The chunk-pass instantiation the last call ran
    (``ssd_chunk_bwd<bf16,64>``, ``ssd_chunk_bwd<f32,32>``...)."""
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
