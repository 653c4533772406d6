"""Mamba2 SSD within-chunk pass: the hand-written CUDA kernels and their plain version.

Replaces ``repro/kernels/ssd_scan.py::ssd_chunked_pallas`` (the Pallas TPU
kernel ``_ssd_chunk_kernel``). The kernels are in ``csrc/ssd_chunk.cu``,
built by ``_build`` and called through ctypes on PyTorch's current
stream. Per (batch, head, chunk) they compute the three outputs of the
TPU kernel: ``y_intra`` (B,H,nc,Q,P), the chunk ``states`` (B,H,nc,N,P)
and ``cum`` (B,H,nc,Q), all fp32. As in the reference, the inter-chunk
recurrence, ``y_inter`` and the ``D*x`` skip stay outside the kernel, in
plain PyTorch (``ssd_chunked``).

Bound on the card: at the serving shape (B=8, S=512, H=24, P=64, N=128,
Q=128, bf16) the call moves ~65.8 MB (the two fp32 outputs are 25.2 MB
each) and needs ~2.5 GFLOP, so its bound is ~20 us at 3.35 TB/s: memory
bound. Both kernels read every input once, in place through its
strides, keep the Q x Q score tile on the SM and write each output once.
bf16 inputs run ``ssd_chunk_mma`` (the three products on the tensor
cores, ``mma.sync``; rows must start on 16 bytes and N <= 128, else
ValueError), fp32 inputs ``ssd_chunk`` (scalar fp32 FMAs, which keep the
fp32 engine at 5e-5 of the plain version). ``last_kernel()`` names the
one that ran; ``PERF.md`` has their times.

``ssd_chunk`` takes a CUDA tensor to the kernel, and only a CPU tensor to
``ssd_chunked_plain``; any other device raises. There is no fallback from
the kernel to the plain version.

Training: when an input requires a gradient, ``ssd_chunked`` runs the
within-chunk pass through `SSDChunk` (a ``torch.autograd.Function``):
its forward is ``ssd_chunk``, its backward
``ssd_scan_bwd.ssd_chunk_bwd`` (the hand-written backward kernels on a
CUDA tensor, their plain version on a CPU tensor), from the cotangents
of all three outputs. The inter-chunk recurrence stays plain PyTorch
under autograd, as the reference leaves it to XLA.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ssd_scan_bwd

NEG_INF = -1e30
Q_MAX = 128                   # chunk rows one kernel block covers
HEAD_DIMS = (32, 64)          # P values the kernel is built for
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the last reset (chip_smoke.py zeroes and reads it)
launches = 0


def ssd_chunked_plain(x, dt, A, Bm, Cm, *, chunk: int):
    """The kernel's arithmetic in plain PyTorch. x (B,S,H,P), dt (B,S,H),
    A (H,), Bm/Cm (B,S,N) -> (y_intra (B,H,nc,Q,P), states (B,H,nc,N,P),
    cum (B,H,nc,Q)), fp32 (float64 for float64 inputs: the tests'
    exact-algebra oracle)."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    _check_chunk(S, chunk)
    nc = S // chunk
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    xf = x.to(acc).reshape(Bsz, nc, chunk, H, P).permute(0, 3, 1, 2, 4)
    dtc = dt.to(acc).reshape(Bsz, nc, chunk, H)
    dtf = dtc.permute(0, 3, 1, 2)                          # (B,H,nc,Q)
    Bf = Bm.to(acc).reshape(Bsz, 1, nc, chunk, N)
    Cf = Cm.to(acc).reshape(Bsz, 1, nc, chunk, N)

    # cumsum over a non-innermost dim: sequential on the card, the
    # kernel's order (see csrc/ssd_chunk.cu)
    cum = torch.cumsum(dtc * A.to(acc), dim=2).permute(0, 3, 1, 2)
    total = cum[..., -1:]
    diff = cum[..., :, None] - cum[..., None, :]           # (B,H,nc,Q,Q) t,s
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    decay = torch.exp(diff.masked_fill(~tri, NEG_INF))
    cb = torch.einsum("bxctn,bxcsn->bxcts", Cf, Bf)        # (B,1,nc,Q,Q)
    scores = cb * decay * dtf[..., None, :]
    y = torch.einsum("bhcts,bhcsp->bhctp", scores, xf)

    w = torch.exp(total - cum) * dtf                       # (B,H,nc,Q)
    states = torch.einsum("bhcsn,bhcsp->bhcnp", Bf * w[..., None], xf)
    return y.contiguous(), states, cum.contiguous()


def _check_chunk(S: int, chunk: int) -> None:
    if chunk < 1 or S % chunk:
        raise ValueError(f"seq {S} not divisible by chunk {chunk}")


def _check(x, dt, A, Bm, Cm, chunk):
    if x.dim() != 4 or dt.dim() != 3 or Bm.dim() != 3 or Cm.dim() != 3:
        raise ValueError("ssd wants x (B,S,H,P), dt (B,S,H), B/C (B,S,N)")
    Bsz, S, H, P = x.shape
    if dt.shape != (Bsz, S, H) or A.shape != (H,) or Bm.shape != Cm.shape \
            or Bm.shape[:2] != (Bsz, S):
        raise ValueError(f"shape mismatch x {tuple(x.shape)} dt "
                         f"{tuple(dt.shape)} A {tuple(A.shape)} B "
                         f"{tuple(Bm.shape)} C {tuple(Cm.shape)}")
    if x.dtype not in _DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"ssd takes x, B and C in float32 or bfloat16, one "
                        f"dtype: {x.dtype} {Bm.dtype} {Cm.dtype}")
    if dt.dtype != torch.float32:
        raise TypeError(f"ssd takes dt in float32, not {dt.dtype}")
    if P not in HEAD_DIMS:
        raise ValueError(f"head dim {P} not built; kernel has {HEAD_DIMS}")
    if not 1 <= chunk <= Q_MAX:
        raise ValueError(f"chunk {chunk} outside the kernel's 1..{Q_MAX}")
    _check_chunk(S, chunk)
    for name, t in (("x", x), ("B", Bm), ("C", Cm)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s last dim must be contiguous")
    if x.dtype == torch.bfloat16:
        ssd_scan_bwd.check_mma_rows(x, Bm, Cm)


def ssd_chunk(x, dt, A, Bm, Cm, *, chunk: int):
    """The within-chunk pass: ``(y_intra, states, cum)`` as
    ``ssd_chunked_plain`` returns them. CUDA tensors run the hand-written
    kernel; CPU tensors run ``ssd_chunked_plain``."""
    global launches
    if x.device.type == "cpu":
        return ssd_chunked_plain(x, dt, A, Bm, Cm, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd runs on cuda or cpu, not {x.device}")
    if any(t.device != x.device for t in (dt, A, Bm, Cm)):
        raise ValueError("x, dt, A, B and C must be on one device")
    _check(x, dt, A, Bm, Cm, chunk)
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    nc = S // chunk
    A32 = A.float().contiguous()
    kw = dict(dtype=torch.float32, device=x.device)
    y = torch.empty((Bsz, H, nc, chunk, P), **kw)
    states = torch.empty((Bsz, H, nc, N, P), **kw)
    cum = torch.empty((Bsz, H, nc, chunk), **kw)
    if y.numel() == 0:
        return y, states, cum
    fn = _kernel()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), dt.data_ptr(), A32.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), y.data_ptr(), states.data_ptr(), cum.data_ptr(),
            x.stride(0), x.stride(1), x.stride(2),
            dt.stride(0), dt.stride(1), dt.stride(2),
            Bm.stride(0), Bm.stride(1), Cm.stride(0), Cm.stride(1),
            Bsz, S, H, P, N, chunk, _DTYPES[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"ssd_chunk kernel launch failed: cudaError {rc}")
    launches += 1
    return y, states, cum


class SSDChunk(torch.autograd.Function):
    """The within-chunk pass with its backward: the forward is
    ``ssd_chunk`` and saves its inputs and ``cum``; the backward runs
    ``ssd_scan_bwd.ssd_chunk_bwd`` on the cotangents of ``y_intra``,
    ``states`` and ``cum`` (the kernels on a CUDA tensor, or raises; the
    plain version on a CPU tensor) and returns dx, ddt, dA, dB and dC."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk):
        y, states, cum = ssd_chunk(x, dt, A, Bm, Cm, chunk=chunk)
        ctx.save_for_backward(x, dt, A, Bm, Cm, cum)
        ctx.chunk = chunk
        return y, states, cum

    @staticmethod
    def backward(ctx, dy, dstates, dcum):
        x, dt, A, Bm, Cm, cum = ctx.saved_tensors
        grads = ssd_scan_bwd.ssd_chunk_bwd(x, dt, A, Bm, Cm, cum, dy,
                                           dstates, dcum, chunk=ctx.chunk)
        return (*grads, None)


def ssd_chunked(x, dt, A, Bm, Cm, D, *, chunk: int = 128):
    """Chunked SSD through the within-chunk pass (kernel on the card),
    with the inter-chunk recurrence, ``y_inter`` and the skip in plain
    PyTorch. x (B,S,H,P) -> y (B,S,H,P) in x's dtype. With an input that
    requires a gradient the pass runs through `SSDChunk`."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A, Bm, Cm)):
        y_intra, states, cum = SSDChunk.apply(x, dt, A, Bm, Cm, chunk)
    else:
        y_intra, states, cum = ssd_chunk(x, dt, A, Bm, Cm, chunk=chunk)
    nc = S // chunk

    # inter-chunk recurrence (tiny loop over nc): the state BEFORE each chunk
    gamma = torch.exp(cum[..., -1])                        # (B,H,nc)
    state = torch.zeros((Bsz, H, N, P), dtype=torch.float32, device=x.device)
    before = []
    for c in range(nc):
        before.append(state)
        state = state * gamma[:, :, c, None, None] + states[:, :, c]
    before = torch.stack(before, dim=2)                    # (B,H,nc,N,P)

    Ct = Cm.float().reshape(Bsz, nc, chunk, N)
    y_inter = torch.einsum("bhct,bctn,bhcnp->bhctp", torch.exp(cum), Ct,
                           before)
    y = (y_intra + y_inter).reshape(Bsz, H, S, P).transpose(1, 2)
    y = y + x.float() * D.float()[None, None, :, None]
    return y.to(x.dtype)


def last_kernel() -> str:
    """The name of the kernel instantiation the last launch ran, as the
    library reports it (``ssd_chunk_mma<bf16,64>``, ``ssd_chunk<f32,32>``...)."""
    fn = _build.load("ssd_chunk").repro_ssd_chunk_last_kernel
    fn.argtypes, fn.restype = [], ctypes.c_char_p
    return fn().decode()


def _kernel():
    lib = _build.load("ssd_chunk")
    fn = lib.repro_ssd_chunk_fwd
    if fn.argtypes is None:
        ll, i = ctypes.c_longlong, ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ll] * 10 + [i] * 7
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn
