"""Flash attention backward: the hand-written CUDA kernels and their plain
version.

The reference trains through the Pallas TPU kernel
``repro/kernels/attention.py::flash_attention`` (``_fa_kernel``) under
``jax.value_and_grad``; this is the gradient of that function, from the
row log-sum-exp the forward writes (``attention.FlashAttention``). The
kernels are in ``csrc/flash_attention_bwd.cu``, built by ``_build`` and
called through ctypes on PyTorch's current stream: ``fa_bwd_dq`` (dQ, and
the per-row ``delta = sum(dO * O)``) then ``fa_bwd_dkdv`` (dK and dV, each
block summing its KV head's whole query group, so no atomics), scalar
fp32 FMAs from fp32 tiles in shared memory, for f32 and bf16 and head
dims 64, 80 and 128. Two calls give the same bits.

Bound on the card: at smollm-135m's training shape (B=2, S=T=256, H=9,
KV=3, D=64, bf16, causal) the call reads q, k, v, o, dO and lse and
writes dq, dk, dv once (~3.2 MB, ~0.95 us at 3.35 TB/s) and does five
products over the visible pairs (0.38 GFLOP, ~0.4 us at the bf16 peak):
memory bound. ``PERF.md`` has its time.

Numerics: both versions recompute ``P = exp(scale * q.k - lse)`` in fp32
from the inputs as given and round the fp32 results once to the input
dtype. The bf16 forward rounds P to bf16 before its PV product, so in
bf16 this is the gradient of a slightly different function than the
forward computed (the fp32-P one); against the plain version the kernel
differs only in fp32 summation order and the final rounding.

``flash_attention_bwd`` takes CUDA tensors to the kernel and only CPU
tensors to ``flash_attention_bwd_plain``; any other device raises, and
there is no fallback from the kernel to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import attention_mask

HEAD_DIMS = (64, 80, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: kernel launches of one backward call (``fa_bwd_dq``, ``fa_bwd_dkdv``)
LAUNCHES_PER_CALL = 2

# kernel launches since the last reset (chip_smoke.py zeroes and reads it)
launches = 0


def flash_attention_bwd_plain(q, k, v, o, dout, lse, *, causal=True,
                              window=0, q_offset=0, scale=None):
    """The backward's algebra in plain PyTorch, fp32, from ``lse``:
    ``delta = sum(dO * O)``, ``P = exp(scale * q.k - lse)`` (0 where
    masked), ``dV = P^T dO``, ``dS = P * (dO.v - delta)``,
    ``dQ = scale * dS K``, ``dK = scale * dS^T Q`` (summed over each KV
    head's query group). q/o/dout (B,S,H,D), k/v (B,T,KV,D), lse fp32
    (B,H,S) -> (dq, dk, dv) in the inputs' dtype."""
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    g = H // KV
    scale = scale if scale is not None else D ** -0.5
    qf = q.float().reshape(B, S, KV, g, D)
    kf, vf = k.float(), v.float()
    of = o.float().reshape(B, S, KV, g, D)
    dof = dout.float().reshape(B, S, KV, g, D)
    mask = attention_mask(S, T, causal=causal, window=window,
                          q_offset=q_offset, device=q.device)
    lse = lse.float().reshape(B, KV, g, S)
    # a fully masked row (lse -inf) has no visible entry: any finite
    # stand-in keeps exp() finite where the mask zeroes it
    lse = torch.where(torch.isfinite(lse), lse,
                      torch.zeros((), device=q.device))
    s = torch.einsum("bskgd,btkd->bkgst", qf, kf) * scale
    p = torch.where(mask, torch.exp(s - lse[..., None]),
                    torch.zeros((), device=q.device))
    delta = (dof * of).sum(-1).permute(0, 2, 3, 1)              # (B,KV,g,S)
    dv = torch.einsum("bkgst,bskgd->btkd", p, dof)
    dp = torch.einsum("bskgd,btkd->bkgst", dof, vf)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bkgst,btkd->bskgd", ds, kf) * scale
    dk = torch.einsum("bkgst,bskgd->btkd", ds, qf) * scale
    return (dq.reshape(B, S, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _check(q, k, v, o, dout, lse):
    B, S, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D or \
            o.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"shape mismatch q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} o "
                         f"{tuple(o.shape)} dout {tuple(dout.shape)}")
    KV = k.shape[2]
    if KV == 0 or H % KV:
        raise ValueError(f"{H} query heads do not group over {KV} kv heads")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype
                                     for t in (k, v, o, dout)):
        raise TypeError(f"the backward takes float32 or bfloat16, one dtype: "
                        f"{[str(t.dtype) for t in (q, k, v, o, dout)]}")
    if lse.shape != (B, H, S) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be fp32 {(B, H, S)}, got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not built; kernel has {HEAD_DIMS}")
    if any(t.device != q.device for t in (k, v, o, dout, lse)):
        raise ValueError("the backward's tensors must be on one device")
    if S > 65535 * 32 or k.shape[1] > 65535 * 32:
        raise ValueError(f"sequence {S} / {k.shape[1]} exceeds the grid")


def flash_attention_bwd(q, k, v, o, dout, lse, *, causal=True, window=0,
                        q_offset=0, scale=None):
    """Gradients (dq, dk, dv) of flash attention at its output ``o`` and
    row log-sum-exp ``lse``, for the output gradient ``dout``. CUDA
    tensors run the hand-written kernels (two launches, counted in
    ``launches``); CPU tensors run ``flash_attention_bwd_plain``."""
    global launches
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, dout, lse,
                                         causal=causal, window=window,
                                         q_offset=q_offset, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on cuda or cpu, not "
                         f"{q.device}")
    _check(q, k, v, o, dout, lse)
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    scale = scale if scale is not None else D ** -0.5
    # autograd may hand over a strided output gradient; the kernels read
    # rows whose last dim is contiguous
    q, k, v, o, dout = (t if t.stride(3) == 1 else t.contiguous()
                        for t in (q, k, v, o, dout))
    lse = lse.contiguous()
    dq, dk, dv = torch.empty_like(q, memory_format=torch.contiguous_format), \
        torch.empty_like(k, memory_format=torch.contiguous_format), \
        torch.empty_like(v, memory_format=torch.contiguous_format)
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 24)(*(
        st for t in (q, k, v, o, dout, dq, dk, dv) for st in t.stride()[:3]))
    fn = _kernel()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), strides,
            B, S, T, H, KV, D, _DTYPES[q.dtype], int(causal), int(window),
            int(q_offset), float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention backward launch failed: "
                           f"cudaError {rc}")
    launches += LAUNCHES_PER_CALL
    return dq, dk, dv


def last_kernel() -> str:
    """The kernels the last call ran (``fa_bwd<bf16,64>``...)."""
    fn = _build.load("flash_attention_bwd") \
        .repro_flash_attention_bwd_last_kernel
    fn.argtypes, fn.restype = [], ctypes.c_char_p
    return fn().decode()


def _kernel():
    lib = _build.load("flash_attention_bwd")
    fn = lib.repro_flash_attention_bwd
    if fn.argtypes is None:
        i = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 10
                       + [ctypes.POINTER(ctypes.c_longlong)] + [i] * 10
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn
