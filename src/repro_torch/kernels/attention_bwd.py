"""Flash attention backward: the hand-written CUDA kernels and their plain
versions.

The reference trains through the Pallas TPU kernel
``repro/kernels/attention.py::flash_attention`` (``_fa_kernel``) under
``jax.value_and_grad``; this is the gradient of that function, from the
row log-sum-exp the forward writes (``attention.FlashAttention``). The
kernels are in ``csrc/flash_attention_bwd.cu``, built by ``_build`` and
called through ctypes on PyTorch's current stream, two launches a call,
dq first (it also writes the per-row ``delta = sum(dO * O)`` that dk/dv
reads), head dims 64, 80 and 128:

* bf16 runs ``fa_bwd_dq_mma`` then ``fa_bwd_dkdv_mma`` on the tensor
  cores (``mma.sync``, tiles brought in by ``cp.async`` in two stages,
  P and dS kept in registers). A dk/dv block owns one query head's
  64-key tile; the last block of a (b, KV head, key tile) to arrive sums
  the group's fp32 partials in head order, so two calls give the same
  bits. At smollm-135m's training shape (2, 256, 9, 3, 64) that is 144
  dq blocks and 72 dk/dv blocks (the SIMT design: 144 and 48). Rows must
  start on 16 bytes: others are copied first.
* fp32 runs the SIMT ``fa_bwd_dq`` then ``fa_bwd_dkdv`` (scalar fp32
  FMAs from fp32 tiles, each dk/dv block summing its KV head's whole
  query group in registers); ``simt=True`` runs them for bf16 too, as
  the yardstick ``chip_smoke.py`` times beside the tensor-core kernels.

Bound on the card (bytes: q, k, v, o, dO and lse read once and dq, dk,
dv written once; operations: five products over the visible pairs):
3.16 MB, ~0.95 us at 3.35 TB/s, at the training shape (bf16, causal),
and 25.3 MB, ~7.6 us, at the serving shape (8, 512, 9, 3, 64); both
memory bound. ``PERF.md`` has the times.

Numerics: every version recomputes ``P = exp(scale * q.k - lse)`` and
``dS = P * (dO.v - delta)`` in fp32 from the inputs as given and rounds
the fp32 results once to the input dtype. The tensor-core kernels also
round P and dS to bf16 where they enter the dV, dK and dQ products (the
forward rounds P before PV likewise); ``flash_attention_bwd_mma_plain``
is that algebra, ``flash_attention_bwd_plain`` the fp32-P one (the SIMT
kernels').

``flash_attention_bwd`` takes CUDA tensors to the kernels and only CPU
tensors to ``flash_attention_bwd_plain``; ``meta`` tensors get the
kernels' outputs and scratch and run nothing (both note `bwd_work` to
the open count, ``repro_torch.count``); any other device raises, and
there is no fallback from a kernel to another or to a plain version.
Later work: ``wgmma`` with TMA, dQ in the dk/dv kernel, persistent
blocks.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import count
from repro_torch.kernels import _build
from repro_torch.kernels.ref import attention_mask

HEAD_DIMS = (64, 80, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: kernel launches of one backward call (dq, then dk/dv)
LAUNCHES_PER_CALL = 2
#: keys of a tensor-core dk/dv block (the kernel's ``MT``)
BLOCK_KEYS = 64

# kernel launches since the last reset (chip_smoke.py zeroes and reads it)
launches = 0


def _p_and_ds(q, k, v, o, dout, lse, causal, window, q_offset, scale):
    """fp32 (B,S,KV,g,D) q and dO, (B,T,KV,D) k, and the (B,KV,g,S,T)
    probabilities ``P = exp(scale * q.k - lse)`` (0 where masked) and
    ``dS = P * (dO.v - delta)`` with ``delta = sum(dO * O)``."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    g = H // KV
    qf = q.float().reshape(B, S, KV, g, D)
    kf, vf = k.float(), v.float()
    of = o.float().reshape(B, S, KV, g, D)
    dof = dout.float().reshape(B, S, KV, g, D)
    mask = attention_mask(S, k.shape[1], causal=causal, window=window,
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
    dp = torch.einsum("bskgd,btkd->bkgst", dof, vf)
    return qf, kf, dof, p, p * (dp - delta[..., None])


def flash_attention_bwd_plain(q, k, v, o, dout, lse, *, causal=True,
                              window=0, q_offset=0, scale=None):
    """The backward's algebra in plain PyTorch, fp32, from ``lse``:
    ``delta = sum(dO * O)``, ``P = exp(scale * q.k - lse)`` (0 where
    masked), ``dV = P^T dO``, ``dS = P * (dO.v - delta)``,
    ``dQ = scale * dS K``, ``dK = scale * dS^T Q`` (summed over each KV
    head's query group). q/o/dout (B,S,H,D), k/v (B,T,KV,D), lse fp32
    (B,H,S) -> (dq, dk, dv) in the inputs' dtype."""
    B, S, H, D = q.shape
    scale = scale if scale is not None else D ** -0.5
    qf, kf, dof, p, ds = _p_and_ds(q, k, v, o, dout, lse, causal, window,
                                   q_offset, scale)
    dv = torch.einsum("bkgst,bskgd->btkd", p, dof)
    dq = torch.einsum("bkgst,btkd->bskgd", ds, kf) * scale
    dk = torch.einsum("bkgst,bskgd->btkd", ds, qf) * scale
    return (dq.reshape(B, S, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def flash_attention_bwd_mma_plain(q, k, v, o, dout, lse, *, causal=True,
                                  window=0, q_offset=0, scale=None):
    """The tensor-core kernels' algebra in plain PyTorch (tests and
    ``chip_smoke.py`` only; the main path never calls it): as
    `flash_attention_bwd_plain`, but the fp32 P and dS are rounded to the
    inputs' dtype where they enter the dV, dK and dQ products, and dK and
    dV are summed over each KV head's query group from per-head fp32
    partials in head order (dK scaled after the sum), as the last block
    of a key tile sums them."""
    B, S, H, D = q.shape
    g = H // k.shape[2]
    scale = scale if scale is not None else D ** -0.5
    qf, kf, dof, p, ds = _p_and_ds(q, k, v, o, dout, lse, causal, window,
                                   q_offset, scale)
    pr, dsr = p.to(q.dtype).float(), ds.to(q.dtype).float()
    dq = torch.einsum("bkgst,btkd->bskgd", dsr, kf) * scale
    dv_h = torch.einsum("bkgst,bskgd->btkgd", pr, dof)
    dk_h = torch.einsum("bkgst,bskgd->btkgd", dsr, qf)
    dv, dk = dv_h[:, :, :, 0], dk_h[:, :, :, 0]
    for j in range(1, g):
        dv, dk = dv + dv_h[:, :, :, j], dk + dk_h[:, :, :, j]
    return (dq.reshape(B, S, H, D).to(q.dtype), (dk * scale).to(k.dtype),
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


def _rows(t, aligned):
    """``t`` if the kernels can read it in place (last dim contiguous and,
    for the tensor-core kernels, every row on a 16-byte boundary), else a
    contiguous copy: autograd may hand over a strided or offset output
    gradient."""
    if t.stride(3) == 1 and not aligned:
        return t
    if t.stride(3) == 1 and t.data_ptr() % 16 == 0 and all(
            st % 8 == 0 for st, n in zip(t.stride()[:3], t.shape[:3])
            if n > 1):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def bwd_work(q, k):
    """``(flops, bytes)`` of one backward call: FLOPs as
    ``torch.utils.flop_counter`` counts autograd's backward of
    ``ref.attention`` with every input requiring a gradient (each of the
    forward's two products transposed twice: 8 x ``B H S T D``), bytes as
    q, k, v, o, dout and ``lse`` read once and dq, dk, dv written once."""
    B, S, H, D = q.shape
    T = k.shape[1]
    nbytes = (4 * q.numel() + 4 * k.numel()) * q.element_size() \
        + 4 * B * H * S
    return 8 * B * H * S * T * D, nbytes


def flash_attention_bwd(q, k, v, o, dout, lse, *, causal=True, window=0,
                        q_offset=0, scale=None, simt=False):
    """Gradients (dq, dk, dv) of flash attention at its output ``o`` and
    row log-sum-exp ``lse``, for the output gradient ``dout``. CUDA
    tensors run the hand-written kernels (two launches, counted in
    ``launches``): bf16 on the tensor cores, fp32 on the SIMT kernels;
    ``simt=True`` runs the SIMT kernels for bf16 too (the first design,
    which ``chip_smoke.py`` times beside the tensor-core kernels; the
    training path never passes it). CPU tensors run
    ``flash_attention_bwd_plain``."""
    global launches
    if q.device.type == "cpu":
        with count.kernel("flash_attention_bwd", *bwd_work(q, k),
                          LAUNCHES_PER_CALL):
            return flash_attention_bwd_plain(q, k, v, o, dout, lse,
                                             causal=causal, window=window,
                                             q_offset=q_offset, scale=scale)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention_bwd runs on cuda or cpu (or "
                         f"meta), not {q.device}")
    _check(q, k, v, o, dout, lse)
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    scale = scale if scale is not None else D ** -0.5
    mma = q.dtype == torch.bfloat16 and not simt
    q, k, v, o, dout = (_rows(t, mma) for t in (q, k, v, o, dout))
    lse = lse.contiguous()
    dq, dk, dv = torch.empty_like(q, memory_format=torch.contiguous_format), \
        torch.empty_like(k, memory_format=torch.contiguous_format), \
        torch.empty_like(v, memory_format=torch.contiguous_format)
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    # one fp32 scratch: delta (B, H, S), then for the tensor-core kernels
    # over a GQA group the per-head dK and dV partials (B, T, H, D) each
    # and the int arrival counters (B, KV, T/64), each part 16-byte aligned
    n_delta = -(-B * H * S // 4) * 4
    n_part = B * T * H * D if mma and H > KV else 0
    n_arr = B * KV * -(-T // BLOCK_KEYS) if n_part else 0
    scratch = torch.empty(n_delta + 2 * n_part + n_arr, dtype=torch.float32,
                          device=q.device)
    if q.device.type == "meta":     # the outputs and the scratch, no launch
        count.note("flash_attention_bwd", *bwd_work(q, k),
                   LAUNCHES_PER_CALL)
        return dq, dk, dv
    base = scratch.data_ptr()
    parts = (base + 4 * n_delta, base + 4 * (n_delta + n_part),
             base + 4 * (n_delta + 2 * n_part)) if n_part else (None,) * 3
    strides = (ctypes.c_longlong * 24)(*(
        st for t in (q, k, v, o, dout, dq, dk, dv) for st in t.stride()[:3]))
    fn = _kernel()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), base, *parts,
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), strides,
            B, S, T, H, KV, D, _DTYPES[q.dtype], int(causal), int(window),
            int(q_offset), float(scale), int(simt), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention backward launch failed: "
                           f"cudaError {rc}")
    launches += LAUNCHES_PER_CALL
    return dq, dk, dv


def last_kernel() -> str:
    """The kernels the last call ran (``fa_bwd_mma<bf16,64>``,
    ``fa_bwd<f32,64>``...)."""
    fn = _build.load("flash_attention_bwd") \
        .repro_flash_attention_bwd_last_kernel
    fn.argtypes, fn.restype = [], ctypes.c_char_p
    return fn().decode()


def _kernel():
    lib = _build.load("flash_attention_bwd")
    fn = lib.repro_flash_attention_bwd
    if fn.argtypes is None:
        i = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 13
                       + [ctypes.POINTER(ctypes.c_longlong)] + [i] * 10
                       + [ctypes.c_float, i, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn
