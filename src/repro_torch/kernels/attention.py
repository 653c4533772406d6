"""Flash attention forward: the hand-written CUDA kernels, their plain version.

Replaces ``repro/kernels/attention.py::flash_attention`` (the Pallas TPU
kernel ``_fa_kernel``). The kernels are in ``csrc/flash_attention.cu``,
built by ``_build`` and called through ctypes on PyTorch's current
stream: bf16 runs ``fa_fwd_mma`` (``mma.sync`` on the tensor cores, K/V
brought in by ``cp.async``, P kept in registers), fp32 runs ``fa_fwd``
(scalar fp32 FMAs, held at 2e-5, which TF32 would not meet).

Bound on the card: at the serving shape (B=8, S=512, H=9, KV=3, D=64,
bf16, causal) the call moves ~12.6 MB and does ~2.4 GFLOP, so its bound
is ~3.8 us at 3.35 TB/s: memory bound. The design reads each K/V tile
from device memory once per 64 query rows, keeps scores, probabilities
and the online-softmax state on the SM, and skips k-tiles that the
causal mask or the window hides entirely; ``PERF.md`` has its time.

``flash_attention`` takes a CUDA tensor to the kernel, and only a CPU
tensor to ``flash_attention_plain``; any other device raises. There is
no fallback from one kernel to the other or to the plain version: what
the bf16 kernel does not take (a row that does not start on a 16-byte
boundary) raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
HEAD_DIMS = (64, 80, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

BLOCK_K = 64          # keys per tile, as in the kernel
# kernel launches since the last reset (chip_smoke.py zeroes and reads it)
launches = 0


def flash_attention_plain(q, k, v, *, causal=True, window=0, q_offset=0,
                          scale=None):
    """The kernel's arithmetic in plain PyTorch: online softmax over
    ``BLOCK_K``-key tiles in fp32, -1e30 masking, whole-tile skips, and
    0 for a fully masked row. q (B,S,H,D), k/v (B,T,KV,D) -> (B,S,H,D)."""
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    g = H // KV
    scale = scale if scale is not None else D ** -0.5
    dev = q.device
    qf = (q.float() * scale).reshape(B, S, KV, g, D)
    qpos = torch.arange(S, device=dev)[:, None] + q_offset
    m = torch.full((B, KV, g, S), NEG_INF, device=dev)
    l = torch.zeros((B, KV, g, S), device=dev)
    acc = torch.zeros((B, KV, g, S, D), device=dev)
    for k0 in range(0, T, BLOCK_K):
        n = min(BLOCK_K, T - k0)
        if causal and k0 > q_offset + S - 1:
            break                               # tile entirely in the future
        if window > 0 and k0 + n - 1 <= q_offset - window:
            continue                            # tile entirely before the window
        kt = k[:, k0:k0 + n].float()
        vt = v[:, k0:k0 + n].float()
        kpos = torch.arange(k0, k0 + n, device=dev)[None, :]
        mask = torch.ones((S, n), dtype=torch.bool, device=dev)
        if causal:
            mask &= kpos <= qpos
        if window > 0:
            mask &= kpos > qpos - window
        s = torch.einsum("bskgd,btkd->bkgst", qf, kt)
        s = torch.where(mask, s, torch.full((), NEG_INF, device=dev))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(mask, torch.exp(s - m_new[..., None]),
                        torch.zeros((), device=dev))
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bkgst,btkd->bkgsd", p, vt)
        m = m_new
    l = torch.where(l == 0.0, torch.ones((), device=dev), l)
    out = acc / l[..., None]                                 # (B,KV,g,S,D)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, D).to(q.dtype)


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention wants q (B,S,H,D), k/v (B,T,KV,D)")
    B, S, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"shape mismatch q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    KV = k.shape[2]
    if KV == 0 or H % KV:
        raise ValueError(f"{H} query heads do not group over {KV} kv heads")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16, one "
                        f"dtype: {q.dtype} {k.dtype} {v.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not built; kernel has {HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}'s last dim must be contiguous")
    if S > 65535 * 64:
        raise ValueError(f"sequence {S} exceeds the kernel's grid")
    if q.dtype == torch.bfloat16:
        # cp.async copies whole 16-byte rows: each (b, s, h) row starts
        # on a 16-byte boundary
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16 or any(
                    st % 8 for st, n in zip(t.stride()[:3], t.shape[:3])
                    if n > 1):
                raise ValueError(f"the bf16 kernel reads 16-byte-aligned "
                                 f"rows; {name} has data_ptr "
                                 f"{t.data_ptr()} and strides {t.stride()}")


def flash_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                    scale=None):
    """GQA flash attention forward. q (B,S,H,D), k/v (B,T,KV,D) -> (B,S,H,D)
    in q's dtype. CUDA tensors run the hand-written kernel of their dtype
    (one launch either way); CPU tensors run ``flash_attention_plain``."""
    global launches
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    _check(q, k, v)
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    scale = scale if scale is not None else D ** -0.5
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    fn = _kernel()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            out.stride(0), out.stride(1), out.stride(2),
            B, S, T, H, KV, D, _DTYPES[q.dtype],
            int(causal), int(window), int(q_offset), float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {rc}")
    launches += 1
    return out


def last_kernel() -> str:
    """The name of the kernel instantiation the last launch ran, as the
    library reports it (``fa_fwd_mma<bf16,64>``, ``fa_fwd<f32,80>``...)."""
    fn = _build.load("flash_attention").repro_flash_attention_last_kernel
    fn.argtypes, fn.restype = [], ctypes.c_char_p
    return fn().decode()


def _kernel():
    lib = _build.load("flash_attention")
    fn = lib.repro_flash_attention_fwd
    if fn.argtypes is None:
        ll, i = ctypes.c_longlong, ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ll] * 12 + [i] * 10
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn
