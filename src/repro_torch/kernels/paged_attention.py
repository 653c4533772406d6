"""Paged decode attention: the hand-written CUDA kernel and its plain version.

Replaces ``repro/kernels/paged_attention.py::_paged_attention_pallas``
(the Pallas TPU kernel ``_pa_kernel``): one new token per request
attends, through its block table, to its ring-buffer view of a shared
KV block pool, without the view ever being copied out of the pool. The
kernel is ``csrc/paged_attention.cu``, built by ``_build`` and called
through ctypes on PyTorch's current stream.

Bound on the card: the call reads each request's K and V view once and
does 4 * Dh operations per (query head, slot), so it is memory bound
(smollm's serving shape, 8 requests of 576 slots, 3 KV heads of 64,
bf16: 3.54 MB of K and V, ~1.06 us at 3.35 TB/s). One thread block per
(request, KV head) reads only the pool blocks that hold a valid slot
and keeps scores and the online softmax on the SM; ``PERF.md`` has its
time.

``paged_attention`` takes a CUDA tensor to the kernel, and only a CPU
tensor to the plain version, ``ref.paged_attention_ref`` (the gather
path, the reference's non-TPU ``auto``); any other device raises. There
is no fallback from the kernel to the plain version. The two differ in
where they round: the gather path casts the scaled q and the
probabilities to the pool dtype, the kernel keeps both in fp32 as the
TPU kernel does; with fp32 q and pools they compute the same function.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

HEAD_DIMS = (64, 80, 128)
MAX_BLOCK_SIZE = 64
SMEM_LIMIT = 232448          # bytes a block may use on an H100
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the last reset (chip_smoke.py zeroes and reads it)
launches = 0


def _check_shapes(q, k_pool, v_pool, block_tables, lengths):
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"paged attention decodes one token per request: "
                         f"q (R, 1, H, Dh), got {tuple(q.shape)}")
    R, _, H, Dh = q.shape
    if k_pool.dim() != 4 or k_pool.shape != v_pool.shape or \
            k_pool.shape[3] != Dh:
        raise ValueError(f"pools must be (NB, bs, KV, {Dh}): k "
                         f"{tuple(k_pool.shape)} v {tuple(v_pool.shape)}")
    KV = k_pool.shape[2]
    if KV == 0 or H % KV:
        raise ValueError(f"{H} query heads do not group over {KV} kv heads")
    if block_tables.dim() != 2 or block_tables.shape[0] != R:
        raise ValueError(f"block tables must be ({R}, nb), got "
                         f"{tuple(block_tables.shape)}")
    if tuple(lengths.shape) != (R,):
        raise ValueError(f"lengths must be ({R},), got {tuple(lengths.shape)}")


def _check_kernel(q, k_pool, v_pool):
    if q.dtype not in _DTYPES or k_pool.dtype not in _DTYPES or \
            v_pool.dtype != k_pool.dtype:
        raise TypeError(f"paged_attention takes float32 or bfloat16 q and "
                        f"one such dtype for both pools: {q.dtype} "
                        f"{k_pool.dtype} {v_pool.dtype}")
    Dh, bs = q.shape[3], k_pool.shape[1]
    if Dh not in HEAD_DIMS:
        raise ValueError(f"head dim {Dh} not built; kernel has {HEAD_DIMS}")
    if not 1 <= bs <= MAX_BLOCK_SIZE:
        raise ValueError(f"block size {bs} outside 1..{MAX_BLOCK_SIZE}")
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()):
        raise ValueError("paged_attention takes contiguous pools")
    if q.stride(3) != 1:
        raise ValueError("q's last dim must be contiguous")
    group = q.shape[2] // k_pool.shape[2]
    smem = _lib().repro_paged_attention_smem(Dh, group, bs)
    if smem > SMEM_LIMIT:
        raise ValueError(f"{group} query heads per kv head at block size "
                         f"{bs} need {smem} bytes of shared memory")


def paged_attention(q, k_pool, v_pool, block_tables, lengths, *,
                    window: int = 0):
    """Decode attention through a paged KV pool.

    q: (R, 1, H, Dh), the current token's queries, one row per request;
    k_pool/v_pool: (NB, bs, KV, Dh), one layer's shared block pool;
    block_tables: (R, nb) pool-block ids; lengths: (R,) tokens written
    per request INCLUDING the current one. Returns (R, 1, H, Dh) in q's
    dtype. CUDA tensors run the hand-written kernel (tables and lengths
    taken as contiguous int32, a no-op for int32 inputs); CPU tensors run
    ``ref.paged_attention_ref``.
    """
    global launches
    lengths = torch.as_tensor(lengths, device=q.device)
    _check_shapes(q, k_pool, v_pool, block_tables, lengths)
    if q.device.type == "cpu":
        return ref.paged_attention_ref(q, k_pool, v_pool, block_tables,
                                       lengths, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cuda or cpu, not "
                         f"{q.device}")
    if any(t.device != q.device for t in (k_pool, v_pool, block_tables)):
        raise ValueError("q, the pools and the block tables must be on one "
                         "device")
    _check_kernel(q, k_pool, v_pool)
    R, _, H, Dh = q.shape
    bs, KV = k_pool.shape[1], k_pool.shape[2]
    tables = block_tables.to(torch.int32).contiguous()
    lens = lengths.to(torch.int32).contiguous()
    out = torch.empty((R, 1, H, Dh), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _lib().repro_paged_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), out.data_ptr(),
        tables.data_ptr(), lens.data_ptr(), q.stride(0), q.stride(2),
        R, H, KV, Dh, bs, tables.shape[1], int(window), float(Dh ** -0.5),
        _DTYPES[q.dtype], _DTYPES[k_pool.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: "
                           f"cudaError {rc}")
    launches += 1
    return out


def _lib():
    lib = _build.load("paged_attention")
    fn = lib.repro_paged_attention
    if fn.argtypes is None:
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = ([vp] * 6 + [ll] * 2 + [i] * 7 + [ctypes.c_float]
                       + [i] * 2 + [vp])
        fn.restype = ctypes.c_int
        lib.repro_paged_attention_smem.argtypes = [i, i, i]
        lib.repro_paged_attention_smem.restype = ctypes.c_longlong
    return lib
