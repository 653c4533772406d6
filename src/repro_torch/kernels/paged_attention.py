"""Paged decode attention: the hand-written CUDA kernel and its plain versions.

Replaces ``repro/kernels/paged_attention.py::_paged_attention_pallas``
(the Pallas TPU kernel ``_pa_kernel``): one new token per request
attends, through its block table, to its ring-buffer view of a shared
KV block pool, without the view ever being copied out of the pool. The
kernel is ``csrc/paged_attention.cu``, built by ``_build`` and called
through ctypes on PyTorch's current stream.

Bound on the card: the call reads each request's K and V view once and
does 4 * Dh operations per (query head, slot), so it is memory bound
(smollm's serving shape, 8 requests of 576 slots, 3 KV heads of 64,
bf16: 3.54 MB of K and V, ~1.06 us at 3.35 TB/s). The kernel splits each
request's table into chunks of pool blocks (``split_plan``: at least four
thread blocks per SM), reads only the pool blocks that hold a valid
slot, 16 bytes a copy, and runs as two launches: the scores and each
split's max and sum, then the normalised probabilities times V per split
and the partials summed in split order. ``PERF.md`` has its time.

The kernel computes the gather path's function, ``ref.paged_attention_ref``
(the reference's ``cache_attention``, which its engine decodes with): the
scaled q rounded to q's dtype and then to the pool dtype, fp32 logits,
-1e30 for a masked slot, the softmax in fp32 normalised over the whole
row and then rounded to the pool dtype, P V accumulated in fp32 and cast
to q's dtype. This departs from ``_pa_kernel``, which keeps q and P in
fp32; the reference's engine never calls ``_pa_kernel``, and the port's
engine is held to the dense decode's rounding. A row with no valid slot
gives 0 (the gather path gives the mean of V there; the engine never
asks for one). ``paged_attention_split_plain`` is the kernel's split
algebra in plain PyTorch, for the tests and ``chip_smoke.py``.

``paged_attention`` takes a CUDA tensor to the kernel, and only a CPU
tensor to the plain version, ``ref.paged_attention_ref`` (the gather
path, the reference's non-TPU ``auto``); any other device raises. There
is no fallback from the kernel to the plain version.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, ref

HEAD_DIMS = (64, 80, 128)
MAX_BLOCK_SIZE = 64
SMEM_LIMIT = 232448          # bytes a block may use on an H100
H100_SMS = 132               # streaming multiprocessors of an H100
BLOCKS_PER_SM = 4            # thread blocks per SM the split aims for
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the last reset (chip_smoke.py zeroes and reads it)
launches = 0


def split_plan(R: int, KV: int, nb: int, sms: int = H100_SMS):
    """``(blocks_per_split, splits)`` for ``R`` requests of ``nb`` pool
    blocks over ``KV`` heads: the most pool blocks per split for which
    the ``R * KV * splits`` thread blocks are at least ``BLOCKS_PER_SM``
    per SM (one split when ``R * KV`` alone fills the card)."""
    want = -(-BLOCKS_PER_SM * sms // max(1, R * KV))
    bps = max(1, nb // want)
    return bps, max(1, -(-nb // bps))


def paged_attention_split_plain(q, k_pool, v_pool, block_tables, lengths,
                                *, window: int = 0,
                                blocks_per_split: int | None = None):
    """The kernel's two phases in plain PyTorch, split by
    ``blocks_per_split`` pool blocks (``split_plan``'s by default): each
    split's max and sum of its valid logits, the row's max and sum merged
    from them in split order, the normalised probabilities rounded to
    the pool dtype, P V per split in fp32, and the partials summed in
    split order. Shapes as ``paged_attention``; a row with no valid slot
    gives 0."""
    R, _, H, Dh = q.shape
    bs, KV = k_pool.shape[1], k_pool.shape[2]
    nb = block_tables.shape[1]
    T, group = nb * bs, H // KV
    if blocks_per_split is None:
        blocks_per_split = split_plan(R, KV, nb)[0]
    width = blocks_per_split * bs
    kv = k_pool.dtype
    qr = (q * (Dh ** -0.5)).to(kv).float().reshape(R, KV, group, Dh)
    kf = ref.gather_kv_view(k_pool, block_tables).float()   # (R, T, KV, Dh)
    vf = ref.gather_kv_view(v_pool, block_tables).float()
    lengths = torch.as_tensor(lengths, device=q.device)
    pos = ref.ring_slot_positions(lengths, T)                # (R, T)
    last = (lengths - 1)[:, None]
    valid = (pos >= 0) & (pos <= last)
    if window > 0:
        valid &= pos > last - window
    valid = valid[:, None, None, :]                          # (R, 1, 1, T)
    s = torch.einsum("rkgd,rtkd->rkgt", qr, kf)
    s = torch.where(valid, s, torch.full((), ref.NEG_INF))
    starts = range(0, T, width)
    # phase 1: each split's max and sum
    ms, ls = [], []
    for a in starts:
        m = s[..., a:a + width].amax(-1)
        e = torch.exp(s[..., a:a + width] - m[..., None])
        ls.append(torch.where(valid[..., a:a + width], e, 0.0).sum(-1))
        ms.append(m)
    # phase 2: the row's max and sum, then P V per split
    m = torch.stack(ms).amax(0)
    l = torch.zeros_like(m)
    for mi, li in zip(ms, ls):
        l = l + li * torch.exp(mi - m)
    out = torch.zeros((R, KV, group, Dh), device=q.device)
    for a in starts:
        p = torch.exp(s[..., a:a + width] - m[..., None]) / l[..., None]
        p = torch.where(valid[..., a:a + width], p, 0.0).to(kv).float()
        out = out + torch.einsum("rkgt,rtkd->rkgd", p, vf[:, a:a + width])
    return out.reshape(R, 1, H, Dh).to(q.dtype)


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
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        # cp.async copies 16-byte pieces of each pool row
        raise ValueError(f"paged_attention reads 16-byte-aligned pools; "
                         f"data_ptr {k_pool.data_ptr()} {v_pool.data_ptr()}")
    if q.stride(3) != 1:
        raise ValueError("q's last dim must be contiguous")
    group = q.shape[2] // k_pool.shape[2]
    smem = _smem_bytes(Dh, group, bs, k_pool.element_size())
    if smem > SMEM_LIMIT:
        raise ValueError(f"{group} query heads per kv head at block size "
                         f"{bs} need {smem} bytes of shared memory")


@functools.lru_cache(maxsize=None)
def _smem_bytes(Dh, group, bs, itemsize):
    return _lib().repro_paged_attention_smem(Dh, group, bs, itemsize)


@functools.lru_cache(maxsize=None)
def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def paged_attention(q, k_pool, v_pool, block_tables, lengths, *,
                    window: int = 0):
    """Decode attention through a paged KV pool.

    q: (R, 1, H, Dh), the current token's queries, one row per request;
    k_pool/v_pool: (NB, bs, KV, Dh), one layer's shared block pool;
    block_tables: (R, nb) pool-block ids; lengths: (R,) tokens written
    per request INCLUDING the current one. Returns (R, 1, H, Dh) in q's
    dtype. CUDA tensors run the hand-written kernel (tables taken as
    contiguous int32, lengths as contiguous int32 or int64: no-ops for
    the engine's tensors); CPU tensors run ``ref.paged_attention_ref``.
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
    # the engine's int64 lengths are read as they are: no cast launch
    lens = lengths if lengths.dtype in (torch.int32, torch.int64) \
        else lengths.to(torch.int32)
    lens = lens.contiguous()
    out = torch.empty((R, 1, H, Dh), dtype=q.dtype, device=q.device)
    nb = tables.shape[1]
    if out.numel() == 0 or nb == 0:        # no slot at all: every row is 0
        return out.zero_()
    bps, splits = split_plan(R, KV, nb, _sms(q.device))
    # ml (float2), partials, scores, arrival counters: see the .cu
    scratch = torch.empty(4 * (R * H * splits * (2 + Dh) + R * H * nb * bs
                               + R * KV), dtype=torch.uint8, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _lib().repro_paged_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), out.data_ptr(),
        tables.data_ptr(), lens.data_ptr(), int(lens.dtype == torch.int64),
        scratch.data_ptr(),
        q.stride(0), q.stride(2), R, H, KV, Dh, bs, nb, int(window), bps,
        splits, float(Dh ** -0.5), _DTYPES[q.dtype], _DTYPES[k_pool.dtype],
        stream)
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
        fn.argtypes = ([vp] * 6 + [i, vp] + [ll] * 2 + [i] * 9
                       + [ctypes.c_float] + [i] * 2 + [vp])
        fn.restype = ctypes.c_int
        lib.repro_paged_attention_smem.argtypes = [i, i, i, i]
        lib.repro_paged_attention_smem.restype = ctypes.c_longlong
    return lib
