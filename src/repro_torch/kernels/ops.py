"""Public kernel entry points with backend dispatch (port of ``kernels/ops.py``).

``impl``:
  "auto" — the hand-written CUDA kernel for a CUDA tensor, its plain
           PyTorch version for a CPU tensor (``attention.flash_attention``,
           ``ssd_scan.ssd_chunked``, ``segment_reduce.segment_combine``,
           ``paged_attention.paged_attention``); an input that requires a
           gradient trains through the kernels' autograd functions
           (``attention.FlashAttention``, ``ssd_scan.SSDChunk``), whose
           backwards are hand-written kernels too.
  "ref"  — the plain oracle (``ref.attention``, ``ref.ssd``,
           ``ref.segment_combine``, ``ref.paged_attention_ref``).
  "xla"  — the chunked plain oracle (``ref.attention_xla_chunked``,
           ``ref.ssd_chunked``) and the gather path of paged attention
           (``ref.paged_attention_ref``), named after the reference's
           non-TPU production path. "ref" and "xla" train through plain
           autograd.
"""
from __future__ import annotations

from repro_torch.kernels import attention as _fa
from repro_torch.kernels import attention_bwd as _fab
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ref
from repro_torch.kernels import segment_reduce as _sr
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels import ssd_scan_bwd as _ssdb

#: the kernels of the training path, by the name the launch counts use
#: (each module's ``launches``); serving adds the paged decode kernel
TRAIN_COUNTERS = {"flash_attention": _fa, "flash_attention_bwd": _fab,
                  "ssd_chunk": _ssd, "ssd_chunk_bwd": _ssdb,
                  "segment_combine": _sr}
SERVE_COUNTERS = {**TRAIN_COUNTERS, "paged_attention": _pa}


def attention(q, k, v, *, causal=True, window=0, q_offset=0, scale=None,
              impl="auto"):
    if impl == "auto":
        return _fa.flash_attention(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, scale=scale)
    if impl == "xla":
        return ref.attention_xla_chunked(q, k, v, causal=causal,
                                         window=window, q_offset=q_offset,
                                         scale=scale)
    if impl == "ref":
        return ref.attention(q, k, v, causal=causal, window=window,
                             q_offset=q_offset, scale=scale)
    raise ValueError(f"unknown attention impl {impl!r}")


def ssd(x, dt, A, B, C, D, *, chunk=128, impl="auto"):
    if impl == "auto":
        return _ssd.ssd_chunked(x, dt, A, B, C, D, chunk=chunk)
    if impl == "xla":
        return ref.ssd_chunked(x, dt, A, B, C, D, chunk=chunk)
    if impl == "ref":
        return ref.ssd(x, dt, A, B, C, D)
    raise ValueError(f"unknown ssd impl {impl!r}")


def segment_combine(acc, part, op="add", *, impl="auto", out=None):
    """``out`` (which may be ``acc``) takes the result in place."""
    if impl == "auto":
        return _sr.segment_combine(acc, part, op, out=out)
    if impl == "ref":
        r = ref.segment_combine(acc, part, op)
        return r if out is None else out.copy_(r)
    raise ValueError(f"unknown segment_combine impl {impl!r}")


def paged_attention(q, k_pool, v_pool, block_tables, lengths, *, window=0,
                    impl="auto"):
    if impl == "auto":
        return _pa.paged_attention(q, k_pool, v_pool, block_tables, lengths,
                                   window=window)
    if impl in ("xla", "ref"):
        return ref.paged_attention_ref(q, k_pool, v_pool, block_tables,
                                       lengths, window=window)
    raise ValueError(f"unknown paged attention impl {impl!r}")
