"""Public kernel entry points with backend dispatch (port of ``kernels/ops.py``).

``impl``:
  "auto" — the hand-written CUDA kernel for a CUDA tensor, its plain
           PyTorch version for a CPU tensor (``attention.flash_attention``,
           ``ssd_scan.ssd_chunked``, ``segment_reduce.segment_combine``).
  "ref"  — the plain oracle (``ref.attention``, ``ref.ssd``,
           ``ref.segment_combine``).
  "xla"  — the chunked plain oracle (``ref.attention_xla_chunked``,
           ``ref.ssd_chunked``), named after the reference's non-TPU
           production path.
"""
from __future__ import annotations

from repro_torch.kernels import attention as _fa
from repro_torch.kernels import ref
from repro_torch.kernels import segment_reduce as _sr
from repro_torch.kernels import ssd_scan as _ssd


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


def segment_combine(acc, part, op="add", *, impl="auto"):
    if impl == "auto":
        return _sr.segment_combine(acc, part, op)
    if impl == "ref":
        return ref.segment_combine(acc, part, op)
    raise ValueError(f"unknown segment_combine impl {impl!r}")
