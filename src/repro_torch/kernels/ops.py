"""Public kernel entry points with backend dispatch (port of ``kernels/ops.py``).

``impl``:
  "auto" — the hand-written CUDA kernel for a CUDA tensor, its plain
           PyTorch version for a CPU tensor (``attention.flash_attention``).
  "ref"  — the quadratic plain oracle (``ref.attention``).
  "xla"  — the query-chunked plain oracle (``ref.attention_xla_chunked``),
           named after the reference's non-TPU production path.

``ssd`` and ``segment_combine`` arrive with the slices that port their
kernels (ROADMAP.md Queue 2).
"""
from __future__ import annotations

from repro_torch.kernels import attention as _fa
from repro_torch.kernels import ref


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
