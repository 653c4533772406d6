"""Serving tier of the port: continuous batching over a paged KV cache.

  * ``paged_kv``   — block pool + free list + per-request block tables.
  * ``scheduler``  — the reference's continuous-batching policy (a copy).
  * ``engine``     — PyTorch execution: prefill + one batched decode over
                     fixed request slots, paged KV views, per-request
                     latency records for ``decode_summary``.
"""
from repro_torch.serve.paged_kv import BlockPool, PagedKV
from repro_torch.serve.scheduler import Request, Scheduler, load_trace, \
    synthetic_trace
from repro_torch.serve.engine import ServeEngine, ServeResult

__all__ = [
    "BlockPool",
    "PagedKV",
    "Request",
    "Scheduler",
    "load_trace",
    "synthetic_trace",
    "ServeEngine",
    "ServeResult",
]
