"""Segment combine: the hand-written CUDA kernel and its plain version.

Replaces ``repro/kernels/segment_reduce.py::segment_combine_pallas`` (the
Pallas TPU kernel ``_combine_kernel``), the reduce step of every tuned
reduction: ``out = cast(op(float(acc), float(part)))`` for op in
{add, max, min}, fp32 math, cast back to the wire dtype (fp32 or bf16).
The kernel is ``csrc/segment_combine.cu``, built by ``_build`` and called
through ctypes on PyTorch's current stream.

Bound on the card: the call reads ``acc`` and ``part`` once and writes
``out`` once, ``3 * n * itemsize`` bytes for ``n`` operations, so it is
memory bound (~0.060 ms for 16M fp32 elements at 3.35 TB/s). The kernel
moves each byte once, in 16-byte vectors where the three buffers share
an alignment, on a grid sized to the work; ``PERF.md`` has its time.
With ``out=acc`` it combines in place, so a caller that owns the
accumulator's buffer (the ring, the step programs) needs no copy back.

``segment_combine`` takes a CUDA tensor to the kernel, and only a CPU
tensor to ``segment_combine_plain``; a ``meta`` tensor gets the kernel's
output and runs nothing (both note `work` to the open count,
``repro_torch.count``); any other device raises. There is no
fallback from the kernel to the plain version. The kernel takes
contiguous inputs: the port's algorithms slice whole rows, so their
segments are contiguous, and a strided input raises rather than being
copied.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import count
from repro_torch.kernels import _build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_OPS = {"add": 0, "max": 1, "min": 2}

# kernel launches since the last reset (chip_smoke.py zeroes and reads it)
launches = 0


def segment_combine_plain(acc: torch.Tensor, part: torch.Tensor,
                          op: str = "add") -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch (``ref.segment_combine``):
    one fp32 operation per element, cast back to ``acc``'s dtype."""
    _check(acc, part, op)
    return ref.segment_combine(acc, part, op)


def work(acc):
    """``(flops, bytes)`` of one call: no FLOPs as
    ``torch.utils.flop_counter`` counts (it counts products, not
    elementwise adds), ``acc`` and ``part`` read once and the output
    written once."""
    return 0, 3 * acc.numel() * acc.element_size()


def _check(acc, part, op):
    if op not in _OPS:
        raise ValueError(f"unknown op {op!r}; have {sorted(_OPS)}")
    if acc.shape != part.shape or acc.dtype != part.dtype:
        raise ValueError(f"segment_combine wants one shape and dtype: "
                         f"{tuple(acc.shape)} {acc.dtype} vs "
                         f"{tuple(part.shape)} {part.dtype}")


def _overlap(a, b):
    """Whether the byte ranges of two tensors on one device overlap."""
    if a.device != b.device or a.numel() == 0 or b.numel() == 0 \
            or a.device.type == "meta":         # no addresses on meta
        return False

    def span(t):
        lo = t.data_ptr()
        last = sum((n - 1) * st for n, st in zip(t.shape, t.stride()))
        return lo, lo + (last + 1) * t.element_size()
    (a0, a1), (b0, b1) = span(a), span(b)
    return a0 < b1 and b0 < a1


def _check_out(acc, part, out):
    """``out`` takes the result in place: acc's shape, dtype and device,
    contiguous, either ``acc`` itself or apart from it, and apart from
    ``part``."""
    if out.shape != acc.shape or out.dtype != acc.dtype or \
            out.device != acc.device:
        raise ValueError(f"segment_combine's out must match acc: "
                         f"{tuple(out.shape)} {out.dtype} {out.device} vs "
                         f"{tuple(acc.shape)} {acc.dtype} {acc.device}")
    if not out.is_contiguous():
        raise ValueError("segment_combine's out must be contiguous")
    if _overlap(out, part):
        raise ValueError("segment_combine's out must not overlap part")
    if _overlap(out, acc) and not (out.data_ptr() == acc.data_ptr()
                                   and acc.is_contiguous()):
        raise ValueError("segment_combine's out must be acc itself or "
                         "apart from it")


def segment_combine(acc: torch.Tensor, part: torch.Tensor,
                    op: str = "add", *, out=None) -> torch.Tensor:
    """``acc (op) part`` elementwise in fp32, cast to ``acc``'s dtype.
    CUDA tensors run the hand-written kernel; CPU tensors run
    ``segment_combine_plain``. With ``out`` (which may be ``acc``) the
    result is written there and ``out`` returned."""
    global launches
    if acc.device.type == "cpu" and part.device.type == "cpu":
        with count.kernel("segment_combine", *work(acc), 1):
            if out is None:
                return segment_combine_plain(acc, part, op)
            _check_out(acc, part, out)
            return out.copy_(segment_combine_plain(acc, part, op))
    if acc.device.type not in ("cuda", "meta") or \
            part.device != acc.device:
        raise ValueError(f"segment_combine runs on cuda or cpu, both "
                         f"inputs on one device, not {acc.device} and "
                         f"{part.device}")
    _check(acc, part, op)
    if acc.dtype not in _DTYPES:
        raise TypeError(f"segment_combine takes float32 or bfloat16, not "
                        f"{acc.dtype}")
    if not (acc.is_contiguous() and part.is_contiguous()):
        raise ValueError("segment_combine takes contiguous inputs")
    if out is None:
        out = torch.empty_like(acc, memory_format=torch.contiguous_format)
    else:
        _check_out(acc, part, out)
    n = acc.numel()
    if acc.device.type == "meta":
        count.note("segment_combine", *work(acc), 1)
        return out
    if n == 0:
        return out
    stream = torch.cuda.current_stream(acc.device).cuda_stream
    rc = _kernel()(acc.data_ptr(), part.data_ptr(), out.data_ptr(), n,
                   _DTYPES[acc.dtype], _OPS[op], stream)
    if rc != 0:
        raise RuntimeError(f"segment_combine kernel launch failed: "
                           f"cudaError {rc}")
    launches += 1
    return out


def _kernel():
    lib = _build.load("segment_combine")
    fn = lib.repro_segment_combine
    if fn.argtypes is None:
        vp = ctypes.c_void_p
        fn.argtypes = [vp, vp, vp, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_int, vp]
        fn.restype = ctypes.c_int
    return fn
