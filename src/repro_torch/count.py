"""The open work count: how the kernels and the rank transport report to
the step counter of ``launch/accounting.py`` (the port's counterpart of
the reference's ``hlo_analysis``), without importing it.

A kernel wrapper given ``meta`` tensors makes outputs of its kernel's
shapes and types, runs nothing, and calls `note` with the work its
kernel does: FLOPs as ``torch.utils.flop_counter`` counts the plain
reference of the same function (``kernels/ref.py``), bytes as its inputs
read once and its outputs written once, and its launches. On CPU tensors
a wrapper runs its plain version inside `kernel`, which notes the same
work and hides the plain version's own operations from the count, so a
run on the CPU and a trace on ``meta`` count the same work. A collective
on a real axis runs inside `hidden`: its copies are transport, not the
step's work (``group.Record`` keeps the collectives apart).

A counter is any object with ``kernel(name, flops, nbytes, launches)``
and an integer ``paused``; it pushes itself on `_OPEN` while it counts.
"""
from __future__ import annotations

import contextlib

#: the open counters, innermost last
_OPEN: list = []


def current():
    """The innermost open counter, or None."""
    return _OPEN[-1] if _OPEN else None


def note(name: str, flops: int, nbytes: int, launches: int) -> None:
    """Add one kernel call's work to the open counter (if any)."""
    c = current()
    if c is not None:
        c.kernel(name, flops, nbytes, launches)


@contextlib.contextmanager
def hidden():
    """The operations inside the block are not counted (their allocations
    still are)."""
    c = current()
    if c is None:
        yield
        return
    c.paused += 1
    try:
        yield
    finally:
        c.paused -= 1


@contextlib.contextmanager
def kernel(name: str, flops: int, nbytes: int, launches: int):
    """A kernel's plain version on the CPU: its work noted as the kernel's,
    its own operations hidden."""
    note(name, flops, nbytes, launches)
    with hidden():
        yield
