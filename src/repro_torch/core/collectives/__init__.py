"""Collective algorithms on a ``torch.distributed`` group, synthesized step
programs, and the dispatch value types (port of
``repro.core.collectives``). ``group`` is the rank transport.

The reference's hierarchical compositions (``hierarchical``,
``schedule``) come with a later slice.
"""
from repro_torch.core.collectives.algorithms import ALGORITHMS, get
from repro_torch.core.collectives.dispatch import (
    CollectiveSpec,
    apply_collective,
)

__all__ = [
    "ALGORITHMS",
    "get",
    "CollectiveSpec",
    "apply_collective",
]
