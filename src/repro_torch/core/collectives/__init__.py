"""Collective algorithms on a ``torch.distributed`` group, synthesized step
programs, hierarchical compositions over mesh axes, and the dispatch
value types (port of ``repro.core.collectives``). ``group`` is the rank
transport and the mesh of ranks (`group.RankMesh`).
"""
from repro_torch.core.collectives.algorithms import ALGORITHMS, get
from repro_torch.core.collectives.dispatch import (
    CollectiveSpec,
    apply_collective,
)
from repro_torch.core.collectives.hierarchical import (
    hierarchical_all_gather,
    hierarchical_all_reduce,
    hierarchical_reduce_scatter,
    multilevel_all_gather,
    multilevel_all_reduce,
    multilevel_reduce_scatter,
    sync_gradients_hierarchical,
    sync_gradients_multilevel,
)

__all__ = [
    "ALGORITHMS",
    "get",
    "CollectiveSpec",
    "apply_collective",
    "hierarchical_all_gather",
    "hierarchical_all_reduce",
    "hierarchical_reduce_scatter",
    "multilevel_all_gather",
    "multilevel_all_reduce",
    "multilevel_reduce_scatter",
    "sync_gradients_hierarchical",
    "sync_gradients_multilevel",
]
