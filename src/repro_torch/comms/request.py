"""`CollectiveRequest`: the survey's richer collective feature vector.

A copy of ``repro/comms/request.py``, with one change: ``for_array``
takes a tensor and spells its dtype as the reference does
(``"float32"``, never ``"torch.float32"``), so artifact keys and plan
text are the reference's. The reference's text follows.

The survey's core observation is that the collective parameter space is
combinatorially explosive — operation, message size, datatype, communicator
size/shape, reduction operator, network level all shift the optimal
{algorithm, segments}. A `CollectiveRequest` carries that full vector as
the key every `Communicator` decision is made on.

Existing schema-2/3 artifacts key only on the minimal 3-tuple
``(op, nbytes, axis_size)``; `key3()` is the backward-compatible
degradation every request supports, so old artifacts keep resolving while
richer tables can be introduced without touching call sites.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

from repro_torch import pytree


@dataclasses.dataclass(frozen=True)
class CollectiveRequest:
    """One collective the runtime wants dispatched.

    op         one of the registered collective operations
               ("all_reduce", "reduce_scatter", "all_gather",
               "all_to_all", "broadcast", ...);
    nbytes     wire message size: the local buffer the algorithm moves
               (the shard for all_gather, the full buffer otherwise);
    axis       mesh axis name, or an (inner, ..., outer) tuple for a
               hierarchical multi-axis composition (innermost first);
    axis_size  ranks participating on ``axis`` (product over all for a
               multi-axis composition);
    dtype      element dtype name — part of the survey's feature vector
               (reduction cost and packetization differ by width);
    reduce_op  combine operator for reducing collectives;
    level      optional topology-level address ("intra_pod" / index) when
               the caller pins the decision to one level of a
               hierarchical artifact.
    """

    op: str
    nbytes: int
    axis: Union[str, Tuple[str, ...], None] = None
    axis_size: int = 1
    dtype: str = "float32"
    reduce_op: str = "add"
    level: Optional[Union[int, str]] = None

    def key3(self) -> Tuple[str, int, int]:
        """Degrade to the legacy (op, nbytes, axis_size) decision key used
        by every schema-2/3 artifact."""
        return (self.op, int(self.nbytes), int(self.axis_size))

    @property
    def hierarchical(self) -> bool:
        """True when the request names a multi-axis (inner, ..., outer)
        composition."""
        return isinstance(self.axis, tuple)

    @classmethod
    def for_array(cls, op: str, x, axis, axis_size: int, *,
                  reduce_op: str = "add",
                  level: Optional[Union[int, str]] = None
                  ) -> "CollectiveRequest":
        """The request for dispatching ``op`` on local buffer ``x``."""
        return cls(op=op, nbytes=x.numel() * x.element_size(), axis=axis,
                   axis_size=axis_size, dtype=pytree.dtype_name(x.dtype),
                   reduce_op=reduce_op, level=level)

    def describe(self) -> str:
        axis = "x".join(self.axis) if self.hierarchical else (self.axis or "?")
        return (f"{self.op}[{self.dtype}] {self.nbytes} B over "
                f"{axis}({self.axis_size})")
