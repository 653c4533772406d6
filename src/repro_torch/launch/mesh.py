"""Launch meshes of ranks (port of ``repro/launch/mesh.py``:
``local_mesh_spec`` and ``make_local_mesh``).

The reference builds a ``jax`` mesh over the attached devices; the port
builds a `group.RankMesh` over the ranks of the default process group
(``--ranks`` of the launcher), so it runs inside every rank, and every
rank must build it (each sub-group creation is collective).
"""
from __future__ import annotations

from typing import Tuple

from repro_torch.core.collectives import group as grp


def local_mesh_spec(n: int, model_parallel: int = 1, pods: int = 1,
                    dcn: int = 1) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """The ``(shape, axes)`` `make_local_mesh` builds over ``n`` ranks —
    shared with the placement sweep, so candidates are enumerated for
    exactly the mesh the launch constructs. Raises `ValueError` naming
    the offending values when the ranks don't tile."""
    if n % (model_parallel * pods * dcn) != 0:
        raise ValueError(
            f"{n} ranks cannot tile --dcn={dcn} x --pods={pods} x "
            f"--model-parallel={model_parallel} "
            f"(= {model_parallel * pods * dcn} ranks); pick factors of {n}")
    if dcn > 1:
        return ((dcn, pods, n // (dcn * pods * model_parallel),
                 model_parallel), ("dcn", "pod", "data", "model"))
    if pods > 1:
        return ((pods, n // (pods * model_parallel), model_parallel),
                ("pod", "data", "model"))
    return ((n // model_parallel, model_parallel), ("data", "model"))


def make_local_mesh(model_parallel: int = 1, pods: int = 1, dcn: int = 1,
                    *, mapping=None, device=None) -> grp.RankMesh:
    """The mesh over every rank of the default group. ``pods > 1`` splits
    the data axis into ("pod", "data"); ``dcn > 1`` stacks the third tier
    on top (("dcn", "pod", "data")). ``mapping`` (a swept `MeshMapping`)
    builds it in the mapping's rank order instead; it must target the
    same axes and shape this call would construct. Collective."""
    shape, axes = local_mesh_spec(grp.size(), model_parallel, pods, dcn)
    if mapping is not None:
        if tuple(mapping.axes) != axes or tuple(mapping.shape) != shape:
            raise ValueError(
                f"mesh mapping targets axes={mapping.axes} "
                f"shape={mapping.shape} but this launch builds "
                f"axes={axes} shape={shape}")
        return mapping.build_mesh(device=device)
    return grp.RankMesh(shape, axes, device=device)
