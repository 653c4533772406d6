"""Launch meshes of ranks (port of ``repro/launch/mesh.py``:
``make_production_mesh``, ``local_mesh_spec``, ``make_local_mesh`` and
``local_topology``).

The reference builds a ``jax`` mesh over the attached devices; the port
builds a `group.RankMesh` over the ranks of the default process group
(``--ranks`` of the launcher), so it runs inside every rank, and every
rank must build it (each sub-group creation is collective). The
production meshes of the dry-run (16 x 16, or 2 x 16 x 16 over pods)
are recording meshes (`group.MetaMesh`): one rank's view of 256 or 512
ranks, with no process group.

Mesh builders that take a topology return the mesh TOGETHER with its
``Topology`` (the per-level network description ``core.topology``
tunes against), so every launcher knows which mesh axis rides which
fabric tier.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

from repro_torch.core.collectives import group as grp
from repro_torch.core.topology import (
    DEFAULT_LEVEL_PROFILES,
    SYNC_AXES,
    MeshLevel,
    Topology,
    level_names_for,
)


def make_production_mesh(*, multi_pod: bool = False,
                         coords: Optional[Sequence[int]] = None) -> Tuple:
    """16 x 16 = 256 ranks a pod (``("data", "model")``); 2 pods = 512
    ranks (``("pod", "data", "model")``), as a `group.MetaMesh` standing
    for the rank at ``coords`` (default rank 0: the reference reports one
    device's program). Returns ``(mesh, topology)``: single-pod is one
    level over "data"; multi-pod stacks the cross-pod level over "pod"
    on top of it."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    mesh = grp.MetaMesh(shape, axes, coords)
    return mesh, local_topology(mesh)


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


def local_topology(mesh) -> Topology:
    """A Topology matching a mesh's data axes (default profiles).

    Level names follow the tier count, innermost first: one sync axis is
    the ICI baseline ("intra_pod"); "pod" stacks "cross_pod" on top; a
    "dcn" axis pushes the naming down a tier (data becomes "intra_host",
    pod "intra_pod", dcn "cross_pod") — the same rule as
    ``Topology.from_spec``. Sync axes follow the MESH's nesting order
    (innermost first), not the canonical tuple's, so a permuted mesh
    still gets its innermost axis on the fastest tier."""
    axes = [a for a in reversed(tuple(mesh.axis_names))
            if a in SYNC_AXES]
    names = level_names_for(len(axes))
    return Topology(tuple(
        MeshLevel(name, mesh.shape[axis], DEFAULT_LEVEL_PROFILES[name],
                  axis=axis)
        for name, axis in zip(names, axes)))
