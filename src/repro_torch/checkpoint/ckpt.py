"""Checkpointing (port of ``repro/checkpoint/ckpt.py``): a tree of
tensors (params, optimizer state) round-trips through the reference's
files, an ``arrays.npz`` bundle beside a JSON ``manifest.json``, in the
reference's layout, so a checkpoint crosses between the two packages
either way.

`save` writes each leaf under the key the reference gives it
(`bridge.reference_leaves`): the per-layer lists of ``bridge.STACKED``
stacked over layers into one ``(L, ...)`` array each, an ``AdamWState``
under ``.step`` (int32, shape ``[]``), ``.mu`` and ``.nu``, every other
leaf as it is. Dtypes are numpy's names; numpy has no bfloat16, so a
bf16 leaf is written as fp32 data under ``"bfloat16"`` (the reference's
``restore`` casts it back exactly).

`restore` reads that layout, and the port's earlier one (one key a
layer, ``params/layers/0/attn/wq``, ``opt/1/...`` for Adam's mu), told
apart by the manifest's keys; a bf16 leaf that the reference wrote
(raw 2-byte ``|V2`` data where numpy cannot name bfloat16) is decoded
bit for bit.
"""
from __future__ import annotations

import json
import os
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch import bridge, pytree


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = torch.as_tensor(t).detach().cpu()
    if t.dtype == torch.bfloat16:        # numpy has no bfloat16
        t = t.float()
    return t.numpy()


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A stored array as a tensor: 2-byte data under ``"bfloat16"`` (the
    reference's raw bits) as bf16, bit for bit."""
    arr = np.array(arr, order="C")       # a writable copy, 0-d kept
    if dtype == "bfloat16" and arr.dtype.itemsize == 2:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save(path: str, tree: Any, *, step: int = 0,
         extra: Optional[dict] = None) -> None:
    """Write ``tree`` in the reference's layout (module docstring)."""
    os.makedirs(path, exist_ok=True)
    groups: dict = {}       # reference key -> [(layer, leaf)], in order
    for _, key, layer, leaf in bridge.reference_leaves(tree):
        groups.setdefault(key, []).append((layer, leaf))
    arrays = {}
    manifest = {"step": step, "extra": extra or {}, "leaves": []}
    for key, entries in groups.items():
        if entries[0][0] is None:
            (_, leaf), = entries
            arr = _to_numpy(leaf)
        else:
            if [i for i, _ in entries] != list(range(len(entries))):
                raise ValueError(f"{key}: layers {[i for i, _ in entries]}")
            arr = np.stack([_to_numpy(leaf) for _, leaf in entries])
        arrays[key.replace("/", "__")] = arr
        manifest["leaves"].append({
            "key": key, "dtype": pytree.dtype_name(entries[0][1].dtype),
            "shape": list(arr.shape)})
    np.savez(os.path.join(path, "arrays.npz"), **arrays)
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)


def restore(path: str, like: Any, *, device=None,
            shard: Optional[Callable] = None):
    """Restore into the structure, dtypes and (unless ``device`` is
    given) devices of ``like``; returns (tree, step, extra).

    ``shard`` (the reference's ``shardings=``): ``(path, whole) ->
    block``, called on every whole leaf (a stacked array's layer) with
    its path in ``like`` (dict keys, list and tuple indices), returning
    the block this rank holds, e.g. `sharding.shard_leaf` at the rank's
    coordinate; ``like`` then holds blocks. Shapes are checked per leaf:
    the block's against ``like``'s, a stacked array's layer count
    against ``like``'s."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    rows = {r["key"]: r for r in manifest["leaves"]}
    walk = list(bridge.reference_leaves(like))
    if all(key in rows for _, key, _, _ in walk):
        entries = [(p, key, layer) for p, key, layer, _ in walk]
        layers: dict = {}
        for _, key, layer in entries:
            if layer is not None:
                layers[key] = layers.get(key, 0) + 1
    else:           # the port's earlier per-layer layout
        entries = [(p, "/".join(map(str, p)), None) for p, _, _, _ in walk]
        layers = {}
        missing = [key for _, key, _ in entries if key not in rows]
        if missing:
            raise KeyError(f"{path}: no leaf {missing[:3]} (of "
                           f"{len(missing)}) in either layout")
    data = np.load(os.path.join(path, "arrays.npz"))
    cache: dict = {}
    out = []
    for (p, key, layer), leaf in zip(entries, pytree.leaves(like)):
        if key not in cache:     # each stored array read once
            cache[key] = _from_numpy(data[key.replace("/", "__")],
                                     rows[key]["dtype"])
        whole = cache[key]
        if layer is not None:
            if whole.shape[0] != layers[key]:
                raise ValueError(f"layer mismatch at {key}: {whole.shape[0]}"
                                 f" stored vs {layers[key]}")
            whole = whole[layer]
        if shard is not None:
            whole = shard(p, whole)
        if list(whole.shape) != list(leaf.shape):
            raise ValueError(f"shape mismatch at {key}"
                             + ("" if layer is None else f"[{layer}]")
                             + f": {tuple(whole.shape)} vs "
                             f"{tuple(leaf.shape)}")
        out.append(whole.to(device=device if device is not None
                            else leaf.device, dtype=leaf.dtype,
                            copy=True))
    return pytree.flatten(like)[1].unflatten(out), manifest["step"], \
        manifest["extra"]
